"""Dataset registry: resolve config ``dataset:`` strings to loaders.

Port of ``proudslam_tpu/data/registry.py``; the loaders are the port's
copies (numpy, with PIL imported where a real-data frame is read)."""

from __future__ import annotations

from proudslam_tpu_torch.config import Config


def get_dataset(cfg: Config):
    name = cfg.get("dataset", "synthetic")
    data = cfg.get("data_specs", {})
    path = data.get("data_path", "")
    max_depth = data.get("max_depth", 10.0)
    if name == "replica":
        from proudslam_tpu_torch.data.replica import ReplicaDataset
        return ReplicaDataset(path, max_depth=max_depth,
                              use_gt=data.get("use_gt", False))
    if name == "scannet":
        from proudslam_tpu_torch.data.scannet import ScanNetDataset
        return ScanNetDataset(
            path, use_gt=data.get("use_gt", False),
            scale_factor=data.get("scale_factor", 0),
            crop=data.get("crop", 0),
            depth_scale=data.get("depth_scale", 1000.0),
            max_depth=max_depth)
    if name == "arkit":
        from proudslam_tpu_torch.data.arkit import ARKitDataset
        return ARKitDataset(path, max_depth=max_depth,
                            transpose=data.get("transpose", False))
    if name == "synthetic":
        from proudslam_tpu_torch.data.synthetic import SyntheticDataset
        return SyntheticDataset(
            num_frames=data.get("num_frames", 40),
            width=data.get("width", 320), height=data.get("height", 240))
    raise ValueError(f"unknown dataset {name!r}")
