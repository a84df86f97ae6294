"""Run artifact logger.

Port of ``proudslam_tpu/utils/logger.py``: creates
``<log_dir>/<exp_name>/<timestamp>/{imgs,mesh,ckpt,bak,misc}``, backs up the
config, saves meshes (PLY), numpy arrays and the rendered-vs-ground-truth
image panels, and appends scalar metrics to ``metrics.jsonl``.

The panels are PNG files written with ``zlib`` and ``struct`` alone (the
JAX package draws them with matplotlib into a JPEG): one writer on every
machine, with no plotting or imaging package. A panel holds the JAX
panel's six images, value ranges and jet colormap in the same 2x3 order,
without titles and axes:

    input depth | rendered depth | depth error
    input rgb   | rendered rgb   | rgb error
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

# matplotlib's "jet" segment data (x, y0, y1) per channel
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
              (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
_JET_LUT = np.stack([
    np.interp(np.linspace(0.0, 1.0, 256), [p[0] for p in pts],
              [p[1] for p in pts])
    for pts in _JET.values()], axis=-1)                  # (256, 3)


def jet(values: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """(...,) values -> (..., 3) colors in [0, 1], as matplotlib's ``jet``
    with ``Normalize(vmin, vmax)``: a 256-entry table, entry
    ``floor(256 * (v - vmin) / (vmax - vmin))`` clipped to [0, 255]
    (non-finite values take entry 0)."""
    x = (np.asarray(values, np.float64) - vmin) / max(vmax - vmin, 1e-30)
    idx = np.clip(np.floor(np.nan_to_num(x, nan=0.0) * 256.0), 0, 255)
    return _JET_LUT[idx.astype(np.int64)]


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),   # filter type 0
                           img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def render_panel(gt_rgb, gt_depth, rgb, depth) -> np.ndarray:
    """The 2x3 rendered-vs-ground-truth panel (module docstring) of (h, w)
    images -> (2h, 3w, 3) uint8. Depth maps share ``[0, max_depth]``
    (the larger of both maxima), the depth error spans a quarter of it,
    the rgb error (mean over channels) ``[0, 0.5]``."""
    gt_depth = np.asarray(gt_depth, np.float32)
    depth = np.asarray(depth, np.float32).reshape(gt_depth.shape)
    gt_rgb = np.asarray(gt_rgb, np.float32)
    rgb = np.asarray(rgb, np.float32).reshape(gt_rgb.shape)
    max_depth = max(float(gt_depth.max()), float(depth.max()), 1e-6)
    tiles = [
        [jet(gt_depth, 0.0, max_depth), jet(depth, 0.0, max_depth),
         jet(np.abs(depth - gt_depth), 0.0, max_depth / 4)],
        [np.clip(gt_rgb, 0.0, 1.0), np.clip(rgb, 0.0, 1.0),
         jet(np.abs(rgb - gt_rgb).mean(-1), 0.0, 0.5)],
    ]
    panel = np.concatenate([np.concatenate(r, axis=1) for r in tiles], axis=0)
    return np.round(panel * 255.0).astype(np.uint8)


class RunLogger:
    def __init__(self, log_dir: str, exp_name: str = "default"):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        self.dir = osp.join(log_dir, exp_name, stamp)
        self.img_dir = osp.join(self.dir, "imgs")
        self.mesh_dir = osp.join(self.dir, "mesh")
        self.ckpt_dir = osp.join(self.dir, "ckpt")
        self.backup_dir = osp.join(self.dir, "bak")
        self.misc_dir = osp.join(self.dir, "misc")
        for d in (self.img_dir, self.mesh_dir, self.ckpt_dir,
                  self.backup_dir, self.misc_dir):
            os.makedirs(d, exist_ok=True)
        self.metrics_path = osp.join(self.dir, "metrics.jsonl")
        open(self.metrics_path, "a").close()

    def log_config(self, config_path: Optional[str] = None,
                   config_dict: Optional[dict] = None) -> None:
        if config_path and osp.exists(config_path):
            shutil.copy(config_path, self.backup_dir)
        if config_dict is not None:
            with open(osp.join(self.backup_dir, "config.json"), "w") as f:
                json.dump(config_dict, f, indent=2, default=str)

    def log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_numpy(self, data: np.ndarray, name: str) -> None:
        np.save(osp.join(self.misc_dir, f"{name}.npy"), np.asarray(data))

    def log_mesh(self, mesh, name: str = "final_mesh.ply") -> None:
        from proudslam_tpu_torch.mesher import save_ply
        save_ply(osp.join(self.mesh_dir, name), mesh)

    def log_images(self, index: int, gt_rgb, gt_depth, rgb, depth) -> str:
        """Save the rendered-vs-ground-truth panel (:func:`render_panel`)
        as ``imgs/render_<index:05d>.png``; returns its path."""
        path = osp.join(self.img_dir, f"render_{index:05d}.png")
        write_png(path, render_panel(gt_rgb, gt_depth, rgb, depth))
        return path
