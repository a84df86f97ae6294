"""ARKit capture loader (reference `src/dataset/arkit.py`).

A copy of ``proudslam_tpu/data/arkit.py``.

Layout: a ``Frames.csv`` index (first/last 50 frames dropped), per-frame
jpg + uint16 depth png (scale 1000, 65535 -> invalid), intrinsics from the
csv row divided by 5, images resized to 256x144, optional vertical
transpose. No ground-truth poses (SLAM starts from identity).
"""

from __future__ import annotations

import csv
import os.path as osp

import numpy as np


class ARKitDataset:
    def __init__(self, data_path: str, use_gt: bool = False,
                 max_depth: float = 10.0, transpose: bool = False):
        self.data_path = data_path
        self.max_depth = max_depth
        self.transpose = transpose
        with open(osp.join(data_path, "Frames.csv")) as f:
            rows = list(csv.reader(f))
        rows = rows[1:] if rows and not rows[0][0].isdigit() else rows
        self.rows = rows[50:-50] if len(rows) > 100 else rows
        r0 = self.rows[0]
        # intrinsics stored at capture resolution; depth is 5x smaller
        self.K = np.array([
            [float(r0[2]) / 5.0, 0.0, float(r0[4]) / 5.0],
            [0.0, float(r0[3]) / 5.0, float(r0[5]) / 5.0],
            [0.0, 0.0, 1.0]])

    @property
    def intrinsics(self):
        return (self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2])

    def get_init_pose(self) -> np.ndarray:
        return np.eye(4)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int):
        from PIL import Image
        row = self.rows[index]
        frame_id = row[0]
        rgb = Image.open(
            osp.join(self.data_path, f"{frame_id}.jpg")).convert("RGB")
        rgb = rgb.resize((256, 144), Image.BILINEAR)
        rgb = np.asarray(rgb, dtype=np.float32) / 255.0
        depth = np.asarray(Image.open(
            osp.join(self.data_path, f"{frame_id}.png")), dtype=np.float64)
        depth = np.where(depth >= 65535, 0.0, depth) / 1000.0
        depth = np.where(depth > self.max_depth, 0.0, depth)
        depth = depth.astype(np.float32)
        if depth.sum() == 0:
            raise ValueError(f"frame {frame_id}: all-zero depth")
        if self.transpose:
            rgb = np.transpose(rgb, (1, 0, 2))[:, ::-1]
            depth = depth.T[:, ::-1]
        return index, rgb, depth, self.K, None
