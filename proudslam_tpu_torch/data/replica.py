"""Replica RGB-D sequence loader (reference `src/dataset/replica.py`).

A copy of ``proudslam_tpu/data/replica.py``.

Layout: ``<root>/results/frame%06d.jpg``, ``results/depth%06d.png``
(uint16, scale 6553.5), ``traj.txt`` with one flattened 4x4 pose per line.
Fixed intrinsics fx = fy = 600, cx = 599.5, cy = 339.5 (1200x680 images).
PIL, imported where a frame is read.
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np


class ReplicaDataset:
    def __init__(self, data_path: str, max_depth: float = -1.0,
                 use_gt: bool = False):
        self.data_path = data_path
        self.max_depth = max_depth
        self.use_gt = use_gt
        self.num_imgs = len(glob.glob(osp.join(data_path, "results/*.jpg")))
        self.K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])
        gt_file = osp.join(data_path, "traj.txt")
        self.gt_pose = (np.loadtxt(gt_file)
                        if osp.exists(gt_file) else None)

    @property
    def intrinsics(self):
        return (self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2])

    def get_init_pose(self) -> np.ndarray:
        if self.gt_pose is not None:
            return self.gt_pose[0].reshape(4, 4)
        return np.eye(4)

    def load_depth(self, index: int) -> np.ndarray:
        from PIL import Image
        path = osp.join(self.data_path,
                        "results/depth{:06d}.png".format(index))
        depth = np.asarray(Image.open(path), dtype=np.float64) / 6553.5
        if self.max_depth > 0:
            depth = np.where(depth > self.max_depth, 0.0, depth)
        return depth.astype(np.float32)

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image
        path = osp.join(self.data_path,
                        "results/frame{:06d}.jpg".format(index))
        rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
        return rgb / 255.0

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, index: int):
        rgb = self.load_image(index)
        depth = self.load_depth(index)
        pose = (self.gt_pose[index].reshape(4, 4)
                if (self.use_gt and self.gt_pose is not None) else None)
        return index, rgb, depth, self.K, pose
