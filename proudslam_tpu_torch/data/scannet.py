"""ScanNet RGB-D sequence loader (reference `src/dataset/scannet.py`).

A copy of ``proudslam_tpu/data/scannet.py``.

Layout: ``color/%d.jpg`` (resized to 640x480), ``depth/%d.png`` (uint16,
scale ``depth_scale``), ``pose/%d.txt``, ``intrinsic/intrinsic_depth.txt``.
Supports the reference's crop / power-of-two scale options. PIL is
imported where a frame is read.
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np


class ScanNetDataset:
    def __init__(self, data_path: str, use_gt: bool = False,
                 scale_factor: int = 0, crop: int = 0,
                 depth_scale: float = 1000.0, max_depth: float = 10.0):
        self.data_path = data_path
        self.use_gt = use_gt
        self.scale_factor = scale_factor
        self.crop = crop
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        num = len(glob.glob(osp.join(data_path, "color/*.jpg")))
        self.num_imgs = num
        self.depth_files = [osp.join(data_path, f"depth/{i}.png")
                            for i in range(num)]
        self.image_files = [osp.join(data_path, f"color/{i}.jpg")
                            for i in range(num)]
        self.pose_files = [osp.join(data_path, f"pose/{i}.txt")
                           for i in range(num)]
        self.K = self._load_intrinsic()

    def _load_intrinsic(self) -> np.ndarray:
        K = np.loadtxt(osp.join(
            self.data_path, "intrinsic/intrinsic_depth.txt"))[:3, :3]
        if self.scale_factor > 0:
            K = K / (2 ** self.scale_factor)
            K[2, 2] = 1
        if self.crop > 0:
            K[0, 2] -= self.crop
            K[1, 2] -= self.crop
        return K

    @property
    def intrinsics(self):
        return (self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2])

    def get_init_pose(self) -> np.ndarray:
        return np.loadtxt(self.pose_files[0])

    def load_depth(self, index: int) -> np.ndarray:
        from PIL import Image
        depth = np.asarray(Image.open(self.depth_files[index]),
                           dtype=np.float64) / self.depth_scale
        depth = np.where(depth > self.max_depth, 0.0, depth)
        if self.scale_factor > 0:
            skip = 2 ** self.scale_factor
            depth = depth[::skip, ::skip]
        if self.crop > 0:
            depth = depth[self.crop:-self.crop, self.crop:-self.crop]
        return depth.astype(np.float32)

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image
        img = Image.open(self.image_files[index]).convert("RGB")
        size = (640, 480)
        if self.scale_factor > 0:
            f = 2 ** self.scale_factor
            size = (640 // f, 480 // f)
        img = img.resize(size, Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.crop > 0:
            arr = arr[self.crop:-self.crop, self.crop:-self.crop]
        return arr

    def __len__(self):
        return self.num_imgs

    def __getitem__(self, index: int):
        rgb = self.load_image(index)
        depth = self.load_depth(index)
        pose = np.loadtxt(self.pose_files[index]) if self.use_gt else None
        return index, rgb, depth, self.K, pose
