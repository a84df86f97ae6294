"""Pinhole camera model: pixel ray grids and depth backprojection.

Port of ``proudslam_tpu/geometry/camera.py``. Ray directions are
unnormalized ``[(x-cx)/fx, (y-cy)/fy, 1]``, so the ray parameter equals
camera-plane z depth.
"""

from __future__ import annotations

import torch


def pixel_ray_directions(width: int, height: int, fx, fy, cx, cy, *,
                         device) -> torch.Tensor:
    """(H, W, 3) per-pixel camera-frame ray directions on ``device``."""
    ix = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    iy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    x = ((ix - cx) / fx).expand(height, width)
    y = ((iy - cy) / fy).expand(height, width)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def backproject(rays_d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Camera-frame point map (H, W, 3) = rays * depth."""
    return rays_d * depth[..., None]


def transform_points(points: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to (..., 3) points: p @ R^T + t."""
    return points @ R.transpose(-1, -2) + t
