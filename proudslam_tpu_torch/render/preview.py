"""Full-image preview rendering for the rendered-vs-ground-truth panels.

Port of ``proudslam_tpu/render/preview.py``: depth and color of every pixel
of a (possibly downscaled) view against the current map, rendered in
chunks of rays; misses render as zeros.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.geometry import camera, se3
from proudslam_tpu_torch.render.renderer import render_rays


def render_preview(map_state, decoder_params, pose6: torch.Tensor,
                   settings: SystemSettings, width: int, height: int,
                   intrinsics: Tuple[float, float, float, float],
                   full_wh: Tuple[int, int], chunk: int = 4096,
                   seed: int = 0,
                   noise_fn: Optional[Callable[[int], torch.Tensor]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rgb (height, width, 3), depth (height, width)) numpy images.

    The intrinsics are rescaled from the capture resolution ``full_wh``.
    Each chunk of ``chunk`` rays gets a (chunk, S - H) block of
    stratification uniforms (a short last chunk its first rows) from
    ``noise_fn(chunk_index)``, by default from a ``torch.Generator`` of
    its own seeded with ``seed``: the preview never draws from the
    engine's generator, so a run with panels keeps the trajectory of a run
    without them. The pcd branch raises: it renders from a point store,
    which the preview does not take (as in the JAX package).
    """
    rs = settings.render
    if rs.feature_mode == "pcd":
        raise ValueError("render_preview: feature_mode='pcd' renders from a "
                         "point store, which the preview does not take")
    dev = pose6.device
    fx, fy, cx, cy = camera.scaled_intrinsics(
        intrinsics, full_wh[0], full_wh[1], width, height)
    dirs = camera.pixel_ray_directions(width, height, fx, fy, cx, cy,
                                       device=dev).reshape(-1, 3)
    SJ = rs.max_samples - rs.max_hits
    if noise_fn is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def noise_fn(_):
            return torch.rand((chunk, SJ), generator=gen, device=dev)
    n = dirs.shape[0]
    rgb = torch.zeros((n, 3), device=dev)
    depth = torch.zeros((n,), device=dev)
    with torch.no_grad():
        R = se3.exp_rotation(pose6[3:6])
        for c, i in enumerate(range(0, n, chunk)):
            world_d = dirs[i:i + chunk] @ R.T
            m = world_d.shape[0]
            out = render_rays(pose6[0:3].expand_as(world_d), world_d,
                              map_state, map_state.embeddings,
                              decoder_params, settings.decoder, rs,
                              noise=noise_fn(c)[:m])
            hit = out.hit_mask
            rgb[i:i + m] = torch.where(hit[:, None], out.color, 0.0)
            depth[i:i + m] = torch.where(hit, out.depth, 0.0)
    return (rgb.reshape(height, width, 3).cpu().numpy(),
            depth.reshape(height, width).cpu().numpy())
