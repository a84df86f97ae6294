"""Ray–voxel intersection: brute-force slab test + K nearest hits.

Port of ``ray_intersect`` in ``proudslam_tpu/ops/intersect.py`` (the
``intersect_mode="brute"`` path): one (R, V) entry-depth matrix, then the
H closest hits per ray, depth-sorted. The JAX package selects with
``approx_min_k`` (exact on the CPU); the port selects exactly with
``torch.topk``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proudslam_tpu_torch.config import RenderSettings


class Intersections(NamedTuple):
    """Per-ray sorted voxel hits (all (R, H))."""

    t_near: torch.Tensor     # entry depth (max_distance where invalid)
    t_far: torch.Tensor      # exit depth (max_distance where invalid)
    voxel_idx: torch.Tensor  # voxel slot, -1 where invalid
    hit_mask: torch.Tensor   # (R,) bool — ray hit at least one voxel


def _slab_axis(o, d, c, half):
    """Per-axis slab interval; NaN (0 * inf) imposes no constraint."""
    inv = 1.0 / d
    lo = (c - half - o) * inv
    hi = (c + half - o) * inv
    t1 = torch.minimum(lo, hi)
    t2 = torch.maximum(lo, hi)
    t1 = torch.nan_to_num(t1, nan=-float("inf"), posinf=float("inf"),
                          neginf=-float("inf"))
    t2 = torch.nan_to_num(t2, nan=float("inf"), posinf=float("inf"),
                          neginf=-float("inf"))
    return t1, t2


def ray_box_slab_pairs(rays_o, rays_d, centers, half: float):
    """Slab test for per-ray candidate boxes: rays (R, 3) x boxes (R, H, 3)."""
    t1, t2 = _slab_axis(rays_o[:, None, :], rays_d[:, None, :], centers, half)
    t_near = torch.clamp_min(t1.amax(dim=-1), 0.0)
    t_far = t2.amin(dim=-1)
    return t_near, t_far, t_near <= t_far


def ray_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  centers: torch.Tensor, voxel_valid: torch.Tensor,
                  settings: RenderSettings) -> Intersections:
    """Intersect rays with all valid voxels; H closest hits, depth-sorted.

    Args:
      rays_o, rays_d: (R, 3) world rays (directions unnormalized).
      centers: (V, 3) voxel centers (padded slots allowed).
      voxel_valid: (V,) bool — live voxel slots.
    """
    H = settings.max_hits
    half = settings.voxel_size * 0.5
    BIG = settings.max_depth_sentinel

    tn = tf = None
    for a in range(3):
        t1, t2 = _slab_axis(rays_o[:, a:a + 1], rays_d[:, a:a + 1],
                            centers[None, :, a], half)
        tn = t1 if tn is None else torch.maximum(tn, t1)
        tf = t2 if tf is None else torch.minimum(tf, t2)
    tn = torch.clamp_min(tn, 0.0)
    hit = (tn <= tf) & voxel_valid[None, :] & (tn <= settings.max_distance)
    score = torch.where(hit, tn, BIG)                     # (R, V)

    V = centers.shape[0]
    if V <= H:  # pad with always-invalid columns
        score = torch.nn.functional.pad(score, (0, H + 1 - V), value=BIG)
    t_near, idx = torch.topk(score, H, dim=1, largest=False, sorted=True)
    idx = torch.clamp_max(idx, V - 1)

    _, tf2, _ = ray_box_slab_pairs(rays_o, rays_d, centers[idx], half)
    invalid = t_near >= BIG
    voxel_idx = torch.where(invalid, -1, idx.to(torch.int32))
    t_near = torch.where(invalid, settings.max_distance, t_near)
    t_far = torch.where(invalid, settings.max_distance, tf2)
    hit_mask = torch.any(~invalid, dim=-1)
    return Intersections(t_near=t_near, t_far=t_far, voxel_idx=voxel_idx,
                         hit_mask=hit_mask)
