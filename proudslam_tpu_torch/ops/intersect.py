"""Ray–voxel intersection: brute-force slab test + K nearest hits, and the
grid-marching (DDA) form.

Port of ``proudslam_tpu/ops/intersect.py``:

* :func:`ray_intersect` (``intersect_mode="brute"``): one (R, V)
  entry-depth matrix, then the H closest hits per ray, depth-sorted. The
  JAX package selects with ``approx_min_k`` (exact on the CPU); the port
  selects exactly with ``torch.topk``.
* :func:`ray_intersect_dda` (``intersect_mode="dda"``): march each ray at
  a fixed euclidean spacing through a dense occupancy grid
  (:func:`build_occupancy`) and keep the first H distinct voxels, with
  exact slab depths for those. The JAX package compacts the runs by an
  (R, M, H) one-hot sum; here one scatter by rank gives the same slots.
* :func:`ray_intersect_scan`: the exact chunked top-K merge, the oracle
  of both in the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from proudslam_tpu_torch.config import RenderSettings
from proudslam_tpu_torch.ops.voxel_hash import unpack_key


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


def dda_num_points(settings: RenderSettings) -> int:
    """March points per ray: covers t <= max_distance for any ray with
    |d| <= dda_dir_bound (rounded up to a multiple of 8, as the JAX
    package's count)."""
    m = settings.max_distance * settings.dda_dir_bound / (
        settings.dda_step_frac * settings.voxel_size)
    return (int(m) + 2 + 7) // 8 * 8


def _grid_index(c: torch.Tensor, settings: RenderSettings):
    """Integer voxel coords (..., 3) -> (linear cell index, inside the
    configured extent)."""
    gx, gy, gz = settings.grid_dims
    ox, oy, oz = settings.grid_origin
    cx, cy, cz = c[..., 0] - ox, c[..., 1] - oy, c[..., 2] - oz
    inside = ((cx >= 0) & (cx < gx) & (cy >= 0) & (cy < gy)
              & (cz >= 0) & (cz < gz))
    return (cx * gy + cy) * gz + cz, inside


def build_occupancy(voxel_keys: torch.Tensor, num_voxels: int,
                    settings: RenderSettings) -> torch.Tensor:
    """Dense voxel-slot grid: (prod(grid_dims),) int32, -1 where empty.

    The live voxel keys are unique, so each real cell is written at most
    once; dead slots and voxels outside the extent go to one pad cell past
    the end, sliced off (the only cell with duplicate writes). Voxels
    outside the extent are unreachable by the DDA path."""
    total = int(np.prod(settings.grid_dims))
    V = voxel_keys.shape[0]
    slots = torch.arange(V, dtype=torch.int32, device=voxel_keys.device)
    lin, inside = _grid_index(unpack_key(voxel_keys), settings)
    lin = torch.where(inside & (slots < num_voxels), lin, total)
    occ = torch.full((total + 1,), -1, dtype=torch.int32,
                     device=voxel_keys.device)
    occ[lin.long()] = slots
    return occ[:total]


def ray_intersect_dda(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      voxel_keys: torch.Tensor, num_voxels: int,
                      settings: RenderSettings,
                      occupancy: torch.Tensor = None) -> Intersections:
    """Grid-marching intersection: O(path length) per ray, V-independent.

    March points ``o + d * t`` at euclidean spacing ``dda_step_frac *
    voxel_size`` look up the occupancy grid; the first H distinct voxels
    are the H nearest, since march order is depth order. Their entry and
    exit depths are recomputed exactly (slab test), so the result equals
    :func:`ray_intersect`'s up to corner grazes: a voxel whose in-voxel
    chord is shorter than the spacing may be skipped.

    The march points are computed as the JAX package computes them
    (``t = arange(M) * step_t``, then ``o + d * t`` as two ops, the cell
    by a multiply with the reciprocal of the voxel size), so a point on a
    cell face falls on the side XLA puts it.
    """
    H = settings.max_hits
    vox = settings.voxel_size
    total = int(np.prod(settings.grid_dims))
    M = dda_num_points(settings)
    dev = rays_o.device
    if occupancy is None:
        occupancy = build_occupancy(voxel_keys, num_voxels, settings)
    occ_pad = torch.cat([occupancy, occupancy.new_full((1,), -1)])

    dnorm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True))
    # a tensor numerator: ``scalar / tensor`` is a reciprocal times the
    # scalar in PyTorch, which rounds differently from XLA's division
    step_t = (torch.tensor(settings.dda_step_frac * vox, device=dev)
              / torch.clamp_min(dnorm, 1e-12))
    t = torch.arange(M, dtype=torch.float32, device=dev)[None, :] * step_t
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]  # (R, M, 3)
    c = torch.floor(pts * (1.0 / vox)).to(torch.int32)
    lin, inside = _grid_index(c, settings)
    lin = torch.where(inside & (t <= settings.max_distance), lin, total)
    slot = occ_pad[lin.long()]                                    # (R, M)

    # first marched point of each visited cell (a line's span inside an
    # AABB is one interval, so runs of equal lin are contiguous)
    new_run = torch.ones_like(lin, dtype=torch.bool)
    new_run[:, 1:] = lin[:, 1:] != lin[:, :-1]
    hit = (slot >= 0) & new_run
    rank = torch.cumsum(hit.to(torch.int32), dim=1) - 1
    keep = hit & (rank < H)
    # compact to (R, H) by rank: every kept point has its own rank, the
    # rest go to a dump column
    R = rays_o.shape[0]
    idx = torch.zeros((R, H + 1), dtype=torch.int32, device=dev)
    idx.scatter_(1, torch.where(keep, rank, H).long(),
                 torch.where(keep, slot, 0))
    idx = idx[:, :H]
    n_hits = keep.sum(dim=1)
    sel_valid = (torch.arange(H, device=dev)[None, :] < n_hits[:, None])

    # exact entry/exit depths for the selected voxels only
    sel_keys = voxel_keys[idx.clamp(0, voxel_keys.shape[0] - 1).long()]
    centers = (unpack_key(sel_keys).float() + 0.5) * vox
    tn, tf, _ = ray_box_slab_pairs(rays_o, rays_d, centers, vox * 0.5)
    sel_valid &= tn <= settings.max_distance
    return Intersections(
        t_near=torch.where(sel_valid, tn, settings.max_distance),
        t_far=torch.where(sel_valid, tf, settings.max_distance),
        voxel_idx=torch.where(sel_valid, idx, -1),
        hit_mask=sel_valid.any(dim=-1))


def ray_intersect_scan(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       centers: torch.Tensor, voxel_valid: torch.Tensor,
                       settings: RenderSettings,
                       chunk: int = 4096) -> Intersections:
    """Exact chunked-scan variant: a running per-ray top-H merge over
    chunks of voxels (the oracle of :func:`ray_intersect_dda`). Ties keep
    the earlier candidate, as XLA's ``top_k`` does."""
    R = rays_o.shape[0]
    V = centers.shape[0]
    H = settings.max_hits
    half = settings.voxel_size * 0.5
    BIG = settings.max_depth_sentinel
    dev = rays_o.device
    best_tn = torch.full((R, H), BIG, device=dev)
    best_tf = torch.full((R, H), BIG, device=dev)
    best_idx = torch.full((R, H), -1, dtype=torch.int32, device=dev)
    for base in range(0, V, chunk):
        c = centers[base:base + chunk]
        n_c = c.shape[0]
        if n_c < chunk:  # pad as the JAX scan does (invalid columns)
            c = torch.cat([c, c.new_zeros((chunk - n_c, 3))])
        ok = torch.zeros(chunk, dtype=torch.bool, device=dev)
        ok[:n_c] = voxel_valid[base:base + chunk]
        t1, t2 = _slab_axis(rays_o[:, None, :], rays_d[:, None, :],
                            c[None], half)
        tn = torch.clamp_min(t1.amax(dim=-1), 0.0)
        tf = t2.amin(dim=-1)
        hit = (tn <= tf) & ok[None, :] & (tn <= settings.max_distance)
        ids = torch.arange(base, base + chunk, dtype=torch.int32,
                           device=dev)
        cand_tn = torch.cat([best_tn, torch.where(hit, tn, BIG)], dim=1)
        cand_tf = torch.cat([best_tf, torch.where(hit, tf, BIG)], dim=1)
        cand_idx = torch.cat([best_idx, torch.where(hit, ids, -1)], dim=1)
        best_tn, pos = torch.sort(cand_tn, dim=1, stable=True)
        best_tn, pos = best_tn[:, :H], pos[:, :H]
        best_tf = torch.gather(cand_tf, 1, pos)
        best_idx = torch.gather(cand_idx, 1, pos)
    invalid = best_idx < 0
    return Intersections(
        t_near=torch.where(invalid, settings.max_distance, best_tn),
        t_far=torch.where(invalid, settings.max_distance, best_tf),
        voxel_idx=best_idx, hit_mask=(~invalid).any(dim=-1))
