"""Point-feature render branch: per-voxel point clouds -> sample features.

Port of ``proudslam_tpu/render/pcd_features.py``. Points live in a
fixed-capacity table indexed by voxel slot (at most K per voxel,
first-come, later points dropped once a voxel is full); a sample's feature
is the softmax inverse-distance blend of the PointNet features of its
voxel's points, computed per (ray, hit slot) and moved to the samples by
an exact one-hot contraction over the small H axis.

The contractions are ``torch.bmm`` of the (R, S, H) one-hot, never a
``gather``: a gather's backward is an atomic scatter-add on CUDA, which
would make the engine's runs differ from one another. Every scatter in
:func:`insert_frame_points` writes distinct destinations or adds integers,
so it is deterministic too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proudslam_tpu_torch.config import MapSettings
from proudslam_tpu_torch.models.pointnet import pointnet_apply
from proudslam_tpu_torch.ops import voxel_hash as vh


class VoxelPointStore(NamedTuple):
    """Fixed-capacity per-voxel point storage."""

    xyz: torch.Tensor      # (V, K, 3) world positions
    rgb: torch.Tensor      # (V, K, 3) colors in [0, 1]
    counts: torch.Tensor   # (V,) int32 live points per voxel


def init_point_store(settings: MapSettings, points_per_voxel: int = 8,
                     device="cuda") -> VoxelPointStore:
    V, K = settings.voxel_capacity, points_per_voxel
    return VoxelPointStore(
        xyz=torch.zeros((V, K, 3), dtype=torch.float32, device=device),
        rgb=torch.zeros((V, K, 3), dtype=torch.float32, device=device),
        counts=torch.zeros((V,), dtype=torch.int32, device=device))


def insert_frame_points(store: VoxelPointStore, map_state,
                        points: torch.Tensor, colors: torch.Tensor,
                        valid: torch.Tensor,
                        settings: MapSettings) -> VoxelPointStore:
    """Scatter a frame's depth cloud into its voxels' point slots.

    Args:
      map_state: must already hold the frame's voxels (call after
        ``insert_points``).
      points: (N, 3) world; colors: (N, 3); valid: (N,) bool.

    Points outside the map's voxels are dropped; within one call a point's
    rank in its voxel is its order among that voxel's points (stable sort
    by slot), and ranks at or past the voxel's free capacity are dropped.
    """
    V, K = store.xyz.shape[:2]
    N = points.shape[0]
    dev = points.device
    coords = torch.floor(points / settings.voxel_size).to(torch.int32)
    keys = vh.pack_coords(coords, settings.coord_bits)
    slots = vh.lookup_voxel_slots(map_state, keys)              # (N,) or -1
    ok = valid & (slots >= 0)
    slots = torch.where(ok, slots, V).long()                    # V = drop row

    # arrival rank of each point within its voxel
    order = torch.argsort(slots, stable=True)
    ss = slots[order].contiguous()
    rank = torch.empty_like(slots)
    rank[order] = (torch.arange(N, device=dev)
                   - torch.searchsorted(ss, ss, side="left"))

    dst = store.counts[slots.clamp(0, V - 1)] + rank
    keep = ok & (dst < K)
    flat = (slots * K + dst)[keep]
    xyz = store.xyz.reshape(V * K, 3).clone()
    rgb = store.rgb.reshape(V * K, 3).clone()
    xyz[flat] = points[keep]
    rgb[flat] = colors[keep]
    added = torch.zeros((V + 1,), dtype=torch.int32, device=dev)
    added.scatter_add_(0, torch.where(keep, slots, V),
                       torch.ones_like(slots, dtype=torch.int32))
    return VoxelPointStore(xyz=xyz.reshape(V, K, 3),
                           rgb=rgb.reshape(V, K, 3),
                           counts=store.counts + added[:V])


def gather_pcd_features(sampled_xyz: torch.Tensor, sample_bins: torch.Tensor,
                        hit_voxel_idx: torch.Tensor, store: VoxelPointStore,
                        pointnet_params, voxel_size: float,
                        sharpness: float = 10.0) -> torch.Tensor:
    """Per-sample features from the sample's voxel's stored points.

    Args:
      sampled_xyz: (R, S, 3) world positions (differentiable).
      sample_bins: (R, S) int hit-slot index of each sample.
      hit_voxel_idx: (R, H) voxel slots from the intersection (-1 invalid).
    Returns:
      (R, S, D) features (zero where the voxel stores no points).
    """
    R, S, _ = sampled_xyz.shape
    H = hit_voxel_idx.shape[1]
    K = store.xyz.shape[1]
    dev = sampled_xyz.device

    vidx = hit_voxel_idx.clamp_min(0).long()                    # (R, H)
    pts = store.xyz[vidx]                                       # (R, H, K, 3)
    feats = pointnet_apply(pointnet_params, pts, store.rgb[vidx])
    D = feats.shape[-1]

    onehot = (sample_bins[:, :, None]
              == torch.arange(H, device=dev)).float()           # (R, S, H)
    pts_s = torch.bmm(onehot, pts.reshape(R, H, K * 3)).reshape(R, S, K, 3)
    feats_s = torch.bmm(onehot, feats.reshape(R, H, K * D)
                        ).reshape(R, S, K, D)
    cnt_s = torch.bmm(onehot, store.counts[vidx].float()[..., None])

    # softmax inverse-distance blend with the half-voxel sample bias; the
    # finite mask value keeps softmax and its gradient finite for
    # point-less voxels
    q = sampled_xyz + 0.5 * voxel_size
    d = torch.linalg.vector_norm(q[:, :, None, :] - pts_s, dim=-1)  # (R,S,K)
    live = torch.arange(K, device=dev).float() < cnt_s
    w = torch.softmax(torch.where(live, -sharpness * d, -1e30), dim=-1)
    w = torch.where(live, w, 0.0)
    return torch.einsum("rsk,rskd->rsd", w, feats_s)
