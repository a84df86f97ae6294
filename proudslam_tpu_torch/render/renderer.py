"""Differentiable SDF volume renderer (the fused render branch).

Port of ``proudslam_tpu/render/renderer.py`` on its fused branch
(``use_fused_mlp=True``, ``feature_mode="vox"``): intersect -> stratified
samples -> kernel K1 (sample features + decoder) -> sdf-to-weights ->
integrate. Every ray keeps its lane; misses are masked by ``hit_mask``.
Sample depths and indices carry no gradient; pose gradients flow through
``o + d*z`` inside the fused op, map gradients through the corner view.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from proudslam_tpu_torch.config import DecoderSettings, RenderSettings
from proudslam_tpu_torch.ops.interp import corner_view
from proudslam_tpu_torch.ops.intersect import ray_intersect
from proudslam_tpu_torch.ops.kernels.render_kernel import (
    fused_feats_decode, fused_render_applicable)
from proudslam_tpu_torch.ops.sampling import sample_rays_in_segments
from proudslam_tpu_torch.ops.voxel_hash import unpack_key


class RenderOutputs(NamedTuple):
    color: torch.Tensor        # (R, 3)
    depth: torch.Tensor        # (R,)
    sdf: torch.Tensor          # (R, S) — 1.0 at invalid samples
    z_vals: torch.Tensor       # (R, S) — sentinel at invalid samples
    weights: torch.Tensor      # (R, S)
    sample_mask: torch.Tensor  # (R, S) bool
    hit_mask: torch.Tensor     # (R,) bool
    z_min: torch.Tensor        # (R,) first zero-crossing depth
    fresh_frac: torch.Tensor   # (R,) fraction of hit slots in fresh voxels


def sdf_to_weights(sdf, z_vals, valid, truncation: float):
    """Bell-shaped SDF weights with first-surface truncation masking,
    normalized per ray -> (weights, z_min)."""
    w = torch.sigmoid(sdf / truncation) * torch.sigmoid(-sdf / truncation)
    crossing = (sdf[:, 1:] * sdf[:, :-1] < 0.0).float()
    inds = torch.argmax(crossing, dim=1)        # first crossing (0 if none)
    z_min = torch.gather(z_vals, 1, inds[:, None])
    trunc_mask = (z_vals < z_min + truncation).float()
    w = w * trunc_mask * valid.float()
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-8)
    return w, z_min[:, 0]


def _fresh_fraction(hit_voxel_idx, num_voxels: int,
                    settings: RenderSettings, fresh_thresh: Optional[int]):
    """Per-ray fraction of hit slots in freshly allocated voxels."""
    hit_valid = hit_voxel_idx >= 0
    if fresh_thresh is not None:
        thresh = fresh_thresh
    elif settings.fresh_voxel_margin > 0:
        thresh = num_voxels - settings.fresh_voxel_margin
    else:
        return torch.zeros(hit_voxel_idx.shape[:1], dtype=torch.float32,
                           device=hit_voxel_idx.device)
    fresh = hit_valid & (hit_voxel_idx >= thresh)
    return (fresh.sum(dim=-1).float()
            / hit_valid.sum(dim=-1).clamp_min(1).float())


def intersect_and_sample(rays_o, rays_d, map_state, settings: RenderSettings,
                         noise):
    """Intersect + stratified-sample a ray batch (brute mode)."""
    if settings.intersect_mode != "brute":
        raise NotImplementedError(
            "intersect_mode='dda' is not ported yet (ROADMAP Queue 1, "
            "non-default engine modes)")
    V = map_state.voxel_keys.shape[0]
    centers = ((unpack_key(map_state.voxel_keys).float() + 0.5)
               * settings.voxel_size)
    voxel_valid = (torch.arange(V, device=rays_o.device)
                   < map_state.num_voxels)
    inter = ray_intersect(rays_o, rays_d, centers, voxel_valid, settings)
    return inter, sample_rays_in_segments(inter, settings, noise)


def render_rays(rays_o, rays_d, map_state, embeddings, decoder_params,
                decoder_settings: DecoderSettings, settings: RenderSettings,
                noise=None, corner_feats=None, fresh_thresh=None,
                precomputed=None) -> RenderOutputs:
    """Render a batch of rays against the current map (fused branch).

    Args:
      rays_o, rays_d: (R, 3) world rays (directions unnormalized).
      map_state: ops.voxel_hash.MapState (may be a view sliced to the live
        voxels).
      embeddings: (E, D) vertex embeddings (differentiable).
      noise: (R, S - H) stratification uniforms (unused with precomputed).
      corner_feats: optional precomputed (V, 8D) corner view.
      fresh_thresh: optional voxel-slot threshold for ``fresh_frac``.
      precomputed: optional ``(Intersections, RaySamples)`` reused across
        optimizer iterations.
    """
    if settings.feature_mode == "pcd":
        raise NotImplementedError(
            "feature_mode='pcd' is not ported yet (ROADMAP Queue 1, the pcd "
            "feature branch)")
    if not fused_render_applicable(decoder_settings):
        raise NotImplementedError(
            "only the fused render branch (use_fused_mlp=True, default "
            "architecture) is ported; the unfused branch is in ROADMAP "
            "Queue 2 (K2 and gather_ray_features)")
    if precomputed is not None:
        inter, samples = precomputed
    else:
        inter, samples = intersect_and_sample(rays_o, rays_d, map_state,
                                              settings, noise)
    z_vals = samples.depth.detach()
    valid = samples.voxel_idx >= 0
    R, S = z_vals.shape
    H = inter.voxel_idx.shape[1]

    vidx = inter.voxel_idx.clamp_min(0)
    EV = corner_feats
    if EV is None:
        EV = corner_view(embeddings, map_state.voxel_vertex_ids)
    keys_rb = map_state.voxel_keys[vidx.long()]
    S_bins = torch.where(valid, samples.bin, H).to(torch.int32)
    out = fused_feats_decode(EV, keys_rb, vidx, S_bins, z_vals, rays_o,
                             rays_d, decoder_params, settings,
                             decoder_settings)
    color = out[:, :3].reshape(R, S, 3)
    sdf = out[:, 3].reshape(R, S)
    sdf = torch.where(valid, sdf, 1.0)
    color = torch.where(valid[..., None], color, 0.0)
    weights, z_min = sdf_to_weights(sdf, z_vals, valid, settings.truncation)
    rgb = torch.sum(weights[..., None] * color, dim=-2)
    depth = torch.sum(weights * torch.where(valid, z_vals, 0.0), dim=-1)
    fresh_frac = _fresh_fraction(inter.voxel_idx, map_state.num_voxels,
                                 settings, fresh_thresh)
    return RenderOutputs(color=rgb, depth=depth, sdf=sdf, z_vals=z_vals,
                         weights=weights, sample_mask=valid,
                         hit_mask=inter.hit_mask, z_min=z_min,
                         fresh_frac=fresh_frac)
