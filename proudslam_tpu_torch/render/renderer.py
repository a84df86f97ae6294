"""Differentiable SDF volume renderer.

Port of ``proudslam_tpu/render/renderer.py``: intersect (brute slab test,
or the grid march with ``intersect_mode="dda"``) -> stratified samples ->
sample features + decoder -> sdf-to-weights -> integrate.

* ``feature_mode="vox"`` with ``use_fused_mlp=True``: kernel K1 blends the
  corner embeddings and decodes in one pass; map gradients flow through
  the corner view.
* ``feature_mode="vox"`` with ``use_fused_mlp=False`` (the configs'
  default): ``ops/interp.gather_ray_features`` blends the corner
  embeddings and the plain ``models/decoder.decoder_values`` decodes, at
  the config's ``matmul_dtype``.
* ``feature_mode="pcd"``: PointNet features of each voxel's stored points
  (``render/pcd_features.py``), decoded by kernels K2/K3
  (``decoder_values_fused``) when ``use_fused_mlp=True``, else by the plain
  ``models/decoder.decoder_values``.

Every ray keeps its lane; misses are masked by ``hit_mask``. Sample depths
and indices carry no gradient; pose gradients flow through ``o + d*z``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from proudslam_tpu_torch.config import DecoderSettings, RenderSettings
from proudslam_tpu_torch.models.decoder import decoder_values
from proudslam_tpu_torch.ops.interp import corner_view, gather_ray_features
from proudslam_tpu_torch.ops.intersect import (ray_intersect,
                                               ray_intersect_dda)
from proudslam_tpu_torch.ops.kernels.mlp_kernel import (decoder_values_fused,
                                                        fused_applicable)
from proudslam_tpu_torch.ops.kernels.render_kernel import fused_feats_decode
from proudslam_tpu_torch.ops.sampling import sample_rays_in_segments
from proudslam_tpu_torch.ops.voxel_hash import unpack_key
from proudslam_tpu_torch.render.pcd_features import gather_pcd_features


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
                         noise, occupancy=None):
    """Intersect + stratified-sample a ray batch. ``occupancy``: the
    ``intersect_mode="dda"`` grid (``ops.intersect.build_occupancy``),
    built here when not given."""
    if settings.intersect_mode == "dda":
        inter = ray_intersect_dda(rays_o, rays_d, map_state.voxel_keys,
                                  map_state.num_voxels, settings,
                                  occupancy=occupancy)
        return inter, sample_rays_in_segments(inter, settings, noise)
    V = map_state.voxel_keys.shape[0]
    centers = ((unpack_key(map_state.voxel_keys).float() + 0.5)
               * settings.voxel_size)
    voxel_valid = (torch.arange(V, device=rays_o.device)
                   < map_state.num_voxels)
    inter = ray_intersect(rays_o, rays_d, centers, voxel_valid, settings)
    return inter, sample_rays_in_segments(inter, settings, noise)


def render_rays(rays_o, rays_d, map_state, embeddings, decoder_params,
                decoder_settings: DecoderSettings, settings: RenderSettings,
                noise=None, point_store=None, corner_feats=None, fresh_thresh=None,
                precomputed=None, f8_center=None,
                occupancy=None, decode=None) -> RenderOutputs:
    """Render a batch of rays against the current map.

    Args:
      rays_o, rays_d: (R, 3) world rays (directions unnormalized).
      map_state: ops.voxel_hash.MapState (may be a view sliced to the live
        voxels).
      embeddings: (E, D) vertex embeddings (differentiable; unused by the
        pcd branch).
      noise: (R, S - H) stratification uniforms (unused with precomputed).
      decoder_params: the decoder's params; the pcd branch also reads the
        PointNet params from ``decoder_params["pointnet"]``.
      point_store: the pcd branch's ``render.pcd_features.VoxelPointStore``.
      corner_feats: optional precomputed (V, 8D) corner view (vox branch).
      fresh_thresh: optional voxel-slot threshold for ``fresh_frac``.
      precomputed: optional ``(Intersections, RaySamples)`` reused across
        optimizer iterations.
      f8_center: optional ``ops.interp.precompute_f8`` result for
        ``precomputed`` (unfused vox branch, frozen embeddings).
      occupancy: optional ``ops.intersect.build_occupancy`` grid for
        ``intersect_mode="dda"`` (loop-invariant across an optimizer's
        iterations: callers that iterate build it once).
      decode: optional ``decode(params, decoder_settings, feats) -> (N, 4)``
        in place of ``models/decoder.decoder_values`` where the plain
        decoder runs (the tensor-parallel decoder of
        ``parallel/sharded.py``).
    """
    pcd = settings.feature_mode == "pcd"
    # K1 and K2/K3 take the same architectures (as in the JAX package)
    fused = fused_applicable(decoder_settings)
    decode = decode or decoder_values
    if precomputed is not None:
        inter, samples = precomputed
    else:
        inter, samples = intersect_and_sample(rays_o, rays_d, map_state,
                                              settings, noise, occupancy)
    z_vals = samples.depth.detach()
    valid = samples.voxel_idx >= 0
    R, S = z_vals.shape
    H = inter.voxel_idx.shape[1]
    if pcd or not fused:
        sampled_xyz = (rays_o[:, None, :]
                       + rays_d[:, None, :] * z_vals[..., None])

    if pcd:
        if point_store is None:
            raise ValueError("feature_mode='pcd' needs a VoxelPointStore")
        feats = gather_pcd_features(
            sampled_xyz, samples.bin, inter.voxel_idx, point_store,
            decoder_params["pointnet"], settings.voxel_size).reshape(R * S, -1)
        if fused:
            out = decoder_values_fused(decoder_params, decoder_settings,
                                       feats)
        else:
            out = decode(decoder_params, decoder_settings, feats)
    elif not fused:
        # invalid samples -> bin H: zero features, zero cotangents
        S_bins = torch.where(valid, samples.bin, H)
        feats = gather_ray_features(
            sampled_xyz, S_bins, inter.voxel_idx, map_state.voxel_keys,
            map_state.voxel_vertex_ids, embeddings, settings.voxel_size,
            EV=corner_feats, f8_center=f8_center).reshape(R * S, -1)
        out = decode(decoder_params, decoder_settings, feats)
    else:
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
    # invalid lanes: sdf -> 1 (free space), color -> 0
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
