"""Trilinear gather of vertex embeddings at sample points.

Port of ``proudslam_tpu/ops/interp.py``. Corner j's offset bits are
``(j>>2, (j>>1)&1, j&1)`` (z fastest). Two paths:

* :func:`gather_voxel_features`, per point (the mesher's);
* :func:`gather_ray_features`, ray-structured (the unfused render
  branch): the corner embeddings reach each sample through three row
  gathers, corner view ``EV[v] = embeddings[vertex_ids[v]]`` (V, 8D), hit
  slot ``rb[r, h] = EV[hit_voxel[r, h]]`` (R, H, 8D) and sample
  ``f8[r, s] = rb[r, bin[r, s]]`` (R, S, 8D).

The JAX package selects samples from hit slots by exact one-hot einsums;
a gather gives the same values. Its custom backward of the sample fetch
folds the cotangent onto hit slots by the one-hot transpose and onto the
corner view by one scatter-add; here the second fold is
:func:`segment_sum_rows`, a deterministic stable-sort segment sum, the same
fold as the fused branch's backward (``ops/kernels/render_kernel.py``).
The JAX package folds the corner view's cotangent onto embedding rows
through an inverse-map gather, a TPU scatter workaround; here autograd's
index backward does it.
"""

from __future__ import annotations

import numpy as np
import torch

from proudslam_tpu_torch.ops.voxel_hash import unpack_key

CORNER_BITS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.float32)


def corner_view(embeddings: torch.Tensor,
                vertex_ids: torch.Tensor) -> torch.Tensor:
    """(E, D), (V, 8) -> (V, 8D) per-voxel corner embeddings."""
    V = vertex_ids.shape[0]
    return embeddings[vertex_ids.reshape(-1).long()].reshape(V, -1)


def segment_sum_rows(rows: torch.Tensor, index: torch.Tensor,
                     n: int) -> torch.Tensor:
    """out[i] = sum of rows[index == i] for i < n, in a fixed order on every
    device: rows are grouped by a stable sort and each group is summed in
    sequence. (A scatter-add of these heavily repeated indices is either
    nondeterministic, with atomics, or serialized per index.) The counts
    are an integer scatter-add, exact in any order; ``torch.bincount``
    would read the largest index back to the host."""
    index = index.long()
    order = torch.argsort(index, stable=True)
    counts = torch.zeros(n, dtype=torch.long, device=index.device)
    counts.scatter_add_(0, index, torch.ones_like(index))
    return torch.segment_reduce(rows[order], "sum", lengths=counts,
                                unsafe=True)


def corner_bits(device) -> torch.Tensor:
    """(8, 3) float :data:`CORNER_BITS`, made on the device (a
    host-to-device copy would synchronize the stream)."""
    j = torch.arange(8, device=device)
    return torch.stack([(j >> 2) & 1, (j >> 1) & 1, j & 1], dim=-1).float()


def trilinear_weights(p: torch.Tensor) -> torch.Tensor:
    """(N, 3) fractional coords in [0, 1] -> (N, 8) corner weights
    prod_axis (p*q + (1-p)(1-q)), q the corner's offset bits."""
    q = corner_bits(p.device)[None]                              # (1, 8, 3)
    pe = p[:, None, :]
    return torch.prod(pe * q + (1.0 - pe) * (1.0 - q), dim=-1)


def voxel_centers_of(keys: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World-space centers (..., 3) of packed voxel keys."""
    return (unpack_key(keys).float() + 0.5) * voxel_size


def gather_voxel_features(sampled_xyz: torch.Tensor,
                          sampled_voxel_idx: torch.Tensor,
                          voxel_keys: torch.Tensor,
                          voxel_vertex_ids: torch.Tensor,
                          embeddings: torch.Tensor,
                          voxel_size: float) -> torch.Tensor:
    """(N, 3) points in the voxels ``sampled_voxel_idx`` (N,) -> (N, D)
    trilinear blends of the voxels' corner embeddings (slots are clamped
    to >= 0; mask invalid points downstream). Voxel centers come from the
    packed keys, as ``voxel_hash.voxel_centers`` computes them."""
    idx = sampled_voxel_idx.clamp_min(0).long()
    centers = voxel_centers_of(voxel_keys[idx], voxel_size)      # (N, 3)
    corner = embeddings[voxel_vertex_ids[idx].long()]            # (N, 8, D)
    p = (sampled_xyz - centers) / voxel_size + 0.5
    w = trilinear_weights(p)                                     # (N, 8)
    return torch.sum(w[..., None] * corner, dim=-2)


def _select_samples(rb: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """(R, H, K), (R, S) -> (R, S, K): rb[r, bins[r, s]], zero where
    bins >= H (the one-hot einsum's values)."""
    R, H, K = rb.shape
    valid = bins < H
    h = torch.where(valid, bins, 0).long()
    out = torch.gather(rb, 1, h[..., None].expand(R, h.shape[1], K))
    return torch.where(valid[..., None], out, 0.0)


class GatherF8(torch.autograd.Function):
    """(V, 8D) corner view, (R, H) hit voxels, (R, S) bins -> (R, S, 8D)
    corner features per sample (``_gather_f8``). ``bins`` entries of
    invalid samples must be H: zero features forward, zero cotangent
    backward. Differentiable w.r.t. the corner view only."""

    @staticmethod
    def forward(ctx, EV, vidx, bins):
        ctx.save_for_backward(vidx, bins)
        ctx.num_rows = EV.shape[0]
        return _select_samples(EV[vidx.long()], bins)

    @staticmethod
    def backward(ctx, dout):
        vidx, bins = ctx.saved_tensors
        R, S, K = dout.shape
        H = vidx.shape[1]
        # samples -> hit slots: the one-hot transpose (R, H, S) @ (R, S, K)
        onehot = (bins[:, :, None]
                  == torch.arange(H, device=bins.device)).to(dout.dtype)
        d_rb = torch.bmm(onehot.transpose(1, 2), dout)
        # hit slots -> corner view rows (clamped invalid slots get only
        # zero cotangents)
        dEV = segment_sum_rows(d_rb.reshape(-1, K), vidx.reshape(-1),
                               ctx.num_rows)
        return dEV, None, None


def _sample_centers(vidx, bins, voxel_keys, voxel_size):
    """(R, S, 3) center of each sample's hit voxel (0 where bins >= H)."""
    centers_rb = voxel_centers_of(voxel_keys[vidx.long()], voxel_size)
    return _select_samples(centers_rb, bins)


def precompute_f8(EV: torch.Tensor, vidx: torch.Tensor,
                  sample_bins: torch.Tensor, voxel_keys: torch.Tensor,
                  voxel_size: float):
    """The per-sample corner features and voxel centers of a frozen
    (corner view, ray batch) pair, for ``gather_ray_features(f8_center=)``:
    loop-invariant across the tracker's iterations, where only the
    pose-dependent trilinear weights change -> (f8 (R, S, 8, D),
    center (R, S, 3)). ``vidx`` are hit voxels clamped to >= 0."""
    R, S = sample_bins.shape
    f8 = GatherF8.apply(EV, vidx, sample_bins).reshape(R, S, 8, -1)
    return f8, _sample_centers(vidx, sample_bins, voxel_keys, voxel_size)


def gather_ray_features(sampled_xyz: torch.Tensor,
                        sample_bins: torch.Tensor,
                        hit_voxel_idx: torch.Tensor,
                        voxel_keys: torch.Tensor,
                        voxel_vertex_ids: torch.Tensor,
                        embeddings: torch.Tensor,
                        voxel_size: float, EV: torch.Tensor = None,
                        f8_center=None) -> torch.Tensor:
    """Ray-structured :func:`gather_voxel_features` -> (R, S, D).

    Args:
      sampled_xyz: (R, S, 3) world positions (differentiable).
      sample_bins: (R, S) hit slot of each sample, non-decreasing per ray;
        H for invalid samples.
      hit_voxel_idx: (R, H) voxel slots from the intersection (-1 invalid).
      voxel_keys: (V,) packed keys; voxel_vertex_ids: (V, 8);
      embeddings: (E, D).
      EV: optional precomputed :func:`corner_view` (frozen embeddings).
      f8_center: optional :func:`precompute_f8` result (frozen embeddings
        and ray batch): only the trilinear weights are computed here.
    """
    R, S, _ = sampled_xyz.shape
    H = hit_voxel_idx.shape[1]
    vidx = hit_voxel_idx.clamp_min(0)
    if f8_center is not None:
        f8, center = f8_center
    else:
        if EV is None:
            EV = corner_view(embeddings, voxel_vertex_ids)
        f8 = GatherF8.apply(EV, vidx, sample_bins).reshape(R, S, 8, -1)
        center = _sample_centers(vidx, sample_bins, voxel_keys, voxel_size)
    p = (sampled_xyz - center) / voxel_size + 0.5
    w = trilinear_weights(p.reshape(R * S, 3)).reshape(R, S, 8)
    # invalid samples: zero weights, so their features are exactly 0
    w = torch.where((sample_bins < H)[:, :, None], w, 0.0)
    return torch.sum(w[..., None] * f8, dim=-2)


def gather_ray_features_onehot(sampled_xyz: torch.Tensor,
                               sample_bins: torch.Tensor,
                               hit_voxel_idx: torch.Tensor,
                               voxel_keys: torch.Tensor,
                               voxel_vertex_ids: torch.Tensor,
                               embeddings: torch.Tensor,
                               voxel_size: float) -> torch.Tensor:
    """Test oracle of :func:`gather_ray_features`: the JAX package's one-hot
    einsum form (``gather_ray_features_onehot``), differentiated by
    autograd. Samples select hit slots by one-hot products, and bins >= H
    select the last slot (their features are not zeroed): compare valid
    samples only. Nothing on the engine's path calls it."""
    R, S, _ = sampled_xyz.shape
    H = hit_voxel_idx.shape[1]
    D = embeddings.shape[1]
    vidx = hit_voxel_idx.clamp_min(0).long()                     # (R, H)
    cids = voxel_vertex_ids[vidx].long()                         # (R, H, 8)
    emb_rb = embeddings[cids].reshape(R, H, 8 * D)
    centers_rb = voxel_centers_of(voxel_keys[vidx], voxel_size)  # (R, H, 3)
    onehot = (sample_bins.clamp_max(H - 1)[:, :, None]
              == torch.arange(H, device=sample_bins.device)).float()
    f8 = torch.einsum("rsh,rhk->rsk", onehot, emb_rb).reshape(R, S, 8, D)
    center = torch.einsum("rsh,rhc->rsc", onehot, centers_rb)
    p = (sampled_xyz - center) / voxel_size + 0.5
    w = trilinear_weights(p.reshape(R * S, 3)).reshape(R, S, 8)
    return torch.sum(w[..., None] * f8, dim=-2)
