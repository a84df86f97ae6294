"""Ray sampling: stratified samples inside intersected voxel segments,
and the pixel samplers.

Port of ``sample_rays_in_segments``, ``gumbel_sample_pixels`` and
``sample_frame_pixels`` (all-ones mask) in ``proudslam_tpu/ops/sampling.py``.
Samples are the sorted
merge of jittered arc-length events ``(k + u_k) * step`` and the segment
end events, mapped back to depth; each event's depth is the midpoint to
the previous event (reset to the segment start in a new segment). The
jitter ``noise`` is an argument, so tests feed both packages the same
draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from proudslam_tpu_torch.config import RenderSettings
from proudslam_tpu_torch.ops.intersect import Intersections


class RaySamples(NamedTuple):
    """(R, S) per-sample arrays; invalid samples: voxel_idx == -1."""

    depth: torch.Tensor      # midpoint depth (sentinel where invalid)
    dist: torch.Tensor       # distance to previous sample (0 where invalid)
    voxel_idx: torch.Tensor  # voxel slot (-1 where invalid)
    bin: torch.Tensor        # hit-slot index in [0, H) (0 if invalid)


def _pick(onehot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per (r, s) value of the hit slot selected by ``onehot`` (R, S, H)."""
    return torch.where(onehot, values[:, None, :],
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device)).sum(-1)


def sample_rays_in_segments(inter: Intersections, settings: RenderSettings,
                            noise: torch.Tensor) -> RaySamples:
    """Stratified sampling along intersected segments.

    Args:
      inter: sorted per-ray intersections, (R, H).
      noise: (R, S - H) uniforms in (0, 1), clamped to [0.001, 0.999].
    Returns:
      RaySamples with S = settings.max_samples entries per ray, sorted by
      depth, invalid entries trailing.
    """
    H = settings.max_hits
    S = settings.max_samples
    SJ = S - H
    assert noise.shape[-1] == SJ, (noise.shape, SJ)
    dev = noise.device
    sentinel = settings.max_depth_sentinel
    INF = float("inf")

    valid_bin = inter.voxel_idx >= 0
    seg_len = torch.where(valid_bin,
                          torch.clamp_min(inter.t_far - inter.t_near, 0.0),
                          0.0)
    cum = torch.cumsum(seg_len, dim=-1)
    cum_lo = cum - seg_len
    total = cum[:, -1:]

    k = torch.arange(SJ, dtype=torch.float32, device=dev)[None, :]
    step_r = (torch.clamp_min(total / SJ, settings.step_size)
              if settings.adaptive_step else settings.step_size)
    jit_arc = (k + torch.clamp(noise, 0.001, 0.999)) * step_r
    jit_arc = torch.where(jit_arc < total, jit_arc, INF)

    bound_valid = valid_bin & (seg_len > 0)
    bnd_arc = torch.where(bound_valid, cum, INF)

    h_iota = torch.arange(H, dtype=torch.int32, device=dev)
    jbin = (cum[:, None, :] < jit_arc[:, :, None]).sum(-1).to(torch.int32)
    jbin = jbin.clamp(0, H - 1)
    jhot = jbin[:, :, None] == h_iota                            # (R, SJ, H)
    j_tnear = _pick(jhot, inter.t_near)
    j_lo = _pick(jhot, cum_lo)
    j_idx = _pick(jhot, inter.voxel_idx).to(torch.int32)
    j_valid = (jit_arc < INF) & (j_idx >= 0)
    j_arc_safe = torch.where(jit_arc < INF, jit_arc, 0.0)
    j_z = j_tnear + (j_arc_safe - j_lo)

    j_zprev = torch.cat([j_z[:, :1], j_z[:, :-1]], dim=1)
    j_prevbin = torch.cat([jbin[:, :1] - 1, jbin[:, :-1]], dim=1)
    j_zlow = torch.where(j_prevbin == jbin, j_zprev, j_tnear)

    b_z = torch.where(bound_valid, inter.t_far, 0.0)
    in_bin = jhot & j_valid[:, :, None]
    b_zmax = torch.where(in_bin, j_z[:, :, None], -INF).amax(dim=1)
    b_zlow = torch.where(b_zmax > -INF, b_zmax, inter.t_near)
    b_valid = bound_valid & (inter.voxel_idx >= 0)

    j_depth = torch.where(j_valid, 0.5 * (j_z + j_zlow), sentinel)
    j_dist = torch.where(j_valid, torch.clamp_min(j_z - j_zlow, 0.0), 0.0)
    j_vidx = torch.where(j_valid, j_idx, -1)
    j_bin = torch.where(j_valid, jbin, 0)
    b_depth = torch.where(b_valid, 0.5 * (b_z + b_zlow), sentinel)
    b_dist = torch.where(b_valid, torch.clamp_min(b_z - b_zlow, 0.0), 0.0)
    b_vidx = torch.where(b_valid, inter.voxel_idx, -1)
    b_bin = torch.where(b_valid, h_iota[None, :], 0)

    # rank-merge: jitter before boundary on ties, inf events last in order
    j_pos = (torch.arange(SJ, device=dev)[None, :]
             + (bnd_arc[:, None, :] < jit_arc[:, :, None]).sum(-1))
    b_lt = (bnd_arc[:, None, :] < bnd_arc[:, :, None]) | (
        (bnd_arc[:, None, :] == bnd_arc[:, :, None])
        & (h_iota[None, None, :] < h_iota[None, :, None]))
    b_pos = (b_lt.sum(-1)
             + (jit_arc[:, :, None] <= bnd_arc[:, None, :]).sum(1))

    # each position receives exactly one event: scatter by position
    R = noise.shape[0]
    pos = torch.cat([j_pos, b_pos], dim=1)                       # (R, S)
    pay = torch.stack([
        torch.cat([j_depth, b_depth], 1), torch.cat([j_dist, b_dist], 1),
        torch.cat([j_vidx, b_vidx], 1).float(),
        torch.cat([j_bin, b_bin], 1).float()], dim=-1)           # (R, S, 4)
    out = torch.zeros((R, S, 4), dtype=torch.float32, device=dev)
    out.scatter_(1, pos[..., None].expand(R, S, 4), pay)

    depth, dist = out[..., 0], out[..., 1]
    vidx = out[..., 2].to(torch.int32)
    bins = out[..., 3].to(torch.int32)
    valid = vidx >= 0
    return RaySamples(
        depth=torch.where(valid, depth, sentinel),
        dist=torch.where(valid, dist, 0.0),
        voxel_idx=torch.where(valid, vidx, -1),
        bin=torch.where(valid, bins, 0))


def gumbel_sample_pixels(u: torch.Tensor, logp: torch.Tensor,
                         num: int) -> torch.Tensor:
    """Top-k Gumbel sampling without replacement: the ``num`` largest
    ``logp + g`` with ``g = -log(-log(u + 1e-7) + 1e-7)``.

    Args:
      u: (N,) uniforms in [0, 1) (injected, so tests feed JAX's draws).
      logp: (N,) log-probabilities.
    Returns:
      (num,) int64 flat indices, in descending order of the perturbed keys.

    The selection is an exact top-k, taken as a stable descending sort so
    that equal keys (f32 rounding makes some) come lower index first, the
    rule of XLA's TopK: ``torch.topk`` orders ties arbitrarily. The JAX
    package takes ``jax.lax.approx_max_k``, which is exact on the CPU
    (where the tests compare the two) and approximate on a TPU, which its
    docstring accepts since the perturbed top-k is itself a random draw.
    """
    gumbel = -torch.log(-torch.log(u + 1e-7) + 1e-7)
    return torch.sort(logp + gumbel, descending=True,
                      stable=True).indices[:num]


def sample_frame_pixels(generator: torch.Generator, num: int,
                        num_pixels: int, method: str = "uniform"
                        ) -> torch.Tensor:
    """``num`` flat pixel indices over the all-ones mask of ``num_pixels``
    pixels. ``"uniform"``: independent uniform draws (duplicates allowed);
    ``"gumbel"``: without replacement, through :func:`gumbel_sample_pixels`
    on ``num_pixels`` fresh uniforms and the JAX package's log-probabilities
    of the all-ones mask, ``log(1 / (num_pixels + 1e-7) + 1e-7)`` in f32."""
    dev = generator.device
    if method == "uniform":
        return torch.randint(0, num_pixels, (num,), generator=generator,
                             device=dev)
    if method != "gumbel":
        raise ValueError(f"unknown pixel sampler {method!r}")
    flat = torch.ones((num_pixels,), dtype=torch.float32, device=dev)
    logp = torch.log(flat / (flat.sum() + 1e-7) + 1e-7)
    u = torch.rand((num_pixels,), generator=generator, device=dev)
    return gumbel_sample_pixels(u, logp, num)


def frame_pixels(generator: torch.Generator, count: int, n: int,
                 num_pixels: int, method: str) -> torch.Tensor:
    """(count, n) pixel indices, each row one draw of ``n`` from a frame of
    ``num_pixels`` (without replacement within a row for ``"gumbel"``)."""
    if method == "uniform":
        return sample_frame_pixels(generator, count * n,
                                   num_pixels).reshape(count, n)
    return torch.stack([sample_frame_pixels(generator, n, num_pixels, method)
                        for _ in range(count)])
