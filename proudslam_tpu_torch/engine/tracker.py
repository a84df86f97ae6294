"""Frame-to-model tracking: SE(3) pose optimization against the map.

Port of ``proudslam_tpu/engine/tracker.py``: ``num_iterations`` Adam steps
on the 6-dof pose tangent with an exponential lr anneal, the
depth-variance outlier rule and fresh-voxel ray weighting. The map,
decoder and PointNet are frozen; only the pose gets gradients (kernel K3
skips its weight-gradient pass). The vox branch hoists the corner view out
of the iterations; the pcd branch renders from the point store.

With ``fixed_sample_batch=True`` one pixel batch per frame is intersected
and sampled once at the predicted pose, and the unfused vox branch also
hoists the per-sample corner features and voxel centers
(``ops/interp.precompute_f8``), leaving only the pose-dependent trilinear
weights inside. With ``fixed_sample_batch=False`` (the reference's
semantics) every iteration takes its own pixel batch and stratification
noise and intersects and samples it at the current pose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.engine.adam import adam_update, init_adam
from proudslam_tpu_torch.geometry import se3
from proudslam_tpu_torch.ops.interp import corner_view, precompute_f8
from proudslam_tpu_torch.ops.kernels.mlp_kernel import fused_applicable
from proudslam_tpu_torch.ops.sampling import frame_pixels
from proudslam_tpu_torch.render.losses import compute_loss
from proudslam_tpu_torch.render.renderer import (intersect_and_sample,
                                                 render_rays)


class TrackResult(NamedTuple):
    pose: torch.Tensor       # (6,) refined tangent
    adam_m: torch.Tensor     # (6,) final Adam moments (BA warm start)
    adam_v: torch.Tensor     # (6,)
    adam_t: int
    loss: torch.Tensor       # () final-iteration loss
    hit_ratio: torch.Tensor  # () fraction of rays that hit the map


def track_draws(generator: torch.Generator, settings: SystemSettings,
                num_pixels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame's random draws: (n_rays,) pixel indices and
    (n_rays, S - H) stratification uniforms; with
    ``fixed_sample_batch=False`` one pair per iteration, (iters, n_rays)
    and (iters, n_rays, S - H)."""
    rnd = settings.render
    trk = settings.tracker
    n = trk.n_rays
    count = 1 if trk.fixed_sample_batch else trk.num_iterations
    pix = frame_pixels(generator, count, n, num_pixels, rnd.pixel_sampler)
    noise = torch.rand((count, n, rnd.max_samples - rnd.max_hits),
                       generator=generator, device=generator.device)
    if trk.fixed_sample_batch:
        return pix[0], noise[0]
    return pix, noise


def track_frame(map_state, decoder_params, prev_pose: torch.Tensor,
                rays_dir: torch.Tensor, rgb: torch.Tensor,
                depth: torch.Tensor, settings: SystemSettings,
                draws: Tuple[torch.Tensor, torch.Tensor],
                fresh_thresh: Optional[int] = None,
                point_store=None) -> TrackResult:
    """Track one RGB-D frame starting from ``prev_pose``.

    Args:
      map_state: the map (a view sliced to the live voxels is fine).
      rays_dir: (H, W, 3) camera-frame pixel ray directions.
      rgb: (H, W, 3); depth: (H, W).
      draws: ``(pix, noise)`` from :func:`track_draws` (or injected).
      fresh_thresh: voxel-slot freshness threshold (fresh_window_frames).
      point_store: the pcd branch's ``VoxelPointStore``.
    """
    trk = settings.tracker
    rnd = settings.render
    if rnd.fresh_window_frames <= 0:
        fresh_thresh = None
    pix, noise = draws
    pix = pix.long()
    pcd = rnd.feature_mode == "pcd"
    dirs_flat = rays_dir.reshape(-1, 3)
    rgb_flat = rgb.reshape(-1, 3)
    depth_flat = depth.reshape(-1)

    def batch(p):
        return dirs_flat[p], rgb_flat[p], depth_flat[p]

    fixed = f8c = None
    with torch.no_grad():
        corner_feats = None if pcd else corner_view(
            map_state.embeddings, map_state.voxel_vertex_ids)
        if trk.fixed_sample_batch:
            f_batch = batch(pix)
            R0 = se3.exp_rotation(prev_pose[3:6])
            w_d = f_batch[0] @ R0.T
            fixed = intersect_and_sample(prev_pose[0:3].expand_as(w_d), w_d,
                                         map_state, rnd, noise)
            if not pcd and not fused_applicable(settings.decoder):
                inter0, samples0 = fixed
                bins0 = torch.where(samples0.voxel_idx >= 0, samples0.bin,
                                    inter0.voxel_idx.shape[1])
                f8c = precompute_f8(corner_feats,
                                    inter0.voxel_idx.clamp_min(0), bins0,
                                    map_state.voxel_keys, rnd.voxel_size)

    def loss_fn(pose6, dirs, gt_c, gt_d, noise_i):
        R = se3.exp_rotation(pose6[3:6])
        world_d = dirs @ R.T
        outputs = render_rays(
            pose6[0:3].expand_as(world_d), world_d, map_state,
            map_state.embeddings, decoder_params, settings.decoder, rnd,
            noise=noise_i, point_store=point_store,
            corner_feats=corner_feats, fresh_thresh=fresh_thresh,
            precomputed=fixed, f8_center=f8c)
        ray_w = None
        if rnd.fresh_voxel_margin > 0 or rnd.fresh_window_frames > 0:
            ray_w = 1.0 - (1.0 - trk.fresh_ray_floor) * outputs.fresh_frac
        loss, _ = compute_loss(outputs, gt_c, gt_d, settings.loss,
                               weight_depth_loss=trk.depth_variance,
                               ray_weights=ray_w)
        return loss, outputs.hit_mask.float().mean()

    N = trk.num_iterations
    expo = np.arange(N) / max(N - 1, 1)
    lrs = (trk.learning_rate * np.power(trk.final_lr_frac, expo)).astype(
        np.float32)
    pose6 = prev_pose.detach().clone()
    opt = init_adam([pose6])
    loss = hit_ratio = None
    for i in range(N):
        pose6.requires_grad_(True)
        if trk.fixed_sample_batch:
            loss, hit_ratio = loss_fn(pose6, *f_batch, noise)
        else:
            loss, hit_ratio = loss_fn(pose6, *batch(pix[i]), noise[i])
        (grad,) = torch.autograd.grad(loss, pose6)
        with torch.no_grad():
            (pose6,), opt = adam_update([pose6.detach()], [grad], opt,
                                        float(lrs[i]))
    return TrackResult(pose=pose6, adam_m=opt.m[0], adam_v=opt.v[0],
                       adam_t=opt.t,
                       loss=loss.detach(), hit_ratio=hit_ratio.detach())
