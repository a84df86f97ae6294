"""Incremental mapping: joint Adam over vertex embeddings, the decoder and
the keyframe-window poses (bundle adjustment).

Port of ``proudslam_tpu/engine/mapper.py`` in its fixed-batch form
(``fixed_sample_batch=True``): one pixel batch per window frame per round,
intersected and sampled once at the round's starting poses, then
``num_iterations`` joint Adam steps. Invalid window slots have their ray
origins moved ``FAR_AWAY`` so they hit nothing; their pose rows, and
rows whose gauge flag is 0 (the anchor), are masked from updates.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.engine.adam import (AdamState, adam_update,
                                             adam_update_rows, init_adam)
from proudslam_tpu_torch.engine.state import KeyframeStore
from proudslam_tpu_torch.geometry import se3
from proudslam_tpu_torch.models.decoder import tree_leaves, tree_unflatten
from proudslam_tpu_torch.ops.sampling import sample_frame_pixels
from proudslam_tpu_torch.render.losses import compute_loss
from proudslam_tpu_torch.render.renderer import (intersect_and_sample,
                                                 render_rays)

FAR_AWAY = 1.0e6  # ray origin displacement that guarantees zero hits


class MapOptState(NamedTuple):
    embed: AdamState
    decoder: AdamState


def init_map_opt(embeddings: torch.Tensor, decoder_params) -> MapOptState:
    return MapOptState(embed=init_adam([embeddings]),
                       decoder=init_adam(tree_leaves(decoder_params)))


class MapStepResult(NamedTuple):
    embeddings: torch.Tensor
    decoder_params: dict
    opt: MapOptState
    loss: torch.Tensor


def map_draws(generator: torch.Generator, settings: SystemSettings,
              wsel: int, num_pixels: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's random draws: (Wsel, n_rays) pixel indices and
    (Wsel, n_rays, S - H) stratification uniforms."""
    rnd = settings.render
    n = settings.mapper.n_rays_each
    pix = sample_frame_pixels(generator, wsel * n, num_pixels).reshape(wsel, n)
    noise = torch.rand((wsel, n, rnd.max_samples - rnd.max_hits),
                       generator=generator, device=generator.device)
    return pix, noise


def map_step(map_state, decoder_params, store: KeyframeStore,
             opt: MapOptState, rays_dir: torch.Tensor, sel_idx: List[int],
             sel_valid: List[bool], settings: SystemSettings,
             draws: Tuple[torch.Tensor, torch.Tensor]) -> MapStepResult:
    """One mapping round (one reference ``do_mapping`` call).

    Args:
      map_state: the map (a view sliced to the live voxels is fine); its
        ``embeddings`` are the full table being optimized.
      sel_idx: distinct keyframe-store slots (window + provisional slot).
      sel_valid: live entries of ``sel_idx``.
      draws: ``(pix, noise)`` from :func:`map_draws` (or injected).

    The window's refined poses and pose-Adam moments are written back into
    ``store`` in place; the new embeddings, decoder and optimizer state are
    returned.
    """
    mpr = settings.mapper
    rnd = settings.render
    if not mpr.fixed_sample_batch:
        raise NotImplementedError(
            "per-iteration resampling (fixed_sample_batch=False) is not "
            "ported yet (ROADMAP Queue 1, non-default engine modes)")
    dev = store.poses.device
    Wsel = len(sel_idx)
    SJ = rnd.max_samples - rnd.max_hits
    H, W = store.depth.shape[1:3]
    sel = torch.as_tensor(sel_idx, dtype=torch.long, device=dev)
    valid = torch.as_tensor(sel_valid, dtype=torch.bool, device=dev)
    pix, noise = draws
    pix = pix.long()

    with torch.no_grad():
        dirs = rays_dir.reshape(H * W, 3)[pix]                   # (Wsel, N, 3)
        gt_c = torch.gather(store.rgb[sel].reshape(Wsel, H * W, 3), 1,
                            pix[..., None].expand(-1, -1, 3))
        gt_d = torch.gather(store.depth[sel].reshape(Wsel, H * W), 1, pix)
        pose_mask = valid & (store.stamps[sel] != 0)
        origin_shift = torch.where(valid[:, None], 0.0, FAR_AWAY)
        poses0 = store.poses[sel]
        R0 = se3.exp_rotation(poses0[:, 3:6])
        w_d = torch.einsum("fnd,fed->fne", dirs, R0)
        w_o = (poses0[:, 0:3] + origin_shift)[:, None, :].expand_as(w_d)
        fixed = intersect_and_sample(w_o.reshape(-1, 3), w_d.reshape(-1, 3),
                                     map_state, rnd, noise.reshape(-1, SJ))
    gt_c = gt_c.reshape(-1, 3)
    gt_d = gt_d.reshape(-1)

    def loss_fn(embeddings, dec_params, poses):
        R = se3.exp_rotation(poses[:, 3:6])
        world_d = torch.einsum("fnd,fed->fne", dirs, R)
        world_o = (poses[:, 0:3] + origin_shift)[:, None, :].expand_as(
            world_d)
        outputs = render_rays(world_o.reshape(-1, 3), world_d.reshape(-1, 3),
                              map_state, embeddings, dec_params,
                              settings.decoder, rnd, precomputed=fixed)
        loss, _ = compute_loss(outputs, gt_c, gt_d, settings.loss,
                               weight_depth_loss=False)
        return loss

    embeddings = map_state.embeddings.detach()
    dec_leaves = [t.detach() for t in tree_leaves(decoder_params)]
    poses = poses0.clone()
    pm, pv, pt = store.adam_m[sel], store.adam_v[sel], store.adam_t[sel]
    embed_opt, dec_opt = opt.embed, opt.decoder
    loss = None
    for _ in range(mpr.num_iterations):
        embeddings.requires_grad_(True)
        poses.requires_grad_(True)
        for t in dec_leaves:
            t.requires_grad_(True)
        loss = loss_fn(embeddings, tree_unflatten(decoder_params, dec_leaves),
                       poses)
        grads = torch.autograd.grad(loss, [embeddings, poses] + dec_leaves)
        with torch.no_grad():
            (embeddings,), embed_opt = adam_update(
                [embeddings.detach()], [grads[0]], embed_opt, mpr.embed_lr)
            dec_leaves, dec_opt = adam_update(
                [t.detach() for t in dec_leaves], list(grads[2:]), dec_opt,
                mpr.decoder_lr)
            poses, pm, pv, pt = adam_update_rows(
                poses.detach(), grads[1], pm, pv, pt,
                settings.tracker.learning_rate, pose_mask)

    with torch.no_grad():
        rows = sel[valid]
        store.poses[rows] = poses[valid]
        store.adam_m[rows] = pm[valid]
        store.adam_v[rows] = pv[valid]
        store.adam_t[rows] = pt[valid]
    dec_out = tree_unflatten(decoder_params, [t.detach() for t in dec_leaves])
    return MapStepResult(embeddings=embeddings.detach(),
                         decoder_params=dec_out,
                         opt=MapOptState(embed=embed_opt, decoder=dec_opt),
                         loss=loss.detach())
