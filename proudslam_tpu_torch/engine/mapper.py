"""Incremental mapping: joint Adam over vertex embeddings, the decoder and
the keyframe-window poses (bundle adjustment).

Port of ``proudslam_tpu/engine/mapper.py``: ``num_iterations`` joint Adam
steps per round. With ``fixed_sample_batch=True`` one pixel batch per
window frame per round is intersected and sampled once at the round's
starting poses; with ``fixed_sample_batch=False`` (the reference's
semantics) every iteration draws its own batch per window frame and
intersects and samples it at the current poses. Invalid window slots have
their ray origins moved ``FAR_AWAY`` so they hit nothing; their pose rows, and
rows whose gauge flag is 0 (the anchor), are masked from updates;
``update_pose=False`` / ``update_decoder=False`` freeze the window's poses
/ the decoder (final refinement and re-baking). In the
pcd branch the PointNet params ride in the decoder dict (and its Adam); the
embeddings are not rendered from and get zero gradients, as in the JAX
package.

With ``mesh`` (``parallel/engine.EngineMesh``) each rank renders its dp
block of every window frame's rays (axis 1 of the (Wsel, N) batch); the
ranks of an mp group render the same rays. The gradients (the full
embedding table's, the decoder's, the window poses') are all-reduced over
the dp group in one collective, and every rank takes the same decoder and
pose steps. Under mp a rank keeps only its rows of the embedding table and
of its Adam moments: it steps its rows, and the table is all-gathered
inside the mp group before the next iteration.
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
from proudslam_tpu_torch.ops.intersect import build_occupancy
from proudslam_tpu_torch.ops.sampling import frame_pixels
from proudslam_tpu_torch.parallel.engine import (all_reduce_flat,
                                                 gather_embeddings,
                                                 shard_embeddings,
                                                 shard_ray_batch)
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
    """The round's random draws: (Wsel, n_rays) pixel indices, one draw per
    window frame (as the JAX package's ``vmap`` over per-frame keys: a
    Gumbel draw is without replacement within a frame), and (Wsel, n_rays,
    S - H) stratification uniforms; with ``fixed_sample_batch=False`` one
    pair per iteration, (iters, Wsel, n_rays) and (iters, Wsel, n_rays,
    S - H)."""
    rnd = settings.render
    mpr = settings.mapper
    n = mpr.n_rays_each
    count = 1 if mpr.fixed_sample_batch else mpr.num_iterations
    pix = frame_pixels(generator, count * wsel, n, num_pixels,
                       rnd.pixel_sampler).reshape(count, wsel, n)
    noise = torch.rand((count, wsel, n, rnd.max_samples - rnd.max_hits),
                       generator=generator, device=generator.device)
    if mpr.fixed_sample_batch:
        return pix[0], noise[0]
    return pix, noise


def map_step(map_state, decoder_params, store: KeyframeStore,
             opt: MapOptState, rays_dir: torch.Tensor, sel_idx: List[int],
             sel_valid: List[bool], settings: SystemSettings,
             draws: Tuple[torch.Tensor, torch.Tensor],
             point_store=None, update_pose: bool = True,
             update_decoder: bool = True, mesh=None) -> MapStepResult:
    """One mapping round (one reference ``do_mapping`` call).

    Args:
      map_state: the map (a view sliced to the live voxels is fine); its
        ``embeddings`` are the full table being optimized.
      sel_idx: distinct keyframe-store slots (window + provisional slot).
      sel_valid: live entries of ``sel_idx``.
      draws: ``(pix, noise)`` from :func:`map_draws` (or injected).
      point_store: the pcd branch's ``VoxelPointStore``.
      update_pose/update_decoder: False freezes the window's poses (no pose
        gradient is taken) / the decoder (no decoder gradient is taken).
      mesh: optional ``EngineMesh``: ``draws`` are the whole batch's, of
        which this rank renders its dp block; ``map_state`` is the full
        map, and under mp ``opt.embed`` holds this rank's rows of the
        moments.

    The window's refined poses and pose-Adam moments are written back into
    ``store`` in place; the new embeddings (under mp, this rank's rows),
    decoder and optimizer state are returned.
    """
    mpr = settings.mapper
    rnd = settings.render
    dev = store.poses.device
    Wsel = len(sel_idx)
    SJ = rnd.max_samples - rnd.max_hits
    H, W = store.depth.shape[1:3]
    sel = torch.as_tensor(sel_idx, dtype=torch.long, device=dev)
    valid = torch.as_tensor(sel_valid, dtype=torch.bool, device=dev)
    pix, noise = draws
    pix, noise = shard_ray_batch(mesh, 1 if mpr.fixed_sample_batch else 2,
                                 pix.long(), noise)
    group = None if mesh is None else mesh.dp_group
    dirs_flat = rays_dir.reshape(H * W, 3)

    with torch.no_grad():
        sel_rgb = store.rgb[sel].reshape(Wsel, H * W, 3)
        sel_depth = store.depth[sel].reshape(Wsel, H * W)
        pose_mask = valid & (store.stamps[sel] != 0)
        origin_shift = torch.where(valid[:, None], 0.0, FAR_AWAY)
        poses0 = store.poses[sel]

    def batch(p):
        """(Wsel, N) pixel indices -> ray directions (Wsel, N, 3) and the
        flattened ground truth."""
        gt_c = torch.gather(sel_rgb, 1, p[..., None].expand(-1, -1, 3))
        return (dirs_flat[p], gt_c.reshape(-1, 3),
                torch.gather(sel_depth, 1, p).reshape(-1))

    fixed = occupancy = None
    if rnd.intersect_mode == "dda":   # voxel topology is frozen: build once
        occupancy = build_occupancy(map_state.voxel_keys,
                                    map_state.num_voxels, rnd)
    if mpr.fixed_sample_batch:
        with torch.no_grad():
            f_batch = batch(pix)
            R0 = se3.exp_rotation(poses0[:, 3:6])
            w_d = torch.einsum("fnd,fed->fne", f_batch[0], R0)
            w_o = (poses0[:, 0:3] + origin_shift)[:, None, :].expand_as(w_d)
            fixed = intersect_and_sample(w_o.reshape(-1, 3),
                                         w_d.reshape(-1, 3), map_state, rnd,
                                         noise.reshape(-1, SJ), occupancy)
    pcd = rnd.feature_mode == "pcd"

    def loss_fn(embeddings, dec_params, poses, dirs, gt_c, gt_d, noise_i):
        R = se3.exp_rotation(poses[:, 3:6])
        world_d = torch.einsum("fnd,fed->fne", dirs, R)
        world_o = (poses[:, 0:3] + origin_shift)[:, None, :].expand_as(
            world_d)
        outputs = render_rays(
            world_o.reshape(-1, 3), world_d.reshape(-1, 3), map_state,
            embeddings, dec_params, settings.decoder, rnd,
            noise=noise_i.reshape(-1, SJ), point_store=point_store,
            precomputed=fixed, occupancy=occupancy)
        loss, _ = compute_loss(outputs, gt_c, gt_d, settings.loss,
                               weight_depth_loss=False, group=group)
        return loss

    table = map_state.embeddings.detach()
    embeddings = shard_embeddings(mesh, table)
    dec_leaves = [t.detach() for t in tree_leaves(decoder_params)]
    poses = poses0.clone()
    pm, pv, pt = store.adam_m[sel], store.adam_v[sel], store.adam_t[sel]
    embed_opt, dec_opt = opt.embed, opt.decoder
    loss = None
    for i in range(mpr.num_iterations):
        if i > 0:
            table = gather_embeddings(mesh, embeddings)
        wrt = [table.requires_grad_(True)]
        if update_pose:
            wrt.append(poses.requires_grad_(True))
        if update_decoder:
            wrt += [t.requires_grad_(True) for t in dec_leaves]
        if mpr.fixed_sample_batch:
            it_batch, it_noise = f_batch, noise
        else:
            it_batch, it_noise = batch(pix[i]), noise[i]
        loss = loss_fn(table, tree_unflatten(decoder_params, dec_leaves),
                       poses, *it_batch, it_noise)
        # unused inputs (the embeddings in the pcd branch) get zeros
        grads = list(torch.autograd.grad(loss, wrt, allow_unused=pcd,
                                         materialize_grads=pcd))
        if mesh is not None:
            grads = all_reduce_flat(grads, group)
        with torch.no_grad():
            (embeddings,), embed_opt = adam_update(
                [embeddings.detach()], [shard_embeddings(mesh, grads.pop(0))],
                embed_opt, mpr.embed_lr)
            if update_pose:
                poses, pm, pv, pt = adam_update_rows(
                    poses.detach(), grads.pop(0), pm, pv, pt,
                    settings.tracker.learning_rate, pose_mask)
            if update_decoder:
                dec_leaves, dec_opt = adam_update(
                    [t.detach() for t in dec_leaves], grads, dec_opt,
                    mpr.decoder_lr)

    with torch.no_grad():
        rows = sel[valid]
        store.poses[rows] = poses[valid]
        store.adam_m[rows] = pm[valid]
        store.adam_v[rows] = pv[valid]
        store.adam_t[rows] = pt[valid]
    dec_out = tree_unflatten(decoder_params, [t.detach() for t in dec_leaves])
    loss = loss.detach()
    if mesh is not None:
        (loss,) = all_reduce_flat([loss], group)
    return MapStepResult(embeddings=embeddings.detach(),
                         decoder_params=dec_out,
                         opt=MapOptState(embed=embed_opt, decoder=dec_opt),
                         loss=loss)
