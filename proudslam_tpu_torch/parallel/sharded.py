"""Multi-device scale-out: the (dp, mp) mesh and a sharded bundle-adjustment
step.

Port of ``proudslam_tpu/parallel/sharded.py``. JAX places the step with
GSPMD sharding constraints; the port writes each collective out:

* ``dp`` — the flattened (F*N) ray batch splits into contiguous blocks,
  one per dp index; the loss's statistics come from the whole dp group
  (``render/losses.compute_loss(group=...)``) and the gradients are
  all-reduced over it.
* ``mp`` — the embedding rows split over mp (each rank updates its rows;
  the table is all-gathered for rendering and after the step), and the
  decoder's trunk is tensor-parallel as the JAX constraints place it:
  layer 0 split by output columns (w and b), every later layer by input
  rows, with an all-reduce over mp after each row-split product. The
  all-reduce's backward is the identity, and the replicated input of a
  split layer all-reduces its gradient on the way back, so every
  replicated tensor's gradient is whole on each mp rank and each split
  weight's block is exact on its owner.

The step runs the plain decoder (``use_fused_mlp=False``, as JAX forces):
no kernel takes a width-split decoder. Updates are plain SGD.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.geometry import se3
from proudslam_tpu_torch.models.decoder import (_linear, _tree_map,
                                                embed_input, tree_leaves,
                                                tree_unflatten)
from proudslam_tpu_torch.parallel.engine import (EngineMesh, all_gather_rows,
                                                 all_reduce_flat,
                                                 gather_embeddings,
                                                 make_engine_mesh, rows,
                                                 shard_embeddings,
                                                 shard_ray_batch)
from proudslam_tpu_torch.parallel.spatial import plain_decoder
from proudslam_tpu_torch.render.losses import compute_loss
from proudslam_tpu_torch.render.renderer import render_rays


def make_mesh(n_devices: Optional[int] = None, mp: Optional[int] = None,
              device=None) -> EngineMesh:
    """(dp, mp) mesh over ``n_devices`` ranks (default: all); mp defaults
    to 2 when the count is even and at least 4, else 1."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if mp is None:
        mp = 2 if (n % 2 == 0 and n >= 4) else 1
    return make_engine_mesh(n, mp=mp, device=device)


class _ReduceMP(torch.autograd.Function):
    """Sum over the mp group; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterMP(torch.autograd.Function):
    """Identity; the gradient is summed over the mp group (a replicated
    tensor entering a split layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherCols(torch.autograd.Function):
    """All-gather a column-split (N, W/mp) tensor to (N, W); the gradient
    (whole on every rank) keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.cols = rows(x.shape[1] * size, size, index)
        return all_gather_rows(x.t(), group, size).t().contiguous()

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.cols], None, None, None


def tp_decoder_values(mesh: EngineMesh, params, settings, x: torch.Tensor
                      ) -> torch.Tensor:
    """``models/decoder.decoder_values`` with the trunk's width split over
    mp (layer 0 by columns, later layers by rows); the same products at
    the config's ``matmul_dtype``, summed in another order."""
    dt = torch.bfloat16 if settings.matmul_dtype == "bf16" else torch.float32
    group, mp, j = mesh.mp_group, mesh.mp, mesh.mp_index
    xe = embed_input(settings, params, x)
    h, split = xe, False
    for i, layer in enumerate(params["layers"]):
        w, b = layer["w"], layer["b"]
        if i == 0:
            c = rows(w.shape[1], mp, j)
            h = torch.relu(_linear({"w": w[:, c], "b": b[c]},
                                   _EnterMP.apply(h, group), dt))
            split = True
        else:
            r = rows(w.shape[0], mp, j)
            hin = h if split else _EnterMP.apply(h, group)[:, r]
            part = hin.to(dt).float() @ w[r].to(dt).float()
            h = torch.relu(_ReduceMP.apply(part, group) + b)
            split = False
        if i in settings.skips:
            if split:
                h = _GatherCols.apply(h, group, mp, j)
                split = False
            h = torch.cat([xe, h], dim=-1)
    if split:
        h = _GatherCols.apply(h, group, mp, j)
    sdf_out = _linear(params["sdf_out"], h, dt)
    hc = torch.cat([sdf_out[:, 1:], xe], dim=-1)
    rgb = torch.sigmoid(_linear(params["color1"], torch.relu(
        _linear(params["color0"], hc, dt)), dt))
    return torch.cat([rgb, sdf_out[:, :1]], dim=-1)


def _split_leaves(params) -> list:
    """Per decoder leaf (``tree_leaves`` order): whether the step splits it
    over mp (layer 0's w and b, later trunk layers' w)."""
    marks = _tree_map(lambda _: False, params)
    marks["layers"] = [{"w": True, "b": i == 0}
                       for i, _ in enumerate(params["layers"])]
    return tree_leaves(marks)


def make_sharded_ba_step(mesh: EngineMesh, settings: SystemSettings):
    """One SGD bundle-adjustment step over the mesh.

    Returns ``step(map_state, decoder_params, poses, dirs, gt_c, gt_d,
    noise, lr=1e-2) -> (new_embeddings, new_decoder_params, new_poses,
    loss)``, every input whole on every rank and every output whole (the
    full table, decoder and poses; the whole batch's loss). ``dirs/gt_*/
    noise`` are (F, N, ...) per-frame camera-frame ray batches; F*N must
    divide by dp and the embedding count by mp.
    """
    settings = plain_decoder(settings)
    rnd = settings.render
    SJ = rnd.max_samples - rnd.max_hits

    def decode(params, dec, feats):
        return tp_decoder_values(mesh, params, dec, feats)

    def step(map_state, dec_params, poses, dirs, gt_c, gt_d, noise, lr=1e-2):
        F, N = dirs.shape[:2]
        emb_own = shard_embeddings(mesh, map_state.embeddings.detach())
        table = gather_embeddings(mesh, emb_own).requires_grad_(True)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(dec_params)]
        poses_g = poses.detach().requires_grad_(True)
        g_c, g_d, nz = shard_ray_batch(
            mesh, 0, gt_c.reshape(-1, 3), gt_d.reshape(-1),
            noise.reshape(-1, SJ))

        R = se3.exp_rotation(poses_g[:, 3:6])
        world_d = torch.einsum("fnd,fed->fne", dirs, R).reshape(-1, 3)
        world_o = poses_g[:, None, 0:3].expand(F, N, 3).reshape(-1, 3)
        world_o, world_d = shard_ray_batch(mesh, 0, world_o, world_d)
        outputs = render_rays(world_o, world_d, map_state, table,
                              tree_unflatten(dec_params, leaves),
                              settings.decoder, rnd, noise=nz, decode=decode)
        loss, _ = compute_loss(outputs, g_c, g_d, settings.loss,
                               group=mesh.dp_group)
        grads = torch.autograd.grad(loss, [table, poses_g] + leaves)
        split = _split_leaves(dec_params)
        # a split weight's gradient is zero off its owner's block: the sum
        # over the whole mesh assembles it; the rest is whole per mp rank
        whole = all_reduce_flat([g for g, s in zip(grads[2:], split) if s],
                                mesh.group)
        reduced = all_reduce_flat(
            [grads[0], grads[1], loss.detach()]
            + [g for g, s in zip(grads[2:], split) if not s], mesh.dp_group)
        g_emb, g_pose, loss_all = reduced[:3]
        rest, whole = iter(reduced[3:]), iter(whole)
        g_dec = [next(whole) if s else next(rest) for s in split]
        with torch.no_grad():
            new_own = emb_own - lr * shard_embeddings(mesh, g_emb)
            new_emb = gather_embeddings(mesh, new_own)
            new_dec = tree_unflatten(dec_params, [
                p.detach() - lr * g for p, g in zip(leaves, g_dec)])
            new_poses = poses.detach() - lr * g_pose
        return new_emb, new_dec, new_poses, loss_all

    return step
