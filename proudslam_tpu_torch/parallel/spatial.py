"""Spatially sharded map scale-out with explicit collectives.

Port of ``proudslam_tpu/parallel/spatial.py``: the map itself is split
across a 1-axis group of ranks, and every collective is written out:

* the voxel table (packed keys + corner embedding ids) and the embedding
  table are row-sharded over the whole group: each rank owns ``V/n``
  voxels and ``E/n`` embedding rows;
* rays are sharded too: each rank renders ``N/n`` rays of every frame
  against the full map;
* rendering needs global geometry, so the voxel keys and ids are
  all-gathered (int32), and so is the embedding table; the embedding
  gradient returns to its owners by ``reduce_scatter``, the all-gather's
  transpose;
* the loss's normalizing statistics are reduced over the group
  (``render/losses.compute_loss(group=...)``, the JAX package's
  ``_loss_psum``), so the sharded loss is the same math as the loss of
  the whole batch;
* replicated parameters (decoder, poses) get their gradients
  all-reduced.

The step runs the plain decoder (``use_fused_mlp=False``, as the JAX step
does), so it is held against the JAX step on the same inputs. SGD
updates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.geometry import se3
from proudslam_tpu_torch.models.decoder import tree_leaves, tree_unflatten
from proudslam_tpu_torch.ops import voxel_hash as vh
from proudslam_tpu_torch.parallel.engine import (all_gather_rows,
                                                 all_reduce_flat,
                                                 make_engine_mesh,
                                                 reduce_scatter_rows, rows)
from proudslam_tpu_torch.render.losses import compute_loss
from proudslam_tpu_torch.render.renderer import render_rays


@dataclasses.dataclass(frozen=True)
class JointMesh:
    """A 1-axis group of ranks ("shard") over which map, embeddings and
    rays all split."""

    size: int
    rank: int
    group: object
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"shard": self.size}


def make_joint_mesh(n_devices: Optional[int] = None,
                    device=None) -> JointMesh:
    """1-axis mesh over the process group's ranks (``n_devices``, default
    all, must be the world size: a rank is one device)."""
    m = make_engine_mesh(n_devices, mp=1, device=device)
    return JointMesh(size=m.size, rank=m.rank, group=m.group,
                     device=m.device)


def plain_decoder(settings: SystemSettings) -> SystemSettings:
    """``settings`` with ``use_fused_mlp=False``: the BA-step forms run the
    plain decoder, as the JAX package's do."""
    return dataclasses.replace(settings, decoder=dataclasses.replace(
        settings.decoder, use_fused_mlp=False))


def map_view(mesh: JointMesh, map_state) -> vh.MapState:
    """The renderer's view: this rank's voxel rows all-gathered into the
    full voxel table (the cell table is not read by rendering)."""
    V = map_state.voxel_keys.shape[0]
    own = rows(V, mesh.size, mesh.rank)
    dummy = torch.zeros((1,), dtype=torch.int32, device=mesh.device)
    return vh.MapState(
        cell_keys=dummy, cell_ids=dummy, cell_vslot=dummy,
        num_cells=map_state.num_voxels,
        voxel_keys=all_gather_rows(map_state.voxel_keys[own], mesh.group,
                                   mesh.size),
        voxel_vertex_ids=all_gather_rows(map_state.voxel_vertex_ids[own],
                                         mesh.group, mesh.size),
        num_voxels=map_state.num_voxels, embeddings=None, inv_map=dummy)


def spatial_grads(mesh: JointMesh, settings: SystemSettings, map_state,
                  dec_params, poses, dirs, gt_c, gt_d, noise):
    """This rank's part of the step's backward: ``(loss, g_emb_own,
    g_dec, g_pose)`` with the whole batch's loss, the gradient of this
    rank's ``E/n`` embedding rows (reduce-scattered to it), and the
    all-reduced decoder (leaves, ``tree_leaves`` order) and pose
    gradients. Inputs are whole; each rank takes its blocks."""
    settings = plain_decoder(settings)
    rnd = settings.render
    SJ = rnd.max_samples - rnd.max_hits
    n = mesh.size
    F, N = dirs.shape[:2]
    E = map_state.embeddings.shape[0]
    V = map_state.voxel_keys.shape[0]
    if V % n or E % n or N % n:
        raise ValueError(f"V={V}, E={E} and N={N} must divide by {n}")
    r = rows(N, n, mesh.rank)
    dirs, gt_c, gt_d, noise = (dirs[:, r], gt_c[:, r], gt_d[:, r],
                               noise[:, r])
    Nl = dirs.shape[1]
    view = map_view(mesh, map_state)
    emb_own = map_state.embeddings[rows(E, n, mesh.rank)]
    table = all_gather_rows(emb_own, mesh.group, n).requires_grad_(True)
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(dec_params)]
    poses_g = poses.detach().requires_grad_(True)

    R = se3.exp_rotation(poses_g[:, 3:6])
    world_d = torch.einsum("fnd,fed->fne", dirs, R).reshape(-1, 3)
    world_o = poses_g[:, None, 0:3].expand(F, Nl, 3).reshape(-1, 3)
    outputs = render_rays(world_o, world_d, view, table,
                          tree_unflatten(dec_params, leaves),
                          settings.decoder, rnd, noise=noise.reshape(-1, SJ))
    loss, _ = compute_loss(outputs, gt_c.reshape(-1, 3), gt_d.reshape(-1),
                           settings.loss, group=mesh.group)
    g_table, g_pose, *g_dec = torch.autograd.grad(
        loss, [table, poses_g] + leaves)
    g_own = reduce_scatter_rows(g_table, mesh.group, n)
    loss_all, g_pose, *g_dec = all_reduce_flat(
        [loss.detach(), g_pose] + g_dec, mesh.group)
    return loss_all, g_own, g_dec, g_pose


def make_spatial_ba_step(mesh: JointMesh, settings: SystemSettings):
    """BA step with map, embeddings and rays sharded over the mesh.

    Returns ``step(map_state, decoder_params, poses, dirs, gt_c, gt_d,
    noise, lr=1e-2) -> (new_embeddings_full, new_decoder_params,
    new_poses, loss)``. ``dirs/gt_c/gt_d/noise`` are (F, N, ...) per-frame
    batches; N, the voxel capacity V and the embedding count E must divide
    by the mesh size. Inputs are whole on every rank; each rank keeps its
    blocks, and the new table is all-gathered from its owners.
    """

    def step(map_state, dec_params, poses, dirs, gt_c, gt_d, noise, lr=1e-2):
        loss, g_own, g_dec, g_pose = spatial_grads(
            mesh, settings, map_state, dec_params, poses, dirs, gt_c, gt_d,
            noise)
        E = map_state.embeddings.shape[0]
        with torch.no_grad():
            own = map_state.embeddings[rows(E, mesh.size, mesh.rank)]
            new_emb = all_gather_rows(own - lr * g_own, mesh.group,
                                      mesh.size)
            new_dec = tree_unflatten(dec_params, [
                p.detach() - lr * g
                for p, g in zip(tree_leaves(dec_params), g_dec)])
            new_poses = poses.detach() - lr * g_pose
        return new_emb, new_dec, new_poses, loss

    return step

