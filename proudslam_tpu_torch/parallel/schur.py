"""Schur-complement-structured distributed Gauss-Newton BA step.

Port of ``proudslam_tpu/parallel/schur.py``. The normal equations over
keyframe poses T (6 dof each) and embedding rows W (D floats each) have
the arrow structure: H_ww block-diagonal per embedding row (kept as
per-row D x D blocks), H_tt dense over the 6K pose dofs, and the Schur
complement S = H_tt - H_tw H_ww^-1 H_wt reduces the joint solve to a small
dense pose system.

Distribution over a 1-axis group of ranks (``parallel/spatial.py``'s
layout: rays and embedding rows split over the same ranks):

* each rank renders its ray block and takes the exact per-residual
  Jacobians of the depth residuals;
* the per-row D x D H_ww blocks, g_w and the H_tw columns are summed over
  the ranks by one ``reduce_scatter``: each owner receives its rows;
* each owner runs a batched Cholesky over its rows;
* g_t, H_tt and the Schur corrections are all-reduced, and every rank
  solves the same dense pose system;
* the map update dW = -H_ww^-1 (g_w + H_wt dT) is owner-local
  back-substitution, all-gathered into the full table;
* anchored pose rows are zeroed.

The Jacobians are built by one ``torch.autograd.grad`` per residual (rays
that miss or have no valid depth are skipped: their residual is 0): the
port's render runs autograd Functions that functorch transforms
(``jacrev``, batched gradients) do not take. The step runs the plain
decoder (``use_fused_mlp=False``), in f32 with TF32 off (the package's
setting).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.geometry import se3
from proudslam_tpu_torch.parallel.engine import (all_gather_rows,
                                                 all_reduce_flat,
                                                 reduce_scatter_rows, rows)
from proudslam_tpu_torch.parallel.spatial import (JointMesh, map_view,
                                                  plain_decoder)
from proudslam_tpu_torch.render.renderer import render_rays


class GNResult(NamedTuple):
    d_emb: torch.Tensor     # (E, D) map update (full table, owner-written)
    d_poses: torch.Tensor   # (K, 6) pose tangent update
    r_norm: torch.Tensor    # () residual 2-norm before the step


def _depth_residuals(emb_full, poses, view, dec_params, dirs, gt_d, noise,
                     settings: SystemSettings, anchor_mask):
    """Per-ray depth residuals r_i = valid_i * (depth_i(W, T) - gt_i) and
    the valid mask (hit, with 0.01 < gt < max_depth). dirs (F, N, 3)
    camera frame, poses (F, 6) tangents, gt_d (F, N); anchored poses carry
    no gradient."""
    F, N = gt_d.shape
    p = torch.where(anchor_mask[:, None], poses.detach(), poses)
    R = se3.exp_rotation(p[:, 3:6])
    world_d = torch.einsum("fnd,fed->fne", dirs, R).reshape(-1, 3)
    world_o = p[:, None, 0:3].expand(F, N, 3).reshape(-1, 3)
    out = render_rays(world_o, world_d, view, emb_full, dec_params,
                      settings.decoder, settings.render,
                      noise=noise.reshape(F * N, -1))
    gd = gt_d.reshape(-1)
    valid = out.hit_mask & (gd > 0.01) & (gd < settings.loss.max_depth)
    return (out.depth - gd) * valid.float(), valid


def _jacobians(emb_full, poses, view, dec_params, dirs, gt_d, noise,
               settings, anchor_mask):
    """Residuals (R,) and their exact Jacobians w.r.t. the full table
    (R, E, D) and the poses (R, 6K)."""
    emb = emb_full.detach().requires_grad_(True)
    pos = poses.detach().requires_grad_(True)
    r, valid = _depth_residuals(emb, pos, view, dec_params, dirs, gt_d,
                                noise, settings, anchor_mask)
    R = r.shape[0]
    Jw = torch.zeros((R,) + tuple(emb.shape), dtype=emb.dtype,
                     device=emb.device)
    Jt = torch.zeros((R, pos.numel()), dtype=emb.dtype, device=emb.device)
    for i in torch.nonzero(valid).reshape(-1).tolist():
        gw, gt = torch.autograd.grad(r[i], [emb, pos], retain_graph=True)
        Jw[i] = gw
        Jt[i] = gt.reshape(-1)
    return r.detach(), Jw, Jt


def make_schur_gn_step(mesh: JointMesh, settings: SystemSettings,
                       damping: float = 1e-4):
    """Distributed GN step. Returns ``step(map_state, dec_params, poses,
    dirs, gt_d, noise, anchor_mask) -> GNResult`` (whole inputs on every
    rank, whole outputs).

    Shapes: poses (K, 6); dirs (K, N, 3); gt_d (K, N); noise (K, N, SJ);
    anchor_mask (K,) bool. N and E must divide by the mesh size.
    """
    settings = plain_decoder(settings)
    n = mesh.size

    def step(map_state, dec_params, poses, dirs, gt_d, noise,
             anchor_mask) -> GNResult:
        E, D = map_state.embeddings.shape
        K = poses.shape[0]
        N = dirs.shape[1]
        if E % n or N % n:
            raise ValueError(f"E={E} and N={N} must divide by {n}")
        r_rays = rows(N, n, mesh.rank)
        view = map_view(mesh, map_state)
        emb_full = all_gather_rows(
            map_state.embeddings[rows(E, n, mesh.rank)], mesh.group, n)
        r, Jw, Jt = _jacobians(
            emb_full, poses, view, dec_params, dirs[:, r_rays],
            gt_d[:, r_rays], noise[:, r_rays], settings, anchor_mask)
        El, K6 = E // n, 6 * K

        # per-row blocks, summed over the ranks onto their owners
        per_row = torch.cat([
            torch.einsum("red,r->ed", Jw, r),                 # g_w
            torch.einsum("red,ref->edf", Jw, Jw).reshape(E, D * D),
            torch.einsum("rk,red->ekd", Jt, Jw).reshape(E, K6 * D),
        ], dim=1)
        own = reduce_scatter_rows(per_row, mesh.group, n)
        gw_own = own[:, :D]
        Hb = own[:, D:D + D * D].reshape(El, D, D)
        Htw_own = own[:, D + D * D:].reshape(El, K6, D)
        Hb = Hb + damping * torch.eye(D, device=Hb.device)[None]
        g_t, Htt, rr = all_reduce_flat(
            [Jt.T @ r, Jt.T @ Jt, (r * r).sum()], mesh.group)

        Lb = torch.linalg.cholesky(Hb)                        # (El, D, D)

        def chol_apply(b):                                    # (El, D, m)
            y = torch.linalg.solve_triangular(Lb, b, upper=False)
            return torch.linalg.solve_triangular(Lb.transpose(1, 2), y,
                                                 upper=True)

        Winv_g = chol_apply(gw_own[..., None])[..., 0]        # (El, D)
        Winv_Hwt = chol_apply(Htw_own.transpose(1, 2))        # (El, D, 6K)
        corr_S, corr_g = all_reduce_flat([
            torch.einsum("ekd,edl->kl", Htw_own, Winv_Hwt),
            torch.einsum("ekd,ed->k", Htw_own, Winv_g)], mesh.group)

        S = Htt - corr_S + damping * torch.eye(K6, device=Htt.device)
        d_t = -torch.linalg.solve(S, g_t - corr_g)            # (6K,)
        hwt_dt = torch.einsum("ekd,k->ed", Htw_own, d_t)
        d_w_own = -chol_apply((gw_own + hwt_dt)[..., None])[..., 0]

        d_poses = torch.where(anchor_mask[:, None], 0.0, d_t.reshape(K, 6))
        return GNResult(d_emb=all_gather_rows(d_w_own, mesh.group, n),
                        d_poses=d_poses, r_norm=torch.sqrt(rr))

    return step


def dense_gn_reference(map_state, dec_params, poses, dirs, gt_d, noise,
                       settings: SystemSettings, anchor_mask,
                       damping: float = 1e-4):
    """Single-device dense joint GN solve (the correctness oracle), in
    float64 numpy: the full H = [[H_ww, H_wt], [H_tw, H_tt]] + damping*I
    with H_ww cut to its per-row D x D blocks (the structure the Schur
    step factorizes), solved directly. Returns (d_emb (E, D), d_poses
    (K, 6), r_norm) as numpy."""
    settings = plain_decoder(settings)
    E, D = map_state.embeddings.shape
    K = poses.shape[0]
    r, Jw, Jt = _jacobians(map_state.embeddings, poses, map_state,
                           dec_params, dirs, gt_d, noise, settings,
                           anchor_mask)
    r = r.cpu().numpy().astype(np.float64)
    J = np.concatenate([Jw.reshape(r.shape[0], E * D).cpu().numpy(),
                        Jt.cpu().numpy()], axis=1).astype(np.float64)
    g = J.T @ r
    H = J.T @ J
    Hww = H[:E * D, :E * D]
    Hbd = np.zeros_like(Hww)
    for e in range(E):
        s = slice(e * D, (e + 1) * D)
        Hbd[s, s] = Hww[s, s]
    H[:E * D, :E * D] = Hbd
    H += damping * np.eye(H.shape[0])
    d = -np.linalg.solve(H, g)
    d_poses = d[E * D:].reshape(K, 6)
    d_poses[anchor_mask.cpu().numpy()] = 0.0
    return d[:E * D].reshape(E, D), d_poses, float(np.linalg.norm(r))
