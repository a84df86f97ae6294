"""Trajectory evaluation metrics.

The reference dumps `frame_poses.npy` for offline ATE evaluation against
the dataset's ground-truth trajectory (`mapping.py:164-170`,
`replica.py:34-37`) but ships no eval script; this module provides the
standard ATE-RMSE (with optional Umeyama alignment, as used by the
Vox-Fusion paper's evaluation protocol) plus RPE.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid alignment src -> dst for (N, 3) point sets."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    scale = 1.0
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(D) @ S) / var_s)
    t = mu_d - scale * R @ mu_s
    return R, t, scale


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True) -> float:
    """ATE RMSE (meters) between (N, 4, 4) trajectories."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(est_t, gt_t)
        est_t = (s * (R @ est_t.T)).T + t
    err = est_t - gt_t
    return float(np.sqrt((err ** 2).sum(axis=-1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over ``delta``-frame gaps."""
    errs = []
    for i in range(len(est_poses) - delta):
        e_rel = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        g_rel = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        d = np.linalg.inv(g_rel) @ e_rel
        errs.append(np.linalg.norm(d[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))
