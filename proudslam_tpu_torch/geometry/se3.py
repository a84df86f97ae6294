"""SE(3) pose parameterization as an optimizable (t, omega) 6-vector.

Port of ``proudslam_tpu/geometry/se3.py``: Rodrigues' rotation with the
Taylor series of sin(x)/x and (1-cos(x))/x^2 evaluated in x^2, so the map
is smooth with finite gradients at a zero rotation, plus the log map.

A pose is a tensor of shape (..., 6): ``[tx, ty, tz, wx, wy, wz]``.
"""

from __future__ import annotations

import math

import torch


def taylor_A_sq(x2: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """sin(x)/x as a series in x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    power = torch.ones_like(x2)
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
            power = power * x2
        ans = ans + (-1.0) ** i * power / denom
    return ans


def taylor_B_sq(x2: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(1-cos(x))/x^2 as a series in x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    power = torch.ones_like(x2)
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        if i > 0:
            power = power * x2
        ans = ans + (-1.0) ** i * power / denom
    return ans


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    row0 = torch.stack([zeros, -w2, w1], dim=-1)
    row1 = torch.stack([w2, zeros, -w0], dim=-1)
    row2 = torch.stack([-w1, w0, zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def exp_rotation(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3): R = I + A*[w]x + B*[w]x^2."""
    wx = skew(w)
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    A = taylor_A_sq(theta_sq)
    B = taylor_B_sq(theta_sq)
    return eye + A * wx + B * (wx @ wx)


def log_rotation(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) -> so(3); theta clamped away from the trace singularities."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.remainder(torch.arccos(cos_theta), math.pi)[..., None, None]
    lnR = 1.0 / (2.0 * taylor_A_sq(theta * theta) + 1e-8) * (
        R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]],
                       dim=-1)


def matrix_from_tangent(pose6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4) homogeneous transform."""
    R = exp_rotation(pose6[..., 3:6])
    t = pose6[..., 0:3]
    bottom = torch.zeros(pose6.shape[:-1] + (1, 4), dtype=pose6.dtype,
                         device=pose6.device)
    bottom[..., 0, 3] = 1.0
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse_matrix(Rt: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: [R t; 0 1]^-1 = [R^T -R^T t; 0 1]."""
    Rinv = Rt[..., :3, :3].transpose(-2, -1)
    tinv = -torch.einsum("...ij,...j->...i", Rinv, Rt[..., :3, 3])
    out = torch.zeros_like(Rt)
    out[..., :3, :3] = Rinv
    out[..., :3, 3] = tinv
    out[..., 3, 3] = 1.0
    return out


def tangent_from_matrix(Rt: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6)."""
    return torch.cat([Rt[..., :3, 3], log_rotation(Rt[..., :3, :3])], dim=-1)
