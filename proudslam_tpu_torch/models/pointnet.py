"""Per-point feature MLP + inverse-distance feature aggregation.

Port of ``proudslam_tpu/models/pointnet.py``: an MLP 6 -> 64 -> 128 -> 256
-> 512 -> feature_n over concat(xyz, rgb) of the points stored in each
voxel, and the softmax inverse-distance blend of their features. Params
are a dict in the JAX layout (``w`` (fan_in, fan_out), ``b`` (fan_out,)):

  {"layers": [{"w", "b"}, ...], "fc": {"w", "b"}}

The products are plain f32 ``torch.matmul`` (the JAX package runs them at
``highest`` precision outside any kernel; the package turns TF32 off).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

Params = Dict[str, Any]

_WIDTHS = (64, 128, 256, 512)


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int, device):
    bound = 1.0 / math.sqrt(fan_in)
    u = lambda *shape: (torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
                        * (2 * bound) - bound).to(device)
    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def init_pointnet(gen: torch.Generator, feature_n: int = 16,
                  device="cuda") -> Params:
    layers = []
    fan_in = 6
    for w in _WIDTHS:
        layers.append(_linear_init(gen, fan_in, w, device))
        fan_in = w
    fc = _linear_init(gen, _WIDTHS[-1], feature_n, device)
    # small head: the decoder is trained against N(0, 0.01)-scale
    # features; a default-init head would emit O(1) features
    fc = {"w": fc["w"] * 0.02, "b": fc["b"] * 0.02}
    return {"layers": layers, "fc": fc}


def pointnet_apply(params: Params, xyz: torch.Tensor,
                   rgb: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) xyz + (..., K, 3) rgb -> (..., K, feature_n)."""
    x = torch.cat([xyz, rgb], dim=-1)
    for layer in params["layers"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ params["fc"]["w"] + params["fc"]["b"]


def aggregate_point_features(sample_xyz: torch.Tensor,
                             point_xyz: torch.Tensor,
                             point_feats: torch.Tensor, voxel_size: float,
                             sharpness: float = 10.0) -> torch.Tensor:
    """Softmax inverse-distance blend with the half-voxel sample bias.

    Args:
      sample_xyz: (N, 3); point_xyz: (N, K, 3); point_feats: (N, K, D).
    Returns:
      (N, D)
    """
    q = sample_xyz + 0.5 * voxel_size
    d = torch.linalg.vector_norm(q[:, None, :] - point_xyz, dim=-1)
    w = torch.softmax(-sharpness * d, dim=-1)
    return torch.sum(w[..., None] * point_feats, dim=-2)
