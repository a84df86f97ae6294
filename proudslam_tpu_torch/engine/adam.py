"""Hand-written Adam with torch.optim.Adam semantics (bias correction, eps
outside the square root of v-hat), over lists of tensors.

Port of ``proudslam_tpu/engine/adam.py``, including the per-row variant
for the keyframe pose table (each row has its own step count and only
masked rows update). Bias corrections are computed in f32, like the JAX
package's ``B1 ** t`` on an f32 ``t``; no step moves a value between
host and device (a host-to-device copy would synchronize the stream).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    t: int


def init_adam(params: List[torch.Tensor]) -> AdamState:
    return AdamState(m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params], t=0)


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                state: AdamState, lr
                ) -> Tuple[List[torch.Tensor], AdamState]:
    """One Adam step on every tensor of ``params`` (new tensors returned).
    The bias corrections are host f32 scalars (no device round trip)."""
    t = state.t + 1
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(B1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(B2) ** tf)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g * g
        new_p.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamState(m=new_m, v=new_v, t=t)


def adam_update_rows(params: torch.Tensor, grads: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                     lr: float, row_mask: torch.Tensor):
    """Per-row Adam for a (K, D) table with per-row step counts ``t`` (K,);
    rows outside ``row_mask`` keep their values and moments."""
    mask = row_mask.to(params.dtype)[:, None]
    t_new = t + row_mask.to(t.dtype)
    tf = torch.clamp_min(t_new, 1).to(torch.float32)[:, None]
    bc1, bc2 = 1.0 - B1 ** tf, 1.0 - B2 ** tf
    m_new = B1 * m + (1 - B1) * grads
    v_new = B2 * v + (1 - B2) * grads * grads
    step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
    return (params - step * mask, torch.where(mask > 0, m_new, m),
            torch.where(mask > 0, v_new, v), t_new)
