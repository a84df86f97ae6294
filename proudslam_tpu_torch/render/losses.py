"""Tracking/mapping loss with mask-safe static shapes.

Port of ``proudslam_tpu/render/losses.py``: color L1 and depth L1 over hit
rays (depth optionally filtered by the rendered depth-variance outlier
rule), free-space and truncated-SDF L2 terms averaged over
(hit rays x max live sample count), optional per-ray weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from proudslam_tpu_torch.config import LossSettings
from proudslam_tpu_torch.render.renderer import RenderOutputs


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x[mask] (lower middle, like torch.median)."""
    n = mask.sum()
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big)).values
    return xs[torch.clamp_min((n - 1) // 2, 0)]


def compute_loss(outputs: RenderOutputs, gt_color: torch.Tensor,
                 gt_depth: torch.Tensor, settings: LossSettings,
                 weight_depth_loss: bool = False,
                 ray_weights: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted SLAM loss; ``ray_weights`` (R,) in [0, 1] enter every
    term's mask and normalizer."""
    hitb = outputs.hit_mask.float()
    wgt = torch.ones_like(hitb) if ray_weights is None else ray_weights
    hit = hitb * wgt
    n_hit = torch.clamp_min(hit.sum(), 1.0)

    color_err = torch.abs(gt_color - outputs.color) * hit[:, None]
    color_loss = color_err.sum() / (3.0 * n_hit)

    valid_depth = ((gt_depth > 0.01) & (gt_depth < settings.max_depth)
                   & outputs.hit_mask)
    depth_err = torch.abs(gt_depth - outputs.depth)
    if weight_depth_loss:
        zv = torch.where(outputs.sample_mask, outputs.z_vals, 0.0)
        depth_var = torch.sum(
            outputs.weights * (outputs.depth[:, None] - zv) ** 2
            * outputs.sample_mask, dim=-1)
        tmp = depth_err / torch.sqrt(depth_var + 1e-10)
        med = _masked_median(tmp, outputs.hit_mask)
        valid_depth = valid_depth & (tmp < 10.0 * med)
    vd = valid_depth.float()
    if ray_weights is not None:
        vd = vd * ray_weights
    depth_loss = torch.sum(depth_err * vd) / torch.clamp_min(vd.sum(), 1.0)

    # free-space / truncated SDF: region indicators stay binary; per-ray
    # weights scale only the squared errors and counts
    z = outputs.z_vals
    sdf = outputs.sdf
    lane = outputs.sample_mask.float() * hitb[:, None]
    wl = wgt[:, None]
    d_exp = gt_depth[:, None]
    eps = settings.truncation
    front = (z < (d_exp - eps)).float() * lane
    back = (z > (d_exp + eps)).float() * lane
    depth_ok = ((d_exp > 0.0) & (d_exp < settings.max_depth)).float()
    sdf_mask = (1.0 - front) * (1.0 - back) * depth_ok * lane

    num_fs = torch.sum(front * wl)
    num_sdf = torch.sum(sdf_mask * wl)
    num_total = torch.clamp_min(num_fs + num_sdf, 1.0)
    fs_weight = 1.0 - num_fs / num_total
    sdf_weight = 1.0 - num_sdf / num_total
    max_len = torch.clamp_min(
        outputs.sample_mask.sum(dim=-1).max(), 1).float()
    denom = n_hit * max_len
    fs_loss = torch.sum(wl * (sdf * front - front) ** 2) / denom * fs_weight
    sdf_loss = torch.sum(
        wl * ((z + sdf * eps) * sdf_mask - d_exp * sdf_mask) ** 2
    ) / denom * sdf_weight

    loss = (settings.rgb_weight * color_loss
            + settings.depth_weight * depth_loss
            + settings.fs_weight * fs_loss
            + settings.sdf_weight * sdf_loss)
    return loss, {"loss": loss, "color_loss": color_loss,
                  "depth_loss": depth_loss, "fs_loss": fs_loss,
                  "sdf_loss": sdf_loss}
