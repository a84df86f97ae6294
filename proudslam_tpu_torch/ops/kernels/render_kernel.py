"""Fused sample-feature blend + decoder forward (kernel K1), and its
autograd wrapper.

Port of ``fused_render_forward`` and ``fused_feats_decode`` in
``proudslam_tpu/ops/pallas/render_kernel.py``. Per sample: select the hit
slot ``bins[r, s]`` (``== H`` marks an invalid sample: zero features),
form ``p = (o + d*z)/voxel - corner`` with the corner unpacked from the
slot's packed voxel key, blend the slot's 8 corner embeddings trilinearly,
and decode with bf16 operands and f32 sums (always bf16, like the TPU
kernel, whatever ``matmul_dtype`` says).

:func:`fused_render_forward` launches ``csrc/render_kernel.cu`` for CUDA
tensors and runs :func:`fused_render_forward_plain` for CPU tensors.
:class:`FusedFeatsDecode` is the backward of ``_ffd_bwd``: kernel K3 for
the decoder, then plain tensor code for the sample -> hit slot -> corner
view fold and the trilinear derivative (plain XLA in the JAX package too).
"""

from __future__ import annotations

from typing import Tuple

import torch

from proudslam_tpu_torch.config import DecoderSettings, RenderSettings
from proudslam_tpu_torch.ops.interp import CORNER_BITS
from proudslam_tpu_torch.ops.kernels import build
from proudslam_tpu_torch.ops.kernels.mlp_kernel import (
    FusedParams, decoder_bwd, decoder_fwd_plain, pack_params)
from proudslam_tpu_torch.ops.voxel_hash import unpack_key


def fused_render_applicable(dec: DecoderSettings) -> bool:
    return (dec.use_fused_mlp and dec.depth == 2 and not dec.skips
            and dec.embedder == "none")


def fused_render_forward_plain(rb, keys_rb, bins, z, rays_o, rays_d,
                               fp: FusedParams, voxel_size: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 -> (out (R*S, 4), feats (R*S, D))."""
    R, H, K = rb.shape
    S = bins.shape[1]
    D = K // 8
    with torch.no_grad():
        valid = bins < H
        h = torch.where(valid, bins, 0).long()
        rbs = torch.gather(rb, 1, h[..., None].expand(R, S, K))
        corner = unpack_key(torch.gather(keys_rb, 1, h)).float()  # (R, S, 3)
        pos = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None])
        # a tensor divisor: true division, as in the kernel (a Python
        # scalar divisor becomes a reciprocal multiply on CUDA)
        p = pos / torch.tensor(voxel_size, device=pos.device) - corner
        feats = torch.zeros((R, S, D), dtype=torch.float32, device=rb.device)
        for j, (qx, qy, qz) in enumerate(CORNER_BITS.astype(int).tolist()):
            wj = ((p[..., 0] if qx else 1.0 - p[..., 0])
                  * (p[..., 1] if qy else 1.0 - p[..., 1])
                  * (p[..., 2] if qz else 1.0 - p[..., 2]))
            feats = feats + wj[..., None] * rbs[..., j * D:(j + 1) * D]
        feats = torch.where(valid[..., None], feats, 0.0).reshape(R * S, D)
        _, _, _, sdf, _, rgb = decoder_fwd_plain(feats, fp)
        return torch.cat([rgb, sdf], dim=1), feats


def fused_render_forward(rb, keys_rb, bins, z, rays_o, rays_d,
                         fp: FusedParams, voxel_size: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: the CUDA kernel on CUDA tensors, the plain version on CPU ones.

    Args:
      rb: (R, H, 8D) f32 corner features per hit slot.
      keys_rb: (R, H) int32 packed voxel keys of the hit slots.
      bins: (R, S) int32 hit slot per sample, == H for invalid samples.
      z: (R, S) f32 sample depths; rays_o/rays_d: (R, 3).
    """
    if rb.device.type == "cpu":
        return fused_render_forward_plain(rb, keys_rb, bins, z, rays_o,
                                          rays_d, fp, voxel_size)
    if rb.device.type != "cuda":
        raise ValueError(f"fused_render_forward: unsupported device "
                         f"{rb.device}")
    R, H, K = rb.shape
    S = bins.shape[1]
    D = K // 8
    args = [t.detach().contiguous() for t in (rb, keys_rb, bins, z, rays_o,
                                              rays_d)]
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    rb, keys_rb, bins, z, rays_o, rays_d = args
    if (D != 16 or fp.w2.shape != (128, 128) or fp.ws.shape != (128, 129)):
        raise ValueError("the CUDA render kernel takes D=16 and width/"
                         "sdf_dim 128")
    shapes = {"keys_rb": (keys_rb, (R, H), torch.int32),
              "bins": (bins, (R, S), torch.int32),
              "z": (z, (R, S), torch.float32),
              "rays_o": (rays_o, (R, 3), torch.float32),
              "rays_d": (rays_d, (R, 3), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
    for t in (rb, *args[1:], *fp):
        if t.device != rb.device:
            raise ValueError("render kernel inputs must share one device")
    if rb.dtype != torch.float32 or any(t.dtype != torch.float32 for t in fp):
        raise ValueError("rb and the decoder params must be f32")
    out = torch.empty((R * S, 4), dtype=torch.float32, device=rb.device)
    feats = torch.empty((R * S, D), dtype=torch.float32, device=rb.device)
    if R * S == 0:
        return out, feats
    lib = build.load("render_kernel", _bind)
    ntiles = -(-R * S // 64)
    sms = torch.cuda.get_device_properties(rb.device).multi_processor_count
    err = lib.fused_render_forward(
        rb.data_ptr(), keys_rb.data_ptr(), bins.data_ptr(), z.data_ptr(),
        rays_o.data_ptr(), rays_d.data_ptr(), build.pointer_array(fp),
        out.data_ptr(), feats.data_ptr(), R, H, S, float(voxel_size),
        min(ntiles, sms), torch.cuda.current_stream(rb.device).cuda_stream)
    build.check(err, "fused_render_forward")
    fused_render_forward.launches += 1
    return out, feats


fused_render_forward.launches = 0


def _bind(lib) -> None:
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_render_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                         f, i, p]
    lib.fused_render_forward.restype = i


def _corner_bits(device) -> torch.Tensor:
    """(8, 3) corner offset bits (j>>2, (j>>1)&1, j&1), made on the device
    (a host-to-device copy would synchronize the stream)."""
    j = torch.arange(8, device=device)
    return torch.stack([(j >> 2) & 1, (j >> 1) & 1, j & 1], dim=-1).float()


def _segment_sum_rows(rows: torch.Tensor, index: torch.Tensor,
                      n: int) -> torch.Tensor:
    """out[i] = sum of rows[index == i] for i < n, in a fixed order on every
    device: rows are grouped by a stable sort and each group is summed in
    sequence. (A scatter-add of these heavily repeated indices is either
    nondeterministic, with atomics, or serialized per index.) The counts
    are an integer scatter-add, exact in any order; ``torch.bincount``
    would read the largest index back to the host."""
    index = index.long()
    order = torch.argsort(index, stable=True)
    counts = torch.zeros(n, dtype=torch.long, device=index.device)
    counts.scatter_add_(0, index, torch.ones_like(index))
    return torch.segment_reduce(rows[order], "sum", lengths=counts,
                                unsafe=True)


class FusedFeatsDecode(torch.autograd.Function):
    """Corner view -> per-sample [r, g, b, sdf] through K1, with the
    ``_ffd_bwd`` backward. Differentiable w.r.t. EV (the (V, 8D) corner
    view), rays_o/rays_d (pose) and the 11 packed decoder params; ``z``
    gets a zero cotangent (sample depths are stop-grad)."""

    @staticmethod
    def forward(ctx, EV, keys_rb, vidx, bins, z, rays_o, rays_d, voxel_size,
                *fp):
        fp = FusedParams(*fp)
        out, feats = fused_render_forward(EV[vidx.long()], keys_rb, bins, z,
                                          rays_o, rays_d, fp, voxel_size)
        ctx.save_for_backward(EV, keys_rb, vidx, bins, z, rays_o, rays_d,
                              feats, *fp)
        ctx.voxel_size = voxel_size
        return out

    @staticmethod
    def backward(ctx, d_out):
        (EV, keys_rb, vidx, bins, z, rays_o, rays_d, feats,
         *fp) = ctx.saved_tensors
        fp = FusedParams(*fp)
        vox = ctx.voxel_size
        V, K = EV.shape
        R, H = vidx.shape
        S = bins.shape[1]
        D = K // 8
        want_wgrad = any(ctx.needs_input_grad[8:])
        dx, d_fp = decoder_bwd(feats, d_out.contiguous(), fp, want_wgrad)
        d_feats = dx.reshape(R, S, D)

        valid = bins < H
        h = torch.where(valid, bins, 0).long()
        centers_rb = (unpack_key(keys_rb).float() + 0.5) * vox     # (R, H, 3)
        center = torch.gather(centers_rb, 1, h[..., None].expand(R, S, 3))
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        p = (xyz - center) / vox + 0.5                             # (R, S, 3)
        vf = valid.float()
        q = _corner_bits(EV.device)                                # (8, 3)
        pe = p[:, :, None, :]
        ax = pe * q + (1.0 - pe) * (1.0 - q)                       # (R,S,8,3)
        w = torch.prod(ax, dim=-1) * vf[..., None]                 # (R, S, 8)

        # samples -> hit slots (exact one-hot contraction) -> corner view
        # rows; not needed when the corner view is a constant (tracking)
        onehot = ((bins[:, :, None] == torch.arange(H, device=EV.device))
                  .float())                                        # (R, S, H)
        dEV = None
        if ctx.needs_input_grad[0]:
            g8 = (w[..., None] * d_feats[:, :, None, :]).reshape(R, S, K)
            d_rb = torch.bmm(onehot.transpose(1, 2), g8)           # (R, H, K)
            dEV = _segment_sum_rows(d_rb.reshape(-1, K), vidx.reshape(-1),
                                    V)

        # pose: dL/dw_j = f8_j . d_feats, then the trilinear derivative
        rb = EV[vidx.long()]
        f8 = torch.bmm(onehot, rb).reshape(R, S, 8, D)
        d_w = torch.einsum("rsjd,rsd->rsj", f8, d_feats)
        sign = 2.0 * q - 1.0
        others = torch.stack([ax[..., 1] * ax[..., 2],
                              ax[..., 0] * ax[..., 2],
                              ax[..., 0] * ax[..., 1]], dim=-1)
        d_p = torch.sum(d_w[..., None] * sign * others, dim=2)     # (R, S, 3)
        d_xyz = d_p * (vf[..., None] / vox)
        d_o = d_xyz.sum(dim=1)
        d_d = (d_xyz * z[..., None]).sum(dim=1)
        grads_fp = tuple(d_fp) if want_wgrad else (None,) * 11
        return (dEV, None, None, None, torch.zeros_like(z), d_o, d_d, None,
                *grads_fp)


def fused_feats_decode(EV, keys_rb, vidx, bins, z, rays_o, rays_d, params,
                       settings: RenderSettings,
                       dec: DecoderSettings) -> torch.Tensor:
    """(V, 8D) corner view -> (R*S, 4) [r, g, b, sdf] through kernel K1;
    gradients reach EV, rays_o/rays_d and the dict ``params``."""
    fp = pack_params(params, dec)
    return FusedFeatsDecode.apply(EV, keys_rb, vidx, bins, z, rays_o, rays_d,
                                  settings.voxel_size, *fp)
