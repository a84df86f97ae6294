"""Fused decoder backward (kernel K3): CUDA kernel + plain PyTorch version.

Port of ``_run_bwd``/``_bwd_kernel`` in
``proudslam_tpu/ops/pallas/mlp_kernel.py`` (bf16=True). Given the decoder
inputs ``x`` (N, D) and the output cotangent ``g`` (N, 4) [r, g, b, sdf],
it recomputes the forward and returns ``dx`` (N, D) and the 11 parameter
gradients in :class:`FusedParams` layout.

:func:`decoder_bwd` launches ``csrc/mlp_kernel.cu`` for CUDA tensors and
runs :func:`decoder_bwd_plain` for CPU tensors; any other device raises.
The plain version rounds at the kernel's points: both operands of every
product are rounded to bf16, cotangents (``dzo``, ``dhc``, ``dso``,
``dh2``, ``dh1``) included, while bias gradients sum the unrounded f32
cotangents. (Autograd through a bf16-rounded forward would not round the
cotangents, so it is not this function.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from proudslam_tpu_torch.config import DecoderSettings
from proudslam_tpu_torch.ops.kernels import build

# rows of the kernel's tiles, and the most blocks that split the rows (each
# block owns one slab of partial weight gradients)
TILE_ROWS = 64
MAX_BLOCKS = 128


class FusedParams(NamedTuple):
    w1: torch.Tensor     # (in_dim, width)
    b1: torch.Tensor     # (1, width)
    w2: torch.Tensor     # (width, width)
    b2: torch.Tensor     # (1, width)
    ws: torch.Tensor     # (width, sdf_dim + 1)  [feat cols | sdf col last]
    bs: torch.Tensor     # (1, sdf_dim + 1)
    wc_f: torch.Tensor   # (sdf_dim, width)  color head, feature part
    wc_x: torch.Tensor   # (in_dim, width)   color head, input part
    bc: torch.Tensor     # (1, width)
    wo: torch.Tensor     # (width, 3)
    bo: torch.Tensor     # (1, 3)


def pack_params(params: dict, dec: DecoderSettings) -> FusedParams:
    """Dict decoder params -> kernel layout (differentiable torch ops, so
    gradients of the packed tensors flow back to the dict leaves)."""
    if dec.depth != 2 or dec.skips or dec.embedder != "none":
        raise ValueError("fused decoder layout: default architecture only")
    sd = dec.sdf_dim
    w_sdf = params["sdf_out"]["w"]
    b_sdf = params["sdf_out"]["b"]
    wc = params["color0"]["w"]
    return FusedParams(
        w1=params["layers"][0]["w"], b1=params["layers"][0]["b"][None, :],
        w2=params["layers"][1]["w"], b2=params["layers"][1]["b"][None, :],
        ws=torch.cat([w_sdf[:, 1:], w_sdf[:, :1]], dim=1),
        bs=torch.cat([b_sdf[1:], b_sdf[:1]])[None, :],
        wc_f=wc[:sd], wc_x=wc[sd:], bc=params["color0"]["b"][None, :],
        wo=params["color1"]["w"], bo=params["color1"]["b"][None, :])


def unpack_grads(g: FusedParams) -> dict:
    """Kernel-layout gradients -> dict layout of models/decoder.py."""
    return {
        "layers": [{"w": g.w1, "b": g.b1[0]}, {"w": g.w2, "b": g.b2[0]}],
        "sdf_out": {"w": torch.cat([g.ws[:, -1:], g.ws[:, :-1]], dim=1),
                    "b": torch.cat([g.bs[0, -1:], g.bs[0, :-1]])},
        "color0": {"w": torch.cat([g.wc_f, g.wc_x], dim=0), "b": g.bc[0]},
        "color1": {"w": g.wo, "b": g.bo[0]},
    }


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and return as f32."""
    return t.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, exact products, f32 sums."""
    return _r(a) @ _r(b)


def decoder_fwd_plain(x: torch.Tensor, fp: FusedParams):
    """The fused decoder forward with bf16 operands -> activations."""
    h1 = torch.relu(_dot(x, fp.w1) + fp.b1)
    h2 = torch.relu(_dot(h1, fp.w2) + fp.b2)
    so = _dot(h2, fp.ws) + fp.bs
    feat, sdf = so[:, :-1], so[:, -1:]
    hc = torch.relu(_dot(feat, fp.wc_f) + _dot(x, fp.wc_x) + fp.bc)
    rgb = torch.sigmoid(_dot(hc, fp.wo) + fp.bo)
    return h1, h2, feat, sdf, hc, rgb


def decoder_bwd_plain(x: torch.Tensor, g: torch.Tensor, fp: FusedParams,
                      want_wgrad: bool = True
                      ) -> Tuple[torch.Tensor, Optional[FusedParams]]:
    """Plain PyTorch version of the kernel (same rounding points)."""
    with torch.no_grad():
        h1, h2, feat, sdf, hc, rgb = decoder_fwd_plain(x, fp)
        dzo = g[:, 0:3] * rgb * (1.0 - rgb)
        dhc = _dot(dzo, fp.wo.T) * (hc > 0)
        dfeat = _dot(dhc, fp.wc_f.T)
        dso = torch.cat([dfeat, g[:, 3:4]], dim=1)
        dh2 = _dot(dso, fp.ws.T) * (h2 > 0)
        dh1 = _dot(dh2, fp.w2.T) * (h1 > 0)
        dx = _dot(dh1, fp.w1.T) + _dot(dhc, fp.wc_x.T)
        if not want_wgrad:
            return dx, None
        col = lambda t: t.sum(dim=0, keepdim=True)  # noqa: E731
        grads = FusedParams(
            w1=_dot(x.T, dh1), b1=col(dh1), w2=_dot(h1.T, dh2), b2=col(dh2),
            ws=_dot(h2.T, dso), bs=col(dso), wc_f=_dot(feat.T, dhc),
            wc_x=_dot(x.T, dhc), bc=col(dhc), wo=_dot(hc.T, dzo),
            bo=col(dzo))
        return dx, grads


def _check_kernel_inputs(x, g, fp):
    N, D = x.shape
    if D != 16 or fp.w2.shape != (128, 128) or fp.ws.shape != (128, 129):
        raise ValueError("the CUDA decoder kernels take in_dim 16, width "
                         f"128, sdf_dim 128; got x {tuple(x.shape)}, "
                         f"w2 {tuple(fp.w2.shape)}, ws {tuple(fp.ws.shape)}")
    if g.shape != (N, 4):
        raise ValueError(f"g shape {tuple(g.shape)} != ({N}, 4)")
    for t in (x, g, *fp):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("decoder kernel inputs must be f32 on one device")
        if not t.is_contiguous():
            raise ValueError("decoder kernel inputs must be contiguous")


def decoder_bwd(x: torch.Tensor, g: torch.Tensor, fp: FusedParams,
                want_wgrad: bool = True
                ) -> Tuple[torch.Tensor, Optional[FusedParams]]:
    """Decoder backward: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. ``want_wgrad=False`` skips the parameter gradients
    (tracking differentiates the pose only)."""
    if x.device.type == "cpu":
        return decoder_bwd_plain(x, g, fp, want_wgrad)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_bwd: unsupported device {x.device}")
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    x, g = x.detach().contiguous(), g.detach().contiguous()
    _check_kernel_inputs(x, g, fp)
    N = x.shape[0]
    nparam = sum(t.numel() for t in fp)
    dx = torch.empty_like(x)
    dflat = torch.zeros((nparam if want_wgrad else 0,), device=x.device)
    if N > 0:
        lib = build.load("mlp_kernel", _bind)
        ntiles = -(-N // TILE_ROWS)
        per_block = -(-ntiles // MAX_BLOCKS)
        blocks = -(-ntiles // per_block)
        partial = torch.empty(((blocks if want_wgrad else 0) * nparam,),
                              device=x.device)
        err = lib.decoder_backward(
            x.data_ptr(), g.data_ptr(), build.pointer_array(fp),
            dx.data_ptr(), dflat.data_ptr(), partial.data_ptr(), N, blocks,
            per_block, int(want_wgrad),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "decoder_backward")
        decoder_bwd.launches += 1
    if not want_wgrad:
        return dx, None
    parts, off = [], 0
    for t in fp:
        parts.append(dflat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return dx, FusedParams(*parts)


decoder_bwd.launches = 0


def _bind(lib) -> None:
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decoder_backward.argtypes = [p, p, p, p, p, p, ll, i, i, i, p]
    lib.decoder_backward.restype = i
