"""Fused decoder forward (kernel K2) and backward (kernel K3): CUDA kernels,
their plain PyTorch versions, and the autograd function that joins them.

Ports of ``_run_fwd``/``_fwd_kernel`` and ``_run_bwd``/``_bwd_kernel`` in
``proudslam_tpu/ops/pallas/mlp_kernel.py``. The decoder maps inputs ``x``
(N, D) to (N, 4) [r, g, b, sdf]; the backward takes the output cotangent
``g`` (N, 4), recomputes the forward, and returns ``dx`` (N, D) and the
11 parameter gradients in :class:`FusedParams` layout.

:func:`decoder_fwd` and :func:`decoder_bwd` launch a CUDA kernel for CUDA
tensors and run :func:`decoder_fwd_plain` / :func:`decoder_bwd_plain` for
CPU tensors; any other device raises. Both operand types of the Pallas
kernels' ``_make_dot`` have a kernel: ``bf16=True`` launches
``csrc/mlp_kernel.cu`` (bf16 operands on the tensor cores), ``bf16=False``
``csrc/mlp_kernel_f32.cu`` (true f32 products on the FP32 units, no TF32).
Each form counts its own launches (``decoder_fwd.launches`` and
``decoder_fwd_f32.launches``, ``decoder_bwd.launches`` and
``decoder_bwd_f32.launches``). With bf16 operands the
plain versions round at the kernels' points: both operands of every
product are rounded to bf16, cotangents (``dzo``, ``dhc``, ``dso``,
``dh2``, ``dh1``) included, while bias gradients sum the unrounded f32
cotangents. (Autograd through a bf16-rounded forward would not round the
cotangents, so it is not this function.)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch

from proudslam_tpu_torch.config import DecoderSettings
from proudslam_tpu_torch.ops.kernels import build

# rows of the kernels' tiles
TILE_ROWS = 64


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


def _make_dot(bf16: bool):
    """Products with bf16 operands (exact products, f32 sums) or f32 ones."""
    if bf16:
        return lambda a, b: _r(a) @ _r(b)
    return lambda a, b: a @ b


def decoder_fwd_plain(x: torch.Tensor, fp: FusedParams, bf16: bool = True):
    """The fused decoder forward -> activations (h1, h2, feat, sdf, hc,
    rgb)."""
    _dot = _make_dot(bf16)
    h1 = torch.relu(_dot(x, fp.w1) + fp.b1)
    h2 = torch.relu(_dot(h1, fp.w2) + fp.b2)
    so = _dot(h2, fp.ws) + fp.bs
    feat, sdf = so[:, :-1], so[:, -1:]
    hc = torch.relu(_dot(feat, fp.wc_f) + _dot(x, fp.wc_x) + fp.bc)
    rgb = torch.sigmoid(_dot(hc, fp.wo) + fp.bo)
    return h1, h2, feat, sdf, hc, rgb


def decoder_bwd_plain(x: torch.Tensor, g: torch.Tensor, fp: FusedParams,
                      want_wgrad: bool = True, bf16: bool = True
                      ) -> Tuple[torch.Tensor, Optional[FusedParams]]:
    """Plain PyTorch version of K3 (same rounding points)."""
    _dot = _make_dot(bf16)
    with torch.no_grad():
        h1, h2, feat, sdf, hc, rgb = decoder_fwd_plain(x, fp, bf16)
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
    if g is not None and g.shape != (N, 4):
        raise ValueError(f"g shape {tuple(g.shape)} != ({N}, 4)")
    for t in (x, *([] if g is None else [g]), *fp):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("decoder kernel inputs must be f32 on one device")
        if not t.is_contiguous():
            raise ValueError("decoder kernel inputs must be contiguous")
    for t in (x, *([] if g is None else [g])):
        if t.data_ptr() % 16:
            raise ValueError("decoder kernel rows are read as float4: x and "
                             "g must start 16-byte aligned")


def forward_grid(n_rows: int, sms: int) -> int:
    """Blocks of K2 (and K1, which has the same block shape) for ``n_rows``
    rows: a persistent block of two warpgroups, each walking its own 64-row
    tiles (tile = 2 * block + warpgroup, stride 2 * blocks), so
    ``min(ceil(tiles / 2), sms)``: at most one block per SM and none
    without a tile. No rows: 0, nothing to launch."""
    ntiles = -(-n_rows // TILE_ROWS)
    return min(-(-ntiles // 2), sms)


def forward_f32_grid(n_rows: int, sms: int) -> int:
    """Blocks of K2-f32 for ``n_rows`` rows: persistent blocks of 256
    threads, block b taking the 64-row tiles b, b + blocks, ..., so
    ``min(tiles, sms)``. No rows: 0, nothing to launch."""
    return min(-(-n_rows // TILE_ROWS), sms)


def backward_partition(n_rows: int, sms: int) -> Tuple[int, int]:
    """K3's split of ``n_rows`` rows over its blocks -> (blocks,
    tiles_per_block). Block b takes the 64-row tiles [b * tiles_per_block,
    (b + 1) * tiles_per_block) (the last block fewer); each block owns one
    slab of partial weight gradients, so there are at most ``sms`` blocks
    (one per SM) and no empty one. No rows: (0, 0), nothing to launch."""
    ntiles = -(-n_rows // TILE_ROWS)
    if ntiles == 0:
        return 0, 0
    per_block = -(-ntiles // max(1, min(sms, ntiles)))
    return -(-ntiles // per_block), per_block


def _kernel_device(x: torch.Tensor, what: str) -> bool:
    """True when ``x`` is a CUDA tensor (a kernel runs); False on the CPU
    (the plain version's device); raises on anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def decoder_fwd(x: torch.Tensor, fp: FusedParams,
                bf16: bool = True) -> torch.Tensor:
    """K2, the decoder forward (N, D) -> (N, 4) [r, g, b, sdf]: on CUDA
    tensors the kernel of the operand type (``decoder_forward``, or
    ``decoder_forward_f32`` for ``bf16=False``), on CPU tensors the plain
    version."""
    if not _kernel_device(x, "decoder_fwd"):
        _, _, _, sdf, _, rgb = decoder_fwd_plain(x, fp, bf16)
        return torch.cat([rgb, sdf], dim=1)
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    x = x.detach().contiguous()
    _check_kernel_inputs(x, None, fp)
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    if N > 0:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        args = (x.data_ptr(), build.pointer_array(fp), out.data_ptr(), N)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            err = build.load("mlp_kernel", _bind).decoder_forward(
                *args, forward_grid(N, sms), stream)
            build.check(err, "decoder_forward")
            decoder_fwd.launches += 1
        else:
            err = build.load("mlp_kernel_f32", _bind_f32).decoder_forward_f32(
                *args, forward_f32_grid(N, sms), stream)
            build.check(err, "decoder_forward_f32")
            decoder_fwd_f32.launches += 1
    return out


decoder_fwd.launches = 0
# K2-f32's launch count (``decoder_fwd`` with ``bf16=False`` launches it)
decoder_fwd_f32 = SimpleNamespace(launches=0)


def decoder_bwd(x: torch.Tensor, g: torch.Tensor, fp: FusedParams,
                want_wgrad: bool = True, bf16: bool = True
                ) -> Tuple[torch.Tensor, Optional[FusedParams]]:
    """K3, the decoder backward: on CUDA tensors the kernel of the operand
    type (``decoder_backward``, or ``decoder_backward_f32`` for
    ``bf16=False``), on CPU tensors the plain version.
    ``want_wgrad=False`` skips the parameter gradients (tracking
    differentiates the pose only)."""
    if not _kernel_device(x, "decoder_bwd"):
        return decoder_bwd_plain(x, g, fp, want_wgrad, bf16)
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    x, g = x.detach().contiguous(), g.detach().contiguous()
    _check_kernel_inputs(x, g, fp)
    N = x.shape[0]
    nparam = sum(t.numel() for t in fp)
    dx = torch.empty_like(x)
    dflat = torch.zeros((nparam if want_wgrad else 0,), device=x.device)
    if N > 0:
        blocks, per_block = backward_partition(
            N, torch.cuda.get_device_properties(x.device).multi_processor_count)
        partial = torch.empty(((blocks if want_wgrad else 0) * nparam,),
                              device=x.device)
        args = (x.data_ptr(), g.data_ptr(), build.pointer_array(fp),
                dx.data_ptr(), dflat.data_ptr(), partial.data_ptr(), N,
                blocks, per_block, int(want_wgrad),
                torch.cuda.current_stream(x.device).cuda_stream)
        if bf16:
            err = build.load("mlp_kernel", _bind).decoder_backward(*args)
            build.check(err, "decoder_backward")
            decoder_bwd.launches += 1
        else:
            err = build.load("mlp_kernel_f32",
                             _bind_f32).decoder_backward_f32(*args)
            build.check(err, "decoder_backward_f32")
            decoder_bwd_f32.launches += 1
    if not want_wgrad:
        return dx, None
    parts, off = [], 0
    for t in fp:
        parts.append(dflat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return dx, FusedParams(*parts)


decoder_bwd.launches = 0
# K3-f32's launch count (``decoder_bwd`` with ``bf16=False`` launches it)
decoder_bwd_f32 = SimpleNamespace(launches=0)


def _argtypes(lib, fwd: str, bwd: str) -> None:
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    getattr(lib, fwd).argtypes = [p, p, p, ll, i, p]
    getattr(lib, fwd).restype = i
    getattr(lib, bwd).argtypes = [p, p, p, p, p, p, ll, i, i, i, p]
    getattr(lib, bwd).restype = i


def _bind(lib) -> None:
    _argtypes(lib, "decoder_forward", "decoder_backward")


def _bind_f32(lib) -> None:
    _argtypes(lib, "decoder_forward_f32", "decoder_backward_f32")


class FusedDecoder(torch.autograd.Function):
    """Decoder forward through K2 with a K3 backward (the JAX package's
    ``fused_decoder`` custom VJP). Differentiable w.r.t. ``x`` and the 11
    packed params; K3 skips its weight-gradient pass when no param needs a
    gradient."""

    @staticmethod
    def forward(ctx, x, bf16, *fp):
        fp = FusedParams(*fp)
        ctx.save_for_backward(x, *fp)
        ctx.bf16 = bf16
        return decoder_fwd(x, fp, bf16)

    @staticmethod
    def backward(ctx, g):
        x, *fp = ctx.saved_tensors
        want_wgrad = any(ctx.needs_input_grad[2:])
        dx, dfp = decoder_bwd(x, g.contiguous(), FusedParams(*fp),
                              want_wgrad, ctx.bf16)
        grads_fp = tuple(dfp) if want_wgrad else (None,) * 11
        return (dx if ctx.needs_input_grad[0] else None, None, *grads_fp)


def fused_applicable(dec: DecoderSettings) -> bool:
    """True when the fused decoder kernels take the architecture (the device
    of the tensors then chooses kernel or plain version)."""
    return (dec.use_fused_mlp and dec.depth == 2 and not dec.skips
            and dec.embedder == "none")


def decoder_values_fused(params: dict, dec: DecoderSettings,
                         x: torch.Tensor) -> torch.Tensor:
    """``models.decoder.decoder_values`` through K2/K3: (N, in_dim) ->
    (N, 4) [r, g, b, sdf]; gradients reach ``x`` and the dict ``params``.
    No padding: the kernels mask their last tile."""
    fp = pack_params(params, dec)
    return FusedDecoder.apply(x.contiguous(), dec.matmul_dtype == "bf16",
                              *fp)
