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
``csrc/mlp_kernel.cu`` at the decoder size (16, 128, 128),
``csrc/mlp_stream.cu`` at the other sizes of :data:`BUILT_SIZES` up to width
256 and in_dim 64, ``csrc/mlp_wide.cu`` at widths 384 and 512 and at
in_dim 128 (:func:`wide_plan`) and ``csrc/mlp_park.cu`` at widths 768 and
1024 (:func:`parked`; bf16 operands on the tensor cores), ``bf16=False``
``csrc/mlp_kernel_f32.cu`` at (16, 128, 128) and ``csrc/mlp_stream_f32.cu``
at the other sizes of :data:`BUILT_SIZES` (f32 operands: the products on the
tensor cores as three TF32 products with f32 sums, "3xTF32", within f32
tolerance of the true f32 product, except K3-f32's forward recompute,
true f32 FMAs for its ReLU masks, and from width 384 K2-f32's h1
and h2 products, true f32 FMAs for its sdf column; the plain versions
compute true f32).
Any other size with in_dim <= 128 and width, sdf_dim <= 1024 runs the
kernels at :func:`built_size` on zero-padded inputs and params
(:func:`pad_params`), and the outputs and gradients are sliced back
(:func:`unpad_params`): exact, every padded hidden unit being 0. A larger
size raises (:func:`check_kernel_sizes` refuses a configuration before it
runs).
K3 runs in two passes on the card: the backward kernel of its plan (dx,
the small weight gradients, the bf16 operands of the large ones stored)
and ``csrc/mlp_wgrad.cu`` (the large weight gradients summed over long
runs of rows, :func:`decoder_wgrad`, and a fixed-order reduce), built once
for every size.
Each form counts its own launches (``decoder_fwd.launches`` and
``decoder_fwd_f32.launches``, ``decoder_bwd.launches`` and
``decoder_bwd_f32.launches``, a K3 call each; ``decoder_wgrad.launches``,
K3's second pass, a chunk of rows each). With bf16 operands the
plain versions round at the kernels' points: both operands of every
product are rounded to bf16, cotangents (``dzo``, ``dhc``, ``dso``,
``dh2``, ``dh1``) included, while bias gradients sum the unrounded f32
cotangents. (Autograd through a bf16-rounded forward would not round the
cotangents, so it is not this function.)
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch

from proudslam_tpu_torch.config import DecoderSettings
from proudslam_tpu_torch.ops.kernels import build

# rows of the kernels' tiles
TILE_ROWS = 64
# rows of the streamed f32 kernels' tiles (mlp_stream_f32.cu), whose four
# f32 activation tiles of width 256 fit a block only at this height, and
# at the widths above 256 (the `mma.sync` minimum)
STREAM_F32_ROWS = 32
WIDE_F32_ROWS = 16

# The decoder sizes (in_dim, width, sdf_dim) every CUDA kernel form is built
# for, one library per size (``build.size_flags``); chip_smoke.py's kernel
# phase holds every one against its plain version on the card: in_dim 16,
# 32 and 64 with width and sdf_dim multiples of 64 up to 256, then the wide
# sizes, width 384 or 512 with sdf_dim a multiple of 128 from 128 up;
# sdf_dim <= width. At (16, 128, 128) the weights stay in shared memory
# (render_kernel.cu, mlp_kernel.cu; mlp_kernel_f32.cu stages them through
# one buffer); every other size up to width 256 streams the large ones from
# L2 (render_stream.cu, mlp_stream.cu, mlp_stream_f32.cu), and the wide
# sizes stream all five (render_wide.cu, mlp_wide.cu; mlp_stream_f32.cu at
# WIDE_F32_ROWS-row tiles). At in_dim 64 the streamed K3 streams w1 and
# wc_x too, and K1 blends a sample's corners in passes where its whole row
# does not fit the gather buffer (render_gather.cuh). In_dim 128 is built
# at five sizes only (D128_SIZES), to which every in_dim from 65 up is
# padded; the bf16 forms run the wide plan there at every width
# (:func:`wide_plan`), which takes w1 and wc_x in chunks of 64 input rows.
# Widths 768 and 1024 are built at six sizes (PARK_SIZES), in_dim 16 and
# 128, to which every in_dim from 17 up is padded at those widths; there
# the activation tiles do not fit a block beside each other, and the
# kernels keep one (the bf16 forms, decoder_park.cuh) or as many as fit
# (the f32 forms) in shared memory and park the others in a per-block
# scratch in global memory (:func:`parked`).
BUILT_IN_DIMS = (16, 32, 64, 128)
WIDE_WIDTHS = (384, 512)
D128_SIZES = ((128, 128, 128), (128, 256, 128), (128, 256, 256),
              (128, 512, 256), (128, 512, 512))
PARK_SIZES = ((16, 768, 256), (16, 768, 768), (16, 1024, 512),
              (16, 1024, 1024), (128, 768, 768), (128, 1024, 1024))
BUILT_SIZES = (tuple((d, w, sd) for d in BUILT_IN_DIMS[:3]
                     for w in (64, 128, 192, 256)
                     for sd in (64, 128, 192, 256) if sd <= w)
               + tuple((d, w, sd) for d in BUILT_IN_DIMS[:3]
                       for w in WIDE_WIDTHS
                       for sd in (128, 256, 384, 512) if sd <= w)
               + D128_SIZES + PARK_SIZES)
# the CUDA kernel forms, as check_size names them
FORMS = ("K1", "K2", "K3", "K2-f32", "K3-f32")
# the largest in_dim and width (or sdf_dim) a built size covers: every
# kernel reads a row's inputs as in_dim / 16 chunks of 16 floats; 1024 is
# the widest plan built (decoder_park.cuh), the end of the sizes the port
# takes
MAX_IN_DIM, MAX_WIDTH = BUILT_IN_DIMS[-1], PARK_SIZES[-1][1]
# the parked plan's (TILE_ROWS, width) bf16 tiles a block parks in global
# memory (K3's four; K1 and K2 park one), and the most of the f32 forms'
# (WIDE_F32_ROWS, width) tiles that lie there (mlp_stream_f32.cu)
PARK_TILES, PARK_F32_TILES = 4, 3


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


# ---- K3's weight gradients in two passes ----
#
# On the card K3 runs as two kernels. Pass 1 (the backward kernel of each
# plan) computes dx, the six small gradients (the five bias sums and wo's,
# plus ws's sdf column) and stores the bf16 operands of the five large
# products (x, h1, h2, feat, dhc, dfeat, dh2, dh1) in a scratch; pass 2
# (``decoder_wgrad``, csrc/mlp_wgrad.cu) sums the five large products over
# long runs of rows in registers, split along the rows so that the card is
# full, and a fixed-order reduce (``wgrad_reduce``) sums the splits' partials
# and the pass-1 blocks' small-gradient slabs into the gradients. Rows go in
# chunks, so that the scratch stays under WGRAD_SCRATCH_CAP bytes.
#
# The scratch: the chunk's 64-row tiles in order, and within each the eight
# operands' (64, cols) bf16 tiles one after the other, each exactly as the
# kernels hold it in shared memory (decoder_tc.cuh's layout: 8 x 8 core
# matrices of 128 bytes, element (r, c) at ((r // 8) * (cols // 8) + c //
# 8) * 64 + (r % 8) * 8 + c % 8).

WGRAD_OPERANDS = ("x", "h1", "h2", "feat", "dhc", "dfeat", "dh2", "dh1")
# the most bytes of operands one chunk of rows stores
WGRAD_SCRATCH_CAP = 1 << 30
# pass 2's output tile: 128 x 256 (two warpgroups of m64n256), M x N
WGRAD_TILE = (128, 256)


class WgradOperands(NamedTuple):
    """Pass 1's operands of the five large weight-gradient products, (N,
    cols) f32 tensors holding bf16-rounded values."""
    x: torch.Tensor       # (N, in_dim)
    h1: torch.Tensor      # (N, width)
    h2: torch.Tensor      # (N, width)
    feat: torch.Tensor    # (N, sdf_dim)
    dhc: torch.Tensor     # (N, width)
    dfeat: torch.Tensor   # (N, sdf_dim)
    dh2: torch.Tensor     # (N, width)
    dh1: torch.Tensor     # (N, width)


class WgradPlan(NamedTuple):
    """Pass 2's split of ``n_rows`` rows (:func:`wgrad_plan`)."""
    chunk_rows: int    # rows a chunk takes (the last chunk the rest)
    tiles: int         # output tiles of the five products
    splits: int        # row splits of a full chunk
    per_split: int     # 64-row tiles a split of a full chunk sums
    sms: int           # the SMs the splits fill


def wgrad_jobs(size: Tuple[int, int, int]) -> Tuple[Tuple[str, str, str,
                                                          int, int], ...]:
    """The five large products of pass 2 in their order: (gradient, A, B,
    M, N), each summing A^T B (M x N) over the rows. dw1 and dwc_x, whose
    rows are in_dim, are computed transposed (dh1^T x, dhc^T x)."""
    d, w, sd = size
    return (("w2", "h1", "dh2", w, w), ("ws", "h2", "dfeat", w, sd),
            ("wc_f", "feat", "dhc", sd, w), ("wc_x", "dhc", "x", w, d),
            ("w1", "dh1", "x", w, d))


def wgrad_part_floats(size: Tuple[int, int, int]) -> int:
    """Floats of one split's partial sums: the five products' M x N blocks
    in :func:`wgrad_jobs` order, each row-major."""
    return sum(m * n for *_, m, n in wgrad_jobs(size))


def wgrad_tiles(size: Tuple[int, int, int]) -> int:
    """Pass 2's output tiles of WGRAD_TILE (the last of a row or column
    narrower)."""
    tm, tn = WGRAD_TILE
    return sum(-(-m // tm) * -(-n // tn) for *_, m, n in wgrad_jobs(size))


def _operand_cols(size: Tuple[int, int, int]) -> Tuple[int, ...]:
    d, w, sd = size
    return (d, w, w, sd, w, sd, w, w)


def wgrad_scratch_bytes(size: Tuple[int, int, int], rows: int) -> int:
    """Bytes of pass 1's operand scratch for a chunk of ``rows`` rows: the
    eight operands' bf16 tiles, the last tile whole."""
    return 2 * -(-rows // TILE_ROWS) * TILE_ROWS * sum(_operand_cols(size))


def wgrad_splits(size: Tuple[int, int, int], rows: int,
                 sms: int) -> Tuple[int, int]:
    """Pass 2's split of a chunk of ``rows`` rows -> (splits, 64-row tiles
    per split): enough splits that output tiles x splits >= ``sms`` where
    the chunk has the row tiles for it, each split a run of whole tiles,
    none empty. No rows: (0, 0)."""
    ntiles = -(-rows // TILE_ROWS)
    if ntiles == 0:
        return 0, 0
    want = -(-sms // wgrad_tiles(size))
    per = max(1, ntiles // want)
    return -(-ntiles // per), per


def wgrad_plan(size: Tuple[int, int, int], n_rows: int, sms: int,
               cap: int = WGRAD_SCRATCH_CAP) -> WgradPlan:
    """Pass 2's plan for ``n_rows`` rows: chunks of as many whole 64-row
    tiles as keep the scratch at or under ``cap`` bytes (at least one
    tile), as even as that allows (one chunk of all the rows if they
    fit), the output tiles, and a full chunk's splits. No rows: all 0."""
    if n_rows <= 0:
        return WgradPlan(0, 0, 0, 0, sms)
    ntiles = -(-n_rows // TILE_ROWS)
    fit = max(1, cap // wgrad_scratch_bytes(size, TILE_ROWS))
    chunks = -(-ntiles // fit)
    chunk_rows = (n_rows if chunks == 1
                  else -(-ntiles // chunks) * TILE_ROWS)
    return WgradPlan(chunk_rows, wgrad_tiles(size),
                     *wgrad_splits(size, chunk_rows, sms), sms)


def wgrad_chunks(plan: WgradPlan, size: Tuple[int, int, int],
                 n_rows: int):
    """The chunks of a plan for ``n_rows`` rows -> [(first row, rows,
    splits, tiles per split)]."""
    if plan.chunk_rows == 0:
        return []
    out = []
    for r in range(0, n_rows, plan.chunk_rows):
        rows = min(plan.chunk_rows, n_rows - r)
        out.append((r, rows, *wgrad_splits(size, rows, plan.sms)))
    return out


def small_grad_layout(size: Tuple[int, int, int]) -> dict:
    """Offsets of the six small gradients in a pass-1 block's f32 slab,
    and its size ("n"): b1, b2, bs (sdf_dim + 1, the sdf bias last), bc,
    wo (width x 3, row-major), bo, and ws's sdf column (width)."""
    _, w, sd = size
    return dict(b1=0, b2=w, bs=2 * w, bc=2 * w + sd + 1, wo=3 * w + sd + 1,
                bo=6 * w + sd + 1, ws_sdf=6 * w + sd + 4, n=7 * w + sd + 4)


def decoder_bwd_operands_plain(x: torch.Tensor, g: torch.Tensor,
                               fp: FusedParams) -> WgradOperands:
    """The operands pass 1 stores (bf16 operands, as K3 rounds them)."""
    with torch.no_grad():
        h1, h2, feat, _, hc, rgb = decoder_fwd_plain(x, fp)
        dzo = g[:, 0:3] * rgb * (1.0 - rgb)
        dhc = (_r(dzo) @ _r(fp.wo.T)) * (hc > 0)
        dfeat = _r(dhc) @ _r(fp.wc_f.T)
        dso = torch.cat([dfeat, g[:, 3:4]], dim=1)
        dh2 = (_r(dso) @ _r(fp.ws.T)) * (h2 > 0)
        dh1 = (_r(dh2) @ _r(fp.w2.T)) * (h1 > 0)
        return WgradOperands(*[_r(t) for t in (x, h1, h2, feat, dhc, dfeat,
                                                dh2, dh1)])


def _wgrad_parts_plain(ops: WgradOperands, size, splits: int,
                       per_split: int) -> torch.Tensor:
    """Pass 2 on one chunk's operands -> (splits, wgrad_part_floats)
    partial sums, split s summing the rows of tiles [s per_split, (s + 1)
    per_split) (f32 sums of the bf16 operands' products)."""
    parts = []
    for s in range(splits):
        rows = slice(s * per_split * TILE_ROWS,
                     (s + 1) * per_split * TILE_ROWS)
        parts.append(torch.cat([
            (getattr(ops, a)[rows].T @ getattr(ops, b)[rows]).flatten()
            for _, a, b, _, _ in wgrad_jobs(size)]))
    return torch.stack(parts) if parts else ops.x.new_zeros(
        (0, wgrad_part_floats(size)))


def decoder_wgrad_plain(ops: WgradOperands, size: Tuple[int, int, int],
                        plan: Optional[WgradPlan] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The plain version of pass 2 with its reduce: the five large weight
    gradients (w1, w2, ws's feature columns, wc_f, wc_x, in FusedParams'
    orientation) summed chunk by chunk and split by split in the kernels'
    order (``plan`` None: one chunk, one split)."""
    n = ops.x.shape[0]
    if plan is None:
        plan = wgrad_plan(size, n, 1, cap=wgrad_scratch_bytes(size, n))
    total = ops.x.new_zeros((wgrad_part_floats(size),))
    for r0, rows, splits, per in wgrad_chunks(plan, size, n):
        chunk = WgradOperands(*[t[r0:r0 + rows] for t in ops])
        for p in _wgrad_parts_plain(chunk, size, splits, per):
            total = total + p
    large = _split_large(total, size)
    return large["w1"], large["w2"], large["ws"], large["wc_f"], large["wc_x"]


def _split_large(total: torch.Tensor, size) -> dict:
    """One partial (or their sum) -> the five gradients by name, in
    FusedParams' orientation."""
    out, off = {}, 0
    for name, _, _, m, n in wgrad_jobs(size):
        block = total[off:off + m * n].view(m, n)
        out[name] = block.T if name in ("w1", "wc_x") else block
        off += m * n
    return out


def wgrad_reduce_plain(parts: torch.Tensor, slabs: torch.Tensor,
                       size: Tuple[int, int, int]) -> FusedParams:
    """The plain version of the reduce: ``parts`` (P, wgrad_part_floats)
    and ``slabs`` (S, small_grad_layout n) summed in order -> the 11
    gradients."""
    large = parts[0].clone() if len(parts) else parts.new_zeros(
        (wgrad_part_floats(size),))
    for p in parts[1:]:
        large = large + p
    lay = small_grad_layout(size)
    small = slabs[0].clone() if len(slabs) else slabs.new_zeros((lay["n"],))
    for s in slabs[1:]:
        small = small + s
    big = _split_large(large, size)
    _, w, sd = size

    def sm(name, k):
        return small[lay[name]:lay[name] + k]
    return FusedParams(
        w1=big["w1"], b1=sm("b1", w)[None], w2=big["w2"],
        b2=sm("b2", w)[None],
        ws=torch.cat([big["ws"], sm("ws_sdf", w)[:, None]], dim=1),
        bs=sm("bs", sd + 1)[None], wc_f=big["wc_f"], wc_x=big["wc_x"],
        bc=sm("bc", w)[None], wo=sm("wo", 3 * w).view(w, 3),
        bo=sm("bo", 3)[None])


def _tiles_of(t: torch.Tensor) -> torch.Tensor:
    """(N, cols) -> its 64-row tiles in the tile layout, (tiles, 64 cols)
    (the last tile zero-padded)."""
    n, c = t.shape
    nt = -(-n // TILE_ROWS)
    t = torch.nn.functional.pad(t, (0, 0, 0, nt * TILE_ROWS - n))
    return t.reshape(nt, 8, 8, c // 8, 8).permute(0, 1, 3, 2, 4).reshape(
        nt, -1)


def pack_operands(ops: WgradOperands) -> torch.Tensor:
    """Operands -> pass 1's scratch (bf16, flat), as pass 1 writes it."""
    return torch.cat([_tiles_of(t.to(torch.bfloat16)) for t in ops],
                     dim=1).reshape(-1)


def unpack_operands(scratch: torch.Tensor, size: Tuple[int, int, int],
                    rows: int) -> WgradOperands:
    """The inverse of :func:`pack_operands` for a chunk of ``rows`` rows
    (f32)."""
    nt = -(-rows // TILE_ROWS)
    cols = _operand_cols(size)
    tiles = scratch[:nt * TILE_ROWS * sum(cols)].reshape(nt, -1)
    out, off = [], 0
    for c in cols:
        t = tiles[:, off:off + TILE_ROWS * c].reshape(nt, 8, c // 8, 8, 8)
        out.append(t.permute(0, 1, 3, 2, 4).reshape(nt * TILE_ROWS, c)
                   [:rows].float())
        off += TILE_ROWS * c
    return WgradOperands(*out)


@functools.lru_cache(maxsize=16)
def param_shapes(size: Tuple[int, int, int]) -> FusedParams:
    """The 11 packed params' shapes at a decoder size."""
    d, w, sd = size
    return FusedParams(w1=(d, w), b1=(1, w), w2=(w, w), b2=(1, w),
                       ws=(w, sd + 1), bs=(1, sd + 1), wc_f=(sd, w),
                       wc_x=(d, w), bc=(1, w), wo=(w, 3), bo=(1, 3))


def params_size(fp: FusedParams) -> Tuple[int, int, int]:
    """The decoder size (in_dim, width, sdf_dim) of packed params; raises
    if the 11 shapes do not agree on one."""
    d, w = fp.w1.shape
    size = (d, w, fp.ws.shape[1] - 1)
    if tuple(t.shape for t in fp) != param_shapes(size):
        raise ValueError(f"decoder params of shapes "
                         f"{[tuple(t.shape) for t in fp]}: expected "
                         f"{list(param_shapes(size))}")
    return size


def forward_flops(size: Tuple[int, int, int]) -> int:
    """Multiply-adds x 2 of one row's decoder forward at ``size``."""
    d, w, sd = size
    return 2 * (d * w + w * w + w * (sd + 1) + (sd + d) * w + 3 * w)


def built_size(size: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The built size whose kernels run a decoder ``size`` (in_dim <= 128,
    1 <= width, sdf_dim <= 1024) on zero-padded params: of the sizes of
    :data:`BUILT_SIZES` at least as large on each axis, the one with the
    fewest forward flops a row. Up to in_dim 64 and width 512 that is the
    smallest on every axis (in_dim the smallest of 16, 32 and 64 that
    covers it, sdf_dim rounded up to a multiple of 64, width so rounded and
    at least that; a width above 256 rounded up to 384 or 512 and sdf_dim to
    a multiple of 128); above, one of the five :data:`D128_SIZES` or of the
    six :data:`PARK_SIZES`."""
    return _covering(*size)


@functools.lru_cache(maxsize=256)
def _covering(d: int, w: int, sd: int) -> Tuple[int, int, int]:
    return min((b for b in BUILT_SIZES
                if b[0] >= d and b[1] >= w and b[2] >= sd),
               key=forward_flops)


def wide(size: Tuple[int, int, int]) -> bool:
    """True at the built sizes of width 384 and 512 (the bf16 forms' wide
    plan, the f32 forms' 16-row tiles)."""
    return size[1] > 256


def wide_plan(size: Tuple[int, int, int]) -> bool:
    """True where the bf16 forms pack all five weights in chunks of the
    wide plan (decoder_wide.cuh): at the :func:`wide` sizes and at in_dim
    128, where the streamed plan's K1 and K2 would spill at width 256; the
    :func:`parked` sizes among them run decoder_park.cuh's kernels."""
    return wide(size) or size[0] > BUILT_IN_DIMS[2]


def parked(size: Tuple[int, int, int]) -> bool:
    """True at the built sizes of width 768 and 1024, where the kernels
    park activation tiles in global memory: the bf16 forms run the parked
    plan (decoder_park.cuh: one (64, width) tile in shared memory), the
    f32 forms keep as many of their 16-row tiles in shared memory as fit
    (mlp_stream_f32.cu)."""
    return size[1] > WIDE_WIDTHS[-1]


def check_size(size: Tuple[int, int, int], form: str) -> None:
    """Raises ``ValueError`` unless a built size covers the decoder ``size``
    (:func:`built_size`): in_dim <= 128 and width, sdf_dim <= 1024, each at
    least 1. Every form is built at :data:`BUILT_SIZES`; ``form`` (one of
    :data:`FORMS`) is named in the error. Larger decoders are refused: no
    configuration the port runs, nor a decoder the repo cites, is wider."""
    if form not in FORMS:
        raise ValueError(f"unknown CUDA kernel form {form!r}")
    d, w, sd = size
    if not (1 <= d <= MAX_IN_DIM and 1 <= w <= MAX_WIDTH
            and 1 <= sd <= MAX_WIDTH):
        raise ValueError(
            f"decoder size (in_dim, width, sdf_dim) = {tuple(size)}: the CUDA "
            f"kernel {form} takes in_dim <= {MAX_IN_DIM} and width, sdf_dim "
            f"<= {MAX_WIDTH} (built at {list(BUILT_SIZES)}, the others "
            "zero-padded to one of them)")


def pad_params(fp: FusedParams, built: Tuple[int, int, int]) -> FusedParams:
    """Packed params zero-padded to the larger decoder size ``built``: zero
    rows and columns in w1, b1, w2, b2, wc_f, wc_x, bc and wo, and in ws
    and bs ([feat | sdf]) zero feature columns before the sdf column. A
    padded hidden unit then has pre-activation exactly 0 (ReLU output and
    mask 0), and every padded weight meets a zero operand, so the real
    outputs and gradients get the same terms plus exact zeros and every
    padded gradient entry is exactly 0."""
    _, _, sd = params_size(fp)
    d_b, w_b, sd_b = built

    def put(t, shape):
        out = t.new_zeros(shape)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out

    ws = put(fp.ws[:, :sd], (w_b, sd_b + 1))
    ws[:fp.ws.shape[0], sd_b] = fp.ws[:, sd]
    bs = put(fp.bs[:, :sd], (1, sd_b + 1))
    bs[:, sd_b] = fp.bs[:, sd]
    return FusedParams(
        w1=put(fp.w1, (d_b, w_b)), b1=put(fp.b1, (1, w_b)),
        w2=put(fp.w2, (w_b, w_b)), b2=put(fp.b2, (1, w_b)), ws=ws, bs=bs,
        wc_f=put(fp.wc_f, (sd_b, w_b)), wc_x=put(fp.wc_x, (d_b, w_b)),
        bc=put(fp.bc, (1, w_b)), wo=put(fp.wo, (w_b, 3)), bo=fp.bo)


def unpad_params(fp: FusedParams, size: Tuple[int, int, int]) -> FusedParams:
    """The inverse of :func:`pad_params`: packed params (or their gradients)
    of a padded size sliced back to the decoder ``size`` (views)."""
    d, w, sd = size
    sd_b = fp.ws.shape[1] - 1
    return FusedParams(
        w1=fp.w1[:d, :w], b1=fp.b1[:, :w], w2=fp.w2[:w, :w], b2=fp.b2[:, :w],
        ws=torch.cat([fp.ws[:w, :sd], fp.ws[:w, sd_b:]], dim=1),
        bs=torch.cat([fp.bs[:, :sd], fp.bs[:, sd_b:]], dim=1),
        wc_f=fp.wc_f[:sd, :w], wc_x=fp.wc_x[:d, :w], bc=fp.bc[:, :w],
        wo=fp.wo[:w], bo=fp.bo)


def pad_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """Rows of decoder inputs with zero columns up to in_dim ``d``."""
    return torch.nn.functional.pad(x, (0, d - x.shape[1]))


def _check_kernel_inputs(x, g, fp, form) -> Tuple[int, int, int]:
    size = params_size(fp)
    check_size(size, form)
    N, D = x.shape
    if D != size[0]:
        raise ValueError(f"x {tuple(x.shape)}: in_dim {size[0]} expected")
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
    return size


def streamed(size: Tuple[int, int, int]) -> bool:
    """True where the kernels stream the large weights (every size but
    (16, 128, 128)): render_stream.cu and mlp_stream.cu (render_wide.cu and
    mlp_wide.cu at the :func:`wide` sizes, render_park.cu and mlp_park.cu
    at the :func:`parked` ones), which take a scratch buffer for
    the packed weights and one 64-row tile per block at a time, and
    mlp_stream_f32.cu (its own scratch, tiles of :func:`f32_tile_rows`)."""
    return tuple(size) != build.DEFAULT_SIZE


def f32_tile_rows(size: Tuple[int, int, int]) -> int:
    """Rows of mlp_stream_f32.cu's tiles at a streamed size."""
    return WIDE_F32_ROWS if wide(size) else STREAM_F32_ROWS


def bf16_source(base: str, size: Tuple[int, int, int]) -> str:
    """The source of a bf16 kernel (``base`` "render" or "mlp") at a
    streamed size: ``<base>_park`` where :func:`parked`, ``<base>_wide``
    where :func:`wide_plan`, else ``<base>_stream``."""
    if parked(size):
        return f"{base}_park"
    return f"{base}_wide" if wide_plan(size) else f"{base}_stream"


def packed_weights(size: Tuple[int, int, int], device) -> torch.Tensor:
    """Scratch for the streamed kernels' bf16 copy of w2, ws and wc_f; at
    in_dim 64 (for K3) and in the wide plan (:func:`wide_plan`) of all five
    weights, and in the wide plan then K3's park of two (64, width) bf16
    tiles for each of the device's SMs (one block per SM at most). In the
    parked plan (:func:`parked`) the weights are followed by the f32
    vectors (decoder_park.cuh's ``VEC_FLOATS``: ws's sdf column, wo padded
    to 4 columns, b1, b2, bc, bs and bo, 16-byte aligned) and then
    :data:`PARK_TILES` parked tiles a block."""
    d, w, sd = size
    n = w * w + 2 * w * sd
    if d > BUILT_IN_DIMS[1] or wide_plan(size):
        n += 2 * d * w
    if wide_plan(size):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        if parked(size):
            vec_floats = 8 * w + -(-(sd + 1) // 4) * 4 + 4
            n = (-(-n // 8) * 8 + 2 * vec_floats
                 + sms * PARK_TILES * TILE_ROWS * w)
        else:
            n += sms * 2 * TILE_ROWS * w
    return torch.empty((n,), dtype=torch.bfloat16, device=device)


def packed_f32_weights(size: Tuple[int, int, int], device) -> torch.Tensor:
    """Scratch for mlp_stream_f32.cu's packed chunks: w2, ws's feature part
    and wc_f, then their transposes, 16 rows a chunk (8 at the wide sizes)
    at row stride W + 4, and ws's sdf column; at in_dim 32 to 128 and at
    the wide sizes also w1 and wc_x, twice each (the forward's x-side
    products and dx); at the :func:`parked` sizes then
    :data:`PARK_F32_TILES` activation tiles (width x 20 floats) a block."""
    d, w, sd = size
    rows = 2 * (2 * w + sd) + (4 * d if d > BUILT_IN_DIMS[0] or wide(size)
                               else 0)
    n = rows * (w + 4) + w
    if parked(size):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n += sms * PARK_F32_TILES * w * (WIDE_F32_ROWS + 4)
    return torch.empty((n,), dtype=torch.float32, device=device)


def _bf16_library(size, device):
    """K2's and K3's library at ``size`` and its scratch tensors, passed as
    pointers after the params: the streamed plan's packed weights, none for
    the resident plan."""
    if streamed(size):
        return (build.load(bf16_source("mlp", size), _bind_stream, size),
                [packed_weights(size, device)])
    return build.load("mlp_kernel", _bind), []


def _f32_library(size, device):
    """K2-f32's and K3-f32's library at ``size`` and its scratch tensors,
    passed as pointers after the params: the streamed plan's packed
    weights, none for the resident plan (mlp_kernel_f32.cu)."""
    if streamed(size):
        return (build.load("mlp_stream_f32", _bind_stream_f32, size),
                [packed_f32_weights(size, device)])
    return build.load("mlp_kernel_f32", _bind_f32), []


def forward_grid(n_rows: int, sms: int, tiles_at_once: int = 2) -> int:
    """Blocks of K2 (and K1, which has the same block shape) for ``n_rows``
    rows: a persistent block of two warpgroups, each walking its own 64-row
    tiles (tile = 2 * block + warpgroup, stride 2 * blocks), so
    ``min(ceil(tiles / 2), sms)``: at most one block per SM and none
    without a tile. ``tiles_at_once=1``: the streamed plan's blocks, whose
    two warpgroups share one tile (tile = block, stride blocks). No rows:
    0, nothing to launch."""
    ntiles = -(-n_rows // TILE_ROWS)
    return min(-(-ntiles // tiles_at_once), sms)


def forward_f32_grid(n_rows: int, sms: int) -> int:
    """Blocks of K2-f32 for ``n_rows`` rows: persistent blocks of 256
    threads, block b taking the 64-row tiles b, b + blocks, ..., so
    ``min(tiles, sms)``. No rows: 0, nothing to launch."""
    return forward_grid(n_rows, sms, 1)


def forward_f32_stream_grid(n_rows: int, sms: int,
                            rows: int = STREAM_F32_ROWS) -> int:
    """Blocks of the streamed K2-f32 (mlp_stream_f32.cu) for ``n_rows``
    rows: persistent blocks, block b taking the ``rows``-row tiles b, b +
    blocks, ..., so ``min(tiles, sms)``. No rows: 0."""
    return min(-(-n_rows // rows), sms)


def _partition(n_rows: int, sms: int, tile_rows: int) -> Tuple[int, int]:
    ntiles = -(-n_rows // tile_rows)
    if ntiles == 0:
        return 0, 0
    per_block = -(-ntiles // max(1, min(sms, ntiles)))
    return -(-ntiles // per_block), per_block


def backward_partition(n_rows: int, sms: int) -> Tuple[int, int]:
    """K3's (pass 1's) split of ``n_rows`` rows over its blocks ->
    (blocks, tiles_per_block). Block b takes the 64-row tiles [b *
    tiles_per_block, (b + 1) * tiles_per_block) (the last block fewer);
    each block owns one slab of partial (small) weight gradients, so there
    are at most ``sms`` blocks (one per SM) and no empty one. No rows: (0,
    0), nothing to launch."""
    return _partition(n_rows, sms, TILE_ROWS)


def backward_f32_stream_partition(n_rows: int, sms: int,
                                  rows: int = STREAM_F32_ROWS
                                  ) -> Tuple[int, int]:
    """:func:`backward_partition` for the streamed K3-f32
    (mlp_stream_f32.cu), whose tiles have ``rows`` rows."""
    return _partition(n_rows, sms, rows)


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
    ``decoder_forward_f32`` for ``bf16=False``: 3xTF32 products on the
    tensor cores), on CPU tensors the plain version."""
    if not _kernel_device(x, "decoder_fwd"):
        _, _, _, sdf, _, rgb = decoder_fwd_plain(x, fp, bf16)
        return torch.cat([rgb, sdf], dim=1)
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    x = x.detach().contiguous()
    size = _check_kernel_inputs(x, None, fp, "K2" if bf16 else "K2-f32")
    built = built_size(size)
    if built != size:
        return decoder_fwd(pad_rows(x, built[0]), pad_params(fp, built), bf16)
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    if N > 0:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        args = (x.data_ptr(), build.pointer_array(fp), out.data_ptr(), N)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            lib, scratch = _bf16_library(size, x.device)
            err = lib.decoder_forward(
                *args[:2], *[t.data_ptr() for t in scratch], *args[2:],
                forward_grid(N, sms, 1 if scratch else 2), stream)
            build.check(err, "decoder_forward")
            decoder_fwd.launches += 1
        else:
            lib, scratch = _f32_library(size, x.device)
            err = lib.decoder_forward_f32(
                *args[:2], *[t.data_ptr() for t in scratch], *args[2:],
                forward_f32_stream_grid(N, sms, f32_tile_rows(size))
                if scratch else forward_f32_grid(N, sms), stream)
            build.check(err, "decoder_forward_f32")
            decoder_fwd_f32.launches += 1
    return out


decoder_fwd.launches = 0
# K2-f32's launch count (``decoder_fwd`` with ``bf16=False`` launches it)
decoder_fwd_f32 = SimpleNamespace(launches=0)


def decoder_bwd(x: torch.Tensor, g: torch.Tensor, fp: FusedParams,
                want_wgrad: bool = True, bf16: bool = True
                ) -> Tuple[torch.Tensor, Optional[FusedParams]]:
    """K3, the decoder backward: on CUDA tensors the kernels of the operand
    type (``decoder_backward``, pass 1, then per chunk of rows
    :func:`decoder_wgrad`, pass 2, and :func:`wgrad_reduce`; or
    ``decoder_backward_f32`` for ``bf16=False``: 3xTF32 products on the
    tensor cores, its weight gradients in per-block slabs), on CPU tensors
    the plain version.
    ``want_wgrad=False`` skips the parameter gradients (tracking
    differentiates the pose only): one pass-1 launch that stores
    nothing."""
    if not _kernel_device(x, "decoder_bwd"):
        return decoder_bwd_plain(x, g, fp, want_wgrad, bf16)
    fp = FusedParams(*[t.detach().contiguous() for t in fp])
    x, g = x.detach().contiguous(), g.detach().contiguous()
    size = _check_kernel_inputs(x, g, fp, "K3" if bf16 else "K3-f32")
    built = built_size(size)
    if built != size:
        dx, grads = decoder_bwd(pad_rows(x, built[0]), g,
                                pad_params(fp, built), want_wgrad, bf16)
        return (dx[:, :size[0]],
                None if grads is None else unpad_params(grads, size))
    N = x.shape[0]
    nparam = sum(t.numel() for t in fp)
    dx = torch.empty_like(x)
    # each form's reduce writes every gradient; no rows: zeros
    dflat = (torch.empty if N > 0 else torch.zeros)(
        (nparam if want_wgrad else 0,), device=x.device)
    if N > 0:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            _k3_bf16(x, g, fp, size, dx, dflat if want_wgrad else None, sms,
                     stream)
            decoder_bwd.launches += 1
        else:
            if streamed(size):
                blocks, per_block = backward_f32_stream_partition(
                    N, sms, f32_tile_rows(size))
            else:
                blocks, per_block = backward_partition(N, sms)
            partial = torch.empty(((blocks if want_wgrad else 0) * nparam,),
                                  device=x.device)
            args = (x.data_ptr(), g.data_ptr(), build.pointer_array(fp),
                    dx.data_ptr(), dflat.data_ptr(), partial.data_ptr(), N,
                    blocks, per_block, int(want_wgrad), stream)
            lib, scratch = _f32_library(size, x.device)
            err = lib.decoder_backward_f32(
                *args[:3], *[t.data_ptr() for t in scratch], *args[3:])
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


def _k3_bf16(x, g, fp, size, dx, dflat, sms: int, stream: int) -> None:
    """K3's launches on CUDA tensors at a built ``size``: pass 1 alone
    (dx-only, ``dflat`` None), or per chunk of rows (:func:`wgrad_plan`)
    pass 1 and pass 2, then the reduce into ``dflat``."""
    N = x.shape[0]
    # (the packed weights' tensors stay referenced until every launch is
    # queued: the scratch must not take their memory)
    lib, packed = _bf16_library(size, x.device)
    params = build.pointer_array(fp)
    wpack = [t.data_ptr() for t in packed]

    def pass1(r0, rows, slab, scratch):
        blocks, per_block = backward_partition(rows, sms)
        err = lib.decoder_backward(
            x[r0:].data_ptr(), g[r0:].data_ptr(), params, *wpack,
            dx[r0:].data_ptr(), slab, scratch, rows, blocks, per_block,
            int(dflat is not None), stream)
        build.check(err, "decoder_backward")
        return blocks

    if dflat is None:
        pass1(0, N, 0, 0)
        return
    plan = wgrad_plan(size, N, sms)
    chunks = wgrad_chunks(plan, size, N)
    nsmall, npart = small_grad_layout(size)["n"], wgrad_part_floats(size)
    scratch = torch.empty((wgrad_scratch_bytes(size, plan.chunk_rows) // 2,),
                          dtype=torch.bfloat16, device=x.device)
    slabs = torch.empty((sum(backward_partition(rows, sms)[0]
                             for _, rows, _, _ in chunks) * nsmall,),
                        device=x.device)
    parts = torch.empty((sum(c[2] for c in chunks) * npart,), device=x.device)
    nslabs = nparts = 0
    for r0, rows, splits, per in chunks:
        nslabs += pass1(r0, rows, slabs[nslabs * nsmall:].data_ptr(),
                        scratch.data_ptr())
        decoder_wgrad(scratch, size, rows, splits, per,
                      parts[nparts * npart:])
        nparts += splits
    wgrad_reduce(parts, nparts, slabs, nslabs, size, dflat)


def decoder_wgrad(scratch: torch.Tensor, size: Tuple[int, int, int],
                  rows: int, splits: int, per_split: int,
                  part: torch.Tensor) -> None:
    """K3's pass 2 on one chunk of ``rows`` rows whose operands pass 1
    stored in ``scratch`` (bf16; the layout :func:`pack_operands` writes):
    the five large products, ``splits`` splits of ``per_split`` 64-row
    tiles each (:func:`wgrad_splits`), each split's partial sums
    (:func:`wgrad_part_floats` floats) into ``part`` in split order. On
    CUDA tensors ``csrc/mlp_wgrad.cu``'s kernel (built once for every
    size), on CPU tensors the plain version."""
    npart = wgrad_part_floats(size)
    if part.dtype != torch.float32 or part.numel() < splits * npart:
        raise ValueError(f"decoder_wgrad: part needs {splits * npart} f32")
    if scratch.dtype != torch.bfloat16 or (
            scratch.numel() * 2 < wgrad_scratch_bytes(size, rows)):
        raise ValueError("decoder_wgrad: scratch too small")
    if not _kernel_device(scratch, "decoder_wgrad"):
        ops = unpack_operands(scratch, size, rows)
        part[:splits * npart] = _wgrad_parts_plain(
            ops, size, splits, per_split).flatten()
        return
    lib = build.load("mlp_wgrad", _bind_wgrad, None)
    err = lib.decoder_wgrad(scratch.data_ptr(), rows, *size, splits,
                            per_split, part.data_ptr(),
                            torch.cuda.current_stream(
                                scratch.device).cuda_stream)
    build.check(err, "decoder_wgrad")
    decoder_wgrad.launches += 1


decoder_wgrad.launches = 0


def wgrad_reduce(parts: torch.Tensor, nparts: int, slabs: torch.Tensor,
                 nslabs: int, size: Tuple[int, int, int],
                 dflat: torch.Tensor) -> None:
    """K3's fixed-order reduce: ``nparts`` partials of pass 2 and
    ``nslabs`` small-gradient slabs of pass 1 summed in their order into
    ``dflat``, the 11 gradients flat in FusedParams order. On CUDA tensors
    ``csrc/mlp_wgrad.cu``'s reduce kernel, on CPU tensors
    :func:`wgrad_reduce_plain`."""
    if not _kernel_device(dflat, "wgrad_reduce"):
        npart, nsmall = wgrad_part_floats(size), small_grad_layout(size)["n"]
        grads = wgrad_reduce_plain(
            parts[:nparts * npart].view(nparts, npart),
            slabs[:nslabs * nsmall].view(nslabs, nsmall), size)
        dflat.copy_(torch.cat([t.flatten() for t in grads]))
        return
    lib = build.load("mlp_wgrad", _bind_wgrad, None)
    err = lib.decoder_wgrad_reduce(
        parts.data_ptr(), nparts, slabs.data_ptr(), nslabs, *size,
        dflat.data_ptr(), torch.cuda.current_stream(dflat.device).cuda_stream)
    build.check(err, "decoder_wgrad_reduce")


def _argtypes(lib, fwd: str, bwd: str, wpack: bool = False) -> None:
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    w = [p] if wpack else []
    getattr(lib, fwd).argtypes = [p, p, *w, p, ll, i, p]
    getattr(lib, fwd).restype = i
    getattr(lib, bwd).argtypes = [p, p, p, *w, p, p, p, ll, i, i, i, p]
    getattr(lib, bwd).restype = i


def _bind(lib) -> None:
    _argtypes(lib, "decoder_forward", "decoder_backward")


def _bind_stream(lib) -> None:
    _argtypes(lib, "decoder_forward", "decoder_backward", wpack=True)


def _bind_f32(lib) -> None:
    _argtypes(lib, "decoder_forward_f32", "decoder_backward_f32")


def _bind_stream_f32(lib) -> None:
    _argtypes(lib, "decoder_forward_f32", "decoder_backward_f32", wpack=True)


def _bind_wgrad(lib) -> None:
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decoder_wgrad.argtypes = [p, ll, i, i, i, i, i, p, p]
    lib.decoder_wgrad.restype = i
    lib.decoder_wgrad_reduce.argtypes = [p, i, p, i, i, i, i, p, p]
    lib.decoder_wgrad_reduce.restype = i


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


def kernel_forms(dec: DecoderSettings, feature_mode: str) -> Tuple[str, ...]:
    """The CUDA kernel forms a configuration launches on the card: none
    unfused; K1 and K3 on the fused vox path (whatever ``matmul_dtype``
    says, as the TPU kernels); K2 and K3 on the fused pcd path, K2-f32 and
    K3-f32 there at f32 operands."""
    if not fused_applicable(dec):
        return ()
    if feature_mode != "pcd":
        return ("K1", "K3")
    return ("K2", "K3") if dec.matmul_dtype == "bf16" else ("K2-f32",
                                                            "K3-f32")


def check_kernel_sizes(dec: DecoderSettings, feature_mode: str) -> None:
    """Raises ``ValueError`` naming the size and the kernel form if a kernel
    the configuration launches on the card takes its decoder size neither
    as built nor zero-padded to a built size (:func:`check_size`). There is
    no fallback: a refused size is refused, not run without the kernel."""
    for form in kernel_forms(dec, feature_mode):
        check_size((dec.in_dim, dec.width, dec.sdf_dim), form)


def decoder_values_fused(params: dict, dec: DecoderSettings,
                         x: torch.Tensor) -> torch.Tensor:
    """``models.decoder.decoder_values`` through K2/K3: (N, in_dim) ->
    (N, 4) [r, g, b, sdf]; gradients reach ``x`` and the dict ``params``.
    No padding: the kernels mask their last tile."""
    fp = pack_params(params, dec)
    return FusedDecoder.apply(x.contiguous(), dec.matmul_dtype == "bf16",
                              *fp)
