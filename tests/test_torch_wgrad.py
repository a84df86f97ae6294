"""K3's and K3-f32's weight gradients in two passes, on the CPU: the plain
versions of pass 1's stored operands (``decoder_bwd_operands_plain``, bf16
for K3, f32 for K3-f32) and of pass 2 with its reduce
(``decoder_wgrad_plain``) against the form's plain version
``decoder_bwd_plain`` (1e-5 of each output's largest magnitude: f32 sum
order only) and against the JAX package's Pallas ``_run_bwd(...,
bf16=True|False)`` in interpret mode (1e-3 for bf16, 1e-5 for f32: the K3
and K3-f32 parity cases' tolerances in ``tests/test_torch_mlp_kernel.py``);
chunk and split invariance (1e-6); the scratch layouts (``pack_operands``:
K3's 64-row bf16 tiles, K3-f32's f32 tiles of 64, 32 or 16 rows) and the
reduce's mapping (``wgrad_reduce`` on CPU tensors, its plain version)
through the wrappers' CPU path (``decoder_wgrad``, ``decoder_wgrad_f32``);
and the planning functions ``wgrad_plan``, ``wgrad_splits`` and
``wgrad_scratch_bytes`` for both operand types. Inputs are made with numpy
from a seed. The f32 cases carry ``-f32`` in their ids:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_wgrad.py -q
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_wgrad.py -q -k f32
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.config import DecoderSettings
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops.pallas import mlp_kernel as jmk
from proudslam_tpu_torch.models.decoder import params_from_jax
from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk

from torch_parity import SIZED_DEC, assert_close_scaled, port, t

# the kernel parity sizes and one no kernel is built for (run padded on
# the card)
SIZES = {k: SIZED_DEC[k] for k in ("16x64x64", "32x64x64", "16x256x128")}
SIZES["16x100x72"] = DecoderSettings(depth=2, width=100, in_dim=16,
                                     sdf_dim=72, matmul_dtype="bf16",
                                     use_fused_mlp=True)
LARGE = ("w1", "w2", "ws", "wc_f", "wc_x")
# each size with bf16 operands (K3; ids as the sizes) and f32 ones (K3-f32)
CASES = [(k, True) for k in SIZES] + [(k, False) for k in SIZES]
# the Pallas kernel's parity tolerance for each operand type
JAX_TOL = {True: 1e-3, False: 1e-5}


@pytest.fixture(scope="module", params=CASES,
                ids=[k if bf16 else f"{k}-f32" for k, bf16 in CASES])
def case(request):
    """(size, JAX packed params, port packed params, x, g, bf16) at a size
    and operand type."""
    key, bf16 = request.param
    dec = SIZES[key]
    params = j_init(jax.random.PRNGKey(0), dec)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((jmk.TILE, dec.in_dim)).astype(np.float32)
    g = rng.standard_normal((jmk.TILE, 4)).astype(np.float32)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))
    return ((dec.in_dim, dec.width, dec.sdf_dim),
            jmk.pack_params(params, dec), fp, x, g, bf16)


def _cap(size, rows, bf16):
    """Scratch bytes of ``rows`` rows in the operand type's layout."""
    return tmk.wgrad_scratch_bytes(size, rows,
                                   tmk.wgrad_tile_rows(size, bf16), bf16)


def _large(grads, sd):
    """The five large gradients of a FusedParams, ws's feature columns."""
    return (grads.w1, grads.w2, grads.ws[:, :sd], grads.wc_f, grads.wc_x)


def test_two_passes_give_k3s_gradients(case):
    """Pass 1's operands and pass 2's sums (several chunks and splits)
    give decoder_bwd_plain's five large gradients up to the f32 sum order,
    and the Pallas kernel's at its parity tolerance, for either operand
    type."""
    size, jfp, fp, x, g, bf16 = case
    ops = tmk.decoder_bwd_operands_plain(t(x), t(g), fp, bf16)
    plan = tmk.wgrad_plan(size, len(x), 13, cap=_cap(size, 700, bf16),
                          bf16=bf16)
    assert (len(tmk.wgrad_chunks(plan, size, len(x), bf16)) > 1
            and plan.splits > 1)
    got = tmk.decoder_wgrad_plain(ops, size, plan)
    _, grads = tmk.decoder_bwd_plain(t(x), t(g), fp, bf16=bf16)
    outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp,
                        interpret=True, bf16=bf16)
    j = dict(zip(jmk.FusedParams._fields, outs[1:]))
    for name, a, b in zip(LARGE, got, _large(grads, size[2])):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, 1e-5, name)
        ref = j[name][:, :size[2]] if name == "ws" else j[name]
        assert_close_scaled(a, ref, JAX_TOL[bf16], name)


def test_chunks_and_splits_sum_alike(case):
    """One chunk and one split against several chunks and splits: the same
    sums in another order, within 1e-6 of each output's largest
    magnitude."""
    size, _, fp, x, g, bf16 = case
    ops = tmk.decoder_bwd_operands_plain(t(x), t(g), fp, bf16)
    one = tmk.decoder_wgrad_plain(ops, size)
    for cap_rows, sms in ((64, 1), (640, 40), (1000, 132)):
        plan = tmk.wgrad_plan(size, len(x), sms,
                              cap=_cap(size, cap_rows, bf16), bf16=bf16)
        many = tmk.decoder_wgrad_plain(ops, size, plan)
        for name, a, b in zip(LARGE, many, one):
            assert_close_scaled(a, b, 1e-6, name)


def test_wrappers_on_the_cpu_give_all_gradients(case):
    """The kernels' contract through the wrappers' CPU path: the operands
    packed as pass 1 stores them, pass 2 chunk by chunk into the
    partials, and the reduce with two slabs of the small gradients give
    all 11 of decoder_bwd_plain's gradients (1e-5; at the built size that
    covers the decoder's, zero-padded, as on the card; K3-f32's scratch in
    that size's tiles); no kernel launches."""
    size, _, fp, x, g, bf16 = case
    # a size no kernel is built for runs zero-padded, as on the card
    built = tmk.built_size(size)
    _, want = tmk.decoder_bwd_plain(t(x), t(g), fp, bf16=bf16)
    x, fp = tmk.pad_rows(t(x), built[0]), tmk.pad_params(fp, built)
    size = built
    d, w, sd = size
    _, grads = tmk.decoder_bwd_plain(x, t(g), fp, bf16=bf16)
    ops = tmk.decoder_bwd_operands_plain(x, t(g), fp, bf16)
    plan = tmk.wgrad_plan(size, len(x), 24, cap=_cap(size, 900, bf16),
                          bf16=bf16)
    npart = tmk.wgrad_part_floats(size)
    tile_rows = tmk.wgrad_tile_rows(size, bf16)
    pass2 = tmk.decoder_wgrad if bf16 else tmk.decoder_wgrad_f32
    parts = []
    before = pass2.launches
    for r0, rows, splits, per in tmk.wgrad_chunks(plan, size, len(x), bf16):
        scratch = tmk.pack_operands(
            tmk.WgradOperands(*[o[r0:r0 + rows] for o in ops]), tile_rows,
            bf16)
        assert scratch.numel() * scratch.element_size() == _cap(size, rows,
                                                                bf16)
        part = torch.empty(splits * npart)
        pass2(scratch, size, rows, splits, per, part)
        parts.append(part)
    assert pass2.launches == before
    lay = tmk.small_grad_layout(size)
    slab = torch.zeros(lay["n"])
    for name, k in (("b1", w), ("b2", w), ("bs", sd + 1), ("bc", w),
                    ("bo", 3)):
        slab[lay[name]:lay[name] + k] = getattr(grads, name)[0]
    slab[lay["wo"]:lay["wo"] + 3 * w] = grads.wo.flatten()
    slab[lay["ws_sdf"]:lay["ws_sdf"] + w] = grads.ws[:, sd]
    parts = torch.cat(parts)
    dflat = torch.empty(sum(p.numel() for p in fp))
    tmk.wgrad_reduce(parts, parts.numel() // npart,
                     torch.cat([0.25 * slab, 0.75 * slab]), 2, size, dflat)
    parts, off = [], 0
    for ref in grads:
        parts.append(dflat[off:off + ref.numel()].view(ref.shape))
        off += ref.numel()
    got = tmk.unpad_params(tmk.FusedParams(*parts), case[0])
    for name, a, b in zip(tmk.FusedParams._fields, got, want):
        assert_close_scaled(a, b, 1e-5, name)


@pytest.mark.parametrize("size", [(16, 64, 64), (32, 128, 64),
                                  (128, 256, 128)])
def test_scratch_layout(size):
    """pack_operands writes the 64-row tiles in order, each holding the
    operands' tiles one after the other in the kernels' tile layout
    (decoder_tc.cuh: element (r, c) at ((r // 8) * (cols // 8) + c // 8) *
    64 + (r % 8) * 8 + c % 8); unpack_operands inverts it exactly."""
    rng = np.random.default_rng(3)
    rows = 150
    cols = (size[0], *(size[1],) * 2, size[2], size[1], size[2],
            *(size[1],) * 2)
    ops = tmk.WgradOperands(*[
        t(rng.standard_normal((rows, c)).astype(np.float32)).bfloat16()
        .float() for c in cols])
    scratch = tmk.pack_operands(ops)
    assert scratch.dtype == torch.bfloat16
    assert scratch.numel() * 2 == tmk.wgrad_scratch_bytes(size, rows)
    back = tmk.unpack_operands(scratch, size, rows)
    assert all(torch.equal(a, b) for a, b in zip(ops, back))
    base = 64 * sum(cols[:3])                   # feat follows x, h1, h2
    for r, c in ((0, 0), (9, 17), (70, 63), (149, 5)):
        tile, rr = divmod(r, 64)
        at = (tile * 64 * sum(cols) + base
              + ((rr // 8) * (size[2] // 8) + c // 8) * 64 + (rr % 8) * 8
              + c % 8)
        assert scratch[at].float() == ops.feat[r, c]
    # the last tile's missing rows are zeros
    assert float(scratch[-1]) == 0.0


@pytest.mark.parametrize("size,tiles", [((16, 128, 128), 5),
                                        ((16, 256, 128), 9),
                                        ((16, 1024, 1024), 112),
                                        ((128, 512, 512), 32)])
def test_output_tiles(size, tiles):
    assert tmk.wgrad_tiles(size) == tiles
    d, w, sd = size
    assert tmk.wgrad_part_floats(size) == w * w + 2 * w * sd + 2 * w * d


PLAN_SIZES = [(16, 128, 128), (16, 1024, 1024), (64, 192, 64)]
PLAN_ROWS = [0, 1, 63, 64, 65, 4096, 65499, 327643, 327680]
PLAN_CAPS = [(132, tmk.WGRAD_SCRATCH_CAP), (132, 24 << 20), (7, 1 << 20),
             (1, 1)]


def _check_plan(size, n_rows, sms, cap, bf16):
    plan = tmk.wgrad_plan(size, n_rows, sms, cap=cap, bf16=bf16)
    chunks = tmk.wgrad_chunks(plan, size, n_rows, bf16)
    if n_rows == 0:
        assert plan[:4] == (0, 0, 0, 0) and chunks == []
        return
    assert plan.tiles == tmk.wgrad_tiles(size, bf16)
    one_tile = _cap(size, 64, bf16)
    assert _cap(size, plan.chunk_rows, bf16) <= max(cap, one_tile)
    assert chunks[0][0] == 0
    assert sum(rows for _, rows, _, _ in chunks) == n_rows
    for (r0, rows, splits, per), nxt in zip(chunks, chunks[1:] + [None]):
        if nxt is not None:
            assert nxt[0] == r0 + rows and rows % 64 == 0
        ntiles = -(-rows // 64)
        assert (splits - 1) * per < ntiles <= splits * per
        if ntiles >= -(-sms // plan.tiles):
            assert plan.tiles * splits >= sms
    assert (plan.splits, plan.per_split) == chunks[0][2:]


@pytest.mark.parametrize("size", PLAN_SIZES)
@pytest.mark.parametrize("n_rows", PLAN_ROWS)
@pytest.mark.parametrize("sms,cap", PLAN_CAPS)
def test_wgrad_plan(size, n_rows, sms, cap):
    """Chunks cover the rows exactly once, in whole 64-row tiles but the
    last, with the scratch at or under its cap (one tile at the least);
    no split is empty; output tiles x splits >= the SMs where a chunk has
    the row tiles for it; no rows plans nothing."""
    _check_plan(size, n_rows, sms, cap, True)


@pytest.mark.parametrize("size", PLAN_SIZES)
@pytest.mark.parametrize("n_rows", PLAN_ROWS)
@pytest.mark.parametrize("sms,cap", PLAN_CAPS)
def test_wgrad_plan_f32(size, n_rows, sms, cap):
    """The same invariants for K3-f32's plan: its scratch in f32 tiles of
    its plan's height, its output tiles of 128 x 128."""
    _check_plan(size, n_rows, sms, cap, False)


@pytest.mark.parametrize("rows", [1, 64, 65, 327680])
def test_scratch_bytes(rows):
    """Two bytes per stored value: x, h1, h2, feat, dhc, dfeat, dh2, dh1
    over the rows rounded up to whole tiles."""
    d, w, sd = 16, 128, 128
    assert tmk.wgrad_scratch_bytes((d, w, sd), rows) == (
        2 * -(-rows // 64) * 64 * (d + 5 * w + 2 * sd))


@pytest.mark.parametrize("size,rows,nbytes", [
    ((16, 128, 128), 1, 4 * 68 * 912),
    ((16, 128, 128), 65, 2 * 4 * 68 * 912),
    ((16, 128, 128), 327680, 1_270_087_680),
    ((16, 1024, 1024), 17, 2 * 4 * 20 * 7184),
    ((16, 1024, 1024), 327680, 11_770_265_600)])
def test_f32_scratch_bytes(size, rows, nbytes):
    """Four bytes per stored value of K3-f32: the eight operands' columns
    (912 at (16, 128, 128), 7,184 at (16, 1024, 1024)) at row stride tile
    rows + 4, over the rows rounded up to whole tiles of the plan's
    height (64 at (16, 128, 128), 16 at the wide and parked sizes)."""
    assert tmk.wgrad_tile_rows(size, False) == (64 if size[1] == 128
                                                else 16)
    assert tmk.wgrad_scratch_bytes(size, rows,
                                   tmk.wgrad_tile_rows(size, False),
                                   bf16=False) == nbytes


def test_f32_tile_rows():
    """K3-f32's stored tiles have its plan's height: 64 rows at (16, 128,
    128), 32 at the streamed sizes up to width 512, 16 above; K3's 64."""
    for size in tmk.BUILT_SIZES:
        assert tmk.wgrad_tile_rows(size) == 64
        want = (64 if size == (16, 128, 128)
                else 16 if size[1] > 512 else 32)
        assert tmk.wgrad_tile_rows(size, False) == want
    with pytest.raises(ValueError):
        tmk.wgrad_scratch_bytes((16, 64, 64), 10, 32)      # bf16: 64 rows
    with pytest.raises(ValueError):
        tmk.wgrad_scratch_bytes((16, 64, 64), 10, 24, bf16=False)


def _f32_operands(rng, size, rows):
    cols = (size[0], *(size[1],) * 2, size[2], size[1], size[2],
            *(size[1],) * 2)
    return cols, tmk.WgradOperands(*[
        t(rng.standard_normal((rows, c)).astype(np.float32)) for c in cols])


@pytest.mark.parametrize("size", [(16, 384, 128), (128, 512, 256)])
def test_f32_wide_scratch_round_trip(size):
    """At widths 384 and 512 K3-f32 stores 32-row f32 tiles: on 150 rows
    (five tiles, the last ragged) the scratch holds 5 x 36 floats a column
    of the eight operands, as wgrad_scratch_bytes counts, and
    unpack_operands inverts pack_operands exactly."""
    rows = tmk.wgrad_tile_rows(size, False)
    assert rows == 32
    cols, ops = _f32_operands(np.random.default_rng(5), size, 150)
    scratch = tmk.pack_operands(ops, rows, bf16=False)
    assert scratch.numel() * 4 == tmk.wgrad_scratch_bytes(
        size, 150, rows, False) == 4 * 5 * 36 * sum(cols)
    back = tmk.unpack_operands(scratch, size, 150, rows, bf16=False)
    assert all(torch.equal(a, b) for a, b in zip(ops, back))


def test_f32_wide_passes_plain():
    """K3-f32's two passes at (16, 384, 128) in its 32-row tiles, on 333
    rows (no multiple of 32): the plain operands of pass 1
    (``decoder_bwd_operands_plain``) through the scratch and back, pass
    2's plain version (``decoder_wgrad_plain``) over several chunks and
    splits, and the reduce's (``wgrad_reduce_plain``) with the small
    gradients in two slabs, give all 11 of ``decoder_bwd_plain``'s f32
    gradients within 1e-5 of each one's largest magnitude. Params and
    inputs from numpy with a seed."""
    size, n = (16, 384, 128), 333
    rng = np.random.default_rng(11)
    fp = tmk.FusedParams(*[
        t((rng.standard_normal(s) / (np.sqrt(s[0]) if s[0] > 1 else 10.0))
          .astype(np.float32)) for s in tmk.param_shapes(size)])
    x = t(rng.standard_normal((n, size[0])).astype(np.float32))
    g = t(rng.standard_normal((n, 4)).astype(np.float32))
    _, want = tmk.decoder_bwd_plain(x, g, fp, bf16=False)
    rows = tmk.wgrad_tile_rows(size, False)
    ops = tmk.unpack_operands(
        tmk.pack_operands(tmk.decoder_bwd_operands_plain(x, g, fp, False),
                          rows, bf16=False), size, n, rows, bf16=False)
    plan = tmk.wgrad_plan(size, n, 7, cap=_cap(size, 128, False),
                          bf16=False)
    assert len(tmk.wgrad_chunks(plan, size, n, False)) > 1
    large = dict(zip(("w1", "w2", "ws", "wc_f", "wc_x"),
                     tmk.decoder_wgrad_plain(ops, size, plan)))
    part = torch.cat([(large[name].T if name in ("w1", "wc_x")
                       else large[name]).flatten()
                      for name, *_ in tmk.wgrad_jobs(size)])
    lay = tmk.small_grad_layout(size)
    d, w, sd = size
    slab = torch.zeros(lay["n"])
    for name, k in (("b1", w), ("b2", w), ("bs", sd + 1), ("bc", w),
                    ("bo", 3)):
        slab[lay[name]:lay[name] + k] = getattr(want, name)[0]
    slab[lay["wo"]:lay["wo"] + 3 * w] = want.wo.flatten()
    slab[lay["ws_sdf"]:lay["ws_sdf"] + w] = want.ws[:, sd]
    got = tmk.wgrad_reduce_plain(part[None],
                                 torch.stack([0.25 * slab, 0.75 * slab]),
                                 size)
    for name, a, b in zip(tmk.FusedParams._fields, got, want):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, 1e-5, name)


@pytest.mark.parametrize("tile_rows", [64, 32, 16])
@pytest.mark.parametrize("size", [(16, 64, 64), (32, 128, 64)])
def test_f32_scratch_layout(size, tile_rows):
    """pack_operands with f32 operands writes the tiles of ``tile_rows``
    rows in order, each holding the operands' tiles one after the other,
    feature-major (element (r, c) of a tile at c * (tile_rows + 4) + r,
    the padding zero), the values unrounded; the last tile ragged (150
    rows) and zero past the rows; unpack_operands inverts it exactly."""
    rng = np.random.default_rng(4)
    rows = 150
    cols = (size[0], *(size[1],) * 2, size[2], size[1], size[2],
            *(size[1],) * 2)
    ops = tmk.WgradOperands(*[
        t(rng.standard_normal((rows, c)).astype(np.float32)) for c in cols])
    scratch = tmk.pack_operands(ops, tile_rows, bf16=False)
    assert scratch.dtype == torch.float32
    assert scratch.numel() * 4 == tmk.wgrad_scratch_bytes(size, rows,
                                                          tile_rows, False)
    back = tmk.unpack_operands(scratch, size, rows, tile_rows, bf16=False)
    assert all(torch.equal(a, b) for a, b in zip(ops, back))
    ld = tile_rows + 4
    base = ld * sum(cols[:4])                   # dhc follows x .. feat
    for r, c in ((0, 0), (9, 17), (70, 63), (149, 5)):
        tile, rr = divmod(r, tile_rows)
        at = tile * ld * sum(cols) + base + c * ld + rr
        assert scratch[at] == ops.dhc[r, c]
    # padding and the last tile's missing rows are zeros
    tiles = scratch.view(-1, ld)
    assert bool((tiles[:, tile_rows:] == 0).all())
    assert float(scratch[-1 - 4]) == 0.0


@pytest.mark.parametrize("size,tiles", [((16, 128, 128), 5),
                                        ((16, 256, 128), 12),
                                        ((16, 1024, 1024), 208),
                                        ((128, 512, 512), 56)])
def test_f32_output_tiles(size, tiles):
    """K3-f32's pass 2 takes output tiles of 128 x 128."""
    assert tmk.wgrad_tiles(size, bf16=False) == tiles


@pytest.mark.parametrize("size,chunks,splits", [((16, 128, 128), 1, 42),
                                                ((16, 1024, 1024), 3, 1)])
def test_f32_plan_at_the_mapping_shape(size, chunks, splits):
    """K3-f32's default plan on 327,680 rows and 132 SMs: chunks of at
    most WGRAD_F32_SCRATCH_CAP (4 GiB) of f32 operands, and enough splits
    that the output tiles weighted by their area fill the SMs (3.25 at
    (16, 128, 128): its three 128 x 128 tiles and two 128 x 16 ones)."""
    plan = tmk.wgrad_plan(size, 327680, 132, bf16=False)
    assert len(tmk.wgrad_chunks(plan, size, 327680, False)) == chunks
    assert plan.splits == splits
    assert tmk.wgrad_scratch_bytes(
        size, plan.chunk_rows, tmk.wgrad_tile_rows(size, False),
        bf16=False) <= tmk.WGRAD_F32_SCRATCH_CAP
    assert tmk.wgrad_fill((16, 128, 128), bf16=False) == 3.25
    assert tmk.wgrad_fill(size) == tmk.wgrad_tiles(size)
