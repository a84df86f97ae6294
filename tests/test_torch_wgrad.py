"""K3's weight gradients in two passes, on the CPU: the plain versions of
pass 1's stored operands (``decoder_bwd_operands_plain``) and of pass 2
with its reduce (``decoder_wgrad_plain``) against K3's plain version
``decoder_bwd_plain`` (1e-5 of each output's largest magnitude: f32 sum
order only) and against the JAX package's Pallas ``_run_bwd(...,
bf16=True)`` in interpret mode (1e-3, the K3 parity cases' tolerance in
``tests/test_torch_mlp_kernel.py``); chunk and split invariance (1e-6);
the scratch layout (``pack_operands``) and the reduce's mapping
(``wgrad_reduce`` on CPU tensors, its plain version) through the wrappers'
CPU path; and the planning functions ``wgrad_plan``, ``wgrad_splits`` and
``wgrad_scratch_bytes``. Inputs are made with numpy from a seed.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_wgrad.py -q
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


@pytest.fixture(scope="module", params=list(SIZES))
def case(request):
    """(size, JAX packed params, port packed params, x, g) at a size."""
    dec = SIZES[request.param]
    params = j_init(jax.random.PRNGKey(0), dec)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((jmk.TILE, dec.in_dim)).astype(np.float32)
    g = rng.standard_normal((jmk.TILE, 4)).astype(np.float32)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))
    return ((dec.in_dim, dec.width, dec.sdf_dim),
            jmk.pack_params(params, dec), fp, x, g)


def _large(grads, sd):
    """The five large gradients of a FusedParams, ws's feature columns."""
    return (grads.w1, grads.w2, grads.ws[:, :sd], grads.wc_f, grads.wc_x)


def test_two_passes_give_k3s_gradients(case):
    """Pass 1's operands and pass 2's sums (several chunks and splits)
    give decoder_bwd_plain's five large gradients up to the f32 sum order,
    and the Pallas kernel's at its parity tolerance."""
    size, jfp, fp, x, g = case
    ops = tmk.decoder_bwd_operands_plain(t(x), t(g), fp)
    plan = tmk.wgrad_plan(size, len(x), 13,
                          cap=tmk.wgrad_scratch_bytes(size, 700))
    assert len(tmk.wgrad_chunks(plan, size, len(x))) > 1 and plan.splits > 1
    got = tmk.decoder_wgrad_plain(ops, size, plan)
    _, grads = tmk.decoder_bwd_plain(t(x), t(g), fp)
    outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp,
                        interpret=True, bf16=True)
    j = dict(zip(jmk.FusedParams._fields, outs[1:]))
    for name, a, b in zip(LARGE, got, _large(grads, size[2])):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, 1e-5, name)
        ref = j[name][:, :size[2]] if name == "ws" else j[name]
        assert_close_scaled(a, ref, 1e-3, name)


def test_chunks_and_splits_sum_alike(case):
    """One chunk and one split against several chunks and splits: the same
    sums in another order, within 1e-6 of each output's largest
    magnitude."""
    size, _, fp, x, g = case
    ops = tmk.decoder_bwd_operands_plain(t(x), t(g), fp)
    one = tmk.decoder_wgrad_plain(ops, size)
    for cap_rows, sms in ((64, 1), (640, 40), (1000, 132)):
        plan = tmk.wgrad_plan(size, len(x), sms,
                              cap=tmk.wgrad_scratch_bytes(size, cap_rows))
        many = tmk.decoder_wgrad_plain(ops, size, plan)
        for name, a, b in zip(LARGE, many, one):
            assert_close_scaled(a, b, 1e-6, name)


def test_wrappers_on_the_cpu_give_all_gradients(case):
    """The kernels' contract through the wrappers' CPU path: the operands
    packed as pass 1 stores them, pass 2 chunk by chunk into the
    partials, and the reduce with two slabs of the small gradients give
    all 11 of decoder_bwd_plain's gradients (1e-5; at the built size that
    covers the decoder's, zero-padded, as on the card); no kernel
    launches."""
    size, _, fp, x, g = case
    # a size no kernel is built for runs zero-padded, as on the card
    built = tmk.built_size(size)
    _, want = tmk.decoder_bwd_plain(t(x), t(g), fp)
    x, fp = tmk.pad_rows(t(x), built[0]), tmk.pad_params(fp, built)
    size = built
    d, w, sd = size
    _, grads = tmk.decoder_bwd_plain(x, t(g), fp)
    ops = tmk.decoder_bwd_operands_plain(x, t(g), fp)
    plan = tmk.wgrad_plan(size, len(x), 24,
                          cap=tmk.wgrad_scratch_bytes(size, 900))
    npart = tmk.wgrad_part_floats(size)
    parts = []
    before = tmk.decoder_wgrad.launches
    for r0, rows, splits, per in tmk.wgrad_chunks(plan, size, len(x)):
        scratch = tmk.pack_operands(
            tmk.WgradOperands(*[o[r0:r0 + rows] for o in ops]))
        assert scratch.numel() * 2 == tmk.wgrad_scratch_bytes(size, rows)
        part = torch.empty(splits * npart)
        tmk.decoder_wgrad(scratch, size, rows, splits, per, part)
        parts.append(part)
    assert tmk.decoder_wgrad.launches == before
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


@pytest.mark.parametrize("size", [(16, 128, 128), (16, 1024, 1024),
                                  (64, 192, 64)])
@pytest.mark.parametrize("n_rows", [0, 1, 63, 64, 65, 4096, 65499, 327643,
                                    327680])
@pytest.mark.parametrize("sms,cap", [(132, tmk.WGRAD_SCRATCH_CAP),
                                     (132, 24 << 20), (7, 1 << 20), (1, 1)])
def test_wgrad_plan(size, n_rows, sms, cap):
    """Chunks cover the rows exactly once, in whole 64-row tiles but the
    last, with the scratch at or under its cap (one tile at the least);
    no split is empty; output tiles x splits >= the SMs where a chunk has
    the row tiles for it; no rows plans nothing."""
    plan = tmk.wgrad_plan(size, n_rows, sms, cap=cap)
    chunks = tmk.wgrad_chunks(plan, size, n_rows)
    if n_rows == 0:
        assert plan[:4] == (0, 0, 0, 0) and chunks == []
        return
    assert plan.tiles == tmk.wgrad_tiles(size)
    one_tile = tmk.wgrad_scratch_bytes(size, 64)
    assert tmk.wgrad_scratch_bytes(size, plan.chunk_rows) <= max(cap,
                                                                 one_tile)
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


@pytest.mark.parametrize("rows", [1, 64, 65, 327680])
def test_scratch_bytes(rows):
    """Two bytes per stored value: x, h1, h2, feat, dhc, dfeat, dh2, dh1
    over the rows rounded up to whole tiles."""
    d, w, sd = 16, 128, 128
    assert tmk.wgrad_scratch_bytes((d, w, sd), rows) == (
        2 * -(-rows // 64) * 64 * (d + 5 * w + 2 * sd))
