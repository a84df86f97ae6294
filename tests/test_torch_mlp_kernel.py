"""Decoder and kernel-K2/K3 parity.

``decoder_bwd_plain`` (the plain version of the CUDA decoder backward)
against the JAX package's Pallas ``_run_bwd(..., bf16=True)`` in interpret
mode: the same bf16 rounding points, so differences are f32 summation
order only, which can flip the bf16 rounding of an intermediate; held at
1e-3 of each output's largest magnitude. The port's K2 path on CPU tensors
(``decoder_fwd``, the plain version) against ``_run_fwd(...,
interpret=True)`` with both operand types, and ``decoder_values_fused``
with its gradients (``FusedDecoder``: K2 forward, K3 backward) against
``jax.grad`` through the JAX package's ``decoder_values_fused(...,
interpret=True)`` at a row count that is no multiple of its 2048-row tile:
bf16 1e-3 and f32 1e-5 of each output's largest magnitude. Those three
run at the decoder sizes (in_dim, width, sdf_dim) of
``torch_parity.SIZED_DEC``: (16, 64, 64), the reference's wider (16, 256,
128), which the CUDA kernels take through their streamed plan, (32, 64,
64) and (64, 64, 64), the smallest in_dim-32 and in_dim-64 sizes they are
built for (``-k 32x64x64``, ``-k 64x64x64``), the widest, (16, 512,
512), and in_dim 128 at (128, 64, 64) (``-k 128x64x64``; the kernels
run it padded to (128, 128, 128)). Also: the weight
bridge round trip (exact) and ``decoder_values`` in f32 (1e-5) and bf16
(1e-3: f32 accumulation order against XLA's, through bf16-rounded
operands). On CPU tensors neither operand type launches a kernel: the f32
forms' launch counters stay at 0 as the bf16 forms' do. And the size
predicate: which kernel forms a configuration launches, the sizes each
takes (built, or zero-padded to a built size: ``built_size``), the
refusal of the rest, and the streamed f32 kernels' 32-row partitions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.models.decoder import decoder_values as j_values
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops.pallas import mlp_kernel as jmk
from proudslam_tpu_torch.models.decoder import (decoder_values,
                                                params_from_jax,
                                                params_to_numpy,
                                                tree_leaves)
from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk

from torch_parity import (SIZED_DEC, DEC, assert_close_scaled,
                          flipped_rows_zeroed, n, port, t)

FWD_TOL = {"bf16": 1e-3, "f32": 1e-5}


@pytest.fixture(scope="module")
def params():
    return j_init(jax.random.PRNGKey(0), DEC)


@pytest.fixture(scope="module", params=list(SIZED_DEC))
def sized(request):
    """(decoder settings, JAX params) at each decoder size of SIZED_DEC."""
    dec = SIZED_DEC[request.param]
    return dec, j_init(jax.random.PRNGKey(0), dec)


def test_weight_bridge_roundtrip(params):
    tp = params_from_jax(params, device="cpu")
    back = params_to_numpy(tp)
    a = jax.tree.leaves(params)
    b = jax.tree.leaves(back)
    assert len(a) == len(b) == len(tree_leaves(tp))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 1e-3)])
def test_decoder_values_match(params, dtype, tol):
    dec = dataclasses.replace(DEC, matmul_dtype=dtype)
    x = np.random.default_rng(1).standard_normal((512, 16)).astype(np.float32)
    a = j_values(params, dec, jnp.asarray(x))
    b = decoder_values(params_from_jax(params, device="cpu"), port(dec), t(x))
    np.testing.assert_allclose(n(b), n(a), atol=tol)


def test_pack_unpack_roundtrip(params):
    tp = params_from_jax(params, device="cpu")
    fp = tmk.pack_params(tp, port(DEC))
    jfp = jmk.pack_params(params, DEC)
    for x, y in zip(fp, jfp):
        np.testing.assert_array_equal(n(x), n(y))
    back = tmk.unpack_grads(fp)
    for x, y in zip(tree_leaves(back), tree_leaves(tp)):
        np.testing.assert_array_equal(n(x), n(y))


@pytest.mark.parametrize("seed", [2, 3])
def test_decoder_bwd_plain_matches_pallas(sized, seed):
    """K3's plain version against ``_run_bwd`` (bf16 operands), 1e-3 of
    each output's largest magnitude; at the wide sizes with the rows whose
    dx misses (ReLU-mask flips, at most FLIP_SHARE of them) zeroed in a
    second run (``flipped_rows_zeroed``)."""
    dec, params = sized
    rng = np.random.default_rng(seed)
    N = jmk.TILE
    x = rng.standard_normal((N, dec.in_dim)).astype(np.float32)
    g = rng.standard_normal((N, 4)).astype(np.float32)
    jfp = jmk.pack_params(params, dec)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))

    def both(g):
        outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp,
                            interpret=True, bf16=True)
        return outs, tmk.decoder_bwd_plain(t(x), t(g), fp)
    outs, (dx, grads) = both(g)
    if tmk.wide(tmk.built_size(tmk.params_size(fp))):
        outs, (dx, grads) = both(flipped_rows_zeroed(dx, outs[0], g, 1e-3))
    assert_close_scaled(dx, outs[0], 1e-3, "dx")
    for name, a, b in zip(jmk.FusedParams._fields, grads, outs[1:]):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, 1e-3, name)


def _launch_counts():
    return (tmk.decoder_fwd.launches, tmk.decoder_fwd_f32.launches,
            tmk.decoder_bwd.launches, tmk.decoder_bwd_f32.launches)


def test_decoder_bwd_dispatch_cpu(params):
    """On CPU tensors the wrapper is the plain version; the dx-only form
    gives the same dx."""
    rng = np.random.default_rng(4)
    x = t(rng.standard_normal((100, 16)).astype(np.float32))
    g = t(rng.standard_normal((100, 4)).astype(np.float32))
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(DEC))
    before = tmk.decoder_bwd.launches
    dx, grads = tmk.decoder_bwd(x, g, fp)
    dx2, none = tmk.decoder_bwd(x, g, fp, want_wgrad=False)
    assert none is None and torch.equal(dx, dx2)
    assert tmk.decoder_bwd.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError):
        tmk.decoder_bwd(x.to("meta"), g.to("meta"),
                        tmk.FusedParams(*[p.to("meta") for p in fp]))


def test_f32_dispatch_cpu(params):
    """``bf16=False`` on CPU tensors: the f32 plain versions (outputs equal
    to ``decoder_fwd_plain`` / ``decoder_bwd_plain`` with f32 operands), and
    no launch counter moves, the f32 forms' included."""
    rng = np.random.default_rng(8)
    x = t(rng.standard_normal((100, 16)).astype(np.float32))
    g = t(rng.standard_normal((100, 4)).astype(np.float32))
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(DEC))
    before = _launch_counts()
    out = tmk.decoder_fwd(x, fp, bf16=False)
    _, _, _, sdf, _, rgb = tmk.decoder_fwd_plain(x, fp, bf16=False)
    assert torch.equal(out, torch.cat([rgb, sdf], dim=1))
    dx, grads = tmk.decoder_bwd(x, g, fp, bf16=False)
    dx_p, grads_p = tmk.decoder_bwd_plain(x, g, fp, bf16=False)
    assert torch.equal(dx, dx_p)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_p))
    dx2, none = tmk.decoder_bwd(x, g, fp, want_wgrad=False, bf16=False)
    assert none is None and torch.equal(dx2, dx)
    x.requires_grad_(True)
    tmk.FusedDecoder.apply(x, False, *fp).sum().backward()
    assert torch.equal(x.grad, tmk.decoder_bwd(x.detach(), torch.ones(100, 4),
                                               fp, bf16=False)[0])
    assert _launch_counts() == before
    # the f32 form differs from the bf16 one (no operand rounding)
    assert not torch.equal(out, tmk.decoder_fwd(x.detach(), fp))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decoder_fwd_plain_matches_pallas(sized, dtype):
    dec, params = sized
    bf16 = dtype == "bf16"
    x = np.random.default_rng(5).standard_normal(
        (jmk.TILE, dec.in_dim)).astype(np.float32)
    a = jmk._run_fwd(jnp.asarray(x), jmk.pack_params(params, dec),
                     interpret=True, bf16=bf16)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))
    before = tmk.decoder_fwd.launches
    b = tmk.decoder_fwd(t(x), fp, bf16=bf16)
    assert tmk.decoder_fwd.launches == before      # no kernel on the CPU
    assert b.shape == (jmk.TILE, 4)
    assert_close_scaled(b, a, FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decoder_values_fused_and_grads_match(sized, dtype):
    dec, params = sized
    dec = dataclasses.replace(dec, matmul_dtype=dtype)
    rng = np.random.default_rng(6)
    N = 1000                                  # no multiple of jmk.TILE
    x = rng.standard_normal((N, dec.in_dim)).astype(np.float32)
    w = rng.standard_normal((N, 4)).astype(np.float32)

    def jf(x_, p):
        out = jmk.decoder_values_fused(p, dec, x_, interpret=True)
        return jnp.sum(out * w), out

    (_, out_j), (gx, gp) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), params)
    x_t = t(x).requires_grad_(True)
    p_t = params_from_jax(params, device="cpu")
    for p in tree_leaves(p_t):
        p.requires_grad_(True)
    out_t = tmk.decoder_values_fused(p_t, port(dec), x_t)
    (out_t * t(w)).sum().backward()
    tol = FWD_TOL[dtype]
    assert out_t.shape == (N, 4)
    assert_close_scaled(out_t, out_j, tol, "out")
    assert_close_scaled(x_t.grad, gx, tol, "dx")
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(gp)):
        assert_close_scaled(a.grad, b, tol, "params")


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("n_rows", [0, 1, 63, 64, 65, 4096, 65536, 327643,
                                    327680])
def test_backward_partition(n_rows, sms):
    """K3's blocks: at most one per SM, none empty, every 64-row tile in
    exactly one block's run, the last (ragged) tile included."""
    blocks, per_block = tmk.backward_partition(n_rows, sms)
    ntiles = -(-n_rows // tmk.TILE_ROWS)
    if n_rows == 0:
        assert (blocks, per_block) == (0, 0)
        return
    assert 1 <= blocks <= min(sms, ntiles)
    runs = [range(b * per_block, min(ntiles, (b + 1) * per_block))
            for b in range(blocks)]
    assert all(len(r) > 0 for r in runs)
    assert [t for r in runs for t in r] == list(range(ntiles))
    # rows of the last tile: the kernel masks the rest
    assert n_rows - (ntiles - 1) * tmk.TILE_ROWS in range(1, tmk.TILE_ROWS + 1)


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("n_rows", [0, 1, 63, 64, 65, 2 * 7 * 64,
                                    2 * 132 * 64, 2 * 132 * 64 + 1, 65536,
                                    327643, 327680])
def test_forward_grid(n_rows, sms):
    """K2's (and K1's) blocks of two warpgroups: at most one per SM, none
    without a tile, and the strided walk (tile = 2 * block + warpgroup,
    stride 2 * blocks) visits every 64-row tile once, the last (ragged)
    one included."""
    blocks = tmk.forward_grid(n_rows, sms)
    ntiles = -(-n_rows // tmk.TILE_ROWS)
    if n_rows == 0:
        assert blocks == 0
        return
    assert 1 <= blocks <= sms
    assert all(2 * b < ntiles for b in range(blocks))
    # every SM busy once there are two tiles for each
    assert blocks == (sms if ntiles >= 2 * sms else -(-ntiles // 2))
    walked = sorted(t for b in range(blocks) for wg in range(2)
                    for t in range(2 * b + wg, ntiles, 2 * blocks))
    assert walked == list(range(ntiles))


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("n_rows", [0, 1, 63, 64, 65, 7 * 64, 132 * 64,
                                    132 * 64 + 1, 65536, 327643, 327680])
def test_forward_f32_grid(n_rows, sms):
    """K2-f32's persistent blocks (tile = block + k * blocks): at most one
    per SM, none without a tile, every 64-row tile walked once, the last
    (ragged) one included."""
    blocks = tmk.forward_f32_grid(n_rows, sms)
    ntiles = -(-n_rows // tmk.TILE_ROWS)
    assert blocks == min(ntiles, sms)
    walked = sorted(t for b in range(blocks)
                    for t in range(b, ntiles, blocks))
    assert walked == list(range(ntiles))


def test_fused_decoder_skips_weight_grads(params):
    """With frozen params (tracking) only dx is computed; it equals the
    full backward's dx. Other devices raise; no rows give no output."""
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(DEC))
    x = t(np.random.default_rng(7).standard_normal((70, 16)).astype(
        np.float32)).requires_grad_(True)
    tmk.FusedDecoder.apply(x, True, *fp).sum().backward()
    dx_full, _ = tmk.decoder_bwd(x.detach(), torch.ones(70, 4), fp)
    assert torch.equal(x.grad, dx_full)
    assert all(p.grad is None for p in fp)
    assert tmk.decoder_fwd(x[:0].detach(), fp).shape == (0, 4)
    assert tmk.fused_applicable(port(DEC))
    assert not tmk.fused_applicable(
        dataclasses.replace(port(DEC), use_fused_mlp=False))
    with pytest.raises(ValueError):
        tmk.decoder_fwd(x.detach().to("meta"),
                        tmk.FusedParams(*[p.to("meta") for p in fp]))


@pytest.mark.parametrize("mode,dtype,forms", [
    ("vox", "bf16", ("K1", "K3")), ("vox", "f32", ("K1", "K3")),
    ("pcd", "bf16", ("K2", "K3")), ("pcd", "f32", ("K2-f32", "K3-f32"))])
def test_kernel_forms(mode, dtype, forms):
    """The kernel forms a fused configuration launches on the card (the vox
    path's are bf16 whatever ``matmul_dtype`` says); none unfused."""
    dec = dataclasses.replace(port(DEC), matmul_dtype=dtype)
    assert tmk.kernel_forms(dec, mode) == forms
    assert tmk.kernel_forms(dataclasses.replace(dec, use_fused_mlp=False),
                            mode) == ()


def test_kernel_sizes_refused():
    """Every form is built at the 62 sizes (in_dim 16, 32 and 64; width and
    sdf_dim multiples of 64 up to 256, and width 384 or 512 with sdf_dim a
    multiple of 128; sdf_dim <= width; in_dim 128 at (128, 128, 128),
    (128, 256, 128), (128, 256, 256), (128, 512, 256) and (128, 512, 512);
    and the parked sizes (16, 768, 256), (16, 768, 768), (16, 1024, 512),
    (16, 1024, 1024), (128, 768, 768) and (128, 1024, 1024)) and takes every
    other size with in_dim <= 128 and width, sdf_dim <= 1024 zero-padded to
    one of them; ``check_kernel_sizes`` refuses the rest naming size and
    form, and the wrappers' check refuses params whose shapes disagree on a
    size."""
    assert len(tmk.BUILT_SIZES) == 62
    assert len(set(tmk.BUILT_SIZES)) == 62
    for size in ((16, 64, 64), (16, 128, 128), (16, 256, 128), (32, 64, 64),
                 (32, 256, 128), (32, 256, 256), (16, 384, 128),
                 (16, 512, 512), (32, 384, 384), (32, 512, 128),
                 (64, 64, 64), (64, 128, 128), (64, 256, 128),
                 (64, 256, 256), (64, 384, 256), (64, 512, 512)):
        assert size in tmk.BUILT_SIZES
    parked = [(16, 768, 256), (16, 768, 768), (16, 1024, 512),
              (16, 1024, 1024), (128, 768, 768), (128, 1024, 1024)]
    assert [s for s in tmk.BUILT_SIZES if tmk.wide(s)] == [
        (d, w, sd) for d in (16, 32, 64) for w in (384, 512)
        for sd in (128, 256, 384, 512) if sd <= w] + [
        (128, 512, 256), (128, 512, 512)] + parked
    assert [s for s in tmk.BUILT_SIZES if tmk.parked(s)] == parked
    assert [s for s in tmk.BUILT_SIZES if s[0] == 128] == [
        (128, 128, 128), (128, 256, 128), (128, 256, 256), (128, 512, 256),
        (128, 512, 512), (128, 768, 768), (128, 1024, 1024)]
    # the bf16 forms' wide plan: the wide sizes and every in_dim-128 one
    assert [s for s in tmk.BUILT_SIZES if tmk.wide_plan(s)] == [
        s for s in tmk.BUILT_SIZES if tmk.wide(s) or s[0] == 128]
    assert [tmk.bf16_source("mlp", s) for s in (
        (64, 256, 256), (128, 128, 128), (16, 384, 128), (16, 768, 256),
        (128, 1024, 1024))] == [
        "mlp_stream", "mlp_wide", "mlp_wide", "mlp_park", "mlp_park"]
    # K2-f32's and K3-f32's height: their two live tiles take 32 rows up
    # to width 512, 16 at 768 and 1024
    assert tmk.f32_tile_rows((128, 256, 128)) == tmk.STREAM_F32_ROWS
    assert tmk.f32_tile_rows((16, 512, 512)) == tmk.STREAM_F32_ROWS
    assert tmk.f32_tile_rows((16, 1024, 1024)) == tmk.WIDE_F32_ROWS
    assert [s for s in tmk.BUILT_SIZES if s[0] == 64] == [
        (64, w, sd) for w, sd in [s[1:] for s in tmk.BUILT_SIZES
                                  if s[0] == 16 and not tmk.parked(s)]]
    assert tmk.FORMS == ("K1", "K2", "K3", "K2-f32", "K3-f32")
    base = port(DEC)
    accepted = [dict(width=w, sdf_dim=sd) for w, sd in (
        (64, 64), (128, 64), (192, 192), (256, 128), (256, 256))]
    # padded: a width no multiple of 64, sdf_dim > width, in_dim < 16
    accepted += [dict(width=96, sdf_dim=64), dict(width=128, sdf_dim=192),
                 dict(in_dim=8), dict(in_dim=12, width=200, sdf_dim=256),
                 dict(width=1, sdf_dim=1)]
    # in_dim 32, and in_dim 17 to 31 padded to it
    accepted += [dict(in_dim=32), dict(in_dim=32, width=256, sdf_dim=256),
                 dict(in_dim=24, width=200, sdf_dim=72), dict(in_dim=17)]
    # in_dim 64, and in_dim 33 to 63 padded to it
    accepted += [dict(in_dim=64), dict(in_dim=64, width=256, sdf_dim=128),
                 dict(in_dim=33), dict(in_dim=48),
                 dict(in_dim=40, width=300, sdf_dim=200),
                 dict(in_dim=64, width=512, sdf_dim=512)]
    # in_dim 128, and in_dim 65 to 127 padded to it
    accepted += [dict(in_dim=128), dict(in_dim=128, width=256, sdf_dim=128),
                 dict(in_dim=65), dict(in_dim=96), dict(in_dim=100,
                                                        width=256,
                                                        sdf_dim=128),
                 dict(in_dim=96, width=300, sdf_dim=200),
                 dict(in_dim=72, width=64, sdf_dim=320),
                 dict(in_dim=128, width=512, sdf_dim=512)]
    # the wide sizes, built and padded (a width or sdf_dim of 257 to 512)
    accepted += [dict(width=512, sdf_dim=512),
                 dict(in_dim=32, width=384, sdf_dim=256),
                 dict(width=320, sdf_dim=128), dict(width=256, sdf_dim=320),
                 dict(in_dim=24, width=450, sdf_dim=500),
                 dict(width=512, sdf_dim=64)]
    # the parked sizes, built and padded (a width or sdf_dim of 513 to 1024)
    accepted += [dict(width=1024, sdf_dim=1024),
                 dict(in_dim=128, width=768, sdf_dim=768),
                 dict(width=513, sdf_dim=128), dict(width=128, sdf_dim=513),
                 dict(in_dim=40, width=900, sdf_dim=1000)]
    for kw in accepted:
        for mode, dtype in (("vox", "bf16"), ("pcd", "bf16"), ("pcd", "f32")):
            tmk.check_kernel_sizes(dataclasses.replace(
                base, matmul_dtype=dtype, **kw), mode)
    for kw, mode, form in (
            (dict(width=1025, sdf_dim=128), "pcd", "K2"),
            (dict(width=256, sdf_dim=1025), "vox", "K1"),
            (dict(in_dim=129), "vox", "K1"),
            (dict(in_dim=160), "pcd", "K2"),
            (dict(in_dim=129, matmul_dtype="f32"), "pcd", "K2-f32"),
            (dict(width=1025, sdf_dim=128, matmul_dtype="f32"), "pcd",
             "K2-f32"),
            (dict(width=0), "pcd", "K2")):
        with pytest.raises(ValueError, match=form):
            tmk.check_kernel_sizes(dataclasses.replace(base, **kw), mode)
    for size in ((129, 64, 64), (160, 64, 64), (16, 1025, 64),
                 (16, 64, 1025), (64, 1025, 64), (128, 64, 1025), (0, 64, 64),
                 (16, 64, 0)):
        for form in tmk.FORMS:
            with pytest.raises(ValueError, match=f"{form}.*in_dim <= 128"):
                tmk.check_size(size, form)
    for size in ((32, 64, 64), (17, 1, 1), (32, 256, 256), (16, 512, 512),
                 (32, 320, 64), (16, 64, 320), (32, 512, 512), (33, 64, 64),
                 (48, 64, 64), (64, 256, 128), (64, 512, 512), (65, 64, 64),
                 (96, 64, 64), (128, 256, 128), (128, 512, 512),
                 (127, 1, 512), (16, 513, 64), (128, 64, 513),
                 (16, 1024, 1024), (127, 1024, 1)):
        for form in tmk.FORMS:
            tmk.check_size(size, form)
    fp = tmk.pack_params(params_from_jax(j_init(jax.random.PRNGKey(0), DEC),
                                         device="cpu"), port(DEC))
    assert tmk.params_size(fp) == (16, 64, 64)
    bad = fp._replace(wc_f=fp.wc_f[:32])
    with pytest.raises(ValueError, match="shapes"):
        tmk.params_size(bad)
    x = torch.zeros((64, 16))
    assert tmk._check_kernel_inputs(x, None, fp, "K2") == (16, 64, 64)
    assert tmk._check_kernel_inputs(x, None, fp, "K2-f32") == (16, 64, 64)
    with pytest.raises(ValueError, match="in_dim 16 expected"):
        tmk._check_kernel_inputs(torch.zeros((64, 8)), None, fp, "K2-f32")


@pytest.mark.parametrize("size,built", [
    ((16, 64, 64), (16, 64, 64)), ((16, 256, 128), (16, 256, 128)),
    ((8, 40, 24), (16, 64, 64)), ((16, 100, 72), (16, 128, 128)),
    ((12, 64, 192), (16, 192, 192)), ((16, 200, 256), (16, 256, 256)),
    ((1, 1, 1), (16, 64, 64)), ((16, 129, 64), (16, 192, 64)),
    ((16, 65, 130), (16, 192, 192)), ((16, 256, 256), (16, 256, 256)),
    ((32, 64, 64), (32, 64, 64)), ((32, 256, 128), (32, 256, 128)),
    ((17, 1, 1), (32, 64, 64)), ((24, 200, 72), (32, 256, 128)),
    ((20, 64, 64), (32, 64, 64)), ((31, 129, 200), (32, 256, 256)),
    ((16, 512, 512), (16, 512, 512)), ((32, 384, 128), (32, 384, 128)),
    ((16, 257, 64), (16, 384, 128)), ((16, 300, 200), (16, 384, 256)),
    ((16, 384, 129), (16, 384, 256)), ((16, 385, 1), (16, 512, 128)),
    ((24, 450, 500), (32, 512, 512)), ((16, 64, 320), (16, 384, 384)),
    ((16, 256, 257), (16, 384, 384)), ((32, 512, 300), (32, 512, 384)),
    ((1, 1, 512), (16, 512, 512)), ((64, 64, 64), (64, 64, 64)),
    ((64, 256, 128), (64, 256, 128)), ((33, 1, 1), (64, 64, 64)),
    ((48, 64, 64), (64, 64, 64)), ((40, 100, 72), (64, 128, 128)),
    ((48, 256, 128), (64, 256, 128)), ((40, 300, 200), (64, 384, 256)),
    ((63, 450, 500), (64, 512, 512)),
    ((128, 128, 128), (128, 128, 128)), ((128, 256, 128), (128, 256, 128)),
    ((128, 512, 512), (128, 512, 512)), ((65, 64, 64), (128, 128, 128)),
    ((100, 64, 64), (128, 128, 128)), ((100, 256, 128), (128, 256, 128)),
    ((65, 200, 200), (128, 256, 256)), ((128, 64, 256), (128, 256, 256)),
    ((96, 300, 200), (128, 512, 256)), ((72, 300, 200), (128, 512, 256)),
    ((72, 64, 320), (128, 512, 512)), ((127, 1, 1), (128, 128, 128)),
    ((128, 257, 64), (128, 512, 256))])
def test_built_size(size, built):
    """The covering built size with the fewest forward flops a row. Up
    to in_dim 64 that is (D', W', SD'): D' the smallest of 16, 32 and 64
    that is at least in_dim, SD' = sdf_dim up to a multiple of 64, W' = the
    larger of width so rounded and SD'; above 256, W' up to 384 or 512 and
    SD' to a multiple of 128 (64 or less to 128, 129-256 to 256). In_dim 65
    to 128 goes to the cheapest of the five in_dim-128 sizes that covers
    width and sdf_dim. A built size maps to itself, and the result is
    always built."""
    assert tmk.built_size(size) == built
    assert built in tmk.BUILT_SIZES


@pytest.mark.parametrize("size", tmk.BUILT_SIZES,
                         ids=["x".join(map(str, s)) for s in tmk.BUILT_SIZES])
def test_f32_tile_heights(size):
    """mlp_stream_f32.cu's tile heights, one for both kernels: K2-f32's
    and K3-f32's two live tiles have 32 rows at every built size of width
    384 and 512 (as K3-f32's four do up to width 256) and 16 at widths 768
    and 1024; (16, 128, 128) is mlp_kernel_f32.cu's 64-row plan."""
    k3 = tmk.wgrad_tile_rows(size, bf16=False)
    if size == (16, 128, 128):
        assert k3 == tmk.TILE_ROWS
        return
    assert k3 == tmk.f32_tile_rows(size) == (16 if size[1] > 512 else 32)


@pytest.mark.parametrize("size,n_rows,want", [
    ((16, 384, 128), 327680, (132, 78)),
    ((128, 512, 256), 65536, (128, 16)),
    ((16, 512, 256), 1000, (32, 1)),
    ((16, 768, 256), 327680, (132, 156)),
    ((128, 1024, 1024), 65536 - 37, (128, 32))])
def test_f32_wide_backward_partition(size, n_rows, want):
    """K3-f32's pass 1 at the wide sizes splits its rows into tiles of its
    own height (32 rows at widths 384 and 512, 16 at 768 and 1024): at most
    one block per SM, each a run of whole tiles, the last ragged."""
    assert tmk._k3_partition(size, n_rows, 132, bf16=False) == want
    rows = tmk.f32_tile_rows(size)
    assert tmk.backward_f32_stream_partition(n_rows, 132, rows) == want
    blocks, per = want
    assert (blocks - 1) * per < -(-n_rows // rows) <= blocks * per


@pytest.mark.parametrize("size,floats", [
    # up to width 256 one layout: 2 (2 W + SD) weight rows at stride W + 4
    # and ws's sdf column
    ((16, 256, 128), 1280 * 260 + 256),
    # K3-f32's: 98 forward chunks of 16 x 516 floats (w1 and wc_x one
    # each), 100 backward ones (wc_x^T and w1^T as two K-slices of 256
    # rows each), the column
    ((16, 512, 512), (98 + 100) * 16 * 516 + 512),
    # no parked tile at width 768: chunks of 8 rows there, K-slices of 32
    # rows, 24 a weight
    ((128, 768, 768), (320 + 336) * 8 * 772 + 768),
    # width 1024: 194 forward chunks of 16 x 1028 floats, 200 backward
    # ones, the column, then one parked tile of 1024 x 20 a block (K3-f32's
    # A, K2-f32's B)
    ((16, 1024, 1024), (194 + 200) * 16 * 1028 + 1024 + 132 * 1024 * 20)])
def test_f32_packed_floats(size, floats):
    """The packed-weight scratch mlp_stream_f32.cu's two kernels need on
    132 SMs, one layout for both: up to width 256 16-row chunks of the
    streamed weights and their transposes; at the wide sizes K3-f32's
    (chunks of 16 weight rows where its block has room, dx's x-side weights
    as K-slices, one tile a block parked at width 1024, none at 768),
    of which K2-f32 packs and reads the forward's chunks."""
    assert tmk.packed_f32_floats(size, 132) == floats
    if size[1] == 1024:
        assert tmk.f32_chunk_rows(size) == 16
        assert tmk.backward_f32_x_slice_rows(size) == 256


WIDE_SIZES = [s for s in tmk.BUILT_SIZES if tmk.wide(s)]


def _k2_f32_block_bytes(size, chunk_rows):
    """A mirror of mlp_stream_f32.cu's K2F_SMEM at a wide size: its two
    (width, rows + 4) f32 tiles (tile B parked at width 1024), the input
    tile, 16 partial sdf dots a row and two ring slots of ``chunk_rows``
    weight rows at stride width + 4, with their two mbarriers."""
    d, w, _ = size
    rt = tmk.f32_tile_rows(size)
    return (4 * ((1 if w > 768 else 2) * w * (rt + 4) + d * (rt + 4) + 16 * rt)
            + 2 * chunk_rows * (w + 4) * 4 + 16)


@pytest.mark.parametrize("size", WIDE_SIZES,
                         ids=["x".join(map(str, s)) for s in WIDE_SIZES])
def test_f32_wide_forward_plan(size):
    """K2-f32 at the 29 wide sizes runs K3-f32's plan: tiles of 32 rows at
    widths 384 and 512 and 16 at 768 and 1024, one persistent block an SM
    over them, its ring's chunks K3-f32's (16 weight rows, 8 at (128, 512,
    *) and (128, 768, 768), where 16-row ones would not fit K2-f32's block
    either), its block within the 232,448 bytes of an H100's, and the
    packed scratch K3-f32's layout plus one parked tile a block at width
    1024."""
    d, w, sd = size
    rows = tmk.f32_tile_rows(size)
    assert rows == (32 if w <= 512 else 16)
    for n_rows in (327680, 65536, 327643, 27):
        tiles = -(-n_rows // rows)
        assert tmk.forward_f32_stream_grid(n_rows, 132, rows) == min(tiles,
                                                                     132)
    cr = tmk.f32_chunk_rows(size)
    assert cr == (8 if d == 128 and w in (512, 768) else 16)
    assert _k2_f32_block_bytes(size, cr) <= 232448
    assert (_k2_f32_block_bytes(size, 16) <= 232448) == (cr == 16)
    kx = tmk.backward_f32_x_slice_rows(size)
    chunks = 2 * (d // cr) + 2 * (w // kx) + 2 * (2 * w + sd) // cr
    park = 132 * w * 20 if w == 1024 else 0
    assert tmk.packed_f32_floats(size, 132) == (
        chunks * cr * (w + 4) + w + park)


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("n_rows", [0, 1, 31, 32, 33, 64, 7 * 32, 132 * 32,
                                    132 * 32 + 1, 65536, 327643, 327680])
def test_f32_stream_partitions(n_rows, sms):
    """The streamed K2-f32's persistent blocks and K3-f32's runs count
    tiles of STREAM_F32_ROWS (32) rows: at most one block per SM, none
    without a tile, every tile once, the last (ragged) one included."""
    rows = tmk.STREAM_F32_ROWS
    assert rows == 32
    ntiles = -(-n_rows // rows)
    blocks = tmk.forward_f32_stream_grid(n_rows, sms)
    assert blocks == min(ntiles, sms)
    walked = sorted(t for b in range(blocks)
                    for t in range(b, ntiles, blocks))
    assert walked == list(range(ntiles))
    P, per_block = tmk.backward_f32_stream_partition(n_rows, sms)
    if n_rows == 0:
        assert (P, per_block) == (0, 0)
        return
    assert 1 <= P <= min(sms, ntiles)
    runs = [range(b * per_block, min(ntiles, (b + 1) * per_block))
            for b in range(P)]
    assert all(len(r) > 0 for r in runs)
    assert [t for r in runs for t in r] == list(range(ntiles))
    assert n_rows - (ntiles - 1) * rows in range(1, rows + 1)
