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
bf16 1e-3 and f32 1e-5 of each output's largest magnitude. Also: the weight
bridge round trip (exact) and ``decoder_values`` in f32 (1e-5) and bf16
(1e-3: f32 accumulation order against XLA's, through bf16-rounded
operands).
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

from torch_parity import DEC, assert_close_scaled, n, port, t

FWD_TOL = {"bf16": 1e-3, "f32": 1e-5}


@pytest.fixture(scope="module")
def params():
    return j_init(jax.random.PRNGKey(0), DEC)


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
def test_decoder_bwd_plain_matches_pallas(params, seed):
    rng = np.random.default_rng(seed)
    N = jmk.TILE
    x = rng.standard_normal((N, 16)).astype(np.float32)
    g = rng.standard_normal((N, 4)).astype(np.float32)
    jfp = jmk.pack_params(params, DEC)
    outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp, interpret=True,
                        bf16=True)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(DEC))
    dx, grads = tmk.decoder_bwd_plain(t(x), t(g), fp)
    assert_close_scaled(dx, outs[0], 1e-3, "dx")
    for name, a, b in zip(jmk.FusedParams._fields, grads, outs[1:]):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, 1e-3, name)


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


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decoder_fwd_plain_matches_pallas(params, dtype):
    bf16 = dtype == "bf16"
    x = np.random.default_rng(5).standard_normal(
        (jmk.TILE, 16)).astype(np.float32)
    a = jmk._run_fwd(jnp.asarray(x), jmk.pack_params(params, DEC),
                     interpret=True, bf16=bf16)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(DEC))
    before = tmk.decoder_fwd.launches
    b = tmk.decoder_fwd(t(x), fp, bf16=bf16)
    assert tmk.decoder_fwd.launches == before      # no kernel on the CPU
    assert b.shape == (jmk.TILE, 4)
    assert_close_scaled(b, a, FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_decoder_values_fused_and_grads_match(params, dtype):
    dec = dataclasses.replace(DEC, matmul_dtype=dtype)
    rng = np.random.default_rng(6)
    N = 1000                                  # no multiple of jmk.TILE
    x = rng.standard_normal((N, 16)).astype(np.float32)
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
