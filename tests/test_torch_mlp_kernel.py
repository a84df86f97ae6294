"""Decoder and kernel-K3 parity.

``decoder_bwd_plain`` (the plain version of the CUDA decoder backward)
against the JAX package's Pallas ``_run_bwd(..., bf16=True)`` in interpret
mode: the same bf16 rounding points, so differences are f32 summation
order only, which can flip the bf16 rounding of an intermediate; held at
1e-3 of each output's largest magnitude. Also: the weight bridge round
trip (exact) and ``decoder_values`` in f32 (1e-5) and bf16 (1e-3: f32
accumulation order against XLA's, through bf16-rounded operands).
"""

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


@pytest.fixture(scope="module")
def params():
    return j_init(jax.random.PRNGKey(0), DEC)


def test_weight_bridge_roundtrip(params):
    tp = params_from_jax(params)
    back = params_to_numpy(tp)
    a = jax.tree.leaves(params)
    b = jax.tree.leaves(back)
    assert len(a) == len(b) == len(tree_leaves(tp))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 1e-3)])
def test_decoder_values_match(params, dtype, tol):
    import dataclasses
    dec = dataclasses.replace(DEC, matmul_dtype=dtype)
    x = np.random.default_rng(1).standard_normal((512, 16)).astype(np.float32)
    a = j_values(params, dec, jnp.asarray(x))
    b = decoder_values(params_from_jax(params), port(dec), t(x))
    np.testing.assert_allclose(n(b), n(a), atol=tol)


def test_pack_unpack_roundtrip(params):
    tp = params_from_jax(params)
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
    fp = tmk.pack_params(params_from_jax(params), port(DEC))
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
    fp = tmk.pack_params(params_from_jax(params), port(DEC))
    before = tmk.decoder_bwd.launches
    dx, grads = tmk.decoder_bwd(x, g, fp)
    dx2, none = tmk.decoder_bwd(x, g, fp, want_wgrad=False)
    assert none is None and torch.equal(dx, dx2)
    assert tmk.decoder_bwd.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError):
        tmk.decoder_bwd(x.to("meta"), g.to("meta"),
                        tmk.FusedParams(*[p.to("meta") for p in fp]))
