"""PointNet parity: the port's ``pointnet_apply`` and
``aggregate_point_features`` against the JAX package's on the same numpy
inputs and bridged params, in f32 (the JAX package runs the products at
``highest`` precision, the port in true f32): held at 1e-5 of each
output's largest magnitude (f32 summation order). Also: the decoder dict
with a ``"pointnet"`` entry flattens in ``jax.tree.leaves`` order, which
the mapper's Adam state relies on, and the port's initializer has the
JAX package's shapes, bounds and head scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.models.decoder import init_decoder as j_init_decoder
from proudslam_tpu.models.pointnet import (aggregate_point_features as
                                           j_aggregate)
from proudslam_tpu.models.pointnet import init_pointnet as j_init
from proudslam_tpu.models.pointnet import pointnet_apply as j_apply
from proudslam_tpu_torch.models import pointnet as tpn
from proudslam_tpu_torch.models.decoder import (params_from_jax,
                                                tree_leaves, tree_unflatten)

from torch_parity import DEC, assert_close_scaled, t

TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return j_init(jax.random.PRNGKey(3), 16)


@pytest.mark.parametrize("shape", [(7, 8), (3, 5, 8)])
def test_pointnet_apply_matches(params, shape):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-2, 2, shape + (3,)).astype(np.float32)
    rgb = rng.random(shape + (3,)).astype(np.float32)
    a = j_apply(params, jnp.asarray(xyz), jnp.asarray(rgb))
    b = tpn.pointnet_apply(params_from_jax(params, device="cpu"), t(xyz),
                           t(rgb))
    assert b.shape == shape + (16,)
    assert_close_scaled(b, a, TOL)


def test_aggregate_point_features_matches():
    rng = np.random.default_rng(1)
    N, K, D = 40, 8, 16
    sample = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    feats = rng.standard_normal((N, K, D)).astype(np.float32)
    a = j_aggregate(jnp.asarray(sample), jnp.asarray(pts), jnp.asarray(feats),
                    0.2)
    b = tpn.aggregate_point_features(t(sample), t(pts), t(feats), 0.2)
    assert_close_scaled(b, a, TOL)


def test_decoder_dict_with_pointnet_leaf_order(params):
    dec = j_init_decoder(jax.random.PRNGKey(1), DEC)
    dec["pointnet"] = params
    tp = params_from_jax(dec, device="cpu")
    jl = jax.tree.leaves(dec)
    tl = tree_leaves(tp)
    assert len(tl) == len(jl)
    for x, y in zip(tl, jl):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    back = tree_unflatten(tp, tl)
    np.testing.assert_array_equal(back["pointnet"]["fc"]["w"].numpy(),
                                  np.asarray(params["fc"]["w"]))


def test_init_pointnet_layout(params):
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tpn.init_pointnet(gen, 16, device="cpu")
    jl = jax.tree.leaves(params)
    tl = tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(y.shape) for y in jl]
    # uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), head scaled by 0.02
    for layer in tp["layers"]:
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert float(layer["w"].abs().max()) <= bound
    assert float(tp["fc"]["w"].abs().max()) <= 0.02 / np.sqrt(512)
    assert float(tp["fc"]["w"].abs().max()) > 0.01 / np.sqrt(512)
