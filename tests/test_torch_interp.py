"""Unfused gather parity: the port's ``ops/interp.py`` (trilinear weights,
the per-point ``gather_voxel_features``, the ray-structured
``gather_ray_features`` with its ``GatherF8`` backward, ``precompute_f8``,
the one-hot einsum oracle ``gather_ray_features_onehot``) against the JAX
package's on the same map and sample topology
(``tests/test_gather_backward.py``'s generators), and the oracle against
the port's gather.

Tolerances: features and their gradients w.r.t. sample positions and
embeddings 1e-5 of each one's largest magnitude (f32 sums in another
order; the sample selection itself is exact in both); the hoisted
``precompute_f8`` path equal to the inline one bit for bit in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.ops import interp as ji
from proudslam_tpu.ops.voxel_hash import voxel_centers
from proudslam_tpu_torch.models.decoder import map_state_from_numpy
from proudslam_tpu_torch.ops import interp as ti

from test_gather_backward import _ray_batch, _small_map
from torch_parity import assert_close_scaled, n, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    state, s = _small_map()
    emb = (0.5 * np.random.default_rng(3).standard_normal(
        state.embeddings.shape)).astype(np.float32)
    state = state._replace(embeddings=jnp.asarray(emb))
    xyz, bins, hit = _ray_batch(state, s)
    g = np.random.default_rng(4).standard_normal(
        (*bins.shape, emb.shape[1])).astype(np.float32)
    return state, s, xyz, bins, hit, g


def test_trilinear_weights_match():
    p = np.random.default_rng(0).uniform(-0.1, 1.1, (257, 3)).astype(
        np.float32)
    np.testing.assert_allclose(n(ti.trilinear_weights(t(p))),
                               n(ji.trilinear_weights(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)


def test_gather_voxel_features_match(case):
    state, s, xyz, bins, hit, _ = case
    rng = np.random.default_rng(5)
    nv = int(state.num_voxels)
    idx = rng.integers(-1, nv, 300).astype(np.int32)
    cj = voxel_centers(state, s)
    pts = (np.asarray(cj)[np.maximum(idx, 0)]
           + rng.uniform(-0.5, 0.5, (300, 3)) * s.voxel_size).astype(
               np.float32)
    ref = ji.gather_voxel_features(jnp.asarray(pts), jnp.asarray(idx), cj,
                                   state.voxel_vertex_ids, state.embeddings,
                                   s.voxel_size)
    ts = map_state_from_numpy(state, device="cpu")
    got = ti.gather_voxel_features(t(pts), t(idx), ts.voxel_keys,
                                   ts.voxel_vertex_ids, ts.embeddings,
                                   s.voxel_size)
    assert_close_scaled(got, ref, TOL, "gather_voxel_features")


@pytest.mark.parametrize("corner", ["inline", "EV"])
def test_gather_ray_features_and_grads_match(case, corner):
    """Features and gradients w.r.t. sample positions and embeddings; with
    ``EV`` the corner view is passed in (as the tracker hoists it) and the
    gradient reaches the embeddings through it."""
    state, s, xyz, bins, hit, g = case

    def jf(x, emb):
        EV = (ji.corner_view(emb, state.voxel_vertex_ids, state.inv_map)
              if corner == "EV" else None)
        f = ji.gather_ray_features(x, bins, hit, state.voxel_keys,
                                   state.voxel_vertex_ids, emb,
                                   s.voxel_size, inv_map=state.inv_map,
                                   EV=EV)
        return jnp.sum(f * g), f

    (_, fj), (gx_j, ge_j) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        xyz, state.embeddings)

    ts = map_state_from_numpy(state, device="cpu")
    x_t = t(xyz).requires_grad_(True)
    e_t = ts.embeddings.clone().requires_grad_(True)
    EV = (ti.corner_view(e_t, ts.voxel_vertex_ids) if corner == "EV"
          else None)
    ft = ti.gather_ray_features(x_t, t(bins), t(hit), ts.voxel_keys,
                                ts.voxel_vertex_ids, e_t, s.voxel_size,
                                EV=EV)
    (ft * t(g)).sum().backward()
    valid = n(bins) < hit.shape[1]
    assert valid.mean() > 0.3
    np.testing.assert_array_equal(n(ft)[~valid], 0.0)
    assert_close_scaled(ft, fj, TOL, "features")
    assert_close_scaled(x_t.grad, gx_j, TOL, "d_xyz")
    assert_close_scaled(e_t.grad, ge_j, TOL, "d_embeddings")


def test_precompute_f8_matches(case):
    """``precompute_f8`` against the JAX package's (f8 and centers), and
    the port's hoisted path equal to its inline one."""
    state, s, xyz, bins, hit, _ = case
    vidx = jnp.maximum(hit, 0)
    EVj = ji.corner_view(state.embeddings, state.voxel_vertex_ids,
                         state.inv_map)
    f8_j, c_j = ji.precompute_f8(EVj, vidx, bins, state.voxel_keys,
                                 s.voxel_size)
    ts = map_state_from_numpy(state, device="cpu")
    EV = ti.corner_view(ts.embeddings, ts.voxel_vertex_ids)
    f8_t, c_t = ti.precompute_f8(EV, t(hit).clamp_min(0), t(bins),
                                 ts.voxel_keys, s.voxel_size)
    np.testing.assert_array_equal(n(f8_t), n(f8_j))
    np.testing.assert_array_equal(n(c_t), n(c_j))
    args = (t(xyz), t(bins), t(hit), ts.voxel_keys, ts.voxel_vertex_ids,
            ts.embeddings, s.voxel_size)
    hoisted = ti.gather_ray_features(*args, f8_center=(f8_t, c_t))
    inline = ti.gather_ray_features(*args, EV=EV)
    assert torch.equal(hoisted, inline)


def test_onehot_oracle_matches_jax_and_the_gather(case):
    """``gather_ray_features_onehot`` against the JAX package's (every
    sample: both select the last hit slot at bins >= H) and against the
    port's ``gather_ray_features`` (valid samples: the gather zeroes the
    rest), values and gradients w.r.t. sample positions and embeddings."""
    state, s, xyz, bins, hit, g = case
    valid = n(bins) < hit.shape[1]
    gv = g * valid[..., None]          # cotangents on valid samples only

    def jf(x, emb):
        f = ji.gather_ray_features_onehot(x, bins, hit, state.voxel_keys,
                                          state.voxel_vertex_ids, emb,
                                          s.voxel_size)
        return jnp.sum(f * gv), f

    (_, fj), (gx_j, ge_j) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        xyz, state.embeddings)

    ts = map_state_from_numpy(state, device="cpu")
    out = {}
    for name, fn in (("onehot", ti.gather_ray_features_onehot),
                     ("gather", ti.gather_ray_features)):
        x_t = t(xyz).requires_grad_(True)
        e_t = ts.embeddings.clone().requires_grad_(True)
        f = fn(x_t, t(bins), t(hit), ts.voxel_keys, ts.voxel_vertex_ids,
               e_t, s.voxel_size)
        (f * t(gv)).sum().backward()
        out[name] = (f.detach(), x_t.grad, e_t.grad)
    f1, gx1, ge1 = out["onehot"]
    assert_close_scaled(f1, fj, TOL, "onehot features")
    assert_close_scaled(gx1, gx_j, TOL, "onehot d_xyz")
    assert_close_scaled(ge1, ge_j, TOL, "onehot d_embeddings")
    f2, gx2, ge2 = out["gather"]
    assert_close_scaled(n(f2)[valid], n(f1)[valid], TOL, "features")
    assert_close_scaled(n(gx2)[valid], n(gx1)[valid], TOL, "d_xyz")
    assert_close_scaled(ge2, ge1, TOL, "d_embeddings")
    assert np.abs(n(f1)[~valid]).max() > 0    # the oracle's last-slot fill
