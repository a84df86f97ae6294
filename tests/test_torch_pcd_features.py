"""Point-store and pcd-feature parity against the JAX package
(``proudslam_tpu/render/pcd_features.py``) on the same numpy inputs.

``insert_frame_points`` must give exactly the JAX store (positions, colors
and counts): points outside the map, voxels past capacity, and a second
insert into full voxels, as ``tests/test_pcd_features.py`` covers, plus a
random many-voxel cloud. ``gather_pcd_features`` (f32 throughout, the JAX
package at ``highest`` precision): forward held at 1e-5 and its gradients
w.r.t. the sample positions and the PointNet params at 1e-4 of each
output's largest magnitude (f32 summation order, through the softmax and
PointNet's ReLU chain). A point-less voxel gives exact zeros and a finite
gradient in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.config import MapSettings
from proudslam_tpu.models.pointnet import init_pointnet as j_init_pn
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.render import pcd_features as jpf
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax,
                                                point_store_from_numpy,
                                                point_store_to_numpy,
                                                tree_leaves)
from proudslam_tpu_torch.render import pcd_features as tpf

from torch_parity import MAP, assert_close_scaled, map_coords, n, port, t

SMALL = MapSettings(voxel_size=0.2, num_embeddings=512, embed_dim=16,
                    voxel_capacity=64, frame_voxel_capacity=32)


def _insert_both(jstore, tstore, jstate, tstate, ms, pts, cols, valid):
    jstore = jpf.insert_frame_points(jstore, jstate, jnp.asarray(pts),
                                     jnp.asarray(cols), jnp.asarray(valid),
                                     ms)
    tstore = tpf.insert_frame_points(tstore, tstate, t(pts), t(cols),
                                     t(valid), port(ms))
    return jstore, tstore


def _assert_same_store(tstore, jstore, what):
    got = point_store_to_numpy(tstore)
    for name in tpf.VoxelPointStore._fields:
        np.testing.assert_array_equal(got[name], n(getattr(jstore, name)),
                                      err_msg=f"{what}: {name}")


def _two_voxel_points(case):
    if case == "outside":
        # 3 points in voxel (0,0,0), 1 in (1,0,0), 1 outside the map
        pts = np.array([[0.05, 0.05, 0.05], [0.15, 0.1, 0.1],
                        [0.02, 0.18, 0.02], [0.25, 0.05, 0.05],
                        [5.0, 5.0, 5.0]], np.float32)
    else:
        # 10 points in voxel (0,0,0): only the first 4 are kept
        pts = (np.full((10, 3), 0.1)
               + 0.005 * np.arange(10)[:, None]).astype(np.float32)
    cols = (np.arange(pts.size, dtype=np.float32).reshape(-1, 3)
            / pts.size)
    return pts, cols, np.ones(len(pts), bool)


@pytest.mark.parametrize("case", ["outside", "capacity"])
def test_insert_two_voxels_exact(case):
    jstate = jvh.build_map_state_numpy(np.array([[0, 0, 0], [1, 0, 0]]),
                                       SMALL)
    tstate = map_state_from_numpy(jstate, device="cpu")
    jstore = jpf.init_point_store(SMALL, points_per_voxel=4)
    tstore = tpf.init_point_store(port(SMALL), 4, device="cpu")
    _assert_same_store(tstore, jstore, "init")
    pts, cols, valid = _two_voxel_points(case)
    jstore, tstore = _insert_both(jstore, tstore, jstate, tstate, SMALL,
                                  pts, cols, valid)
    _assert_same_store(tstore, jstore, "first insert")
    assert int(tstore.counts.sum()) == 4
    # a second insert into the (now full) voxel drops everything there
    jstore, tstore = _insert_both(jstore, tstore, jstate, tstate, SMALL,
                                  pts, cols, valid)
    _assert_same_store(tstore, jstore, "second insert")


def _random_cloud(rng, coords, n_pts, vox):
    pick = coords[rng.integers(0, len(coords), n_pts)]
    pts = (pick + rng.uniform(0.01, 0.99, (n_pts, 3))) * vox
    pts[: n_pts // 10] += 5.0                   # some points off the map
    cols = rng.random((n_pts, 3))
    valid = rng.random(n_pts) > 0.1
    return pts.astype(np.float32), cols.astype(np.float32), valid


def test_insert_random_cloud_exact():
    coords = map_coords(0, count=60, lo=-3, hi=3)
    jstate = jvh.build_map_state_numpy(coords, MAP)
    tstate = map_state_from_numpy(jstate, device="cpu")
    jstore = jpf.init_point_store(MAP, points_per_voxel=8)
    tstore = point_store_from_numpy(jstore, device="cpu")
    rng = np.random.default_rng(7)
    for frame in range(3):
        pts, cols, valid = _random_cloud(rng, coords, 300, MAP.voxel_size)
        jstore, tstore = _insert_both(jstore, tstore, jstate, tstate, MAP,
                                      pts, cols, valid)
        _assert_same_store(tstore, jstore, f"frame {frame}")
    counts = n(tstore.counts)
    assert counts.max() == 8 and (counts[:len(coords)] < 8).any()


@pytest.fixture(scope="module")
def gather_case():
    """A random map whose voxels hold 0..K=8 points (half of them none),
    rays of H hit slots and S samples near their slot's voxel."""
    coords = map_coords(1, count=80, lo=-3, hi=3)
    jstate = jvh.build_map_state_numpy(coords, MAP)
    nv = int(jstate.num_voxels)
    rng = np.random.default_rng(11)
    pts, cols, valid = _random_cloud(rng, coords[: len(coords) // 2], 250,
                                     MAP.voxel_size)
    jstore = jpf.insert_frame_points(
        jpf.init_point_store(MAP, 8), jstate, jnp.asarray(pts),
        jnp.asarray(cols), jnp.asarray(valid), MAP)
    R, H, S = 24, 6, 20
    hits = rng.integers(-1, nv, (R, H)).astype(np.int32)
    bins = rng.integers(0, H, (R, S)).astype(np.int32)
    vox_xyz = (np.asarray(jvh.unpack_key(jnp.asarray(
        np.asarray(jstate.voxel_keys)[np.maximum(hits, 0)]))) + 0.5
        ) * MAP.voxel_size                               # (R, H, 3) centers
    sample = (np.take_along_axis(vox_xyz, bins[..., None], axis=1)
              + rng.uniform(-0.15, 0.15, (R, S, 3))).astype(np.float32)
    params = j_init_pn(jax.random.PRNGKey(5), 16)
    wts = rng.standard_normal((R, S, 16)).astype(np.float32)
    return jstore, sample, bins, hits, params, wts


def test_gather_pcd_features_and_grads_match(gather_case):
    jstore, sample, bins, hits, params, wts = gather_case

    def jf(s, p):
        f = jpf.gather_pcd_features(s, jnp.asarray(bins), jnp.asarray(hits),
                                    jstore, p, MAP.voxel_size)
        return jnp.sum(f * wts), f

    (_, fj), (gs, gp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(sample), params)

    ts = point_store_from_numpy(jstore, device="cpu")
    s_t = t(sample).requires_grad_(True)
    p_t = params_from_jax(params, device="cpu")
    for p in tree_leaves(p_t):
        p.requires_grad_(True)
    ft = tpf.gather_pcd_features(s_t, t(bins), t(hits), ts, p_t,
                                 MAP.voxel_size)
    (ft * t(wts)).sum().backward()

    assert (np.abs(n(fj)).sum(-1) == 0).any()       # some empty voxels
    assert (np.abs(n(fj)).sum(-1) > 0).mean() > 0.3
    assert_close_scaled(ft, fj, 1e-5, "features")
    assert_close_scaled(s_t.grad, gs, 1e-4, "d_sampled_xyz")
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(gp)):
        assert_close_scaled(a.grad, b, 1e-4, "d_pointnet")


def test_pointless_voxel_gives_zeros_and_finite_grad(gather_case):
    jstore, sample, bins, hits, params, _ = gather_case
    ts = point_store_from_numpy(jstore, device="cpu")
    empty = int(np.flatnonzero(n(ts.counts) == 0)[0])
    hits_e = torch.full((1, 1), empty, dtype=torch.int32)
    s_t = t(sample[:1, :1]).requires_grad_(True)
    out = tpf.gather_pcd_features(s_t, torch.zeros((1, 1), dtype=torch.int32),
                                  hits_e, ts, params_from_jax(
                                      params, device="cpu"), MAP.voxel_size)
    assert torch.all(out == 0.0)
    out.sum().backward()
    assert torch.isfinite(s_t.grad).all()
