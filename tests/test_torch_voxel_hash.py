"""Voxel-hash parity: the integer tables of the port (cell keys/ids/voxel
slots, voxel keys/vertex ids, inverse vertex map, counts) equal the JAX
package's exactly, through a sequence of inserts that includes the steady
(small) insert budget and the capacity limits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                map_state_to_numpy)
from proudslam_tpu_torch.ops import voxel_hash as tvh

from torch_parity import MAP, n, port, t

INT_FIELDS = ("cell_keys", "cell_ids", "cell_vslot", "voxel_keys",
              "voxel_vertex_ids", "inv_map")


def assert_tables_equal(js, ts):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(n(getattr(ts, f)), n(getattr(js, f)),
                                      err_msg=f)
    assert ts.num_cells == int(js.num_cells)
    assert ts.num_voxels == int(js.num_voxels)


def test_pack_unpack_match():
    rng = np.random.default_rng(0)
    c = rng.integers(-600, 600, (500, 3)).astype(np.int32)
    kj = jvh.pack_coords(jnp.asarray(c))
    kt = tvh.pack_coords(t(c))
    np.testing.assert_array_equal(n(kt), n(kj))
    ok = np.all(np.abs(c) < 500, axis=1)
    np.testing.assert_array_equal(n(tvh.unpack_key(kt))[ok],
                                  n(jvh.unpack_key(kj))[ok])


def test_build_map_state_numpy_matches():
    coords = np.unique(np.random.default_rng(1).integers(-5, 5, (150, 3)),
                       axis=0)
    js = jvh.build_map_state_numpy(coords, MAP)
    ts = tvh.build_map_state_numpy(coords, port(MAP))
    assert_tables_equal(js, ts)
    np.testing.assert_array_equal(n(ts.embeddings), n(js.embeddings))
    # the bridge back to the JAX field layout and in again is lossless
    back = jvh.MapState(**map_state_to_numpy(ts))
    assert_tables_equal(back, map_state_from_numpy(back))
    for f in jvh.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _clouds(k, seed=3):
    """k overlapping point clouds (a moving blob), with invalid points."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        pts = (rng.normal(0.0, 0.6, (900, 3))
               + np.array([0.15 * i, 0.0, 0.05 * i])).astype(np.float32)
        valid = rng.random(900) > 0.1
        out.append((pts, valid))
    return out


@pytest.mark.parametrize("case", ["default", "steady", "cell_capacity",
                                  "voxel_capacity"])
def test_insert_sequence_matches(case):
    ms = MAP
    steady = None
    if case == "steady":
        ms = dataclasses.replace(MAP, frame_voxel_capacity=256)
        steady = 16
    elif case == "cell_capacity":
        ms = dataclasses.replace(MAP, num_embeddings=700,
                                 frame_voxel_capacity=256)
    elif case == "voxel_capacity":
        ms = dataclasses.replace(MAP, voxel_capacity=150,
                                 frame_voxel_capacity=256)
    js = jvh.init_map_state(ms, jax.random.PRNGKey(0))
    ts = map_state_from_numpy(js)
    for i, (pts, valid) in enumerate(_clouds(5)):
        cap = steady if (steady and i > 0) else None
        js = jvh.insert_points(js, jnp.asarray(pts), jnp.asarray(valid), ms,
                               frame_capacity=cap)
        ts = tvh.insert_points(ts, t(pts), t(valid), port(ms),
                               frame_capacity=cap)
        assert_tables_equal(js, ts)
    assert ts.num_voxels > 50


def test_lookups_match():
    coords = np.unique(np.random.default_rng(2).integers(-4, 4, (100, 3)),
                       axis=0)
    js = jvh.build_map_state_numpy(coords, MAP)
    ts = tvh.build_map_state_numpy(coords, port(MAP))
    q = np.random.default_rng(3).integers(-6, 6, (300, 3)).astype(np.int32)
    kj = jvh.pack_coords(jnp.asarray(q))
    np.testing.assert_array_equal(
        n(tvh.lookup_voxel_slots(ts, t(n(kj)))),
        n(jvh.lookup_voxel_slots(js, kj)))
    _, ids = jvh.lookup_cells(js, kj)
    np.testing.assert_array_equal(n(tvh.lookup_cells(ts, t(n(kj)))), n(ids))
