"""Mesher parity: the port's ``mesher.py`` against the JAX package's on one
map and decoder carried across by the weight bridge: a random map (the
torch_parity map generator) with embeddings at a trained map's scale and
the decoder's sdf bias shifted so the decoded field crosses zero inside
the map.

Tolerances: ``grid_scores`` 1e-5 absolute with the f32 decoder (f32 sums
in another order) and 2e-3 with bf16 operands (a rounding-level
difference can flip one bf16 rounding, as in ``test_torch_renderer.py``);
``extract_mesh`` with cleaning against a depth cloud and vertex colors
(f32 decoder): vertex counts within 0.5%, symmetric Chamfer distance (mean
nearest-vertex distance both ways) under 1e-4 m, face counts within 0.5%,
and the colors of matched vertices (nearest vertex within 1e-5 m) within
1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from proudslam_tpu import mesher as jmesh
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu_torch import mesher as tmesh
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax)

from torch_parity import DEC, MAP, map_coords, n, port
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RES = 6


def _case(matmul_dtype):
    dec = dataclasses.replace(DEC, matmul_dtype=matmul_dtype,
                              use_fused_mlp=False)
    state = jvh.build_map_state_numpy(map_coords(0, count=160, lo=-3, hi=3),
                                      MAP)
    emb = (0.3 * np.random.default_rng(5).standard_normal(
        state.embeddings.shape)).astype(np.float32)
    state = state._replace(embeddings=jnp.asarray(emb))
    params = j_init(jax.random.PRNGKey(1), dec)
    return state, params, dec


@pytest.fixture(scope="module")
def f32_case():
    """The f32 case with the sdf bias moved to the median decoded value."""
    state, params, dec = _case("f32")
    grids, _ = jmesh.grid_scores(state, params, MAP, dec, res=RES)
    b = params["sdf_out"]["b"]
    params["sdf_out"]["b"] = b.at[0].add(-float(np.median(grids[..., 3])))
    return state, params, dec


@pytest.mark.parametrize("matmul_dtype,tol", [("f32", 1e-5), ("bf16", 2e-3)])
def test_grid_scores_match(f32_case, matmul_dtype, tol):
    state, params, _ = f32_case
    dec = dataclasses.replace(f32_case[2], matmul_dtype=matmul_dtype)
    gj, cj = jmesh.grid_scores(state, params, MAP, dec, res=RES)
    gt, ct = tmesh.grid_scores(map_state_from_numpy(state, device="cpu"),
                               params_from_jax(params, device="cpu"),
                               port(MAP), port(dec), res=RES, chunk=37)
    assert gt.shape == gj.shape == (int(state.num_voxels), RES, RES, RES, 4)
    np.testing.assert_array_equal(n(ct), cj)
    np.testing.assert_allclose(n(gt), gj, atol=tol)


def test_extract_mesh_matches(f32_case):
    state, params, dec = f32_case
    full = jmesh.extract_mesh(state, params, MAP, dec, res=RES,
                              require_color=False)
    assert len(full.faces) > 500
    # a depth cloud over part of the surface: cleaning drops the rest
    rng = np.random.default_rng(7)
    near = full.verts[full.verts[:, 0] < 0.0]
    cloud = (near + rng.normal(0, 0.01, near.shape)).astype(np.float32)
    mj = jmesh.extract_mesh(state, params, MAP, dec, res=RES,
                            depth_points=cloud)
    mt = tmesh.extract_mesh(map_state_from_numpy(state, device="cpu"),
                            params_from_jax(params, device="cpu"), port(MAP),
                            port(dec), res=RES, depth_points=cloud)
    assert 0 < len(mj.faces) < 0.9 * len(full.faces)
    assert abs(len(mt.verts) - len(mj.verts)) <= 0.005 * len(mj.verts)
    assert abs(len(mt.faces) - len(mj.faces)) <= 0.005 * len(mj.faces)
    d_tj, near_j = cKDTree(mj.verts).query(mt.verts)
    d_jt, _ = cKDTree(mt.verts).query(mj.verts)
    assert 0.5 * (d_tj.mean() + d_jt.mean()) < 1e-4
    assert mt.colors.shape == (len(mt.verts), 3)
    matched = d_tj < 1e-5
    assert matched.mean() > 0.99
    np.testing.assert_allclose(mt.colors[matched],
                               mj.colors[near_j[matched]], atol=1e-3)


def test_save_ply_matches(f32_case, tmp_path):
    """The PLY writer gives the JAX package's file for the same mesh."""
    verts = np.random.default_rng(0).random((5, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    colors = np.random.default_rng(1).random((5, 3)).astype(np.float32)
    for c in (None, colors):
        jmesh.save_ply(str(tmp_path / "j.ply"), jmesh.Mesh(verts, faces, c))
        tmesh.save_ply(str(tmp_path / "t.ply"), tmesh.Mesh(verts, faces, c))
        assert (tmp_path / "j.ply").read_text() == \
            (tmp_path / "t.ply").read_text()
