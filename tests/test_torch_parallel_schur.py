"""The port's Schur-structured distributed Gauss-Newton step
(``proudslam_tpu_torch/parallel/schur.py``: per-row H_ww blocks
reduce-scattered to their owners, owner-local batched Cholesky, an
all-reduced dense pose system) on 2 and 4 gloo ranks, against its dense
joint solve (``dense_gn_reference``, float64) and against the JAX step on
meshes of 2 and 4 of the conftest's CPU devices (which ``test_schur.py``
holds against the JAX dense solve), on the same numpy inputs
(``tests/test_schur.py``'s wall, embeddings and 3 x 64 rays).

Tolerances are ``test_schur.py``'s: residual norm rtol 1e-5, pose and
embedding updates atol 5e-4 against a dense solve; across mesh sizes
poses atol 2e-5 and embeddings atol 2e-4.
"""

import jax
import numpy as np
import pytest

import test_schur as jt
from proudslam_tpu.parallel.schur import make_schur_gn_step
from proudslam_tpu.parallel.spatial import make_joint_mesh
from torch_parallel import Ranks
from torch_parity import port_system


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    settings, state, params = jt.setup()
    poses, dirs, gt_d, noise, anchor = jt.make_batch(settings)
    tmp = tmp_path_factory.mktemp("schur")
    args = dict(settings=port_system(settings),
                state={f: np.asarray(getattr(state, f))
                       for f in state._fields},
                params=jax.tree.map(np.asarray, params),
                batch=[np.asarray(b) for b in (poses, dirs, gt_d, noise)],
                anchor=np.asarray(anchor))
    ranks = {n: Ranks(tmp, n, "schur_job", reference=n == 2, **args)
             for n in (2, 4)}
    jax_out = {}
    for n in (2, 4):
        res = make_schur_gn_step(make_joint_mesh(n), settings, damping=1e-3)(
            state, params, poses, dirs, gt_d, noise, anchor)
        jax_out[n] = jax.tree.map(np.asarray, tuple(res))
    return jax_out, {n: r.wait() for n, r in ranks.items()}


def assert_gn_close(got, want):
    d_emb, d_poses, r_norm = got
    w_emb, w_poses, w_r = want
    np.testing.assert_allclose(float(r_norm), float(w_r), rtol=1e-5)
    np.testing.assert_allclose(d_poses, w_poses, atol=5e-4)
    np.testing.assert_allclose(d_emb, w_emb, atol=5e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_schur_matches_dense_reference(runs, n):
    jax_out, port = runs
    dense = port[2][0]["dense"]
    for rank in port[n]:
        got = rank["d3"]
        assert_gn_close(got, dense)            # the port's own oracle
        assert_gn_close(got, jax_out[n])       # the JAX step on n devices
        # gauge anchor: slot 0 never moves
        assert np.allclose(got[1][0], 0.0)
    # the step is non-trivial
    assert np.abs(dense[1][1:]).max() > 1e-6
    assert np.abs(dense[0]).max() > 1e-6


def test_schur_step_reduces_residual(runs):
    """Map-only GN (every pose anchored) is a descent direction: a
    backtracking search along it lowers the residual."""
    _, port = runs
    for n in (2, 4):
        rank = port[n][0]
        d_emb, d_poses, r0 = rank["map_only"]
        assert np.allclose(d_poses, 0.0)
        assert min(rank["search"]) < float(r0), (float(r0), rank["search"])


def test_schur_rank_count_independent(runs):
    """The factorization gives the same step on 2 and 4 ranks (and on
    every rank)."""
    _, port = runs
    for key in ("d3", "d4"):
        a, b = port[2][0][key], port[4][0][key]
        np.testing.assert_allclose(a[1], b[1], atol=2e-5)
        np.testing.assert_allclose(a[0], b[0], atol=2e-4)
        for rank in port[4][1:]:
            for x, y in zip(rank[key], port[4][0][key]):
                np.testing.assert_array_equal(x, y)
