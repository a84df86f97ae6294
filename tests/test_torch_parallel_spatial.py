"""The port's spatially sharded BA step (``proudslam_tpu_torch/parallel/
spatial.py``: voxel table, embedding rows and rays over every rank, the
embedding gradient reduce-scattered to its owners) on 2 and 4 gloo ranks,
against the JAX step (``jax.shard_map``) on meshes of 2 and 4 of the
conftest's CPU devices, on the same numpy inputs (``tests/test_spatial.py``'s
wall and ray batch).

Tolerances: the sharded loss against the port's plain ``compute_loss`` on
the whole batch rtol 1e-5 (the JAX test's); against JAX loss rtol 2e-4,
poses atol 2e-5, embeddings and decoder weights atol 2e-4 (the JAX
package's mesh-against-single bounds); each owner's gradient rows against
the whole batch's gradient 1e-5 of its largest magnitude.
"""

import jax
import numpy as np
import pytest

import test_spatial as jt
from proudslam_tpu.parallel.spatial import (make_joint_mesh,
                                            make_spatial_ba_step)
from torch_parallel import Ranks
from torch_parity import port_system


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    settings, state, params = jt.setup()
    batch = jt.make_batch(settings)
    tmp = tmp_path_factory.mktemp("spatial")
    args = dict(settings=port_system(settings),
                state={f: np.asarray(getattr(state, f))
                       for f in state._fields},
                params=jax.tree.map(np.asarray, params),
                batch=[np.asarray(b) for b in batch])
    ranks = {n: Ranks(tmp, n, "spatial_job", **args) for n in (2, 4)}
    jax_out = {}
    for n in (2, 4):
        step = make_spatial_ba_step(make_joint_mesh(n), settings)
        jax_out[n] = jax.tree.map(np.asarray,
                                  step(state, params, *batch))
    return jax_out, {n: r.wait() for n, r in ranks.items()}, state


def test_spatial_loss_matches_unsharded_criterion(runs):
    """The reduced sharded loss == the plain loss on the whole batch."""
    _, port, _ = runs
    for n in (2, 4):
        for rank in port[n]:
            np.testing.assert_allclose(rank["grad_loss"], rank["loss_ref"],
                                       rtol=1e-5)
            np.testing.assert_allclose(float(rank["once"][3]),
                                       rank["loss_ref"], rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_matches_jax(runs, n):
    jax_out, port, _ = runs
    w_emb, w_dec, w_poses, w_loss = jax_out[n]
    for rank in port[n]:
        emb, dec, poses, loss = rank["once"]
        assert rank["shape"] == {"shard": n}
        np.testing.assert_allclose(float(loss), float(w_loss), rtol=2e-4)
        np.testing.assert_allclose(poses, w_poses, atol=2e-5)
        np.testing.assert_allclose(emb, w_emb, atol=2e-4)
        for a, b in zip(dec["layers"], w_dec["layers"]):
            np.testing.assert_allclose(a["w"], b["w"], atol=2e-4)


def test_spatial_embedding_grads_land_on_owner_shards(runs):
    """Each rank receives exactly its E/n rows of the whole batch's
    embedding gradient (the reduce-scatter), and the rows it does not own
    reach it from no rank."""
    _, port, _ = runs
    for n in (2, 4):
        for rank in port[n]:
            g_full, g_own = rank["g_full"], rank["g_own"]
            E = g_full.shape[0]
            r = rank["rank"]
            assert g_own.shape == (E // n, g_full.shape[1])
            scale = np.abs(g_full).max()
            assert scale > 0
            np.testing.assert_allclose(
                g_own / scale, g_full[r * E // n:(r + 1) * E // n] / scale,
                atol=1e-5)


def test_spatial_steps_reduce_loss(runs):
    """Five steps keep lowering the loss, and the embeddings move (the
    gradient reaches the owners through the plumbing)."""
    _, port, state = runs
    for n in (2, 4):
        losses = port[n][0]["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses
        assert not np.allclose(port[n][0]["emb_final"],
                               np.asarray(state.embeddings))
