"""The port's sharded BA step (``proudslam_tpu_torch/parallel/sharded.py``:
rays on dp, embedding rows and the decoder's width on mp, every collective
written out) on 2 and 4 gloo ranks, against the JAX step on meshes of 2
and 4 of the conftest's CPU devices, on the same numpy inputs
(``tests/test_sharding.py``'s wall and ray batch).

Tolerances are the JAX package's own mesh-against-single bounds
(``test_sharding.py``): loss rtol 2e-4, poses atol 2e-5, embeddings and
decoder weights atol 2e-4.
"""

import jax
import numpy as np
import pytest

import proudslam_tpu_torch.config as pc
import test_sharding as jt
from proudslam_tpu.parallel.sharded import make_mesh, make_sharded_ba_step
from torch_parallel import Ranks
from torch_parity import port_system


# decoders the width split must take beyond the step's 2-layer one: a
# skip after the split layer, a 1-layer trunk (ends split), a 3-layer trunk
# with a skip after a row-split layer and the NeRF embedder (f32 operands)
TP_CASES = [pc.DecoderSettings(depth=3, width=64, sdf_dim=32, skips=(0,)),
            pc.DecoderSettings(depth=1, width=64, sdf_dim=32),
            pc.DecoderSettings(depth=3, width=64, sdf_dim=32, skips=(1,),
                               embedder="nerf", multires=2)]


def numpy_inputs():
    settings, state, params = jt.setup()
    batch = jt.make_batch(settings)
    return (settings, {f: np.asarray(getattr(state, f))
                       for f in state._fields},
            jax.tree.map(np.asarray, params),
            [np.asarray(b) for b in batch], state, params, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's step on 2 and 4 devices, and the port's on 2 ranks at mp 1
    and 2 and on 4 ranks at mp 2 and 4 (the rank processes run while JAX
    computes)."""
    settings, st, pr, bt, state, params, batch = numpy_inputs()
    tmp = tmp_path_factory.mktemp("sharded")
    args = dict(settings=port_system(settings), state=st, params=pr,
                batch=bt)
    ranks = {2: Ranks(tmp, 2, "sharded_job", mps=[None, 2], **args),
             4: Ranks(tmp, 4, "sharded_job", mps=[None, 4], **args),
             "tp": Ranks(tmp, 2, "tp_decoder_job", cases=TP_CASES)}
    jax_out = {}
    for n in (2, 4):
        mesh = make_mesh(n)
        with mesh:
            out = make_sharded_ba_step(mesh, settings)(state, params, *batch)
        jax_out[n] = (dict(shape=dict(mesh.shape)),
                      jax.tree.map(np.asarray, out))
    return jax_out, {n: r.wait() for n, r in ranks.items()}


def test_tp_decoder_matches_plain(runs):
    """The width-split decoder (skips, a 1-layer trunk, an embedder) on 2
    ranks against the plain decoder: outputs and the gradients w.r.t. the
    input and every leaf within 1e-5 of their largest magnitude (f32
    products summed in another order)."""
    _, port = runs
    for rank in port["tp"]:
        for case, errs in zip(TP_CASES, rank):
            assert max(errs.values()) < 1e-5, (case, errs)


def assert_step_close(port, want):
    emb, dec, poses, loss = port
    w_emb, w_dec, w_poses, w_loss = want
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=2e-4)
    np.testing.assert_allclose(poses, w_poses, atol=2e-5)
    np.testing.assert_allclose(emb, w_emb, atol=2e-4)
    for a, b in zip(jax.tree.leaves(dec), jax.tree.leaves(w_dec)):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_mesh_shapes(runs):
    jax_out, port = runs
    assert port[2][0][0]["shape"] == {"dp": 2, "mp": 1}
    assert port[2][0][1]["shape"] == {"dp": 1, "mp": 2}
    assert port[4][0][0]["shape"] == {"dp": 2, "mp": 2}
    assert port[4][0][1]["shape"] == {"dp": 1, "mp": 4}
    for n in (2, 4):
        assert port[n][0][0]["shape"] == jax_out[n][0]["shape"]


def test_sharded_step_runs_and_is_finite(runs):
    _, port = runs
    for rank in port[4]:
        for case in rank:
            emb, dec, poses, loss = case["result"]
            assert np.isfinite(float(loss))
            assert np.isfinite(emb).all() and np.isfinite(poses).all()
            assert all(np.isfinite(x).all() for x in jax.tree.leaves(dec))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_jax(runs, n):
    """Every mesh shape of n ranks (mp 1, 2 or 4) against JAX's step on
    n devices."""
    jax_out, port = runs
    for case in port[n][0]:
        assert_step_close(case["result"], jax_out[n][1])


def test_ranks_hold_the_same_result(runs):
    """The outputs are whole on every rank, and the same."""
    _, port = runs
    for n in (2, 4):
        for rank in port[n][1:]:
            for case, case0 in zip(rank, port[n][0]):
                for a, b in zip(jax.tree.leaves(case["result"]),
                                jax.tree.leaves(case0["result"])):
                    np.testing.assert_array_equal(a, b)
