"""Checkpoint interchange: ``proudslam_tpu_torch/utils/checkpoint.py``
against ``proudslam_tpu/utils/checkpoint.py``, both ways, in one file
layout (``.npz`` of ``leaf_i`` in JAX's ``tree_flatten`` order + the
``.meta.json`` sidecar).

A JAX system after ``initialize`` (plus two skipped frames, a second
keyframe and perturbed keyframe poses, so the trajectory has more than one
reference keyframe) is saved by the JAX package and loaded by the port:
every array equal, the trajectory within 1e-6. The port's system is saved
by the port and loaded by the JAX package: every leaf equal. A port round
trip is bit-exact. Fresh systems of both feature modes (the pcd decoder
carries the PointNet params) interchange too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu.utils import checkpoint as jck
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam
from proudslam_tpu_torch.utils import checkpoint as tck

from test_torch_refine import unfused_settings
from torch_parity import n, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_leaves(ts):
    return tck._leaves(ts)


def _jax_leaves(js):
    leaves, _, _ = jck._flatten_state(js)
    return [np.asarray(x) for x in leaves]


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


@pytest.fixture(scope="module")
def jax_system():
    ds = SyntheticDataset(num_frames=2, width=64, height=48)
    s = unfused_settings()
    js = JSlam(s, ds.intrinsics, (ds.height, ds.width), seed=3)
    _, rgb, depth, _, pose = ds[0]
    js.initialize(rgb, depth, pose, stamp=0)
    js.skip_frame(1)
    js.skip_frame(2)
    rng = np.random.default_rng(0)
    js.store = js.store._replace(poses=js.store.poses.at[:3].add(
        jnp.asarray(0.01 * rng.standard_normal((3, 6)), jnp.float32)))
    js.num_kf = 2
    js.kf_stamps = [0, 2]
    js.frame_poses.append((1, jnp.asarray(np.eye(4) + 0.01 * np.triu(
        rng.standard_normal((4, 4)), 1), jnp.float32)))
    return js, s, ds


def _port(s, ds, seed=0, **kw):
    return TSlam(port_system(s), ds.intrinsics, (ds.height, ds.width),
                 seed=seed, device="cpu", **kw)


def test_jax_save_port_load(jax_system, tmp_path):
    js, s, ds = jax_system
    path = str(tmp_path / "ck.npz")
    jck.save_checkpoint(path, js)
    ts = tck.load_checkpoint(path, _port(s, ds))
    _assert_leaves_equal(_port_leaves(ts), _jax_leaves(js))
    assert (ts.num_kf, ts.kf_stamps) == (js.num_kf, js.kf_stamps)
    assert [r for r, _ in ts.frame_poses] == [r for r, _ in js.frame_poses]
    np.testing.assert_allclose(ts.get_trajectory(), js.get_trajectory(),
                               atol=1e-6)


def test_port_save_jax_load(jax_system, tmp_path):
    js, s, ds = jax_system
    path = str(tmp_path / "ck.npz")
    jck.save_checkpoint(path, js)
    ts = tck.load_checkpoint(path, _port(s, ds))
    # move the port's state off the JAX one, then hand it back
    ts.store.poses[1:3] += 0.001
    ts.num_kf, ts.kf_stamps = 3, [0, 2, 5]
    ts.skip_frame(5)
    tck.save_checkpoint(str(tmp_path / "port"), ts)
    j2 = jck.load_checkpoint(str(tmp_path / "port.npz"),
                             JSlam(s, ds.intrinsics, (ds.height, ds.width),
                                   seed=1))
    _assert_leaves_equal(_jax_leaves(j2), _port_leaves(ts))
    assert (j2.num_kf, j2.kf_stamps) == (3, [0, 2, 5])
    np.testing.assert_allclose(j2.get_trajectory(), ts.get_trajectory(),
                               atol=1e-6)


def test_port_round_trip_bit_exact(jax_system, tmp_path):
    js, s, ds = jax_system
    jck.save_checkpoint(str(tmp_path / "j.npz"), js)
    a = tck.load_checkpoint(str(tmp_path / "j.npz"), _port(s, ds))
    a.store.poses[2] += 0.0123
    tck.save_checkpoint(str(tmp_path / "a.npz"), a)
    b = tck.load_checkpoint(str(tmp_path / "a.npz"), _port(s, ds, seed=9))
    _assert_leaves_equal(_port_leaves(b), _port_leaves(a))
    assert (b.num_kf, b.kf_stamps) == (a.num_kf, a.kf_stamps)
    for (ra, xa), (rb, xb) in zip(a.frame_poses, b.frame_poses):
        assert ra == rb and torch.equal(xa, xb)
    np.testing.assert_array_equal(b.get_trajectory(), a.get_trajectory())


@pytest.mark.parametrize("mode", ["vox", "pcd"])
def test_fresh_systems_interchange(jax_system, tmp_path, mode):
    """Before ``initialize`` (``last_pose6`` saved as zeros), in both
    feature modes: the leaf layouts agree both ways."""
    _, s, ds = jax_system
    if mode == "pcd":
        s = dataclasses.replace(s, render=dataclasses.replace(
            s.render, feature_mode="pcd"))
    js = JSlam(s, ds.intrinsics, (ds.height, ds.width), seed=0)
    jck.save_checkpoint(str(tmp_path / "j"), js)
    ts = tck.load_checkpoint(str(tmp_path / "j"), _port(s, ds, seed=4))
    _assert_leaves_equal(_port_leaves(ts), _jax_leaves(js))
    assert ("pointnet" in ts.decoder_params) == (mode == "pcd")
    tck.save_checkpoint(str(tmp_path / "t"), _port(s, ds, seed=5))
    j2 = jck.load_checkpoint(str(tmp_path / "t"), js)
    _assert_leaves_equal(_jax_leaves(j2),
                         [n(x) for x in np.load(str(tmp_path / "t.npz"))
                          .values()])
    assert jax.tree.structure(j2.decoder_params) == \
        jax.tree.structure(js.decoder_params)
