"""Engine parity on the unfused vox branch (``use_fused_mlp=False`` with an
f32 decoder, the configs' default), and the end-of-run operations: a
4-frame lockstep of the port's ``SlamSystem`` against the JAX package's in
the manner of ``test_torch_slam.py`` (same draws, the port's continuous
state reset to the JAX engine's after every frame), then, from one shared
state, ``finalize(1)``, ``global_refine(anchored=True)`` and
``rebake_map`` with the JAX engine's draws injected. Also the frame guards
(``validate_frame``, ``skip_frame``) of ``tests/test_loaders.py`` and
``tests/test_robustness.py`` on the port.

Tolerances: poses 1e-4 (m / rad) after every frame and every operation,
as in ``test_torch_slam.py``; maps and keyframe commits exactly; the
embedding updates of ``finalize`` and ``rebake_map`` as
``test_torch_engine.assert_adam_updates_close`` holds them; the frozen
poses and decoder bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu_torch.data.synthetic import BenchDataset
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam
from proudslam_tpu_torch.models.decoder import tree_leaves

from test_torch_engine import (assert_adam_updates_close, map_draws,
                               settings, track_draws)
from test_torch_slam import assert_same_map, sync_from_jax
from torch_parity import n, port_system, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 4
POSE_TOL = 1e-4


def unfused_settings():
    """``test_torch_engine.settings`` on the unfused f32 branch, cut for
    time: 12 hit slots / 36 samples per ray, 128 rays, 10 tracking and 3
    mapping iterations, 6 initial ones, width-32 decoder."""
    s = settings(fresh_window_frames=3)
    return dataclasses.replace(
        s, render=dataclasses.replace(s.render, step_size=0.04,
                                      max_samples=36),
        decoder=dataclasses.replace(s.decoder, width=32, sdf_dim=32,
                                    use_fused_mlp=False, matmul_dtype="f32"),
        tracker=dataclasses.replace(s.tracker, n_rays=128, num_iterations=10),
        mapper=dataclasses.replace(s.mapper, n_rays_each=128,
                                   num_iterations=3, init_iterations=6,
                                   keyframe_gap=1))


@pytest.fixture(scope="module")
def lockstep():
    """Both engines after initialize + frames 1..3 (keyframes 0 and 2
    committed), the port's state synced to the JAX engine's, with the
    draw recorder shared by the later operations."""
    ds = SyntheticDataset(num_frames=N_FRAMES, width=64, height=48)
    s = unfused_settings()
    js = JSlam(s, ds.intrinsics, (ds.height, ds.width), seed=0)
    keys, rebake = [], []
    next_key = js._next_key

    def recording_next_key():
        keys.append(next_key())
        return keys[-1]
    js._next_key = recording_next_key
    P = ds.height * ds.width
    used = [0]

    def draw_source(kind, wsel):
        if kind == "rebake":
            return rebake.pop(0)
        k = keys[used[0]]
        used[0] += 1
        if kind == "track":
            return track_draws(k, s, P)
        return map_draws(k, s, wsel, P)

    ts = TSlam(port_system(s), ds.intrinsics, (ds.height, ds.width), seed=0,
               device="cpu", draw_source=draw_source)
    sync_from_jax(ts, js)
    emb0 = n(js.map_state.embeddings).copy()
    frames = [ds[i] for i in range(N_FRAMES)]
    _, rgb, depth, _, pose0 = frames[0]
    js.initialize(rgb, depth, pose0, stamp=0)
    ts.initialize(rgb, depth, pose0, stamp=0)
    assert_same_map(ts, js, "initialize")
    mpr = s.mapper
    assert_adam_updates_close(
        ts.map_state.embeddings, js.map_state.embeddings, emb0,
        mpr.init_iterations // mpr.num_iterations * mpr.num_iterations
        * mpr.embed_lr)
    sync_from_jax(ts, js)
    for i in range(1, N_FRAMES):
        _, rgb, depth, _, _ = frames[i]
        js.process_frame(i, rgb, depth)
        ts.process_frame(i, rgb, depth)
        what = f"frame {i}"
        np.testing.assert_allclose(n(ts.last_pose6), n(js.last_pose6),
                                   atol=POSE_TOL, err_msg=what)
        np.testing.assert_allclose(n(ts.store.poses), n(js.store.poses),
                                   atol=POSE_TOL, err_msg=what)
        assert_same_map(ts, js, what)
        assert (ts.num_kf, ts.kf_stamps) == (js.num_kf, list(js.kf_stamps))
        sync_from_jax(ts, js)
    assert ts.num_kf == 2
    np.testing.assert_allclose(ts.get_trajectory(), js.get_trajectory(),
                               atol=POSE_TOL)
    assert used[0] == len(keys)
    return js, ts, s, rebake, used, keys


def test_unfused_lockstep(lockstep):
    """The fixture's checks, plus the per-frame telemetry of both."""
    js, ts, *_ = lockstep
    a, b = ts.get_track_stats(), js.get_track_stats()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
    np.testing.assert_allclose(a["hit_ratio"], b["hit_ratio"], atol=1e-6)


@pytest.mark.parametrize("op", ["finalize", "global_refine_anchored",
                                "rebake_map"])
def test_end_of_run_ops_match(lockstep, op):
    """One operation from the synced state: poses 1e-4; finalize and
    rebake_map freeze the poses (and finalize the decoder) bit for bit."""
    js, ts, s, rebake, used, keys = lockstep
    sync_from_jax(ts, js)
    poses0 = n(js.store.poses).copy()
    emb0 = n(js.map_state.embeddings).copy()
    dec0 = [n(x).copy() for x in jax.tree.leaves(js.decoder_params)]
    start = len(keys)
    mpr = s.mapper
    if op == "finalize":
        js.finalize(1)
        ts.finalize(1)
    elif op == "global_refine_anchored":
        js.global_refine(rounds=1, anchored=True)
        ts.global_refine(rounds=1, anchored=True)
    else:
        _, k = jax.random.split(js._key)
        E, D = js.map_state.embeddings.shape
        rebake.append(t(n(jax.random.normal(k, (E, D)))))
        emb0 = 0.01 * n(rebake[0])
        js.rebake_map(iterations=mpr.num_iterations)
        ts.rebake_map(iterations=mpr.num_iterations)
        assert not rebake
    assert len(keys) - start == 1          # one map round each
    assert used[0] == len(keys)
    np.testing.assert_allclose(n(ts.store.poses), n(js.store.poses),
                               atol=POSE_TOL)
    if op == "global_refine_anchored":
        moved = np.abs(n(js.store.poses) - poses0).max(axis=1)
        assert moved[0] == 0.0 and moved[1:3].max() > 0
        return
    np.testing.assert_array_equal(n(ts.store.poses), poses0)
    assert_adam_updates_close(ts.map_state.embeddings,
                              js.map_state.embeddings, emb0,
                              mpr.num_iterations * mpr.embed_lr)
    if op == "finalize":
        for a, b in zip(tree_leaves(ts.decoder_params), dec0):
            np.testing.assert_array_equal(n(a), b)


def test_validate_frame_guards():
    """``tests/test_loaders.py::test_validate_frame_guards`` on the port,
    with the JAX package's messages."""
    rgb = np.zeros((4, 4, 3), np.float32)
    depth = np.ones((4, 4), np.float32)
    TSlam.validate_frame(rgb, depth)
    bad_d = depth.copy()
    bad_d[0, 0] = np.nan
    bad_rgb = rgb.copy()
    bad_rgb[0, 0, 0] = np.inf
    for args, match in (((rgb, np.zeros((4, 4), np.float32)), "all-zero"),
                        ((rgb, bad_d), "non-finite"),
                        ((bad_rgb, depth), "non-finite")):
        with pytest.raises(ValueError, match=match) as te:
            TSlam.validate_frame(*args)
        with pytest.raises(ValueError) as je:
            JSlam.validate_frame(*args)
        assert str(te.value) == str(je.value)


def test_skip_frame_leading_corrupt_stays_aligned():
    """``tests/test_robustness.py::test_skip_frame_leading_corrupt_stays_
    aligned`` on the port (unfused branch): corrupt frames before the first
    tracked pose still produce trajectory entries."""
    ds = BenchDataset(num_frames=5, width=64, height=48, radius=1.1, seed=0)
    s = port_system(unfused_settings())
    slam = TSlam(s, ds.intrinsics, (ds.height, ds.width), seed=0,
                 device="cpu")
    rgb0, depth0 = ds.dequantized(0)
    slam.initialize(rgb0, depth0, ds.get_init_pose(), stamp=0)
    slam.frame_poses.clear()
    slam.skip_frame(1)
    slam.skip_frame(2)
    for i in range(3, 5):
        _, rgb, depth, _, _ = ds[i]
        slam.process_frame(i, rgb, depth)
    est = slam.get_trajectory()
    assert est.shape == (4, 4, 4)
    assert np.isfinite(est).all()
    np.testing.assert_array_equal(est[0], est[1])
    assert torch.equal(slam.frame_poses[0][1], torch.eye(4))
