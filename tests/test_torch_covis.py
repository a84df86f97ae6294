"""Covisibility-weighted keyframe windows (``covis_angle_deg > 0``): the
port's ``SlamSystem._covis_angles`` against the JAX engine's ``_covis_fn``,
its ``_select_window`` against the JAX engine's with the same angles and
the same numpy seed, and a lockstep of both engines (state set to the JAX
engine's after every frame, as ``test_torch_slam.py`` does) in which the
windows and the lagged angles agree on every frame.

Tolerances: angles 1e-3 degrees, 0.05 degrees where the angle is under
1 degree (``arccos`` near 1 turns an f32 difference of the rotation
matrices' products into ~0.03 degrees at an angle of 0); windows exactly;
the lockstep's poses as ``test_torch_slam.py`` holds them (its budgets cut
to 10 tracking and 10 initial mapping iterations: the windows and the lag
are what is held here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam

from test_torch_engine import map_draws, settings, track_draws
from test_torch_slam import POSE_TOL, fused_jax, sync_from_jax  # noqa: F401
from torch_parity import n, port_system, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ANGLE = 30.0


def covis_settings(**mapper):
    s = settings()
    return dataclasses.replace(s, mapper=dataclasses.replace(
        s.mapper, covis_angle_deg=ANGLE, **mapper))


def _pair(s, seed=0, hw=(24, 32)):
    intr = (40.0, 40.0, 16.0, 12.0)
    return (JSlam(s, intr, hw, seed=seed),
            TSlam(port_system(s), intr, hw, seed=seed, device="cpu"))


def _random_poses(K, seed):
    """Keyframe-store poses at angles from 0 to ~170 degrees to slot 3,
    a few within a degree of it."""
    rng = np.random.default_rng(seed)
    p = np.zeros((K, 6), np.float32)
    p[:, :3] = rng.normal(0, 1, (K, 3))
    p[:, 3:] = rng.normal(0, 1, (K, 3))
    p[:, 3:] *= (rng.uniform(0, 3.0, K) / np.linalg.norm(p[:, 3:], axis=1)
                 )[:, None]
    p[5, 3:] = p[3, 3:]                               # angle 0
    for k in (6, 7, 8):
        p[k, 3:] = p[3, 3:] + rng.normal(0, 3e-3, 3)  # ~0.1-0.5 degrees
    return p


@pytest.mark.parametrize("slot", [3, 0])
def test_covis_angles_match(slot):
    s = covis_settings()
    js, ts = _pair(s)
    K = s.mapper.max_keyframes
    poses = _random_poses(K, seed=slot + 1)
    js.store = js.store._replace(poses=jnp.asarray(poses))
    ts.store.poses[:] = t(poses)
    want = np.asarray(js._covis(js.store.poses, jnp.int32(slot)))
    got = n(ts._covis_angles(slot))
    assert got.shape == want.shape == (K,)
    small = want < 1.0
    np.testing.assert_allclose(got[~small], want[~small], atol=1e-3)
    np.testing.assert_allclose(got[small], want[small], atol=0.05)
    assert want.max() > 90.0 and small.sum() >= 1


@pytest.mark.parametrize("anchor", [False, True])
def test_select_window_matches_jax(anchor):
    """The JAX engine's angles injected into both, many draws from one
    numpy seed: the same windows, draw for draw (and a uniform draw while
    no angles have arrived)."""
    s = covis_settings(window_size=4, window_include_anchor=anchor)
    js, ts = _pair(s)
    js.rng = np.random.default_rng(5)
    ts.rng = np.random.default_rng(5)
    poses = _random_poses(s.mapper.max_keyframes, seed=9)
    js.store = js.store._replace(poses=jnp.asarray(poses))
    angles = np.asarray(js._covis(js.store.poses, jnp.int32(3)))
    weighted = 0
    for i in range(60):
        cv = None if i < 5 else angles
        js._covis_host = ts._covis_host = cv
        js.num_kf = ts.num_kf = 4 + i % 9
        sel_j, valid_j = js._select_window()
        sel_t, valid_t = ts._select_window()
        assert sel_t == np.asarray(sel_j).tolist(), i
        assert valid_t == np.asarray(valid_j).tolist(), i
        weighted += cv is not None and ts.num_kf > s.mapper.window_size
    assert weighted > 40


def test_covis_lockstep():
    """Both engines over 9 frames at keyframe_gap 2 (commits at frames 3, 6
    and 9, so the covisibility rule draws the windows of frames 7 and 8):
    the lagged angles (none before frame 3, then those written two frames
    earlier) and the windows agree on every frame."""
    ds = SyntheticDataset(num_frames=9, width=64, height=48)
    s = covis_settings(keyframe_gap=2, init_iterations=10)
    s = dataclasses.replace(s, tracker=dataclasses.replace(
        s.tracker, num_iterations=10))
    js = JSlam(s, ds.intrinsics, (ds.height, ds.width), seed=0)
    keys = []
    next_key = js._next_key

    def recording_next_key():
        keys.append(next_key())
        return keys[-1]
    js._next_key = recording_next_key
    P = ds.height * ds.width
    used = [0]

    def draw_source(kind, wsel):
        k = keys[used[0]]
        used[0] += 1
        if kind == "track":
            return track_draws(k, s, P)
        return map_draws(k, s, wsel, P)

    ts = TSlam(port_system(s), ds.intrinsics, (ds.height, ds.width), seed=0,
               device="cpu", draw_source=draw_source)
    windows = {"jax": [], "port": []}
    for name, sys_ in (("jax", js), ("port", ts)):
        sel_fn = sys_._select_window

        def recording(fn=sel_fn, out=windows[name]):
            sel, valid = fn()
            out.append([int(v) for v in np.asarray(sel)])
            return sel, valid
        sys_._select_window = recording
    sync_from_jax(ts, js)
    _, rgb, depth, _, pose0 = ds[0]
    js.initialize(rgb, depth, pose0, stamp=0)
    ts.initialize(rgb, depth, pose0, stamp=0)
    sync_from_jax(ts, js)
    drawn = 0
    for i in range(1, len(ds)):
        _, rgb, depth, _, _ = ds[i]
        num_kf = js.num_kf
        js.process_frame(i, rgb, depth)
        ts.process_frame(i, rgb, depth)
        what = f"frame {i}"
        assert (ts._covis_host is None) == (js._covis_host is None), what
        assert (ts._covis_host is None) == (i < 3), what
        if ts._covis_host is not None:
            want = np.asarray(js._covis_host)
            small = want < 1.0
            np.testing.assert_allclose(ts._covis_host[~small], want[~small],
                                       atol=1e-3, err_msg=what)
            np.testing.assert_allclose(ts._covis_host[small], want[small],
                                       atol=0.05, err_msg=what)
        assert windows["port"][-1] == windows["jax"][-1], what
        assert (ts.num_kf, ts.kf_stamps) == (js.num_kf, list(js.kf_stamps))
        np.testing.assert_allclose(n(ts.store.poses), n(js.store.poses),
                                   atol=POSE_TOL, err_msg=what)
        drawn += (js._covis_host is not None
                  and num_kf > s.mapper.window_size)
        sync_from_jax(ts, js)
    assert drawn >= 2
    assert used[0] == len(keys)
