"""Multi-frame lockstep of the port's ``SlamSystem`` against the JAX
package's, with the JAX fused render branch forced on (interpret mode) and
the same random draws: the port consumes pixel indices and noise computed
from the JAX engine's own key sequence.

Both engines start from the same initial embeddings and decoder (through
the weight bridge), and after every frame the port's continuous state
(map, decoder, optimizer moments, keyframe store, last poses) is set to the
JAX engine's. Each frame therefore starts from one state in both, and the
host-side logic of the system (frame quantization, velocity prior, window
choice from the numpy RNG, keyframe commits, insert stride, freshness
history) is held exactly while the float state is held to one frame's
worth of difference. A free-running comparison cannot be held to mm: at
this tiny size (64x48 frames, 256 rays) the JAX engine alone, given
initial embeddings perturbed by 1e-6 relative, drifts from itself by
0.8 mm at frame 2 and 3.3 mm at frame 4 (measured on the CPU).

Tolerances: after ``initialize`` (from one initial state), the embedding
updates as ``test_torch_engine.py`` holds them; then, per frame, tracked
and refined poses 1e-4 (m / rad; the decoders agree to ~1e-7 relative, see
``test_torch_renderer.py``, and 30 Adam steps amplify that), voxel and
cell counts, voxel tables and keyframe commits exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest

from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu_torch.engine.adam import AdamState
from proudslam_tpu_torch.engine.mapper import MapOptState
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam
from proudslam_tpu_torch.engine.state import KeyframeStore
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax)

from test_torch_engine import (assert_adam_updates_close, map_draws,
                               settings, track_draws)
from torch_parity import n, port_system, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 6
POSE_TOL = 1e-4


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setattr(jrk, "fused_render_applicable",
                        lambda dec: dec.use_fused_mlp and dec.depth == 2
                        and not dec.skips and dec.embedder == "none")


@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num_frames=N_FRAMES, width=64, height=48)


def _adam(state) -> AdamState:
    return AdamState(m=[t(a) for a in jax.tree.leaves(state.m)],
                     v=[t(a) for a in jax.tree.leaves(state.v)],
                     t=int(state.t))


def sync_from_jax(ts: TSlam, js: JSlam) -> None:
    """Set the port's continuous state to the JAX engine's."""
    ts.map_state = map_state_from_numpy(js.map_state, device="cpu")
    ts.decoder_params = params_from_jax(js.decoder_params, device="cpu")
    ts.opt = MapOptState(embed=_adam(js.opt.embed),
                         decoder=_adam(js.opt.decoder))
    st = js.store
    ts.store = KeyframeStore(
        rgb=t(st.rgb), depth=t(st.depth), stamps=t(st.stamps),
        poses=t(st.poses), adam_m=t(st.pose_adam.m),
        adam_v=t(st.pose_adam.v), adam_t=t(st.pose_adam.t))
    for name in ("last_pose6", "prev_pose6"):
        v = getattr(js, name)
        setattr(ts, name, None if v is None else t(v))


def assert_same_map(ts: TSlam, js: JSlam, what: str) -> None:
    jm, tm = js.map_state, ts.map_state
    assert tm.num_voxels == int(jm.num_voxels), what
    assert tm.num_cells == int(jm.num_cells), what
    nv = tm.num_voxels
    np.testing.assert_array_equal(n(tm.voxel_keys)[:nv],
                                  n(jm.voxel_keys)[:nv], err_msg=what)
    np.testing.assert_array_equal(n(tm.voxel_vertex_ids)[:nv],
                                  n(jm.voxel_vertex_ids)[:nv], err_msg=what)


def test_slam_lockstep(dataset):
    """initialize + 5 frames, keyframes committed every other frame (so
    the window is drawn from the numpy RNG once three are committed):
    per-frame poses to 1e-4, maps and keyframe commits exactly."""
    _lockstep(dataset, settings(fresh_window_frames=3), N_FRAMES)


def test_slam_lockstep_in_dim_32(dataset):
    """The same lockstep with a decoder of in_dim 32 on embeddings of 32
    values (the CUDA kernels' second built in_dim), over initialize + 2
    frames (a keyframe committed at frame 2)."""
    s = settings(fresh_window_frames=3)
    s = dataclasses.replace(
        s, map=dataclasses.replace(s.map, embed_dim=32),
        decoder=dataclasses.replace(s.decoder, in_dim=32))
    _lockstep(dataset, s, 3)


def _lockstep(dataset, s, n_frames):
    s = dataclasses.replace(s, mapper=dataclasses.replace(s.mapper,
                                                          keyframe_gap=1))
    js = JSlam(s, dataset.intrinsics, (dataset.height, dataset.width),
               seed=0)
    keys = []
    next_key = js._next_key

    def recording_next_key():
        k = next_key()
        keys.append(k)
        return k
    js._next_key = recording_next_key

    P = dataset.height * dataset.width
    used = [0]

    def draw_source(kind, wsel):
        k = keys[used[0]]
        used[0] += 1
        if kind == "track":
            return track_draws(k, s, P)
        return map_draws(k, s, wsel, P)

    ts = TSlam(port_system(s), dataset.intrinsics,
               (dataset.height, dataset.width), seed=0, device="cpu",
               draw_source=draw_source)
    sync_from_jax(ts, js)
    emb0 = n(js.map_state.embeddings).copy()

    frames = [dataset[i] for i in range(n_frames)]
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
    for i in range(1, len(frames)):
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
    # a commit every other frame: at 6 frames, frame 5 drew its window
    # from the RNG
    assert ts.num_kf >= 1 + (n_frames - 1) // 2
    np.testing.assert_allclose(ts.get_trajectory(), js.get_trajectory(),
                               atol=POSE_TOL)
    assert used[0] == len(keys)                  # every draw was consumed
