"""The engine in point-feature (pcd) mode: a multi-frame lockstep of the
port's ``SlamSystem`` against the JAX package's, and a free-running run of
the port alone.

Configuration: ``tests/test_pcd_features.py``'s end-to-end pcd settings
(48x36 frames, 192 rays, PointNet features of <= 8 points per voxel) on
the port's path: the decoder through the fused kernels (K2 forward, K3
backward; their plain versions here) with bf16 operands, and in the
lockstep also with f32 ones, and fixed per-round ray batches. The
JAX package reaches its fused decoder only on a TPU backend, so its
``fused_applicable`` is patched to skip that check and its
``decoder_values_fused`` to run in Pallas interpret mode.

Lockstep, as ``test_torch_slam.py``, with 8 tracking iterations and 8
initial mapping iterations to keep the JAX interpret-mode run short: the
same random draws, and the port's continuous state (map, decoder and
PointNet params, optimizer moments, keyframe store, point store, last
poses) reset to the JAX engine's after every frame. Held per frame:
tracked and refined poses 1e-4 (m / rad); voxel and cell counts, voxel
tables, keyframe commits, point counts and point colors exactly; stored
point positions 5e-4 m, since each frame's points are back-projected at
that frame's refined pose (1e-4 times depths of up to ~4 m; 1.8e-5 m
measured on the CPU). With f32 operands a point within those 5e-4 m of a
voxel face may land in the neighbouring voxel (``assert_same_points``).
After ``initialize`` the PointNet head's update is held as
``test_torch_engine.py`` holds Adam updates.

Free-running port: points accumulate, the mapper trains PointNet, the
trajectory stays finite and its unaligned ATE under the JAX test's own
functional bound for this branch (60 cm, ``tests/test_pcd_features.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

from proudslam_tpu.config import (DecoderSettings, LossSettings, MapSettings,
                                  MapperSettings, RenderSettings,
                                  SystemSettings, TrackerSettings)
from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu.ops.pallas import mlp_kernel as jmk
from proudslam_tpu.utils.metrics import ate_rmse
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam
from proudslam_tpu_torch.models.decoder import point_store_from_numpy
from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk
from proudslam_tpu_torch.ops.voxel_hash import unpack_key

from test_torch_engine import (assert_adam_updates_close, map_draws,
                               track_draws)
from test_torch_slam import assert_same_map, sync_from_jax
from torch_parity import n, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 5
POSE_TOL = 1e-4
XYZ_TOL = 5e-4
# bf16: the counts are held exactly (as before the f32 case existed); f32:
# frame 1 moves one of ~1,700 points across a voxel face (the engines'
# refined poses differ by 3.4e-6 there, CPU run), so a point within
# XYZ_TOL of a face may land on either side
FACE_TOL = {"bf16": 0.0, "f32": XYZ_TOL}


def pcd_settings() -> SystemSettings:
    return SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02, truncation=0.1,
                              max_distance=10.0, max_hits=12, max_samples=48,
                              feature_mode="pcd"),
        map=MapSettings(voxel_size=0.2, num_embeddings=8192, embed_dim=16,
                        voxel_capacity=4096, frame_voxel_capacity=1024,
                        points_per_voxel=8),
        decoder=DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64,
                                matmul_dtype="bf16", use_fused_mlp=True),
        tracker=TrackerSettings(n_rays=192, num_iterations=15,
                                learning_rate=0.01, fixed_sample_batch=True),
        mapper=MapperSettings(n_rays_each=192, window_size=2,
                              num_iterations=4, keyframe_gap=6,
                              max_keyframes=16, init_iterations=40,
                              fixed_sample_batch=True),
        loss=LossSettings())


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setattr(jmk, "fused_applicable",
                        lambda dec: dec.use_fused_mlp and dec.depth == 2
                        and not dec.skips and dec.embedder == "none")
    monkeypatch.setattr(jmk, "decoder_values_fused", functools.partial(
        jmk.decoder_values_fused, interpret=True))


@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num_frames=N_FRAMES, width=48, height=36)


def sync_pcd(ts: TSlam, js: JSlam) -> None:
    sync_from_jax(ts, js)
    ts.point_store = point_store_from_numpy(js.point_store, device="cpu")


def assert_same_points(ts: TSlam, js: JSlam, what: str,
                       face_tol: float = 0.0) -> None:
    """Point counts and colors equal, positions to XYZ_TOL. With
    ``face_tol`` > 0 a point within ``face_tol`` of a voxel face may have
    gone to the neighbouring voxel in one engine: the two engines' refined
    poses agree to ~1e-6, not bit for bit. Then the total count is equal,
    every voxel whose count differs holds such a point, and every other
    voxel is compared as above."""
    jp, tp = js.point_store, ts.point_store
    cj, ct = n(jp.counts), n(tp.counts)
    same = cj == ct
    if face_tol == 0.0:
        np.testing.assert_array_equal(ct, cj, err_msg=what)
    assert ct.sum() == cj.sum(), what
    vs = ts.settings.map.voxel_size
    centers = (n(unpack_key(ts.map_state.voxel_keys)) + 0.5) * vs
    for v in np.nonzero(~same)[0]:
        pts = np.concatenate([n(tp.xyz)[v, :ct[v]], n(jp.xyz)[v, :cj[v]]])
        to_face = vs / 2 - np.abs(pts - centers[v]).max(axis=1)
        assert to_face.min() < face_tol, (what, v, to_face.min())
    np.testing.assert_array_equal(n(tp.rgb)[same], n(jp.rgb)[same],
                                  err_msg=what)
    np.testing.assert_allclose(n(tp.xyz)[same], n(jp.xyz)[same],
                               atol=XYZ_TOL, err_msg=what)


@pytest.mark.parametrize("matmul_dtype", ["bf16", "f32"])
def test_pcd_slam_lockstep(dataset, matmul_dtype):
    """initialize + 4 frames, keyframes committed every other frame; held
    as the module docstring says, with the fused decoder's operands in
    bf16 or in f32 (the f32 form of K2/K3, the default ``matmul_dtype``)."""
    s = pcd_settings()
    s = dataclasses.replace(
        s, tracker=dataclasses.replace(s.tracker, num_iterations=8),
        mapper=dataclasses.replace(s.mapper, keyframe_gap=1,
                                   init_iterations=8),
        decoder=dataclasses.replace(s.decoder, matmul_dtype=matmul_dtype))
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
    assert "pointnet" in ts.decoder_params
    sync_pcd(ts, js)
    pn0 = n(js.decoder_params["pointnet"]["fc"]["w"]).copy()

    frames = [dataset[i] for i in range(len(dataset))]
    _, rgb, depth, _, pose0 = frames[0]
    js.initialize(rgb, depth, pose0, stamp=0)
    ts.initialize(rgb, depth, pose0, stamp=0)
    assert_same_map(ts, js, "initialize")
    assert_same_points(ts, js, "initialize")
    # PointNet trained by the mapper in both; embeddings not rendered from
    for name, eng in (("port", ts), ("jax", js)):
        pn1 = n(eng.decoder_params["pointnet"]["fc"]["w"])
        assert np.abs(pn1 - pn0).max() > 1e-5, name
    mpr = s.mapper
    assert_adam_updates_close(
        ts.decoder_params["pointnet"]["fc"]["w"],
        js.decoder_params["pointnet"]["fc"]["w"], pn0,
        mpr.init_iterations // mpr.num_iterations * mpr.num_iterations
        * mpr.decoder_lr)
    sync_pcd(ts, js)
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
        assert_same_points(ts, js, what, FACE_TOL[matmul_dtype])
        assert (ts.num_kf, ts.kf_stamps) == (js.num_kf, list(js.kf_stamps))
        sync_pcd(ts, js)
    assert ts.num_kf >= 3
    np.testing.assert_allclose(ts.get_trajectory(), js.get_trajectory(),
                               atol=POSE_TOL)
    assert used[0] == len(keys)                  # every draw was consumed


def test_pcd_slam_free_running(dataset):
    """The port alone (CPU tensors: kernels' plain versions, no launch)."""
    s = port_system(pcd_settings())
    slam = TSlam(s, dataset.intrinsics, (dataset.height, dataset.width),
                 seed=0, device="cpu")
    pn0 = slam.decoder_params["pointnet"]["fc"]["w"].clone()
    launches = (tmk.decoder_fwd.launches, tmk.decoder_bwd.launches)
    _, rgb, depth, _, pose0 = dataset[0]
    slam.initialize(rgb, depth, pose0, stamp=0)
    for i in range(1, len(dataset)):
        _, rgb, depth, _, _ = dataset[i]
        slam.process_frame(i, rgb, depth)
    assert (tmk.decoder_fwd.launches, tmk.decoder_bwd.launches) == launches
    assert int(slam.point_store.counts.sum()) > 500
    pn1 = slam.decoder_params["pointnet"]["fc"]["w"]
    assert float((pn1 - pn0).abs().max()) > 1e-5
    est = slam.get_trajectory()
    assert np.isfinite(est).all()
    ate = ate_rmse(est, np.stack(dataset.poses), align=False)
    assert ate < 0.6, f"pcd-mode ATE {ate * 100:.1f} cm"


def drift(n_frames: int) -> None:
    """Both engines free-running over ``n_frames`` frames of the test
    configuration (the JAX one with its fused decoder in interpret mode):
    per-frame position error and unaligned ATE, printed."""
    from proudslam_tpu.engine import slam as jslam

    ds = SyntheticDataset(num_frames=n_frames, width=48, height=36)
    gt = np.stack(ds.poses)
    js = jslam.SlamSystem(pcd_settings(), ds.intrinsics,
                          (ds.height, ds.width), seed=0)
    ts = TSlam(port_system(pcd_settings()), ds.intrinsics,
               (ds.height, ds.width), seed=0, device="cpu")
    for name, eng in (("jax", js), ("port", ts)):
        _, rgb, depth, _, pose0 = ds[0]
        eng.initialize(rgb, depth, pose0, stamp=0)
        for i in range(1, n_frames):
            _, rgb, depth, _, _ = ds[i]
            eng.process_frame(i, rgb, depth)
        est = eng.get_trajectory()
        err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 100
        print(f"{name}: position error per frame (cm):",
              " ".join(f"{e:.1f}" for e in err))
        print(f"{name}: unaligned ATE {ate_rmse(est, gt, align=False) * 100:.1f}"
              " cm")


def bench_drift(matmul_dtype: str, n_frames: int = 5,
                width: int = 128) -> None:
    """The JAX engine alone at the bench pcd configuration of
    ``chip_smoke.py``'s pcd slices (``bench.py``'s ``bench_settings()``
    with ``feature_mode="pcd"`` and 8 points per voxel; its XLA decoder at
    ``matmul_dtype`` and ``width``, 256 for ``pcd-f32-w256``): the first
    ``n_frames`` frames of the 480-frame
    ``scan`` orbit at 320x240, quantized as the slices quantize them,
    ``point_stride`` 2, then ``global_refine(rounds=2)``. Prints the
    per-frame position error and the unaligned ATE."""
    from bench import bench_settings
    from proudslam_tpu.data.synthetic import AnalyticScene, orbit_poses
    from proudslam_tpu.engine import slam as jslam

    W, H = 320, 240
    s = bench_settings()
    s = dataclasses.replace(
        s, render=dataclasses.replace(s.render, feature_mode="pcd"),
        map=dataclasses.replace(s.map, points_per_voxel=8),
        decoder=dataclasses.replace(s.decoder, matmul_dtype=matmul_dtype,
                                    width=width))
    poses = orbit_poses(480, radius=1.6, total_yaw=np.pi, yaw_wobble=1.0,
                        yaw_cycles=3.0, pitch_wobble=0.22, pitch_cycles=4.0)
    K = (0.9 * W, 0.9 * W, (W - 1) / 2.0, (H - 1) / 2.0)
    scene = AnalyticScene()
    dq = 65535.0 / 10.0
    frames = []
    for p in poses[:n_frames]:
        c, d = scene.render(p, W, H, *K)
        frames.append((np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8),
                       np.clip(d * dq + 0.5, 0, 65535.0).astype(np.uint16)))
    eng = jslam.SlamSystem(s, K, (H, W), seed=0, point_stride=2)
    eng.initialize(frames[0][0].astype(np.float32) / 255.0,
                   frames[0][1].astype(np.float32) / dq, poses[0], stamp=0)
    for i in range(1, n_frames):
        eng.process_frame(i, *frames[i])
    eng.global_refine(rounds=2)
    est = eng.get_trajectory()
    gt = np.stack(poses[:n_frames])
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 100
    tag = f"{matmul_dtype} width {width}"
    print(f"jax bench pcd {tag}: position error per frame (cm):",
          " ".join(f"{e:.2f}" for e in err))
    print(f"jax bench pcd {tag}: unaligned ATE "
          f"{ate_rmse(est, gt, align=False) * 100:.2f} cm, aligned "
          f"{ate_rmse(est, gt, align=True) * 100:.2f} cm")


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pcd_slam.py 20
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pcd_slam.py \
    #     bench bf16     (or f32: the JAX engine at the bench pcd size;
    #     bench f32 256: at decoder width 256)
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "bench":
        bench_drift(sys.argv[2],
                    width=int(sys.argv[3]) if len(sys.argv) > 3 else 128)
        sys.exit(0)
    jmk.fused_applicable = lambda dec: (dec.use_fused_mlp and dec.depth == 2
                                        and not dec.skips
                                        and dec.embedder == "none")
    jmk.decoder_values_fused = functools.partial(jmk.decoder_values_fused,
                                                 interpret=True)
    drift(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
