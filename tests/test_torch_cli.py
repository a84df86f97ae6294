"""The port's CLI (``python -m proudslam_tpu_torch.run_slam``) on the CPU:
``configs/synthetic/room.yaml`` (the unfused f32 branch) cut to 6 frames
at 64x48 with small ray, sample and iteration budgets, run over frames
0-3, then resumed from its checkpoint over frames 4-5; every artifact the
JAX CLI writes (but ``imgs/``) is checked. Also ``parse_overrides`` and
``accumulate_depth_cloud`` against ``scripts/run_slam.py``'s (identical
outputs, the frame/pose offset included), and the refusals: no CPU
fallback for ``--device cuda``, no image panels.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from proudslam_tpu_torch import run_slam
from proudslam_tpu_torch.config import load_config, settings_from_config
from proudslam_tpu_torch.data.synthetic import SyntheticDataset
from proudslam_tpu_torch.engine.slam import SlamSystem
from proudslam_tpu_torch.utils.checkpoint import load_checkpoint
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "synthetic", "room.yaml")
SMALL = ("--data_specs.num_frames 6 --data_specs.width 64 "
         "--data_specs.height 48 --tracker_specs.N_rays 128 "
         "--tracker_specs.num_iterations 5 --mapper_specs.N_rays_each 128 "
         "--mapper_specs.num_iterations 3 --tpu_specs.init_iterations 30 "
         "--tpu_specs.max_samples 36 --mapper_specs.keyframe_gap 1 "
         "--mapper_specs.global_refine_rounds 1 "
         "--mapper_specs.mesh_res 4").split()


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_slam", os.path.join(ROOT, "scripts", "run_slam.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _artifacts(run_dir):
    poses = np.load(os.path.join(run_dir, "misc", "frame_poses.npy"))
    ply = open(os.path.join(run_dir, "mesh", "final_mesh.ply")).read()
    head, body = ply.split("end_header\n")
    nv = int(head.split("element vertex ")[1].split()[0])
    nf = int(head.split("element face ")[1].split()[0])
    lines = body.splitlines()
    assert len(lines) == nv + nf
    verts = np.array([[float(x) for x in ln.split()[:3]]
                      for ln in lines[:nv]])
    faces = np.array([[int(x) for x in ln.split()[1:]] for ln in lines[nv:]])
    assert nv > 0 and nf > 0 and np.isfinite(verts).all()
    assert faces.min() >= 0 and faces.max() < nv
    metrics = [json.loads(ln) for ln in
               open(os.path.join(run_dir, "metrics.jsonl"))]
    for f in ("final_ckpt.npz", "final_ckpt.meta.json"):
        assert os.path.exists(os.path.join(run_dir, "ckpt", f))
    assert os.path.exists(os.path.join(run_dir, "bak", "room.yaml"))
    assert not os.path.exists(os.path.join(run_dir, "imgs"))
    return poses, metrics


def test_cli_run_and_resume(tmp_path):
    logs = str(tmp_path / "logs")
    first = run_slam.main([CONFIG, "--device", "cpu", "--log_dir", logs,
                           "--tracker_specs.end_frame", "4", *SMALL])
    poses, metrics = _artifacts(first["dir"])
    assert poses.shape == (4, 4, 4) and np.isfinite(poses).all()
    assert metrics[-1]["ate_rmse_cm"] == pytest.approx(first["ate_cm"])
    ckpt = os.path.join(first["dir"], "ckpt", "final_ckpt")

    # the checkpoint reloads to the saved trajectory, bit for bit
    cfg = load_config(CONFIG, run_slam.parse_overrides(SMALL))
    ds = SyntheticDataset(6, 64, 48)
    slam = SlamSystem(settings_from_config(cfg), ds.intrinsics, (48, 64),
                      device="cpu")
    load_checkpoint(ckpt, slam)
    np.testing.assert_array_equal(slam.get_trajectory(), poses)

    second = run_slam.main([CONFIG, "--device", "cpu", "--log_dir", logs,
                            "--resume", ckpt, *SMALL])
    poses2, _ = _artifacts(second["dir"])
    assert second["frames"] == 2 and second["skipped"] == 0
    assert poses2.shape == (6, 4, 4) and np.isfinite(poses2).all()
    assert second["ate_cm"] < 50.0


def test_cli_refuses_without_fallback(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_slam.main([CONFIG, "--log_dir", str(tmp_path), *SMALL])
    with pytest.raises(NotImplementedError, match="render_freq"):
        run_slam.main([CONFIG, "--device", "cpu", "--log_dir", str(tmp_path),
                       "--debug_args.render_freq", "5", *SMALL])


def test_parse_overrides_and_depth_cloud_match():
    jcli = _jax_cli()
    argv = ["--a.b", "3", "--c", "2.5", "--d", "true", "--e", "False",
            "--f", "name"]
    assert run_slam.parse_overrides(argv) == jcli.parse_overrides(argv)
    ds = SyntheticDataset(5, 48, 36)
    cfg = load_config(CONFIG)
    s = settings_from_config(cfg)
    rng = np.random.default_rng(0)
    traj = np.stack(ds.poses).astype(np.float32)
    traj[:, :3, 3] += 0.01 * rng.standard_normal((5, 3)).astype(np.float32)
    for start in (0, 1, 3):
        got = run_slam.accumulate_depth_cloud(ds, traj, start, s,
                                              pixel_stride=2)
        ref = jcli.accumulate_depth_cloud(ds, traj, start, s, pixel_stride=2)
        assert len(got) > 100
        np.testing.assert_array_equal(got, ref)
