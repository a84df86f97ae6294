"""The port's CLI (``python -m proudslam_tpu_torch.run_slam``) on the CPU:
``configs/synthetic/room.yaml`` (the unfused f32 branch) cut to 6 frames
at 64x48 with small ray, sample and iteration budgets, run over frames
0-3, then resumed from its checkpoint over frames 4-5; every artifact the
JAX CLI writes is checked. Also ``parse_overrides`` and
``accumulate_depth_cloud`` against ``scripts/run_slam.py``'s (identical
outputs, the frame/pose offset included), and the refusal of a CPU
fallback for ``--device cuda``.

The image panels: with ``debug_args.render_freq`` the run writes
``imgs/render_<frame>.png`` every ``render_freq`` frames, each decoding to
the panel's size, and its trajectory equals, bit for bit, that of the same
run without panels (the preview draws no engine noise). Every YAML under
``configs/`` parses to the JAX package's settings and passes the CLI's
checks before data loading; one YAML of each real-data family (replica,
scannet, arkit) runs end to end, panels and mesh included, on the fixture
directories of ``tests/test_loaders.py`` (the datasets are not in the
repo), cut down as above.
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from proudslam_tpu.config import load_config as j_load_config
from proudslam_tpu.config import settings_from_config as j_settings
from proudslam_tpu_torch import run_slam
from proudslam_tpu_torch.config import load_config, settings_from_config
from proudslam_tpu_torch.data.synthetic import SyntheticDataset
from proudslam_tpu_torch.engine.slam import SlamSystem
from proudslam_tpu_torch.utils.checkpoint import load_checkpoint
from test_loaders import (_write_depth16, arkit_dir,  # noqa: F401
                          replica_dir, scannet_dir)
from torch_parity import port_system
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
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_slam", os.path.join(ROOT, "scripts", "run_slam.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _artifacts(run_dir, config="room.yaml", panels=(), mesh=True):
    poses = np.load(os.path.join(run_dir, "misc", "frame_poses.npy"))
    if mesh:
        ply = open(os.path.join(run_dir, "mesh", "final_mesh.ply")).read()
        head, body = ply.split("end_header\n")
        nv = int(head.split("element vertex ")[1].split()[0])
        nf = int(head.split("element face ")[1].split()[0])
        lines = body.splitlines()
        assert len(lines) == nv + nf
        verts = np.array([[float(x) for x in ln.split()[:3]]
                          for ln in lines[:nv]])
        faces = np.array([[int(x) for x in ln.split()[1:]]
                          for ln in lines[nv:]])
        assert nv > 0 and nf > 0 and np.isfinite(verts).all()
        assert faces.min() >= 0 and faces.max() < nv
    metrics = [json.loads(ln) for ln in
               open(os.path.join(run_dir, "metrics.jsonl"))]
    for f in ("final_ckpt.npz", "final_ckpt.meta.json"):
        assert os.path.exists(os.path.join(run_dir, "ckpt", f))
    assert os.path.exists(os.path.join(run_dir, "bak", config))
    assert sorted(os.listdir(os.path.join(run_dir, "imgs"))) == sorted(
        f"render_{i:05d}.png" for i in panels)
    return poses, metrics


def _derived_yaml(tmp_path, base, **sections):
    """A YAML over ``base`` that sets ``sections`` (the CLI's overrides
    take no lists, such as ``debug_args.render_res``)."""
    path = tmp_path / f"derived_{os.path.basename(base)}"
    lines = [f"base_config: {base}"]
    for sec, kv in sections.items():
        lines.append(f"{sec}:")
        lines += [f"  {k}: {json.dumps(v)}" for k, v in kv.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _panel_size(path):
    with Image.open(path) as im:
        return im.size


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


def test_cli_writes_panels(tmp_path):
    """Panels every 2nd frame (frames 1, 3, 5), at the derived YAML's
    40x30; the trajectory is the run without panels', bit for bit."""
    cfg = _derived_yaml(tmp_path, CONFIG,
                        debug_args={"render_freq": 2, "render_res": [40, 30]})
    common = [cfg, "--device", "cpu", "--log_dir", str(tmp_path / "logs"),
              *SMALL, "--no-mesh"]
    plain = run_slam.main([*common, "--debug_args.render_freq", "0"])
    with_panels = run_slam.main(common)
    name = os.path.basename(cfg)
    poses0, _ = _artifacts(plain["dir"], name, mesh=False)
    poses1, _ = _artifacts(with_panels["dir"], name, (1, 3, 5), mesh=False)
    np.testing.assert_array_equal(poses1, poses0)
    assert len(with_panels["panels"]) == 3
    for p in with_panels["panels"]:
        assert _panel_size(p) == (3 * 40, 2 * 30)


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, ROOT) for p in YAMLS])
def test_every_yaml_passes_the_checks(path):
    """Each YAML's settings equal the JAX package's for it, and the CLI's
    checks before data loading pass."""
    assert len(YAMLS) == 20
    cfg = load_config(path)
    assert run_slam.check_config(cfg) == port_system(
        j_settings(j_load_config(path)))


def test_check_config_refusals():
    """A setting the engine cannot run is refused before any data loads;
    the engine modes once refused (DDA, covisibility windows, the NeRF and
    Gaussian embedders) give the JAX package's settings. For the card (the
    CLI's default device), every fused path takes the decoder sizes its
    kernels are built for and, zero-padded to one of them, every in_dim
    <= 128 and width, sdf_dim <= 1024: the f32 pcd forms at the reference's
    (16, 256, 128) and at widths 64 and 100, a width that is no multiple of
    64, in_dim 12, in_dim 32 and 24, in_dim 64, 33 and 48, in_dim 128, 65
    and 96, the wide (16, 512, 512) and a padded wide size, the widest
    (16, 1024, 1024) and padded sizes above 512. A size no built size
    covers (in_dim 129 or 160, width or sdf_dim 1025) is refused naming
    the form; the CPU (the kernels' plain versions) takes any size."""
    cfg = lambda *kv: load_config(CONFIG, dict(kv))  # noqa: E731
    for kv in ((("tpu_specs.intersect_mode", "dda"),),
               (("tpu_specs.covis_angle_deg", 30.0),),
               (("decoder_specs.embedder", "nerf"),
                ("decoder_specs.multires", 4)),
               (("decoder_specs.embedder", "gaussian"),)):
        want = port_system(j_settings(j_load_config(CONFIG, dict(kv))))
        assert run_slam.check_config(cfg(*kv)) == want
    for key, val in (("tpu_specs.pixel_sampler", "stratified"),
                     ("decoder_specs.embedder", "siren")):
        with pytest.raises(ValueError):
            run_slam.check_config(cfg((key, val)))
    with pytest.raises(ValueError, match="point store"):
        run_slam.check_config(cfg(("debug_args.render_freq", 5),
                                  ("tpu_specs.feature_mode", "pcd")))
    with pytest.raises(ValueError, match="render_res"):
        run_slam.check_config(cfg(("debug_args.render_freq", 5),
                                  ("debug_args.render_res", "640x480")))
    run_slam.check_config(cfg(("tpu_specs.feature_mode", "pcd")))
    fused = (("tpu_specs.fused_mlp", True),)
    pcd_f32 = fused + (("tpu_specs.feature_mode", "pcd"),
                       ("tpu_specs.matmul_dtype", "f32"))
    for kv, size in (
            (pcd_f32 + (("decoder_specs.width", 256),), (16, 256, 128)),
            (pcd_f32 + (("decoder_specs.width", 64),
                        ("decoder_specs.sdf_dim", 64)), (16, 64, 64)),
            (pcd_f32 + (("decoder_specs.width", 100),
                        ("decoder_specs.sdf_dim", 72)), (16, 100, 72)),
            (fused + (("decoder_specs.width", 96),
                      ("decoder_specs.sdf_dim", 64)), (16, 96, 64)),
            (fused + (("decoder_specs.in_dim", 12),), (12, 128, 128)),
            (pcd_f32 + (("decoder_specs.in_dim", 32),
                        ("decoder_specs.width", 256)), (32, 256, 128)),
            (fused + (("decoder_specs.in_dim", 32),), (32, 128, 128)),
            (fused + (("decoder_specs.in_dim", 24),
                      ("decoder_specs.width", 200),
                      ("decoder_specs.sdf_dim", 72)), (24, 200, 72)),
            (pcd_f32 + (("decoder_specs.width", 512),
                        ("decoder_specs.sdf_dim", 512)), (16, 512, 512)),
            (fused + (("decoder_specs.width", 300),
                      ("decoder_specs.sdf_dim", 200)), (16, 300, 200)),
            (pcd_f32 + (("decoder_specs.in_dim", 64),
                        ("decoder_specs.width", 256)), (64, 256, 128)),
            (fused + (("decoder_specs.in_dim", 64),), (64, 128, 128)),
            (fused + (("decoder_specs.in_dim", 33),), (33, 128, 128)),
            (pcd_f32 + (("decoder_specs.in_dim", 48),), (48, 128, 128)),
            (pcd_f32 + (("decoder_specs.in_dim", 128),
                        ("decoder_specs.width", 256)), (128, 256, 128)),
            (fused + (("decoder_specs.in_dim", 128),), (128, 128, 128)),
            (fused + (("decoder_specs.in_dim", 65),), (65, 128, 128)),
            (pcd_f32 + (("decoder_specs.in_dim", 96),), (96, 128, 128)),
            (fused + (("decoder_specs.width", 1024),
                      ("decoder_specs.sdf_dim", 1024)), (16, 1024, 1024)),
            (pcd_f32 + (("decoder_specs.width", 513),), (16, 513, 128)),
            (fused + (("decoder_specs.sdf_dim", 513),), (16, 128, 513)),
            (pcd_f32 + (("decoder_specs.in_dim", 40),
                        ("decoder_specs.width", 900),
                        ("decoder_specs.sdf_dim", 1000)), (40, 900, 1000))):
        s = run_slam.check_config(cfg(*kv))
        assert (s.decoder.in_dim, s.decoder.width, s.decoder.sdf_dim) == size
    for kv, form in (
            (pcd_f32 + (("decoder_specs.width", 1025),), "K2-f32"),
            (pcd_f32 + (("decoder_specs.in_dim", 129),), "K2-f32"),
            (fused + (("decoder_specs.in_dim", 129),), "K1"),
            (fused + (("decoder_specs.in_dim", 160),), "K1"),
            (fused + (("decoder_specs.sdf_dim", 1025),), "K1")):
        with pytest.raises(ValueError, match=form):
            run_slam.check_config(cfg(*kv))
        run_slam.check_config(cfg(*kv), "cpu")
    w256 = fused + (("decoder_specs.width", 256),
                    ("tpu_specs.matmul_dtype", "bf16"))
    for mode in ("vox", "pcd"):
        s = run_slam.check_config(cfg(*w256, ("tpu_specs.feature_mode",
                                              mode)))
        assert (s.decoder.in_dim, s.decoder.width, s.decoder.sdf_dim) == (
            16, 256, 128)


@pytest.fixture
def arkit_slam_dir(arkit_dir):  # noqa: F811
    """``arkit_dir`` with its depth written at the rgb's 256x144: the
    fixture's depth is 256x192 (the loader test checks its values only),
    and the engine of either package needs depth and rgb at one size.
    Frame 2 stays all-invalid."""
    for i, raw in enumerate((1500, 1500, 65535)):
        _write_depth16(os.path.join(arkit_dir, f"{i:05d}.png"), 256, 144,
                       raw=raw)
    return arkit_dir


FAMILY = {"replica": ("configs/replica/room_0.yaml", "replica_dir", (1, 2)),
          "scannet": ("configs/scannet/scene0000.yaml", "scannet_dir", (1,)),
          "arkit": ("configs/arkit/home.yaml", "arkit_slam_dir", (1,))}


@pytest.mark.parametrize("family", sorted(FAMILY))
def test_cli_real_family_yaml(tmp_path, request, family):
    """The family's YAML on its loader fixture (replica 3 frames at 64x36,
    scannet 2 at 640x480, arkit 3 at 256x144 with an all-invalid depth
    frame 2, which the frame guard skips): panels every frame at 32x24,
    trajectory, checkpoint and mesh."""
    yaml_path, fixture, panels = FAMILY[family]
    data = request.getfixturevalue(fixture)
    cfg = _derived_yaml(tmp_path, os.path.join(ROOT, yaml_path),
                        debug_args={"render_freq": 1, "render_res": [32, 24]})
    res = run_slam.main([
        cfg, "--device", "cpu", "--log_dir", str(tmp_path / "logs"),
        "--data_specs.data_path", data, "--tracker_specs.N_rays", "64",
        "--tracker_specs.num_iterations", "3", "--mapper_specs.N_rays_each",
        "64", "--mapper_specs.num_iterations", "2",
        "--tpu_specs.init_iterations", "4", "--tpu_specs.max_samples", "36",
        "--tpu_specs.max_keyframes", "8", "--mapper_specs.mesh_res", "4"])
    run = res["dir"]
    assert sorted(os.listdir(os.path.join(run, "imgs"))) == [
        f"render_{i:05d}.png" for i in panels]
    for p in res["panels"]:
        assert _panel_size(p) == (3 * 32, 2 * 24)
    poses = np.load(os.path.join(run, "misc", "frame_poses.npy"))
    assert poses.shape[0] == res["frames"] + 1 and np.isfinite(poses).all()
    assert res["skipped"] == (1 if family == "arkit" else 0)
    for f in ("ckpt/final_ckpt.npz", "mesh/final_mesh.ply"):
        assert os.path.exists(os.path.join(run, f))


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
