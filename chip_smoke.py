#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``proudslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile both CUDA kernels from ``proudslam_tpu_torch/csrc``;
3. kernels: run each kernel at the slice's shapes on realistic inputs and
   hold it against its plain PyTorch version (stated tolerances), with
   CUDA-event times of both;
4. slice: the bench configuration with the fused render path on
   (``config.bench_settings``): ``SlamSystem.initialize`` (200 mapping
   iterations), 39 ``process_frame`` calls over the first 40 frames of the
   480-frame ``scan`` trajectory at 320x240, and ``global_refine(rounds=2)``;
   both kernels must have been launched, the poses finite and the
   unaligned ATE under 3 cm.

Standard output ends with the slice's JSON line, the kernels' JSON line,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
The script imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 `feats` are f32 blends computed by the same formula in the same order
# (only FMA contraction can differ): 1e-5 absolute at unit-scale features.
# Decoder outputs differ by f32 summation order, which can flip the bf16
# rounding of an intermediate activation (2^-8 relative): 1e-2 absolute on
# sigmoid colors and sdf values of order 1.
TOL_FEATS = 1e-5
TOL_OUT = 1e-2
# K3 gradients: sums over 327,680 rows in another order plus the same bf16
# rounding flips on cotangents; held at 1e-2 of each output's largest
# magnitude.
TOL_GRAD_REL = 1e-2
ATE_LIMIT_CM = 3.0
N_FRAMES = 40
WIDTH, HEIGHT = 320, 240


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return smi


def build_phase() -> float:
    from proudslam_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    for name in ("render_kernel", "mlp_kernel"):
        build.build(name)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}: {line.strip()}")
    return time.perf_counter() - t0


def _event_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call, after a warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def _scene():
    from proudslam_tpu_torch.data.synthetic import AnalyticScene, orbit_poses

    # the bench's 480-frame "scan" trajectory (BenchDataset, trajectory
    # "scan", radius 1.6): ~1 cm and up to ~1.3 deg of motion per frame
    poses = orbit_poses(480, radius=1.6, total_yaw=np.pi, yaw_wobble=1.0,
                        yaw_cycles=3.0, pitch_wobble=0.22, pitch_cycles=4.0)
    fx = fy = 0.9 * WIDTH
    cx, cy = (WIDTH - 1) / 2.0, (HEIGHT - 1) / 2.0
    return AnalyticScene(), poses, (fx, fy, cx, cy)


def kernel_inputs(device):
    """Slice-shaped inputs of both kernels from the real pipeline: frame 0
    of the scan inserted into a bench-capacity map, 5x1024 rays of that
    frame intersected and sampled (S=64, H=12)."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.geometry import camera, se3
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops import voxel_hash as vh
    from proudslam_tpu_torch.ops.interp import corner_view
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import pack_params
    from proudslam_tpu_torch.render.renderer import intersect_and_sample

    s = bench_settings()
    scene, poses, K = _scene()
    rgb, depth = scene.render(poses[0], WIDTH, HEIGHT, *K)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    ms = vh.init_map_state(s.map, gen, device)
    pose6 = se3.tangent_from_matrix(torch.as_tensor(poses[0], dtype=torch.float32,
                                                    device=device))
    dirs = camera.pixel_ray_directions(WIDTH, HEIGHT, *K, device=device)
    d = torch.as_tensor(depth, device=device)
    R = se3.exp_rotation(pose6[3:6])
    pts = camera.transform_points(camera.backproject(dirs, d).reshape(-1, 3),
                                  R, pose6[0:3])
    ms = vh.insert_points(ms, pts, (d > 0).reshape(-1), s.map)
    nv = ms.num_voxels
    view = ms._replace(voxel_keys=ms.voxel_keys[:nv],
                       voxel_vertex_ids=ms.voxel_vertex_ids[:nv])
    n_rays = 5 * s.mapper.n_rays_each
    pix = torch.randint(0, WIDTH * HEIGHT, (n_rays,), generator=gen,
                        device=device)
    rd = dirs.reshape(-1, 3)[pix] @ R.T
    ro = pose6[0:3].expand_as(rd).contiguous()
    noise = torch.rand((n_rays, s.render.max_samples - s.render.max_hits),
                       generator=gen, device=device)
    inter, samples = intersect_and_sample(ro, rd, view, s.render, noise)
    # trained-map-scale embeddings (the init's N(0, 0.01) barely moves
    # the decoder)
    emb = 0.5 * torch.randn(ms.embeddings.shape, generator=gen,
                            device=device)
    vidx = inter.voxel_idx.clamp_min(0).long()
    rb = corner_view(emb, view.voxel_vertex_ids)[vidx].contiguous()
    keys_rb = view.voxel_keys[vidx].contiguous()
    valid = samples.voxel_idx >= 0
    bins = torch.where(valid, samples.bin, s.render.max_hits).to(torch.int32)
    fp = pack_params(init_decoder(gen, s.decoder, device), s.decoder)
    fp = type(fp)(*[t.contiguous() for t in fp])
    return dict(rb=rb, keys_rb=keys_rb, bins=bins.contiguous(),
                z=samples.depth.contiguous(), rays_o=ro, rays_d=rd.contiguous(),
                fp=fp, voxel=s.render.voxel_size, valid=valid, nv=nv,
                gen=gen)


def kernel_phase(device):
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    inp = kernel_inputs(device)
    args = (inp["rb"], inp["keys_rb"], inp["bins"], inp["z"], inp["rays_o"],
            inp["rays_d"], inp["fp"], inp["voxel"])
    R, H, _ = inp["rb"].shape
    S = inp["bins"].shape[1]
    log(f"kernels: K1 at R={R} H={H} S={S} (live voxels {inp['nv']}, "
        f"valid samples {int(inp['valid'].sum())})")
    out_k, feats_k = rk.fused_render_forward(*args)
    out_p, feats_p = rk.fused_render_forward_plain(*args)
    torch.cuda.synchronize()
    err_feats = (feats_k - feats_p).abs().max().item()
    err_out = (out_k - out_p).abs().max().item()
    log(f"K1 feats max_abs_err {err_feats:.3e} (tol {TOL_FEATS}), out "
        f"max_abs_err {err_out:.3e} (tol {TOL_OUT})")
    if not (err_feats <= TOL_FEATS and err_out <= TOL_OUT):
        raise AssertionError("K1 disagrees with fused_render_forward_plain")
    k1_ms = _event_ms(lambda: rk.fused_render_forward(*args))
    k1_plain_ms = _event_ms(lambda: rk.fused_render_forward_plain(*args))

    x = feats_p
    g = 1e-2 * torch.randn((x.shape[0], 4), generator=inp["gen"],
                           device=device)
    fp = inp["fp"]
    log(f"kernels: K3 at N={x.shape[0]}")
    dx_k, gr_k = mk.decoder_bwd(x, g, fp)
    dx_p, gr_p = mk.decoder_bwd_plain(x, g, fp)
    torch.cuda.synchronize()
    worst_rel, worst_abs = 0.0, 0.0
    for name, a, b in [("dx", dx_k, dx_p)] + list(
            zip(mk.FusedParams._fields, gr_k, gr_p)):
        e = (a - b).abs().max().item()
        scale = b.abs().max().item()
        rel = e / max(scale, 1e-30)
        log(f"K3 {name:5s} max_abs_err {e:.3e} of max {scale:.3e} "
            f"(rel {rel:.2e}, tol {TOL_GRAD_REL})")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, e)
    if not worst_rel <= TOL_GRAD_REL:
        raise AssertionError("K3 disagrees with decoder_bwd_plain")
    # determinism: the cross-block reduction has a fixed order
    dx_k2, gr_k2 = mk.decoder_bwd(x, g, fp)
    if not (torch.equal(dx_k, dx_k2)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError("K3 is not bitwise repeatable")
    k3_ms = _event_ms(lambda: mk.decoder_bwd(x, g, fp))
    k3_plain_ms = _event_ms(lambda: mk.decoder_bwd_plain(x, g, fp))
    k3_dx_ms = _event_ms(lambda: mk.decoder_bwd(x, g, fp, want_wgrad=False))
    k3_dx_plain_ms = _event_ms(
        lambda: mk.decoder_bwd_plain(x, g, fp, want_wgrad=False))
    log(f"K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f} ms); K3 {k3_ms:.3f} ms "
        f"(plain {k3_plain_ms:.3f} ms); K3 dx-only {k3_dx_ms:.3f} ms "
        f"(plain {k3_dx_plain_ms:.3f} ms)")
    return {
        "render_kernel": dict(max_abs_err=max(err_feats, err_out),
                              ms=k1_ms, plain_ms=k1_plain_ms),
        "mlp_kernel": dict(max_abs_err=worst_abs, ms=k3_ms,
                           plain_ms=k3_plain_ms),
    }


def slice_phase(device):
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk
    from proudslam_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    settings = bench_settings()
    scene, poses, K = _scene()
    t0 = time.perf_counter()
    frames = [scene.render(p, WIDTH, HEIGHT, *K) for p in poses[:N_FRAMES]]
    log(f"slice: rendered {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    depth_quant = 65535.0 / 10.0
    quant = [(np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8),
              np.clip(d * depth_quant + 0.5, 0, 65535.0).astype(np.uint16))
             for c, d in frames]
    rgb0 = quant[0][0].astype(np.float32) / 255.0
    depth0 = quant[0][1].astype(np.float32) / depth_quant

    slam = SlamSystem(settings, K, (HEIGHT, WIDTH), seed=0, point_stride=2,
                      device=device)
    rk.fused_render_forward.launches = 0
    mk.decoder_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.initialize(rgb0, depth0, poses[0], stamp=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_init_maps = len(slam.clock.marks["map"])
    t0 = time.perf_counter()
    for i in range(1, N_FRAMES):
        slam.process_frame(i, *quant[i])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam.global_refine(rounds=2)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    launches = {"render_kernel": rk.fused_render_forward.launches,
                "mlp_kernel": mk.decoder_bwd.launches}

    est = slam.get_trajectory()
    gt = np.stack(poses[:N_FRAMES])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    ate = ate_rmse(est, gt, align=False) * 100
    ate_al = ate_rmse(est, gt, align=True) * 100
    rpe = rpe_rmse(est, gt, delta=1) * 100
    ms = slam.clock.ms()
    n = N_FRAMES - 1
    frame_map = ms["map"][n_init_maps:n_init_maps + n]
    stats = {
        "fps": n / loop_s, "init_s": init_s, "refine_s": refine_s,
        "track_ms": float(np.mean(ms["track"])),
        "map_ms": float(np.mean(frame_map)),
        "insert_ms": float(np.mean(ms["insert"][1:])),
        "ate_cm": ate, "ate_aligned_cm": ate_al, "rpe_cm": rpe,
        "num_voxels": slam.map_state.num_voxels,
        "num_cells": slam.map_state.num_cells, "num_keyframes": slam.num_kf,
        "launches": launches,
    }
    log("slice: " + json.dumps(stats))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not ate < ATE_LIMIT_CM:
        raise AssertionError(f"unaligned ATE {ate:.3f} cm >= {ATE_LIMIT_CM}")
    return stats


def main() -> None:
    sys.path.insert(0, ROOT)
    smi = device_phase()
    import torch

    try:
        import proudslam_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is missing: {e}")
    device = torch.device("cuda", 0)
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"build: {build_phase():.1f} s")
    kern = kernel_phase(device)
    stats = slice_phase(device)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    record = {"kernels": [
        {"name": "render_kernel", "route": "cuda",
         "source": "proudslam_tpu_torch/csrc/render_kernel.cu",
         "replaces": "proudslam_tpu/ops/pallas/render_kernel.py:63",
         "launches": stats["launches"]["render_kernel"],
         **kern["render_kernel"]},
        {"name": "mlp_kernel", "route": "cuda",
         "source": "proudslam_tpu_torch/csrc/mlp_kernel.cu",
         "replaces": "proudslam_tpu/ops/pallas/mlp_kernel.py:141",
         "launches": stats["launches"]["mlp_kernel"],
         **kern["mlp_kernel"]},
    ]}
    print(json.dumps({"slice": stats}))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
