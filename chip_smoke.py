#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``proudslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile the CUDA kernels from ``proudslam_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
   each library's ``-Xptxas -v`` report (registers, spills, wgmma
   warnings) and its count of tensor-core instructions (HGMMA, HMMA) and
   FFMA in ``cuobjdump -sass`` are logged; K1, K2 and K3 must each hold
   HGMMA, no HMMA, and no spills; K2-f32 and K3-f32 (f32 operands) FFMA,
   no tensor-core instruction at all (so no TF32), and no spills;
3. kernels: run each kernel at the slices' mapping and tracking shapes
   (1024 rays, 65,536 rows) on inputs from the real pipeline and hold it
   against its plain PyTorch version (stated tolerances; K3 full and
   dx-only; all three also at row counts that are no multiple of their
   64-row tile), K2 on K1's features against K1's outputs bit for bit (the
   two run one decoder), with CUDA-event times of each kernel and its
   plain version at both shapes, each kernel's bound (least time on the
   card, from this run's shapes) and, for the decoder kernels, a chain of
   bf16 ``torch.matmul`` calls as a yardstick (no single PyTorch call
   computes these functions); the same for K2-f32 and K3-f32 (full and
   dx-only) on the pcd features at the mapping, tracking and ragged row
   counts, against the plain versions with f32 operands (TF32 off), with a
   chain of f32 ``torch.matmul`` calls as the yardstick; then hold the pcd
   branch's ``render_rays`` (PointNet gather, K2, K3 through autograd) on
   the card against the same call on the CPU, outputs and gradients, on
   512 rays;
4. vox slice: the bench configuration with the fused render path on
   (``config.bench_settings``): ``SlamSystem.initialize`` (200 mapping
   iterations), 39 ``process_frame`` calls over the first 40 frames of the
   480-frame ``scan`` trajectory at 320x240, and ``global_refine(rounds=2)``;
   K1 and K3 must have been launched, the poses finite and the unaligned
   ATE under 3 cm. Then its mesh: ``extract_mesh(res=8)`` with vertex
   colors, cleaned against the slice's depth cloud at the final trajectory
   (``run_slam.accumulate_depth_cloud``), held against the analytic scene
   as ``bench.py`` does: accuracy (mean vertex-to-surface distance) and
   completion (mean distance from depth samples of every 30th frame to
   the nearest vertex) must each be under 10 cm, half the voxel, the mesh
   non-empty, and no kernel may launch inside it (the mesher decodes with
   the plain decoder, as the JAX package's);
5. pcd slice: the same configuration with ``feature_mode="pcd"`` (PointNet
   features of <= 8 stored points per voxel): ``initialize``, the first
   5 frames and ``global_refine(rounds=2)``, which returns at once: the
   first keyframe after the initial one is committed at frame 13 at the
   earliest (``early_keyframe_gap`` 12). K2 and K3 must have been launched
   and K1 not, the poses finite, the point store non-empty, the PointNet
   params trained and the unaligned ATE under 60 cm. That bound and the
   5 frames are the JAX package's own functional test of this branch
   (``tests/test_pcd_features.py``), where the branch drifts by several cm
   per frame; ``tests/test_torch_pcd_slam.py`` run as a script prints both
   engines' drift at that test's size;
5b. pcd-f32 slice: the pcd slice with ``matmul_dtype="f32"`` (the
   configs' default operand type): K2-f32 and K3-f32 must have been
   launched and K1, K2 and K3 not, the poses finite and the unaligned ATE
   under the pcd slice's 60 cm;
5c. resample run: the vox configuration with ``fixed_sample_batch=False``
   in the tracker and the mapper (a fresh pixel batch per Adam iteration,
   intersected at the current pose) and the Gumbel pixel sampler, over the
   first 10 of the rendered frames and ``global_refine(rounds=2)``: K1 and
   K3 must have been launched, the unaligned ATE under 3 cm; its frames/s
   and per-phase ms are logged beside the fixed-batch vox slice's;
6. vox profile: another vox run, ``torch.profiler`` over frames 5-8 (each
   engine phase a profiler range): device busy ms per frame in all and
   per phase with each phase's idle share, kernel launches per frame, the
   top kernels' shares, and the host's CPU ms per frame;
7. cli: ``proudslam_tpu_torch.run_slam.main`` on
   ``configs/synthetic/room.yaml`` (40 frames at 320x240, the unfused
   branch with an f32 decoder, 100 initial mapping iterations, mesh at
   res 8) with ``--debug_args.render_freq 20`` into a temporary log
   directory: every artifact must be there (trajectory, mesh that parses
   back, checkpoint + sidecar, metrics, and the panels
   ``imgs/render_00019.png`` and ``imgs/render_00039.png``, each decoding
   to the panel's 3x2 tiles of the 200x160 preview), no kernel launched
   (the unfused branch and the preview run none), the unaligned ATE under
   3 cm, and the checkpoint, loaded into a fresh ``SlamSystem`` on the
   card, must give the saved trajectory bit for bit;
8. cli-pcd: the same entry point on room.yaml with ``--tpu_specs.feature_mode
   pcd --tpu_specs.fused_mlp true --no-mesh``, 5 frames (the YAML's f32
   operands): K2-f32 and K3-f32 must have been launched and no other
   kernel, the trajectory finite and the checkpoint reloaded bit for bit.

Every launch count is set to 0 just before a slice (and each cli run) and
read just after it; the mesh's launches are the counts' change across it.
Standard output ends with the slices' JSON line, the kernels' JSON line,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 `feats` are f32 blends computed by the same formula in the same order
# (only FMA contraction can differ): 1e-5 absolute at unit-scale features.
TOL_FEATS = 1e-5
# K1's decoder, which K2 runs too, sums on the tensor cores, in another
# order than the plain version's f32 matmuls: a rounding-level difference
# can flip the bf16 rounding of one hidden activation (2^-8 relative),
# which moves an output by up to ~|h| * |w| / 256 (~3e-4 for the sdf
# column: |ws| <= 0.09). On an H100 the largest error was 1.7e-4 on
# trilinear features, in the sdf column (the colors 4e-5); held at 3e-4,
# where the row-shift check still has a margin of ~500x. Every check must
# be able to tell a kernel that reads a neighbouring row: the plain outputs
# of neighbouring rows must differ by more than SHIFT_MARGIN x the
# tolerance.
TOL_K1_OUT = 3e-4
SHIFT_MARGIN = 100.0
# K2 on the pcd branch's features (rms ~0.07, small hidden activations, so
# a flipped bf16 rounding moves an output less): 1e-4 absolute (2.5e-5 on
# an H100). On K1's trilinear features K2 gives K1's outputs bit for bit
# (it runs K1's decoder on inputs rounded the same way), so it is held
# there at K1's tolerance.
TOL_K2 = 1e-4
# pcd render_rays on the card against the CPU (plain kernel versions):
# PointNet's f32 sums run in another order on each, so a feature can round
# to a neighbouring bf16 value at the decoder's input, as between the port
# and the JAX package on the CPU: the tolerances of that test, 2e-3
# absolute on outputs and 5e-3 of each gradient's largest magnitude (a
# gradient routed to the wrong leaf or dropped is off by ~1 of it).
TOL_RENDER_OUT = 2e-3
TOL_RENDER_GRAD_REL = 5e-3
RENDER_RAYS = 512
# K3 gradients: sums over up to 327,680 rows in another order; a
# rounding-level difference in a hidden pre-activation near 0 flips its
# ReLU mask, which drops or adds one term of dx (the kernel phase logs dx's
# error by each row's smallest |pre-activation|). Held at 1e-2 of each
# output's largest magnitude, at the mapping and tracking shapes (full and
# dx-only) and at ragged row counts (a masked last tile).
TOL_GRAD_REL = 1e-2
K3_RAGGED = 37            # rows cut from the mapping shape for the ragged check
# small ragged row counts, where the masked last tile carries all (27) or
# a third (91 = 64 + 27) of each weight and bias gradient's sum
K3_SMALL = (27, 91)
# K2-f32 and K3-f32 (true f32 products, summed in another order than the
# plain version's f32 matmuls): the forward at 1e-5 of each output
# column's largest magnitude (the f32 CPU parity tolerance of
# tests/test_torch_mlp_kernel.py); the backward at 1e-4 of each output's
# largest magnitude: its weight gradients are f32 sums over up to 327,680
# rows, whose rounding grows ~sqrt(rows) x 6e-8 relative (~3e-5 at the
# mapping shape) in either summation order. An f32 rounding-level
# difference can still flip a ReLU mask where a hidden pre-activation is
# within ~1e-7 of 0 (the bf16 forms' 1e-2 allows for that); the log
# counts such rows.
TOL_F32_FWD = 1e-5
TOL_F32_BWD = 1e-4
K1_RAGGED = (1001, 40)    # rays x samples of K1's ragged check (40,040 rows)
TRACK_RAYS = 1024         # the tracking shape: 1024 rays x S samples
ATE_LIMIT_CM = 3.0
# the mesh: accuracy and completion each under half the 20 cm voxel
MESH_LIMIT_CM = 10.0
MESH_RES = 8
# the cli phase: the larger of the verify skill's 3 cm "something is
# broken" line and 1.5x the JAX CLI's ATE on the same command (0.666 cm,
# a CPU run of scripts/run_slam.py configs/synthetic/room.yaml)
CLI_ATE_LIMIT_CM = max(3.0, 1.5 * 0.666)
CLI_CONFIG = os.path.join("configs", "synthetic", "room.yaml")
PCD_ATE_LIMIT_CM = 60.0
N_FRAMES = 40
PCD_FRAMES = 5
RESAMPLE_FRAMES = 10
CLI_RENDER_FREQ = 20      # the cli phase's panels: frames 19 and 39
PANEL_WH = (3 * 200, 2 * 160)   # room.yaml's default 200x160 preview
PCD_CLI_FRAMES = 5
PROFILE_START, PROFILE_FRAMES = 5, 4   # the vox profile: frames 5-8
WIDTH, HEIGHT = 320, 240

# Published H100 SXM peaks (dense) at a 700 W power limit: bf16 tensor
# cores, f32 outside the tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# flops per decoder row (16-128-128-(128+1)-128-3; bf16 operands): the
# five products 2*(16*128 + 128*128 + 128*129 + 128*128 + 16*128) plus
# the color head 2*128*3
DEC_FLOPS = 2 * (16 * 128 + 128 * 128 + 128 * 129 + 128 * 128 + 16 * 128
                 + 128 * 3)
# (library, kernel function): each must hold HGMMA (wgmma), no HMMA and no
# spills
KERNEL_FUNCTIONS = (("render_kernel", "render_forward_kernel"),
                    ("mlp_kernel", "decoder_forward_kernel"),
                    ("mlp_kernel", "decoder_backward_kernel"))
# (library, kernel function) of the f32-operand forms: FFMA, no
# tensor-core instruction (no TF32), no spills
F32_FUNCTIONS = (("mlp_kernel_f32", "decoder_forward_f32_kernel"),
                 ("mlp_kernel_f32", "decoder_backward_f32_kernel"))
LIBRARIES = ("render_kernel", "mlp_kernel", "mlp_kernel_f32")
# the kernels' launch counters, by the name of the kernels JSON line
KERNELS = ("fused_render_forward", "decoder_forward", "decoder_backward",
           "decoder_forward_f32", "decoder_backward_f32")


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


def sass_counts(lib) -> dict:
    """Tensor-core instructions and f32 FMAs per kernel function of a built
    library, from ``cuobjdump -sass``: {function: {"HGMMA": n, "HMMA": n,
    "FFMA": n}} (HGMMA is wgmma, HMMA mma.sync, FFMA an f32 fused
    multiply-add on the FP32 units)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {lib} failed: "
                           f"{res.stderr.strip()[-300:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    return counts


def ptxas_resources(log_text: str) -> dict:
    """Registers and spill bytes per function from ``-Xptxas -v`` output:
    {mangled name: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    import re

    res, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            res.setdefault(fn, {})
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                res[fn]["spill_stores"] = int(m.group(1))
                res[fn]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[fn]["registers"] = int(m.group(1))
    return res


def build_phase():
    """Build the libraries (one nvcc each, in parallel); log the ptxas
    report and the instruction counts -> (seconds, {kernel function: its
    SASS counts and ptxas resources})."""
    from proudslam_tpu_torch.ops.kernels import build

    names = LIBRARIES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(build.build, name) for name in names]:
            f.result()
    seconds = time.perf_counter() - t0
    sass, ptxas = {}, {}
    for name in names:
        text = build.build_log(name)
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "wgmma",
                                       "Performance", "Compiling entry")):
                log(f"ptxas {name}: {line.strip()}")
        sass[name] = sass_counts(build.library_path(name))
        ptxas[name] = ptxas_resources(text)
        log(f"sass {name}: {json.dumps(sass[name])}")
    # the bf16 kernels run their products on the tensor cores (wgmma), the
    # f32 ones on the FP32 units; none spills
    found = {}
    for lib, fn in KERNEL_FUNCTIONS + F32_FUNCTIONS:
        counts = [c for f, c in sass[lib].items() if fn in f]
        res = [r for f, r in ptxas[lib].items() if fn in f and r]
        if len(counts) != 1 or len(res) != 1:
            raise AssertionError(f"{fn}: {len(counts)} functions in the "
                                 f"SASS and {len(res)} in the ptxas report "
                                 f"of {lib}")
        found[fn] = {**counts[0], **res[0]}
        log(f"{fn}: {json.dumps(found[fn])}")
        if (lib, fn) in F32_FUNCTIONS:
            if not (counts[0]["FFMA"] > 0 and counts[0]["HGMMA"] == 0
                    and counts[0]["HMMA"] == 0):
                raise AssertionError(f"{fn}: instructions {counts[0]}, "
                                     "expected FFMA > 0, HGMMA 0, HMMA 0")
        elif not (counts[0]["HGMMA"] > 0 and counts[0]["HMMA"] == 0):
            raise AssertionError(f"{fn}: tensor-core instructions "
                                 f"{counts[0]}, expected HGMMA > 0, HMMA 0")
        if res[0].get("spill_stores", 1) or res[0].get("spill_loads", 1):
            raise AssertionError(f"{fn}: spills in the ptxas report {res[0]}")
    return seconds, found


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(bf16_flops: float, f32_flops: float, nbytes: int):
    """(bound_ms, bound_by): the larger of the operations over their peak
    rates and the bytes (each input read once, each output written once)
    over the memory rate."""
    ops_ms = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _event_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Time of one call: the median over ``reps`` of the CUDA-event time
    of ``calls`` back-to-back calls, divided by ``calls``, after a warm-up
    call. The host issues a call while the card runs the one before, so a
    call's host time (a kernel wrapper's Python before its launch) is
    hidden wherever the card's time per call exceeds it; with
    ``calls=1`` the card waits for it, and it is counted."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
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
    """Mapping-shaped inputs of all three kernels from the real pipeline:
    frame 0 of the scan inserted into a bench-capacity map (and its points
    into a point store), 5x1024 rays of that frame intersected and sampled
    (S=64, H=12)."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.geometry import camera, se3
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.models.pointnet import init_pointnet
    from proudslam_tpu_torch.ops import voxel_hash as vh
    from proudslam_tpu_torch.ops.interp import corner_view
    from proudslam_tpu_torch.ops.kernels.mlp_kernel import pack_params
    from proudslam_tpu_torch.render.pcd_features import (init_point_store,
                                                         insert_frame_points)
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
    valid_px = (d > 0).reshape(-1)
    ms = vh.insert_points(ms, pts, valid_px, s.map)
    store = insert_frame_points(
        init_point_store(s.map, s.map.points_per_voxel, device), ms, pts,
        torch.as_tensor(rgb, dtype=torch.float32, device=device).reshape(-1, 3),
        valid_px, s.map)
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
    dec = init_decoder(gen, s.decoder, device)
    fp = pack_params(dec, s.decoder)
    fp = type(fp)(*[t.contiguous() for t in fp])
    # PointNet with its head at the default-init scale (x50 the init's
    # 0.02); its features are still small (rms ~0.07), so K2 is also held
    # on K1's trilinear features (rms ~0.5)
    pn = init_pointnet(gen, s.decoder.in_dim, device)
    pn["fc"] = {k: v * 50.0 for k, v in pn["fc"].items()}
    sampled_xyz = ro[:, None, :] + rd[:, None, :] * samples.depth[..., None]
    pcd_args = (sampled_xyz, samples.bin, inter.voxel_idx, store, pn,
                s.render.voxel_size)
    gt_c = torch.as_tensor(rgb, device=device).reshape(-1, 3)[pix]
    return dict(rb=rb, keys_rb=keys_rb, bins=bins.contiguous(),
                z=samples.depth.contiguous(), rays_o=ro, rays_d=rd.contiguous(),
                fp=fp, voxel=s.render.voxel_size, valid=valid, nv=nv,
                gen=gen, pcd_args=pcd_args,
                points=int(store.counts.sum()),
                render=dict(settings=s, view=view, store=store, dec=dec, pn=pn,
                            precomputed=(inter, samples), gt_c=gt_c,
                            gt_d=d.reshape(-1)[pix]))


def _matmul_chain(fp, dtype=None):
    """The decoder as a chain of ``torch.matmul`` calls with weight leaves
    of ``dtype`` (bf16 by default; f32 runs with TF32 off, as the package
    sets it): the yardstick for K2 (forward) and K3 (forward and its
    autograd backward) and their f32 forms. No single PyTorch call computes
    either."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick must run with TF32 off")
    w = {k: v.detach().to(dtype, copy=True).requires_grad_(True)
         for k, v in fp._asdict().items()}

    def fwd(x):
        h1 = torch.relu(x @ w["w1"] + w["b1"])
        h2 = torch.relu(h1 @ w["w2"] + w["b2"])
        so = h2 @ w["ws"] + w["bs"]
        hc = torch.relu(so[:, :-1] @ w["wc_f"] + x @ w["wc_x"] + w["bc"])
        return torch.cat([torch.sigmoid(hc @ w["wo"] + w["bo"]), so[:, -1:]],
                         dim=1)
    return fwd, list(w.values())


def _dx_err_by_margin(mk, x, fp, dx_k, dx_p, bf16=True) -> dict:
    """K3's dx error against its plain version's, over dx's largest
    magnitude, binned by each row's margin: its smallest |hidden
    pre-activation| (h1, h2, hc) in the plain forward. Where the margin is
    within the kernel's rounding-level difference, the two can take
    different ReLU masks -> {bin: [rows, max error]}."""
    import torch

    dot = mk._make_dot(bf16)
    h1, _, feat, _, _, _ = mk.decoder_fwd_plain(x, fp, bf16)
    pre = (dot(x, fp.w1) + fp.b1, dot(h1, fp.w2) + fp.b2,
           dot(feat, fp.wc_f) + dot(x, fp.wc_x) + fp.bc)
    margin = torch.stack([p.abs().amin(1) for p in pre]).amin(0)
    err = (dx_k - dx_p).abs().amax(1) / dx_p.abs().max().clamp_min(1e-30)
    edges = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, float("inf"))
    bins = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (margin >= lo) & (margin < hi)
        bins[f"[{lo:g}, {hi:g})"] = [
            int(sel.sum()), float(err[sel].max()) if bool(sel.any()) else 0.0]
    return bins


def _entry(err, ms, plain_ms, bound, chain_ms=None):
    e = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
             bound_by=bound[1], library_ms=None)
    if chain_ms is not None:
        e["matmul_chain_ms"] = chain_ms
    return e


def f32_kernel_phase(x, g, fp, track_rows):
    """K2-f32 and K3-f32 (``bf16=False``) on the pcd features ``x`` and the
    cotangents ``g``: against their plain versions with f32 operands at the
    mapping shape, the tracking shape (the first ``track_rows`` rows), a
    ragged count (a masked last tile) and small ragged counts of non-zero
    rows; repeatability; CUDA-event times of each kernel, its plain version
    and the f32 matmul chain at both shapes, and the bound at the FP32 peak
    -> the two kernels' JSON entries."""
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    N = x.shape[0]
    nz = (x.abs().sum(1) > 0).nonzero().flatten()
    shapes = [("mapping", x, g), ("tracking", x[:track_rows], g[:track_rows]),
              ("ragged", x[:N - K3_RAGGED], g[:N - K3_RAGGED])]
    shapes += [("small ragged", x[nz[:n]], g[nz[:n]]) for n in K3_SMALL]
    err_fwd = 0.0
    for label, xi, _ in shapes:
        xi = xi.contiguous()
        out_k = mk.decoder_fwd(xi, fp, bf16=False)
        _, _, _, sdf_p, _, rgb_p = mk.decoder_fwd_plain(xi, fp, False)
        out_p = torch.cat([rgb_p, sdf_p], dim=1)
        out_k2 = mk.decoder_fwd(xi, fp, bf16=False)
        torch.cuda.synchronize()
        scale = out_p.abs().amax(0).clamp_min(1e-30)
        rel = ((out_k - out_p).abs().amax(0) / scale).tolist()
        # what a kernel reading a neighbouring row would give
        shift = ((out_p[1:] - out_p[:-1]).abs().amax(0) / scale).max().item()
        log(f"K2-f32 at the {label} shape, N={xi.shape[0]}: max_abs_err "
            f"over each column's largest magnitude "
            f"{[float(f'{v:.3e}') for v in rel]} (tol {TOL_F32_FWD}); "
            f"one-row shift {shift:.3e}")
        if not max(rel) <= TOL_F32_FWD:
            raise AssertionError(f"K2-f32 disagrees with decoder_fwd_plain at "
                                 f"the {label} shape")
        big = xi.shape[0] > 2 * K3_SMALL[-1]
        if big and not shift > SHIFT_MARGIN * TOL_F32_FWD:
            raise AssertionError("the K2-f32 check cannot tell neighbouring "
                                 "rows")
        if not torch.equal(out_k, out_k2):
            raise AssertionError("K2-f32 is not bitwise repeatable")
        err_fwd = max(err_fwd, (out_k - out_p).abs().max().item())

    err_bwd = 0.0
    margin_bins = None
    for label, xi, gi in shapes:
        xi, gi = xi.contiguous(), gi.contiguous()
        for wgrad in ((True, False) if label in ("mapping", "tracking")
                      else (True,)):
            dx_k, gr_k = mk.decoder_bwd(xi, gi, fp, want_wgrad=wgrad,
                                        bf16=False)
            dx_p, gr_p = mk.decoder_bwd_plain(xi, gi, fp, want_wgrad=wgrad,
                                              bf16=False)
            torch.cuda.synchronize()
            rels = {}
            for name, a, b in [("dx", dx_k, dx_p)] + (list(
                    zip(mk.FusedParams._fields, gr_k, gr_p)) if wgrad else []):
                e = (a - b).abs().max().item()
                rel = e / max(b.abs().max().item(), 1e-30)
                rels[name] = float(f"{rel:.3e}")
                err_bwd = max(err_bwd, e)
            log(f"K3-f32 at the {label} shape, N={xi.shape[0]}, "
                f"{'full' if wgrad else 'dx-only'}: max_abs_err over each "
                f"output's largest magnitude {json.dumps(rels)} (tol "
                f"{TOL_F32_BWD})")
            if label == "mapping" and wgrad:
                margin_bins = _dx_err_by_margin(mk, xi, fp, dx_k, dx_p,
                                                bf16=False)
                log("K3-f32 dx error at the mapping shape by the row's "
                    "smallest |hidden pre-activation|, {bin: [rows, "
                    "max_abs_err over dx's largest magnitude]}: "
                    + json.dumps(margin_bins))
            if not max(rels.values()) <= TOL_F32_BWD:
                raise AssertionError(
                    f"K3-f32 disagrees with decoder_bwd_plain at the {label} "
                    f"shape, N={xi.shape[0]}")
    dx_k, gr_k = mk.decoder_bwd(x, g, fp, bf16=False)
    dx_k2, gr_k2 = mk.decoder_bwd(x, g, fp, bf16=False)
    dx_only, _ = mk.decoder_bwd(x, g, fp, want_wgrad=False, bf16=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError("K3-f32 is not bitwise repeatable")

    chain, leaves = _matmul_chain(fp, torch.float32)
    k2 = {"mapping": dict(rows=N), "tracking": dict(rows=track_rows)}
    k3 = {"mapping": dict(rows=N), "tracking": dict(rows=track_rows)}
    for shape in k2:
        rows = k2[shape]["rows"]
        xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
        st = k2[shape]
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp, bf16=False))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_fwd_plain(xn, fp, False))
        with torch.no_grad():
            st["matmul_chain_ms"] = _event_ms(lambda: chain(xn))
        st["bound_ms"], st["bound_by"] = _bound(
            0, DEC_FLOPS * rows, _nbytes(xn, *fp) + rows * 4 * 4)
        st["share"] = st["bound_ms"] / st["ms"]
        st = k3[shape]
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp, bf16=False))
        st["plain_ms"] = _event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, bf16=False))
        st["dx_only_ms"] = _event_ms(lambda: mk.decoder_bwd(
            xn, gn, fp, want_wgrad=False, bf16=False))
        st["dx_only_plain_ms"] = _event_ms(lambda: mk.decoder_bwd_plain(
            xn, gn, fp, want_wgrad=False, bf16=False))
        st["bound_ms"], st["bound_by"] = _bound(
            0, 3 * DEC_FLOPS * rows, _nbytes(xn, gn, *fp, xn, *gr_k))
        st["dx_only_bound_ms"], _ = _bound(0, 2 * DEC_FLOPS * rows,
                                           _nbytes(xn, gn, *fp, xn))
        st["share"] = st["bound_ms"] / st["ms"]
        st["dx_only_share"] = st["dx_only_bound_ms"] / st["dx_only_ms"]
    xg = x.detach().clone().requires_grad_(True)

    def chain_fwd_bwd():
        for t in leaves + [xg]:
            t.grad = None
        chain(xg).backward(g)
    chain_bwd_ms = _event_ms(chain_fwd_bwd)
    for shape in ("mapping", "tracking"):
        a, b = k2[shape], k3[shape]
        log(f"{shape} shape, f32 operands: K2-f32 {a['ms']:.3f} ms (plain "
            f"{a['plain_ms']:.3f} ms, bound {a['bound_ms']:.4f} ms by "
            f"{a['bound_by']}, share {a['share']:.3f}; f32 torch.matmul "
            f"chain forward {a['matmul_chain_ms']:.3f} ms, {a['rows']} rows); "
            f"K3-f32 {b['ms']:.3f} ms (plain {b['plain_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms, share {b['share']:.3f}); K3-f32 dx-only "
            f"{b['dx_only_ms']:.3f} ms (plain {b['dx_only_plain_ms']:.3f} ms, "
            f"bound {b['dx_only_bound_ms']:.4f} ms, share "
            f"{b['dx_only_share']:.3f})")
    log(f"f32 torch.matmul chain (a chain of calls, not one library call): "
        f"forward+backward {chain_bwd_ms:.3f} ms at N={N}")
    m2, m3 = k2["mapping"], k3["mapping"]
    return {
        "decoder_forward_f32": dict(
            _entry(err_fwd, m2["ms"], m2["plain_ms"],
                   (m2["bound_ms"], m2["bound_by"]), m2["matmul_chain_ms"]),
            shapes=k2),
        "decoder_backward_f32": dict(
            _entry(err_bwd, m3["ms"], m3["plain_ms"],
                   (m3["bound_ms"], m3["bound_by"]), chain_bwd_ms),
            shapes=k3, dx_err_by_margin=margin_bins),
    }


def kernel_phase(device):
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk
    from proudslam_tpu_torch.render.pcd_features import gather_pcd_features

    inp = kernel_inputs(device)
    args = (inp["rb"], inp["keys_rb"], inp["bins"], inp["z"], inp["rays_o"],
            inp["rays_d"], inp["fp"], inp["voxel"])
    R, H, _ = inp["rb"].shape
    S = inp["bins"].shape[1]
    log(f"kernels: K1 at R={R} H={H} S={S} (live voxels {inp['nv']}, "
        f"valid samples {int(inp['valid'].sum())})")
    # K1 against its plain version at the mapping shape, the tracking shape
    # (the first TRACK_RAYS rays) and a ragged last tile: K1_RAGGED =
    # (rays, samples), whose product is no multiple of the 64-row tile
    nr, ns = K1_RAGGED
    k1_args = {
        "mapping": args,
        "tracking": tuple(a[:TRACK_RAYS].contiguous() for a in args[:6])
        + args[6:],
        "ragged": tuple(a[:nr, :ns].contiguous()
                        if a.dim() == 2 and a.shape[1] == S
                        else a[:nr].contiguous() for a in args[:6]) + args[6:]}
    err_feats = err_out = 0.0
    for shape, a in k1_args.items():
        out_k, feats_k = rk.fused_render_forward(*a)
        out_p, feats_p = rk.fused_render_forward_plain(*a)
        torch.cuda.synchronize()
        ef = (feats_k - feats_p).abs().max().item()
        eo = (out_k - out_p).abs().amax(0)
        log(f"K1 at the {shape} shape, {a[2].shape[0]} rays x {a[2].shape[1]}"
            f" samples: feats max_abs_err {ef:.3e} (tol {TOL_FEATS}), out "
            f"max_abs_err per column {[float(f'{v:.3e}') for v in eo.tolist()]}"
            f" (tol {TOL_K1_OUT})")
        if not (ef <= TOL_FEATS and eo.max().item() <= TOL_K1_OUT):
            raise AssertionError(f"K1 disagrees with fused_render_forward_plain"
                                 f" at the {shape} shape")
        err_feats, err_out = max(err_feats, ef), max(err_out, eo.max().item())
        # K2 runs K1's decoder on inputs rounded as K1 rounds its features
        out_2 = mk.decoder_fwd(feats_k, a[6])
        torch.cuda.synchronize()
        same = torch.equal(out_2, out_k)
        log(f"K2 on K1's feats at the {shape} shape: "
            + ("bitwise equal to K1's out" if same else
               f"{int((out_2 != out_k).sum())} values differ from K1's out, "
               f"max_abs_err {(out_2 - out_k).abs().max().item():.3e}"))
        if not same:
            raise AssertionError(f"K2 on K1's feats differs from K1's out at "
                                 f"the {shape} shape")
        if shape == "mapping":
            x = feats_p
            # the same samples' outputs one row off: what a kernel reading a
            # neighbouring row would give
            shift1 = (out_p[1:] - out_p[:-1]).abs().max().item()
    log(f"K1 one-row-shift error {shift1:.3e} (margin {SHIFT_MARGIN})")
    if not shift1 > SHIFT_MARGIN * TOL_K1_OUT:
        raise AssertionError("the K1 check cannot tell neighbouring rows")
    k1 = {"mapping": dict(rows=R * S),
          "tracking": dict(rows=min(TRACK_RAYS, R) * S)}
    for shape, st in k1.items():
        a = k1_args[shape]
        st["ms"] = _event_ms(lambda: rk.fused_render_forward(*a))
        st["plain_ms"] = _event_ms(lambda: rk.fused_render_forward_plain(*a))
        st["bound_ms"], st["bound_by"] = _bound(
            DEC_FLOPS * st["rows"], (2 * 8 * 16 + 8 * 2) * st["rows"],
            _nbytes(*a[:6], *inp["fp"]) + st["rows"] * (4 + 16) * 4)
        st["share"] = st["bound_ms"] / st["ms"]

    g = 1e-2 * torch.randn((x.shape[0], 4), generator=inp["gen"],
                           device=device)
    fp = inp["fp"]
    N = x.shape[0]
    TR = min(TRACK_RAYS * S, N)
    # K3 against its plain version, full and dx-only, at the mapping and
    # tracking shapes, a ragged mapping shape, and small ragged row counts
    # drawn from the rows with non-zero features
    nz = (x.abs().sum(1) > 0).nonzero().flatten()
    k3_cases = [("mapping", x, g, True), ("mapping", x, g, False),
                ("ragged", x[:N - K3_RAGGED], g[:N - K3_RAGGED], True),
                ("tracking", x[:TR], g[:TR], True),
                ("tracking", x[:TR], g[:TR], False)]
    k3_cases += [("small ragged", x[nz[:n]], g[nz[:n]], True)
                 for n in K3_SMALL]
    worst_abs = 0.0
    for label, xn, gn, wgrad in k3_cases:
        xn, gn = xn.contiguous(), gn.contiguous()
        dx_k, gr_k = mk.decoder_bwd(xn, gn, fp, want_wgrad=wgrad)
        dx_p, gr_p = mk.decoder_bwd_plain(xn, gn, fp, want_wgrad=wgrad)
        torch.cuda.synchronize()
        rels = {}
        for name, a, b in [("dx", dx_k, dx_p)] + (list(
                zip(mk.FusedParams._fields, gr_k, gr_p)) if wgrad else []):
            e = (a - b).abs().max().item()
            rels[name] = float(f"{e / max(b.abs().max().item(), 1e-30):.3e}")
            worst_abs = max(worst_abs, e)
        log(f"K3 at the {label} shape, N={xn.shape[0]}, "
            f"{'full' if wgrad else 'dx-only'}: max_abs_err over each "
            f"output's largest magnitude {json.dumps(rels)} (tol "
            f"{TOL_GRAD_REL})")
        if not max(rels.values()) <= TOL_GRAD_REL:
            raise AssertionError(f"K3 disagrees with decoder_bwd_plain at the "
                                 f"{label} shape, N={xn.shape[0]}")
        if label == "mapping" and wgrad:
            log("K3 dx error at the mapping shape by the row's smallest "
                "|hidden pre-activation|, {bin: [rows, max_abs_err over "
                "dx's largest magnitude]}: "
                + json.dumps(_dx_err_by_margin(mk, xn, fp, dx_k, dx_p)))
    # determinism: the cross-block reduction has a fixed order
    dx_k, gr_k = mk.decoder_bwd(x, g, fp)
    dx_k2, gr_k2 = mk.decoder_bwd(x, g, fp)
    dx_only, _ = mk.decoder_bwd(x, g, fp, want_wgrad=False)
    if not (torch.equal(dx_k, dx_k2) and torch.equal(dx_k, dx_only)
            and all(torch.equal(a, b) for a, b in zip(gr_k, gr_k2))):
        raise AssertionError("K3 is not bitwise repeatable")
    k3 = {"mapping": dict(rows=N), "tracking": dict(rows=TR)}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for shape, st in k3.items():
        xn, gn = x[:st["rows"]].contiguous(), g[:st["rows"]].contiguous()
        st["ms"] = _event_ms(lambda: mk.decoder_bwd(xn, gn, fp))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_bwd_plain(xn, gn, fp))
        st["dx_only_ms"] = _event_ms(
            lambda: mk.decoder_bwd(xn, gn, fp, want_wgrad=False))
        st["dx_only_plain_ms"] = _event_ms(
            lambda: mk.decoder_bwd_plain(xn, gn, fp, want_wgrad=False))
        st["bound_ms"], st["bound_by"] = _bound(
            3 * DEC_FLOPS * st["rows"], 0,
            _nbytes(xn, gn, *fp, dx_k[:st["rows"]], *gr_k))
        st["dx_only_bound_ms"], _ = _bound(
            2 * DEC_FLOPS * st["rows"], 0, _nbytes(xn, gn, *fp, xn))
        st["share"] = st["bound_ms"] / st["ms"]
        blocks, per_block = mk.backward_partition(st["rows"], sms)
        ntiles = -(-st["rows"] // mk.TILE_ROWS)
        # a count from the code, not a measurement: each tile adds its
        # products into its block's f32 slab (the first tile of a block
        # only writes it), then one pass reads every slab
        log(f"K3 at the {shape} shape: {blocks} blocks of <= {per_block} "
            f"tiles; slab bytes with weight gradients, counted from the "
            f"code: {(2 * ntiles + 1) * _nbytes(*fp) / 1e6:.0f} MB")

    # K2 on the pcd branch's decoder inputs (PointNet features of frame 0's
    # stored points, blended per sample) at the mapping and tracking shapes
    # (the first TRACK_RAYS rays), then on K1's trilinear features at a row
    # count that is no multiple of the 64-row tile
    pcd_args = inp["pcd_args"]
    with torch.no_grad():
        x2 = gather_pcd_features(*pcd_args)
    x2 = x2.reshape(-1, x2.shape[-1]).contiguous()
    N2 = x2.shape[0]
    k2_inputs = {}
    for label, xi, tol in (("pcd", x2, TOL_K2),
                           ("pcd tracking", x2[:TR], TOL_K2),
                           ("trilinear", x[:N - 37], TOL_K1_OUT)):
        out_k = mk.decoder_fwd(xi, fp)
        _, _, _, sdf_p, _, rgb_p = mk.decoder_fwd_plain(xi, fp)
        out_p = torch.cat([rgb_p, sdf_p], dim=1)
        # the same rows' outputs one row off: what a kernel reading a
        # neighbouring row would give
        shift = (out_p[1:] - out_p[:-1]).abs().max().item()
        out_k2 = mk.decoder_fwd(xi, fp)
        torch.cuda.synchronize()
        st = dict(rows=xi.shape[0], stored_points=inp["points"],
                  rms=xi.pow(2).mean().sqrt().item(),
                  zero_row_share=(xi.abs().sum(1) == 0).float().mean().item(),
                  out_std_min=out_p.std(dim=0).min().item(),
                  shift_err=shift,
                  max_abs_err_per_column=(out_k - out_p).abs().amax(0).tolist())
        st["max_abs_err"] = max(st["max_abs_err_per_column"])
        k2_inputs[label] = st
        log(f"K2 on {label} features: " + json.dumps(st)
            + f" (tol {tol}, shift margin {SHIFT_MARGIN})")
        if not st["max_abs_err"] <= tol:
            raise AssertionError(f"K2 disagrees with decoder_fwd_plain on "
                                 f"{label} features")
        if not torch.equal(out_k, out_k2):
            raise AssertionError("K2 is not bitwise repeatable")
    if not k2_inputs["trilinear"]["shift_err"] > SHIFT_MARGIN * TOL_K1_OUT:
        raise AssertionError("the K2 check cannot tell neighbouring rows")
    err2 = max(st["max_abs_err"] for st in k2_inputs.values())

    # K2, its plain version and the same decoder as a chain of bf16 matmuls
    # (the yardstick) at both shapes
    chain, leaves = _matmul_chain(fp)
    x2b = x2.to(torch.bfloat16)
    k2 = {"mapping": dict(rows=N2), "tracking": dict(rows=min(TR, N2))}
    for shape, st in k2.items():
        xn, xb_n = x2[:st["rows"]], x2b[:st["rows"]]
        st["ms"] = _event_ms(lambda: mk.decoder_fwd(xn, fp))
        st["plain_ms"] = _event_ms(lambda: mk.decoder_fwd_plain(xn, fp))
        with torch.no_grad():
            st["matmul_chain_ms"] = _event_ms(lambda: chain(xb_n))
        st["bound_ms"], st["bound_by"] = _bound(
            DEC_FLOPS * st["rows"], 0, _nbytes(xn, *fp) + st["rows"] * 4 * 4)
        st["share"] = st["bound_ms"] / st["ms"]
    xb = x.to(torch.bfloat16).requires_grad_(True)
    gb = g.to(torch.bfloat16)

    def chain_fwd_bwd():
        for t in leaves + [xb]:
            t.grad = None
        chain(xb).backward(gb)
    chain_bwd_ms = _event_ms(chain_fwd_bwd)

    # PointNet + blend at the mapping shape (R*H*K rows), forward and with
    # its backward into the PointNet params and sample positions
    with torch.no_grad():
        gather_ms = _event_ms(lambda: gather_pcd_features(*pcd_args), reps=3)
    sxyz = pcd_args[0].detach().requires_grad_(True)
    pn_leaves = [t.requires_grad_(True) for layer in pcd_args[4]["layers"]
                 for t in layer.values()]
    pn_leaves += [t.requires_grad_(True) for t in pcd_args[4]["fc"].values()]

    def gather_fwd_bwd():
        for t in pn_leaves + [sxyz]:
            t.grad = None
        gather_pcd_features(sxyz, *pcd_args[1:]).sum().backward()
    torch.cuda.reset_peak_memory_stats()
    gather_bwd_ms = _event_ms(gather_fwd_bwd, reps=3)
    gather_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for shape in ("mapping", "tracking"):
        a, b, c = k1[shape], k3[shape], k2[shape]
        log(f"{shape} shape: K1 {a['ms']:.3f} ms (plain {a['plain_ms']:.3f} "
            f"ms, bound {a['bound_ms']:.4f} ms by {a['bound_by']}, share "
            f"{a['share']:.3f}, {a['rows']} rows); K2 {c['ms']:.3f} ms (plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms by "
            f"{c['bound_by']}, share {c['share']:.3f}; bf16 torch.matmul "
            f"chain forward {c['matmul_chain_ms']:.3f} ms, {c['rows']} rows); "
            f"K3 {b['ms']:.3f} ms (plain {b['plain_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share "
            f"{b['share']:.3f}); K3 dx-only {b['dx_only_ms']:.3f} ms (plain "
            f"{b['dx_only_plain_ms']:.3f} ms, bound "
            f"{b['dx_only_bound_ms']:.4f} ms)")
    log(f"bf16 torch.matmul chain (a chain of calls, not one library call): "
        f"forward+backward {chain_bwd_ms:.3f} ms at N={N}")
    log(f"pcd gather (PointNet at {pcd_args[3].xyz.shape[1] * R * H} rows + "
        f"blend): forward {gather_ms:.3f} ms, forward+backward "
        f"{gather_bwd_ms:.3f} ms, peak memory {gather_peak_gb:.2f} GB")

    f32 = f32_kernel_phase(x2, g, fp, min(TR, N2))
    render_errs = pcd_render_check(inp["render"], inp["rays_o"],
                                   inp["rays_d"], device)

    m1, m2, m3 = k1["mapping"], k2["mapping"], k3["mapping"]
    return {
        "fused_render_forward": dict(
            _entry(max(err_feats, err_out), m1["ms"], m1["plain_ms"],
                   (m1["bound_ms"], m1["bound_by"])), shapes=k1),
        "decoder_forward": dict(
            _entry(err2, m2["ms"], m2["plain_ms"],
                   (m2["bound_ms"], m2["bound_by"]), m2["matmul_chain_ms"]),
            shapes=k2),
        "decoder_backward": dict(
            _entry(worst_abs, m3["ms"], m3["plain_ms"],
                   (m3["bound_ms"], m3["bound_by"]), chain_bwd_ms),
            shapes=k3),
        **f32,
        "extra": dict(pcd_gather_ms=gather_ms,
                      pcd_gather_fwd_bwd_ms=gather_bwd_ms,
                      pcd_gather_peak_gb=gather_peak_gb,
                      k1_shift_err=shift1, k2_inputs=k2_inputs,
                      pcd_render=render_errs),
    }


def _to(nt, device):
    return type(nt)(*[f.to(device) if hasattr(f, "to") else f for f in nt])


def pcd_render_check(r, rays_o, rays_d, device):
    """The pcd branch's ``render_rays`` and the repo's loss on the first
    RENDER_RAYS mapping rays, on the card (K2, K3 through autograd) and on
    the CPU (plain versions) from the same inputs and the same ray
    intersections: outputs and the gradients w.r.t. ray origins and
    directions (the pose), the decoder and PointNet params."""
    import torch

    from proudslam_tpu_torch.models.decoder import tree_leaves, tree_unflatten
    from proudslam_tpu_torch.render.losses import compute_loss
    from proudslam_tpu_torch.render.renderer import render_rays

    s = r["settings"]
    rnd = dataclasses.replace(s.render, feature_mode="pcd")
    n = RENDER_RAYS
    pre = [type(nt)(*[f[:n] for f in nt]) for nt in r["precomputed"]]

    def run(dev):
        o = rays_o[:n].to(dev).requires_grad_(True)
        d = rays_d[:n].to(dev).requires_grad_(True)
        tree = {**r["dec"], "pointnet": r["pn"]}
        leaves = [t.detach().to(dev).clone().requires_grad_(True)
                  for t in tree_leaves(tree)]
        view = _to(r["view"], dev)
        out = render_rays(o, d, view, view.embeddings,
                          tree_unflatten(tree, leaves), s.decoder, rnd,
                          point_store=_to(r["store"], dev),
                          precomputed=[_to(nt, dev) for nt in pre])
        loss, _ = compute_loss(out, r["gt_c"][:n].to(dev),
                               r["gt_d"][:n].to(dev), s.loss,
                               weight_depth_loss=True)
        loss.backward()
        outs = {"color": out.color, "depth": out.depth, "loss": loss,
                "hit": out.hit_mask.float().mean()}
        grads = {"d_o": o.grad, "d_d": d.grad}
        grads.update({f"param{i}": t.grad for i, t in enumerate(leaves)})
        return ({k: v.detach().cpu() for k, v in outs.items()},
                {k: v.cpu() for k, v in grads.items()})

    before = _launches()
    out_k, grad_k = run(device)
    launched = {k: v - before[k] for k, v in _launches().items()}
    out_c, grad_c = run(torch.device("cpu"))
    err_out = max((out_k[k] - out_c[k]).abs().max().item() for k in out_c)
    err_grad = max(((grad_k[k] - grad_c[k]).abs().max()
                    / grad_c[k].abs().max().clamp_min(1e-30)).item()
                   for k in grad_c)
    st = dict(rays=n, hit_share=out_c["hit"].item(),
              color_std_min=out_c["color"].std(dim=0).min().item(),
              depth_std=out_c["depth"].std().item(), max_abs_err_out=err_out,
              max_rel_err_grad=err_grad, launches=launched)
    log("pcd render_rays, card against CPU: " + json.dumps(st)
        + f" (tol {TOL_RENDER_OUT}, {TOL_RENDER_GRAD_REL} of each "
        "gradient's largest magnitude)")
    if device.type == "cuda" and launched != {
            "fused_render_forward": 0, "decoder_forward": 1,
            "decoder_backward": 1, "decoder_forward_f32": 0,
            "decoder_backward_f32": 0}:
        raise AssertionError("pcd render_rays did not run K2 and K3 once")
    if not (err_out <= TOL_RENDER_OUT and err_grad <= TOL_RENDER_GRAD_REL):
        raise AssertionError("pcd render_rays on the card disagrees with "
                             "the CPU")
    return st


def render_frames():
    """The first N_FRAMES frames of the scan, quantized as the datasets
    store them (uint8 rgb, uint16 depth)."""
    scene, poses, K = _scene()
    t0 = time.perf_counter()
    frames = [scene.render(p, WIDTH, HEIGHT, *K) for p in poses[:N_FRAMES]]
    log(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s "
        "(host)")
    depth_quant = 65535.0 / 10.0
    quant = [(np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8),
              np.clip(d * depth_quant + 0.5, 0, 65535.0).astype(np.uint16))
             for c, d in frames]
    return quant, poses, K, depth_quant


def _counters():
    """Each kernel's launch counter (an object with ``launches``), by the
    kernel's name in the kernels JSON line."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    return {"fused_render_forward": rk.fused_render_forward,
            "decoder_forward": mk.decoder_fwd,
            "decoder_backward": mk.decoder_bwd,
            "decoder_forward_f32": mk.decoder_fwd_f32,
            "decoder_backward_f32": mk.decoder_bwd_f32}


def _launches():
    return {k: c.launches for k, c in _counters().items()}


def _reset_launches() -> None:
    for c in _counters().values():
        c.launches = 0


def _new_slam(device, settings, frames):
    """A ``SlamSystem`` for the scan's camera and frame size."""
    from proudslam_tpu_torch.engine.slam import SlamSystem

    return SlamSystem(settings, frames[2], (HEIGHT, WIDTH), seed=0,
                      point_stride=2, device=device)


def _initialize(slam, frames) -> None:
    quant, poses, _, depth_quant = frames
    slam.initialize(quant[0][0].astype(np.float32) / 255.0,
                    quant[0][1].astype(np.float32) / depth_quant, poses[0],
                    stamp=0)


def _process(slam, frames, first: int, last: int) -> None:
    for i in range(first, last):
        slam.process_frame(i, *frames[0][i])


def _timed(fn) -> float:
    """Host seconds of ``fn()`` until the card has finished its work."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class _FrameSequence:
    """The slice's frames as a dataset (``run_slam``'s protocol:
    ``intrinsics``, ``dataset[i] -> (i, rgb, depth, K, pose)``),
    dequantized."""

    def __init__(self, frames, n_frames):
        self.quant, self.poses, self.intrinsics, self.depth_quant = frames
        self.n = n_frames

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        c, d = self.quant[i]
        return (i, c.astype(np.float32) / 255.0,
                d.astype(np.float32) / self.depth_quant, None, self.poses[i])


def mesh_phase(slam, settings, frames, n_frames, est) -> dict:
    """``extract_mesh`` of a slice's map with colors, cleaned against the
    slice's depth cloud at the trajectory ``est``, and its accuracy and
    completion against the analytic scene (``bench.py``'s measure)."""
    from scipy.spatial import cKDTree

    from proudslam_tpu_torch.mesher import extract_mesh
    from proudslam_tpu_torch.run_slam import accumulate_depth_cloud

    seq = _FrameSequence(frames, n_frames)
    before = _launches()
    t0 = time.perf_counter()
    cloud = accumulate_depth_cloud(seq, est, 0, settings)
    cloud_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = extract_mesh(slam.map_state, slam.decoder_params, settings.map,
                        settings.decoder, res=MESH_RES, depth_points=cloud)
    mesh_s = time.perf_counter() - t0      # ends with host arrays
    launched = {k: v - before[k] for k, v in _launches().items()}
    st = dict(res=MESH_RES, cloud_points=len(cloud), cloud_ms=cloud_s * 1e3,
              mesh_ms=mesh_s * 1e3, verts=len(mesh.verts),
              faces=len(mesh.faces), launches=launched)
    if not (len(mesh.verts) and len(mesh.faces)):
        raise AssertionError(f"empty mesh: {st}")
    if mesh.colors is None or not np.isfinite(mesh.colors).all():
        raise AssertionError("mesh without finite vertex colors")
    scene = _scene()[0]
    st["acc_cm"] = float(np.mean(scene.surface_distance(mesh.verts))) * 100
    kept = np.unique(mesh.faces)
    st["acc_kept_cm"] = float(np.mean(
        scene.surface_distance(mesh.verts[kept]))) * 100
    fx, fy, cx, cy = seq.intrinsics
    ys, xs = np.mgrid[0:HEIGHT:4, 0:WIDTH:4]
    dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy,
                     np.ones_like(xs, np.float32)], axis=-1)
    samples = []
    for i in range(0, n_frames, 30):
        _, _, d, _, pose = seq[i]
        pts = (dirs * d[::4, ::4, None]).reshape(-1, 3)
        pts = pts[(d[::4, ::4] > 0).reshape(-1)]
        samples.append(pts @ pose[:3, :3].T + pose[:3, 3])
    st["comp_cm"] = float(np.mean(
        cKDTree(mesh.verts).query(np.concatenate(samples))[0])) * 100
    log("mesh: " + json.dumps(st) + f" (limit {MESH_LIMIT_CM} cm)")
    if any(launched.values()):
        raise AssertionError(f"a kernel launched inside the mesh: {launched}")
    if not (st["acc_cm"] < MESH_LIMIT_CM and st["comp_cm"] < MESH_LIMIT_CM):
        raise AssertionError(f"mesh accuracy {st['acc_cm']:.2f} cm or "
                             f"completion {st['comp_cm']:.2f} cm >= "
                             f"{MESH_LIMIT_CM}")
    return st


def slice_phase(device, name, settings, frames, n_frames, ate_limit_cm,
                launched, not_launched, mesh=False):
    """``initialize``, ``process_frame`` over frames 1..n_frames-1 and
    ``global_refine(rounds=2)``; the kernels in ``launched`` must have been
    launched in the run and those in ``not_launched`` not. ``mesh``: then
    the slice's mesh (:func:`mesh_phase`)."""
    import torch

    from proudslam_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    poses = frames[1]
    slam = _new_slam(device, settings, frames)
    pn0 = None
    if "pointnet" in slam.decoder_params:
        pn0 = slam.decoder_params["pointnet"]["fc"]["w"].clone()
    torch.cuda.synchronize()
    _reset_launches()
    init_s = _timed(lambda: _initialize(slam, frames))
    n_init_maps = len(slam.clock.marks["map"])
    loop_s = _timed(lambda: _process(slam, frames, 1, n_frames))
    refine_s = _timed(lambda: slam.global_refine(rounds=2))
    launches = _launches()

    est = slam.get_trajectory()
    gt = np.stack(poses[:n_frames])
    if not np.isfinite(est).all():
        raise AssertionError(f"{name} slice: non-finite poses")
    ate = ate_rmse(est, gt, align=False) * 100
    ate_al = ate_rmse(est, gt, align=True) * 100
    rpe = rpe_rmse(est, gt, delta=1) * 100
    pos_err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 100
    ms = slam.clock.ms()
    n = n_frames - 1
    frame_map = ms["map"][n_init_maps:n_init_maps + n]
    stats = {
        "frames": n_frames, "fps": n / loop_s, "init_s": init_s,
        "refine_s": refine_s,
        "track_ms": float(np.mean(ms["track"])),
        "map_ms": float(np.mean(frame_map)),
        "insert_ms": float(np.mean(ms["insert"][1:])),
        "ate_cm": ate, "ate_aligned_cm": ate_al, "rpe_cm": rpe,
        "max_pos_err_cm": float(pos_err.max()),
        "num_voxels": slam.map_state.num_voxels,
        "num_cells": slam.map_state.num_cells, "num_keyframes": slam.num_kf,
        "launches": launches,
    }
    if slam.point_store is not None:
        stats["points"] = int(slam.point_store.counts.sum())
    log(f"{name} slice: " + json.dumps(stats))
    log(f"{name} slice: position error per frame (cm): "
        + " ".join(f"{e:.2f}" for e in pos_err))
    for k in launched:
        if launches[k] <= 0:
            raise AssertionError(f"{name} slice: {k} was not launched")
    for k in not_launched:
        if launches[k] != 0:
            raise AssertionError(f"{name} slice: {k} was launched")
    if slam.point_store is not None and not stats["points"] > 0:
        raise AssertionError(f"{name} slice: empty point store")
    if pn0 is not None:
        moved = (slam.decoder_params["pointnet"]["fc"]["w"] - pn0).abs().max()
        if not float(moved) > 0:
            raise AssertionError(f"{name} slice: PointNet was not trained")
    if not ate < ate_limit_cm:
        raise AssertionError(
            f"{name} slice: unaligned ATE {ate:.3f} cm >= {ate_limit_cm}")
    if mesh:
        stats["mesh"] = mesh_phase(slam, settings, frames, n_frames, est)
    return stats


def _read_ply(path):
    """(verts (N, 3), faces (M, 3)) of an ASCII PLY as ``save_ply``
    writes it."""
    with open(path) as f:
        head, body = f.read().split("end_header\n")
    nv = int(head.split("element vertex ")[1].split()[0])
    nf = int(head.split("element face ")[1].split()[0])
    lines = body.splitlines()
    if len(lines) != nv + nf:
        raise AssertionError(f"{path}: {len(lines)} lines for {nv} vertices "
                             f"and {nf} faces")
    verts = np.array([ln.split()[:3] for ln in lines[:nv]], np.float64)
    faces = np.array([ln.split()[1:] for ln in lines[nv:]], np.int64)
    return verts.reshape(-1, 3), faces.reshape(-1, 3)


def _png_size(path):
    """(width, height) of a PNG from its IHDR chunk, after checking that
    its pixel data decompresses to that size (8-bit RGB rows with a filter
    byte, as the port's logger writes them)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: pixel data does not match {w}x{h}")
    return w, h


def cli_phase(device, name, overrides=(), launched=(), panels=(),
              mesh=True, ate_limit_cm=CLI_ATE_LIMIT_CM):
    """``run_slam.main`` on ``configs/synthetic/room.yaml`` (with the config
    ``overrides``) into a temporary log directory: artifacts (the panels
    ``imgs/render_<frame>.png`` of the frames in ``panels``, the mesh when
    ``mesh``), the kernels in ``launched`` launched and no other, the ATE
    limit (none when ``ate_limit_cm`` is None), and the checkpoint reloaded
    to the saved trajectory bit for bit."""
    import tempfile

    import torch

    from proudslam_tpu_torch.config import load_config, settings_from_config
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.run_slam import main as run_slam_main
    from proudslam_tpu_torch.run_slam import parse_overrides
    from proudslam_tpu_torch.utils.checkpoint import load_checkpoint

    config = os.path.join(ROOT, CLI_CONFIG)
    flags = [o for o in overrides if o == "--no-mesh"]
    keyed = [o for o in overrides if o != "--no-mesh"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as logs:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        res = run_slam_main([config, "--log_dir", logs, "--device",
                             str(device), *overrides])
        wall_s = time.perf_counter() - t0
        launches = _launches()
        run = res["dir"]
        need = ["misc/frame_poses.npy", "ckpt/final_ckpt.npz",
                "ckpt/final_ckpt.meta.json", "metrics.jsonl"]
        need += ["mesh/final_mesh.ply"] if mesh else []
        need += [f"imgs/render_{i:05d}.png" for i in panels]
        paths = {k: os.path.join(run, *k.split("/")) for k in need}
        missing = [k for k, p in paths.items() if not os.path.exists(p)]
        if missing:
            raise AssertionError(f"{name}: missing artifacts {missing}")
        written = sorted(os.listdir(os.path.join(run, "imgs")))
        if written != sorted(f"render_{i:05d}.png" for i in panels):
            raise AssertionError(f"{name}: panels {written}")
        sizes = {os.path.basename(p): _png_size(p) for k, p in paths.items()
                 if k.startswith("imgs/")}
        poses = np.load(paths["misc/frame_poses.npy"])
        if mesh:
            verts, faces = _read_ply(paths["mesh/final_mesh.ply"])
            if not (len(verts) and len(faces) and np.isfinite(verts).all()):
                raise AssertionError(f"{name}: empty or non-finite mesh")
        with open(paths["metrics.jsonl"]) as f:
            metrics = [json.loads(ln) for ln in f]
        cfg = load_config(config, parse_overrides(keyed))
        fresh = SlamSystem(settings_from_config(cfg),
                           res["intrinsics"], tuple(res["image_hw"]), seed=1,
                           device=device)
        load_checkpoint(paths["ckpt/final_ckpt.npz"], fresh)
        reloaded = fresh.get_trajectory()
    same = reloaded.shape == poses.shape and np.array_equal(reloaded, poses)
    keys = ["frames", "skipped", "fps", "init_s", "loop_s", "refine_s",
            "track_ms", "map_ms", "insert_ms", "ate_cm", "ate_aligned_cm",
            "num_voxels", "num_keyframes"]
    keys += ["mesh_s", "mesh_verts", "mesh_faces"] if mesh else []
    st = {k: res[k] for k in keys}
    st.update(wall_s=wall_s, launches=launches, flags=flags,
              overrides=keyed, panel_sizes=sizes,
              metrics_ate_cm=metrics[-1].get("ate_rmse_cm"),
              checkpoint_trajectory_bitwise=same)
    log(f"{name}: " + json.dumps(st) + f" (ATE limit {ate_limit_cm} cm)")
    for k, v in launches.items():
        if (k in launched) != (v > 0):
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{list(launched) or 'none'}")
    if any(wh != PANEL_WH for wh in sizes.values()):
        raise AssertionError(f"{name}: panel sizes {sizes}, expected "
                             f"{PANEL_WH}")
    if not (poses.shape == (res["frames"] + 1, 4, 4)
            and np.isfinite(poses).all()):
        raise AssertionError(f"{name}: trajectory {poses.shape}")
    if not same:
        raise AssertionError(f"{name}: the reloaded checkpoint's trajectory "
                             "differs from frame_poses.npy")
    if ate_limit_cm is not None and not st["ate_cm"] < ate_limit_cm:
        raise AssertionError(f"{name}: unaligned ATE {st['ate_cm']:.3f} cm "
                             f">= {ate_limit_cm}")
    return st


def profile_phase(device, settings, frames, start=PROFILE_START,
                  count=PROFILE_FRAMES):
    """Where the vox slice's device time goes: ``torch.profiler`` over
    ``count`` frames after ``start - 1`` unprofiled ones. Each phase of the
    engine's clock (track, map, insert) is also a profiler range; on the
    device timeline a phase spans its range, is busy for the kernels that
    start inside it, and idle otherwise. Also the top kernels' shares of
    all busy time, and the host's CPU time in profiled operators and in
    ``cudaLaunchKernel``. The profiler slows the host, so the phases'
    spans (and idle shares) are upper bounds of the unprofiled run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from proudslam_tpu_torch.engine.slam import PhaseClock

    class RangedClock(PhaseClock):
        @contextlib.contextmanager
        def phase(self, name):
            with record_function(f"phase:{name}"), super().phase(name):
                yield

    slam = _new_slam(device, settings, frames)
    slam.clock = RangedClock(device)
    _initialize(slam, frames)
    _timed(lambda: _process(slam, frames, 1, start))
    _reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = _timed(lambda: _process(slam, frames, start, start + count))
    launches = _launches()
    # device-timeline events: the phases' ranges (GPU annotations) and the
    # kernels; a kernel belongs to the phase whose range holds its start
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    windows = [(e.name[len("phase:"):], e.time_range.start, e.time_range.end)
               for e in evs if e.name.startswith("phase:")]
    kernels = [e for e in evs if not e.name.startswith("phase:")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    phases = {}
    for name, t0_us, t1_us in windows:
        ph = phases.setdefault(name, dict(span_us=0.0, busy_us=0.0,
                                          kernels=0))
        ph["span_us"] += t1_us - t0_us
        for e in kernels:
            if t0_us <= e.time_range.start < t1_us:
                ph["busy_us"] += e.time_range.elapsed_us()
                ph["kernels"] += 1
    by_name = {}
    for e in kernels:
        k = by_name.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.elapsed_us()
        k[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the host: CPU time of every profiled operator, and the launches
    host = prof.key_averages()
    cpu_us = sum(e.self_cpu_time_total for e in host)
    launch = [e for e in host if e.key == "cudaLaunchKernel"]
    st = dict(frames=[start, start + count - 1],
              wall_ms_per_frame_profiled=wall_s * 1e3 / count,
              host_cpu_ms_per_frame=cpu_us / 1e3 / count,
              cuda_launch_kernel_per_frame=dict(
                  calls=sum(e.count for e in launch) / count,
                  cpu_ms=sum(e.self_cpu_time_total for e in launch) / 1e3
                  / count),
              device_busy_ms_per_frame=busy_us / 1e3 / count,
              kernel_launches_per_frame=len(kernels) / count,
              phases={name: dict(
                  device_span_ms_per_frame=ph["span_us"] / 1e3 / count,
                  device_busy_ms_per_frame=ph["busy_us"] / 1e3 / count,
                  idle_share=1.0 - ph["busy_us"] / max(ph["span_us"], 1e-9),
                  kernels_per_frame=ph["kernels"] / count)
                  for name, ph in phases.items()},
              launches=launches,
              top_kernels=[dict(name=name[:80], share=us / max(busy_us, 1e-9),
                                ms_per_frame=us / 1e3 / count,
                                calls_per_frame=n / count)
                           for name, (us, n) in top])
    log("vox profile: " + json.dumps(st))
    if not busy_us > 0:
        raise AssertionError("the profile saw no device time")
    return st


def main() -> None:
    sys.path.insert(0, ROOT)
    smi = device_phase()
    import torch

    try:
        import proudslam_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is missing: {e}")
    from proudslam_tpu_torch.config import bench_settings

    device = torch.device("cuda", 0)
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_s, built = build_phase()
    log(f"build: {build_s:.1f} s")
    kern = kernel_phase(device)
    frames = render_frames()
    vox = bench_settings()
    bf16_kernels = ("fused_render_forward", "decoder_forward",
                    "decoder_backward")
    f32_kernels = ("decoder_forward_f32", "decoder_backward_f32")
    stats = {"vox": slice_phase(
        device, "vox", vox, frames, N_FRAMES, ATE_LIMIT_CM,
        launched=("fused_render_forward", "decoder_backward"),
        not_launched=("decoder_forward",) + f32_kernels, mesh=True)}
    pcd = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, feature_mode="pcd"),
        map=dataclasses.replace(vox.map, points_per_voxel=8))
    stats["pcd"] = slice_phase(
        device, "pcd", pcd, frames, PCD_FRAMES, PCD_ATE_LIMIT_CM,
        launched=("decoder_forward", "decoder_backward"),
        not_launched=("fused_render_forward",) + f32_kernels)
    pcd_f32 = dataclasses.replace(pcd, decoder=dataclasses.replace(
        pcd.decoder, matmul_dtype="f32"))
    stats["pcd-f32"] = slice_phase(
        device, "pcd-f32", pcd_f32, frames, PCD_FRAMES, PCD_ATE_LIMIT_CM,
        launched=f32_kernels, not_launched=bf16_kernels)
    resample = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, pixel_sampler="gumbel"),
        tracker=dataclasses.replace(vox.tracker, fixed_sample_batch=False),
        mapper=dataclasses.replace(vox.mapper, fixed_sample_batch=False))
    stats["resample"] = slice_phase(
        device, "resample", resample, frames, RESAMPLE_FRAMES, ATE_LIMIT_CM,
        launched=("fused_render_forward", "decoder_backward"),
        not_launched=("decoder_forward",) + f32_kernels)
    log("resample against the fixed-batch vox slice: " + json.dumps(
        {k: {p: stats[p][k] for p in ("vox", "resample")}
         for k in ("frames", "fps", "init_s", "track_ms", "map_ms",
                   "insert_ms", "ate_cm")}))
    profile = profile_phase(device, vox, frames)
    stats["cli"] = cli_phase(
        device, "cli", ("--debug_args.render_freq", str(CLI_RENDER_FREQ)),
        panels=range(CLI_RENDER_FREQ - 1, N_FRAMES, CLI_RENDER_FREQ))
    stats["cli-pcd"] = cli_phase(
        device, "cli-pcd", ("--tpu_specs.feature_mode", "pcd",
                            "--tpu_specs.fused_mlp", "true",
                            "--data_specs.num_frames", str(PCD_CLI_FRAMES),
                            "--no-mesh"),
        launched=f32_kernels, mesh=False, ate_limit_cm=None)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    mlp = "proudslam_tpu/ops/pallas/mlp_kernel.py"
    meta = {
        "fused_render_forward": (
            "proudslam_tpu_torch/csrc/render_kernel.cu",
            "proudslam_tpu/ops/pallas/render_kernel.py:63", None,
            "render_forward_kernel"),
        "decoder_forward": (
            "proudslam_tpu_torch/csrc/mlp_kernel.cu", f"{mlp}:132",
            "bf16=True", "decoder_forward_kernel"),
        "decoder_backward": (
            "proudslam_tpu_torch/csrc/mlp_kernel.cu", f"{mlp}:141",
            "bf16=True", "decoder_backward_kernel"),
        "decoder_forward_f32": (
            "proudslam_tpu_torch/csrc/mlp_kernel_f32.cu", f"{mlp}:132",
            "bf16=False", "decoder_forward_f32_kernel"),
        "decoder_backward_f32": (
            "proudslam_tpu_torch/csrc/mlp_kernel_f32.cu", f"{mlp}:141",
            "bf16=False", "decoder_backward_f32_kernel"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "replaces_form": form,
         "launches": sum(st["launches"][name] for st in stats.values()),
         "launches_by_path": {p: st["launches"][name]
                              for p, st in stats.items()},
         "build": built[fn],
         **kern[name]}
        for name, (src, rep, form, fn) in meta.items()]}
    unlaunched = [k["name"] for k in record["kernels"] if k["launches"] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels launched on no path: {unlaunched}")
    print(json.dumps({"slices": stats, "kernel_phase": kern["extra"],
                      "vox_profile": profile}))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
