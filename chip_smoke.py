#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``proudslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile the CUDA kernels from ``proudslam_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. kernels: run each kernel at the slices' mapping shapes on inputs from
   the real pipeline and hold it against its plain PyTorch version (stated
   tolerances), with CUDA-event times of both, each kernel's bound (least
   time on the card, from this run's shapes) and, for the decoder kernels,
   a chain of bf16 ``torch.matmul`` calls as a yardstick (no single
   PyTorch call computes these functions); then hold the pcd branch's
   ``render_rays`` (PointNet gather, K2, K3 through autograd) on the card
   against the same call on the CPU, outputs and gradients, on 512 rays;
4. vox slice: the bench configuration with the fused render path on
   (``config.bench_settings``): ``SlamSystem.initialize`` (200 mapping
   iterations), 39 ``process_frame`` calls over the first 40 frames of the
   480-frame ``scan`` trajectory at 320x240, and ``global_refine(rounds=2)``;
   K1 and K3 must have been launched, the poses finite and the unaligned
   ATE under 3 cm;
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
   engines' drift at that test's size.

Every launch count is set to 0 just before a slice and read just after it.
Standard output ends with the slices' JSON line, the kernels' JSON line,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
The script imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 `feats` are f32 blends computed by the same formula in the same order
# (only FMA contraction can differ): 1e-5 absolute at unit-scale features.
# Decoder outputs differ by f32 summation order, which can flip the bf16
# rounding of an intermediate activation (2^-8 relative): 1e-2 absolute on
# sigmoid colors and sdf values of order 1.
TOL_FEATS = 1e-5
TOL_OUT = 1e-2
# K2 and its plain version round the same operands to bf16 and differ only
# by f32 summation order; the same decoder inside K1 stays within 1.1e-5 of
# its plain version on an H100. 1e-4 absolute, and the check must be able
# to tell a kernel that reads a neighbouring row: the plain outputs of
# neighbouring rows must differ by more than K2_SHIFT_MARGIN x the tolerance.
TOL_K2 = 1e-4
K2_SHIFT_MARGIN = 100.0
# pcd render_rays on the card against the CPU (plain kernel versions):
# PointNet's f32 sums run in another order on each, so a feature can round
# to a neighbouring bf16 value at the decoder's input, as between the port
# and the JAX package on the CPU: the tolerances of that test, 2e-3
# absolute on outputs and 5e-3 of each gradient's largest magnitude (a
# gradient routed to the wrong leaf or dropped is off by ~1 of it).
TOL_RENDER_OUT = 2e-3
TOL_RENDER_GRAD_REL = 5e-3
RENDER_RAYS = 512
# K3 gradients: sums over 327,680 rows in another order plus the same bf16
# rounding flips on cotangents; held at 1e-2 of each output's largest
# magnitude.
TOL_GRAD_REL = 1e-2
ATE_LIMIT_CM = 3.0
PCD_ATE_LIMIT_CM = 60.0
N_FRAMES = 40
PCD_FRAMES = 5
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

    names = ("render_kernel", "mlp_kernel")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(build.build, name) for name in names]:
            f.result()
    for name in names:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}: {line.strip()}")
    return time.perf_counter() - t0


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


def _matmul_chain(fp):
    """The decoder as a chain of bf16 ``torch.matmul`` calls with bf16
    weight leaves: the yardstick for K2 (forward) and K3 (forward and its
    autograd backward). No single PyTorch call computes either."""
    import torch

    w = {k: v.to(torch.bfloat16).requires_grad_(True)
         for k, v in fp._asdict().items()}

    def fwd(x):
        h1 = torch.relu(x @ w["w1"] + w["b1"])
        h2 = torch.relu(h1 @ w["w2"] + w["b2"])
        so = h2 @ w["ws"] + w["bs"]
        hc = torch.relu(so[:, :-1] @ w["wc_f"] + x @ w["wc_x"] + w["bc"])
        return torch.cat([torch.sigmoid(hc @ w["wo"] + w["bo"]), so[:, -1:]],
                         dim=1)
    return fwd, list(w.values())


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
    n_smp = R * S
    k1_bound = _bound(DEC_FLOPS * n_smp, (2 * 8 * 16 + 8 * 2) * n_smp,
                      _nbytes(*args[:6], *inp["fp"], out_k, feats_k))

    x = feats_p
    g = 1e-2 * torch.randn((x.shape[0], 4), generator=inp["gen"],
                           device=device)
    fp = inp["fp"]
    N = x.shape[0]
    log(f"kernels: K3 at N={N}")
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
    k3_bound = _bound(3 * DEC_FLOPS * N, 0,
                      _nbytes(x, g, *fp, dx_k, *gr_k))

    # K2 on the pcd branch's decoder inputs (PointNet features of frame 0's
    # stored points, blended per sample), then on K1's trilinear features
    # at a row count that is no multiple of the 64-row tile
    pcd_args = inp["pcd_args"]
    with torch.no_grad():
        x2 = gather_pcd_features(*pcd_args)
    x2 = x2.reshape(-1, x2.shape[-1]).contiguous()
    N2 = x2.shape[0]
    k2_inputs = {}
    for label, xi in (("pcd", x2), ("trilinear", x[:N - 37])):
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
                  max_abs_err=(out_k - out_p).abs().max().item())
        k2_inputs[label] = st
        log(f"K2 on {label} features: " + json.dumps(st)
            + f" (tol {TOL_K2}, shift margin {K2_SHIFT_MARGIN})")
        if not st["max_abs_err"] <= TOL_K2:
            raise AssertionError(f"K2 disagrees with decoder_fwd_plain on "
                                 f"{label} features")
        if not torch.equal(out_k, out_k2):
            raise AssertionError("K2 is not bitwise repeatable")
    if not k2_inputs["trilinear"]["shift_err"] > K2_SHIFT_MARGIN * TOL_K2:
        raise AssertionError("the K2 check cannot tell neighbouring rows")
    err2 = max(st["max_abs_err"] for st in k2_inputs.values())
    k2_ms = _event_ms(lambda: mk.decoder_fwd(x2, fp))
    k2_plain_ms = _event_ms(lambda: mk.decoder_fwd_plain(x2, fp))
    k2_bound = _bound(DEC_FLOPS * N2, 0, _nbytes(x2, *fp) + N2 * 4 * 4)

    # yardstick: the same decoder as a chain of bf16 matmuls
    chain, leaves = _matmul_chain(fp)
    x2b = x2.to(torch.bfloat16)
    with torch.no_grad():
        chain_fwd_ms = _event_ms(lambda: chain(x2b))
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

    log(f"K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound[0]:.4f} ms by {k1_bound[1]}); K3 {k3_ms:.3f} ms (plain "
        f"{k3_plain_ms:.3f} ms, bound {k3_bound[0]:.4f} ms by {k3_bound[1]}); "
        f"K3 dx-only {k3_dx_ms:.3f} ms (plain {k3_dx_plain_ms:.3f} ms); K2 "
        f"{k2_ms:.3f} ms (plain {k2_plain_ms:.3f} ms, bound "
        f"{k2_bound[0]:.4f} ms by {k2_bound[1]})")
    log(f"bf16 torch.matmul chain (a chain of calls, not one library call): "
        f"forward {chain_fwd_ms:.3f} ms at N={N2}; forward+backward "
        f"{chain_bwd_ms:.3f} ms at N={N}")
    log(f"pcd gather (PointNet at {pcd_args[3].xyz.shape[1] * R * H} rows + "
        f"blend): forward {gather_ms:.3f} ms, forward+backward "
        f"{gather_bwd_ms:.3f} ms, peak memory {gather_peak_gb:.2f} GB")

    render_errs = pcd_render_check(inp["render"], inp["rays_o"],
                                   inp["rays_d"], device)

    def entry(err, ms, plain_ms, bound, chain_ms=None):
        e = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                 bound_by=bound[1], library_ms=None)
        if chain_ms is not None:
            e["matmul_chain_ms"] = chain_ms
        return e

    return {
        "fused_render_forward": entry(max(err_feats, err_out), k1_ms,
                                      k1_plain_ms, k1_bound),
        "decoder_forward": entry(err2, k2_ms, k2_plain_ms, k2_bound,
                                 chain_fwd_ms),
        "decoder_backward": entry(worst_abs, k3_ms, k3_plain_ms, k3_bound,
                                  chain_bwd_ms),
        "extra": dict(k3_dx_ms=k3_dx_ms, k3_dx_plain_ms=k3_dx_plain_ms,
                      pcd_gather_ms=gather_ms,
                      pcd_gather_fwd_bwd_ms=gather_bwd_ms,
                      pcd_gather_peak_gb=gather_peak_gb,
                      k2_inputs=k2_inputs, pcd_render=render_errs),
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
    if device.type == "cuda" and launched != {"fused_render_forward": 0,
                                              "decoder_forward": 1,
                                              "decoder_backward": 1}:
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


def _launches():
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    return {"fused_render_forward": rk.fused_render_forward.launches,
            "decoder_forward": mk.decoder_fwd.launches,
            "decoder_backward": mk.decoder_bwd.launches}


def _reset_launches() -> None:
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    rk.fused_render_forward.launches = 0
    mk.decoder_fwd.launches = 0
    mk.decoder_bwd.launches = 0


def slice_phase(device, name, settings, frames, n_frames, ate_limit_cm,
                launched, not_launched):
    """``initialize``, ``process_frame`` over frames 1..n_frames-1 and
    ``global_refine(rounds=2)``; the kernels in ``launched`` must have been
    launched in the run and those in ``not_launched`` not."""
    import torch

    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.utils.metrics import ate_rmse, rpe_rmse

    quant, poses, K, depth_quant = frames
    rgb0 = quant[0][0].astype(np.float32) / 255.0
    depth0 = quant[0][1].astype(np.float32) / depth_quant

    slam = SlamSystem(settings, K, (HEIGHT, WIDTH), seed=0, point_stride=2,
                      device=device)
    pn0 = None
    if "pointnet" in slam.decoder_params:
        pn0 = slam.decoder_params["pointnet"]["fc"]["w"].clone()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    slam.initialize(rgb0, depth0, poses[0], stamp=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_init_maps = len(slam.clock.marks["map"])
    t0 = time.perf_counter()
    for i in range(1, n_frames):
        slam.process_frame(i, *quant[i])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam.global_refine(rounds=2)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
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
    return stats


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
    log(f"build: {build_phase():.1f} s")
    kern = kernel_phase(device)
    frames = render_frames()
    vox = bench_settings()
    stats = {"vox": slice_phase(
        device, "vox", vox, frames, N_FRAMES, ATE_LIMIT_CM,
        launched=("fused_render_forward", "decoder_backward"),
        not_launched=("decoder_forward",))}
    pcd = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, feature_mode="pcd"),
        map=dataclasses.replace(vox.map, points_per_voxel=8))
    stats["pcd"] = slice_phase(
        device, "pcd", pcd, frames, PCD_FRAMES, PCD_ATE_LIMIT_CM,
        launched=("decoder_forward", "decoder_backward"),
        not_launched=("fused_render_forward",))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    meta = {
        "fused_render_forward": (
            "proudslam_tpu_torch/csrc/render_kernel.cu",
            "proudslam_tpu/ops/pallas/render_kernel.py:63"),
        "decoder_forward": (
            "proudslam_tpu_torch/csrc/mlp_kernel.cu",
            "proudslam_tpu/ops/pallas/mlp_kernel.py:132"),
        "decoder_backward": (
            "proudslam_tpu_torch/csrc/mlp_kernel.cu",
            "proudslam_tpu/ops/pallas/mlp_kernel.py:141"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(st["launches"][name] for st in stats.values()),
         "launches_by_path": {p: st["launches"][name]
                              for p, st in stats.items()},
         **kern[name]}
        for name, (src, rep) in meta.items()]}
    print(json.dumps({"slices": stats, "kernel_phase": kern["extra"]}))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
