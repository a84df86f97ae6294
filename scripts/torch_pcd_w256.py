#!/usr/bin/env python3
"""The pcd slice of ``chip_smoke.py`` at the reference's wider decoder
(16, 256, 128) with its decoder computed several ways, to tell the
kernels from the branch's drift.

    python3 scripts/torch_pcd_w256.py              # on one card
    python3 scripts/torch_pcd_w256.py seeds [N [FIRST [VARIANTS]]]  # one card
    python3 scripts/torch_pcd_w256.py init [N]     # one card, N seeds
    python3 scripts/torch_pcd_w256.py cpu [SEED]   # the port on the CPU

On the card: ``chip_smoke.slice_phase`` over the first 5 frames (no ATE
bound, no launch check) with K2-f32 / K3-f32, twice; with their plain
versions (``decoder_fwd_plain`` / ``decoder_bwd_plain`` on CUDA tensors
in place of the wrappers); the unfused branch; the bf16 kernels K2 / K3;
and at (16, 128, 128) with the plain versions and with the kernels.
Prints one JSON line of each run's ATE (unaligned and aligned), frames/s,
per-phase ms and launches.

``seeds``: the slice at the engine's seeds FIRST .. FIRST+N-1 (default
0 .. 7) with K2-f32 / K3-f32, with their plain versions and unfused at
(16, 256, 128), and with the kernels and their plain versions at (16,
128, 128); VARIANTS, a comma-separated list of ``SEED_VARIANTS``' names
(e.g. "kernels f32 w256,plain f32 w256"), picks others, among them two
broken plain backwards at (16, 256, 128): dx moved by one row
(``shift``) and the last row of every 32-row tile dropped (``drop``).
Prints one JSON line of each variant's ATE per seed, its median and
spread, each seed's largest position difference between the kernels'
and the plain versions' trajectories and the ATE of a camera that never
moves from the first pose; writes the same with each run's per-frame
position error to ``chiprun_out/pcd_seeds_<FIRST>_<N>.json``.

``init``: ``initialize`` alone (200 mapping iterations on frame 0 at its
true pose, before any tracking) at seeds 0 .. N-1 (default 4) at (16,
256, 128) with f32 operands, with the kernels, their plain versions and
the two broken backwards; prints each run's loss per mapping round and,
per seed, each one's mean loss over the last rounds (``init_loss_tail``)
against the plain versions'.

``cpu``: the slice with f32 operands at (16, 256, 128) on the CPU (the
plain versions) at the engine's seed SEED (default 0), printing its
per-frame position error and ATE (~20 min on 8 cores). The JAX engine's
run of the same configuration is ``tests/test_torch_pcd_slam.py bench f32 256``.
"""

import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from proudslam_tpu_torch.config import bench_settings  # noqa: E402
from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk  # noqa: E402


def settings(**decoder):
    vox = bench_settings()
    pcd = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, feature_mode="pcd"),
        map=dataclasses.replace(vox.map, points_per_voxel=8))
    return dataclasses.replace(pcd, decoder=dataclasses.replace(
        pcd.decoder, **decoder))


# the mapping rounds of initialize whose mean loss init_loss_tail takes
INIT_TAIL = 5


@contextlib.contextmanager
def plain_decoder(bwd=None):
    """Within it the fused decoder runs the plain versions of K2 / K3 and
    their f32 forms (``decoder_fwd_plain``, and ``decoder_bwd_plain`` or
    ``bwd``) on CUDA tensors in place of the kernels' wrappers."""
    def fwd(x, fp, bf16=True):
        _, _, _, sdf, _, rgb = mk.decoder_fwd_plain(x, fp, bf16)
        return torch.cat([rgb, sdf], 1)

    kernels = (mk.decoder_fwd, mk.decoder_bwd)
    mk.decoder_fwd, mk.decoder_bwd = fwd, bwd or mk.decoder_bwd_plain
    try:
        yield
    finally:
        mk.decoder_fwd, mk.decoder_bwd = kernels


def bwd_shift(x, g, fp, want_wgrad=True, bf16=True):
    """A broken backward: dx moved by one row."""
    dx, grads = mk.decoder_bwd_plain(x, g, fp, want_wgrad, bf16)
    return torch.roll(dx, 1, 0), grads


def bwd_drop(x, g, fp, want_wgrad=True, bf16=True):
    """A broken backward: the last row of every 32-row tile dropped."""
    g = g.clone()
    g[31::32] = 0
    return mk.decoder_bwd_plain(x, g, fp, want_wgrad, bf16)


def keep_map_losses(slam) -> list:
    """Wraps ``slam._map`` so that each mapping round's loss (its last
    iteration's) is kept -> the list they go into."""
    losses = []
    step = slam._map

    def kept(*a, **k):
        res = step(*a, **k)
        losses.append(res.loss.detach())
        return res
    slam._map = kept
    return losses


def init_loss_tail(losses) -> float:
    """The mean loss of the last INIT_TAIL mapping rounds."""
    return float(sum(losses[-INIT_TAIL:]) / len(losses[-INIT_TAIL:]))


def init_losses(device, s, frames, seed, decoder) -> list:
    """``initialize`` alone with the decoder ``decoder`` (``None``: the
    kernels; "plain", or a broken backward) -> each round's loss."""
    slam = cs._new_slam(device, s, frames, seed=seed)
    losses = keep_map_losses(slam)
    with (contextlib.nullcontext() if decoder is None else
          plain_decoder(None if decoder == "plain" else decoder)):
        cs._initialize(slam, frames)
    return [float(v) for v in losses]


def card() -> None:
    cs.log(cs.device_phase())
    cs.N_FRAMES = cs.PCD_FRAMES
    frames = cs.render_frames()
    dev = torch.device("cuda", 0)
    w256 = dict(width=256, sdf_dim=128)
    res = {}
    for name, s, plain in (
            ("kernels f32 w256", settings(matmul_dtype="f32", **w256), False),
            ("kernels f32 w256 again", settings(matmul_dtype="f32", **w256),
             False),
            ("plain f32 w256", settings(matmul_dtype="f32", **w256), True),
            ("unfused f32 w256", settings(matmul_dtype="f32",
                                          use_fused_mlp=False, **w256),
             False),
            ("kernels bf16 w256", settings(matmul_dtype="bf16", **w256),
             False),
            ("plain f32 w128", settings(matmul_dtype="f32"), True),
            ("kernels f32 w128", settings(matmul_dtype="f32"), False)):
        with plain_decoder() if plain else contextlib.nullcontext():
            st = cs.slice_phase(dev, name, s, frames, cs.PCD_FRAMES, None,
                                launched=(), not_launched=())
        res[name] = {k: st[k] for k in ("ate_cm", "ate_aligned_cm", "fps",
                                        "track_ms", "map_ms", "launches")}
    print(json.dumps(res))
    print(cs.device_phase())


W256 = dict(matmul_dtype="f32", width=256, sdf_dim=128)
# name, decoder settings, decoder (None: the kernels; "plain": their plain
# versions; else a broken plain backward)
SEED_VARIANTS = (
    ("kernels f32 w256", W256, None),
    ("plain f32 w256", W256, "plain"),
    ("unfused f32 w256", dict(W256, use_fused_mlp=False), None),
    ("kernels f32 w128", dict(matmul_dtype="f32"), None),
    ("plain f32 w128", dict(matmul_dtype="f32"), "plain"),
    ("shift f32 w256", W256, bwd_shift),
    ("drop f32 w256", W256, bwd_drop),
)
# the variants of ``seeds`` when none is named
SEED_DEFAULT = SEED_VARIANTS[:5]


def seeds(n: int, first: int = 0, names=None, device=None) -> None:
    from proudslam_tpu_torch.utils.metrics import ate_rmse

    cs.log(cs.device_phase())
    cs.N_FRAMES = cs.PCD_FRAMES
    frames = cs.render_frames()
    gt = np.stack(frames[1][:cs.PCD_FRAMES])
    dev = torch.device("cuda", 0) if device is None else device
    kernels = (mk.decoder_fwd, mk.decoder_bwd)
    variants = [v for v in SEED_VARIANTS if v[0] in names] if names else \
        list(SEED_DEFAULT)
    if names is not None and len(variants) != len(names):
        raise SystemExit(f"unknown variant in {names}")
    runs = {name: [] for name, _, _ in variants}
    trajs = {}

    def keep(name, seed):
        def after(slam):
            trajs[name, seed] = slam.get_trajectory()
            return {}
        return after

    t0 = time.perf_counter()
    for seed in range(first, first + n):
        for name, dec, decoder in variants:
            with (contextlib.nullcontext() if decoder is None else
                  plain_decoder(None if decoder == "plain" else decoder)):
                st = cs.slice_phase(dev, f"{name} seed {seed}",
                                    settings(**dec), frames, cs.PCD_FRAMES,
                                    None, launched=(), not_launched=(),
                                    after=keep(name, seed), seed=seed)
            err = np.linalg.norm(trajs[name, seed][:, :3, 3]
                                 - gt[:, :3, 3], axis=1) * 100
            runs[name].append({
                "seed": seed, "ate_cm": st["ate_cm"],
                "ate_aligned_cm": st["ate_aligned_cm"],
                "pos_err_cm": [float(e) for e in err],
                "launches": {k: v for k, v in st["launches"].items() if v}})
    summary = {}
    for name, rs in runs.items():
        a = np.array([r["ate_cm"] for r in rs])
        summary[name] = {"ate_cm": a.tolist(), "median": float(np.median(a)),
                         "min": float(a.min()), "max": float(a.max()),
                         "mean": float(a.mean()), "std": float(a.std(ddof=1))
                         if a.size > 1 else 0.0,
                         "over_60": int((a >= 60.0).sum())}
    for w in ("w256", "w128"):
        if f"kernels f32 {w}" not in runs or f"plain f32 {w}" not in runs:
            continue
        summary[f"kernels against plain {w}: largest position difference "
                "per seed (cm)"] = [float(np.abs(np.linalg.norm(
                    trajs[f"kernels f32 {w}", s][:, :3, 3]
                    - trajs[f"plain f32 {w}", s][:, :3, 3], axis=1)).max()
                    * 100) for s in range(first, first + n)]
    summary["static camera ATE (cm)"] = ate_rmse(
        np.repeat(gt[:1], len(gt), 0), gt, align=False) * 100
    out = {"seeds": list(range(first, first + n)), "frames": cs.PCD_FRAMES,
           "summary": summary,
           "runs": runs, "seconds": time.perf_counter() - t0,
           "device": cs.device_phase()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"pcd_seeds_{first}_{n}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"summary": summary, "seconds": out["seconds"]}))
    print(out["device"])


def init(n: int, device=None) -> None:
    cs.log(cs.device_phase())
    cs.N_FRAMES = 1
    frames = cs.render_frames()
    dev = torch.device("cuda", 0) if device is None else device
    s = settings(matmul_dtype="f32", width=256, sdf_dim=128)
    out = {}
    for seed in range(n):
        cs._reset_launches()
        runs = {"kernels": init_losses(dev, s, frames, seed, None),
                "launches": {k: v for k, v in cs._launches().items() if v}}
        runs["plain"] = init_losses(dev, s, frames, seed, "plain")
        runs["shift"] = init_losses(dev, s, frames, seed, bwd_shift)
        runs["drop"] = init_losses(dev, s, frames, seed, bwd_drop)
        tail = {k: init_loss_tail(v) for k, v in runs.items()
                if k != "launches"}
        runs["tail"] = tail
        runs["tail_rel_to_plain"] = {k: v / tail["plain"] - 1.0
                                     for k, v in tail.items()}
        cs.log(f"init seed {seed}: " + json.dumps(runs))
        out[seed] = runs
    plain = np.array([out[k]["tail"]["plain"] for k in out])
    print(json.dumps({
        "tail_rel_to_plain": {k: out[k]["tail_rel_to_plain"] for k in out},
        "plain_tail_across_seeds": {"values": plain.tolist(),
                                    "rel_std": float(plain.std(ddof=1)
                                                     / plain.mean())
                                    if plain.size > 1 else 0.0}}))
    print(cs.device_phase())


def cpu(seed: int = 0) -> None:
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.utils.metrics import ate_rmse

    cs.N_FRAMES = cs.PCD_FRAMES
    quant, poses, K, dq = cs.render_frames()
    slam = SlamSystem(settings(matmul_dtype="f32", width=256, sdf_dim=128),
                      K, (cs.HEIGHT, cs.WIDTH), seed=seed, point_stride=2,
                      device="cpu")
    t0 = time.time()
    slam.initialize(quant[0][0].astype(np.float32) / 255.0,
                    quant[0][1].astype(np.float32) / dq, poses[0], stamp=0)
    for i in range(1, cs.N_FRAMES):
        slam.process_frame(i, *quant[i])
    slam.global_refine(rounds=2)
    est, gt = slam.get_trajectory(), np.stack(poses[:cs.N_FRAMES])
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 100
    print(f"port cpu pcd f32 width 256, seed {seed}: position error per "
          "frame (cm):",
          " ".join(f"{e:.2f}" for e in err))
    print(f"port cpu pcd f32 width 256, seed {seed}: unaligned ATE "
          f"{ate_rmse(est, gt, align=False) * 100:.2f} cm, aligned "
          f"{ate_rmse(est, gt, align=True) * 100:.2f}; "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "card"
    if mode == "cpu":
        cpu(int(sys.argv[2]) if len(sys.argv) > 2 else 0)
    elif mode == "init":
        init(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
    elif mode == "seeds":
        seeds(int(sys.argv[2]) if len(sys.argv) > 2 else 8,
              int(sys.argv[3]) if len(sys.argv) > 3 else 0,
              sys.argv[4].split(",") if len(sys.argv) > 4 else None)
    else:
        card()
