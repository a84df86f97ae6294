#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s slices for several checkouts in turns: the
time a frame takes and the trajectory's error.

    python3 scripts/torch_slice_turns.py [--slice=pcd-f32-w512] [--frames=N] OLD_TREE . . OLD_TREE

Each argument is the root of a checkout of the repo (default: this one).
For each, in the order given, one process imports that tree's
``proudslam_tpu_torch`` and this checkout's ``chip_smoke.py`` (loaded by
path: its scene, frames and ``slice_phase``), renders the scan's first N
frames (default ``chip_smoke.PCD_FRAMES``, 5) and runs the slice as
``chip_smoke.py`` runs it (``initialize``, ``process_frame`` over frames
1..N-1, ``global_refine(rounds=2)``, seed 0), with no ATE bound. The
slices: pcd-f32-w512 (the pcd branch with f32 operands at (16, 512, 256):
K2-f32 and K3-f32 at the wide plan), pcd-f32-w256 and pcd-f32 (the same
at (16, 256, 128) and (16, 128, 128)). Each turn prints one JSON line: the
slice's frames/s, mean tracking and mapping ms a frame (the engine's
CUDA-event clock), unaligned ATE and the kernels' launches. After the
turns, each tree's values are averaged over its turns and, with two
trees, the second's over the first's. Needs one card. Prints the card's
name and power limit last.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("fps", "track_ms", "map_ms", "ate_cm")


def turn(tree: str, name: str, n_frames: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not mk.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {mk.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise SystemExit("torch_slice_turns: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.log = lambda msg: None
    cs.N_FRAMES = n_frames
    vox = bench_settings()
    pcd = dataclasses.replace(
        vox, render=dataclasses.replace(vox.render, feature_mode="pcd"),
        map=dataclasses.replace(vox.map, points_per_voxel=8))
    pcd_f32 = dataclasses.replace(pcd, decoder=dataclasses.replace(
        pcd.decoder, matmul_dtype="f32"))
    settings = {"pcd-f32": pcd_f32,
                "pcd-f32-w256": cs.at_size(pcd_f32, cs.W256_SIZE),
                "pcd-f32-w512": cs.at_size(pcd_f32, cs.PCD_W512_SIZE)}[name]
    st = cs.slice_phase(torch.device("cuda", 0), name, settings,
                        cs.render_frames(), n_frames, None,
                        launched=("decoder_forward_f32", "decoder_backward_f32"),
                        not_launched=())
    return {"tree": tree, "slice": name, "frames": n_frames,
            **{k: st[k] for k in KEYS},
            "launches": {k: v for k, v in st["launches"].items() if v}}


def main() -> None:
    args = sys.argv[1:]
    name, n_frames = "pcd-f32-w512", None
    for a in list(args):
        if a.startswith("--slice="):
            name = a.split("=", 1)[1]
            args.remove(a)
        elif a.startswith("--frames="):
            n_frames = int(a.split("=", 1)[1])
            args.remove(a)
    if len(args) > 1 and args[0] == "--turn":
        print(json.dumps(turn(args[1], name, n_frames)), flush=True)
        return
    if n_frames is None:
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        n_frames = cs.PCD_FRAMES
    turns = []
    for tree in args or ["."]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree, f"--slice={name}",
                              f"--frames={n_frames}"],
                             stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    mean = {}
    for tree in dict.fromkeys(t["tree"] for t in turns):
        mine = [t for t in turns if t["tree"] == tree]
        mean[tree] = {k: sum(t[k] for t in mine) / len(mine) for k in KEYS}
    ratio = {}
    if len(mean) == 2:
        a, b = mean
        ratio = {k: mean[b][k] / mean[a][k] for k in KEYS}
    print(json.dumps({"mean_over_turns": mean,
                      "second_tree_over_first": ratio}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
