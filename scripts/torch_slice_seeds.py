#!/usr/bin/env python3
"""``chip_smoke.py``'s size slices over seeds, with K3's kernels or K3's
plain version, on a given checkout: the unaligned ATE of each run.

    python3 scripts/torch_slice_seeds.py TREE kernel|plain SEEDS \
        [--frames=N] [SLICE ...]

TREE is the root of a checkout (its ``proudslam_tpu_torch`` and its
``chip_smoke.py``, whose slices and helpers run, are imported), ``plain``
runs K3 as ``decoder_bwd_plain`` on the card (K1 stays the kernel), SEEDS is a comma-separated list of ``SlamSystem`` seeds (the
decoder's and the map's initial values, the ray draws), and each SLICE
one of vox-w256, vox-d32, vox-w512, vox-d64, vox-d128 (default vox-w512
and vox-w256), run as ``chip_smoke.slice_phase`` runs it over N frames
(default 5, as ``chip_smoke.py`` runs them) with no bound. Prints one
line per run (tree, variant, slice, seed, frames, ATE cm, largest
position error cm) after its position error per frame, and a JSON line
of all. Needs one card.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tree, variant, seeds = sys.argv[1], sys.argv[2], sys.argv[3]
    rest = sys.argv[4:]
    n_frames = 5
    for a in [a for a in rest if a.startswith("--frames=")]:
        n_frames = int(a.split("=", 1)[1])
        rest.remove(a)
    names = rest or ["vox-w512", "vox-w256"]
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not mk.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {mk.__file__}, not {tree}'s")
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    if variant == "plain":
        # every binding K3 is called through: FusedDecoder's and K1's
        # backward (render_kernel binds it at import)
        def plain(x, g, fp, want_wgrad=True, bf16=True):
            plain.launches += 1
            return mk.decoder_bwd_plain(x, g, fp, want_wgrad, bf16)
        plain.launches = 0
        mk.decoder_bwd = rk.decoder_bwd = plain
    elif variant != "kernel":
        raise SystemExit(f"variant {variant!r}: kernel or plain")
    sizes = {"vox-w256": cs.W256_SIZE, "vox-d32": cs.D32_SIZE,
             "vox-w512": cs.W512_SIZE, "vox-d64": cs.D64_SIZE,
             "vox-d128": cs.D128_SIZE}
    # keep the slices' per-frame position errors, drop the rest of the log
    cs.log = lambda msg: ("position error per frame" in msg
                          and print(tree, variant, msg, flush=True))
    device = torch.device("cuda", 0)
    frames = cs.render_frames()
    vox = bench_settings()
    out = {"tree": tree, "variant": variant}
    for name in names:
        for seed in (int(s) for s in seeds.split(",")):
            st = cs.slice_phase(device, name, cs.at_size(vox, sizes[name]),
                                frames, n_frames, None, launched=(),
                                not_launched=(), seed=seed)
            out[f"{name} seed {seed}"] = st["ate_cm"]
            print(tree, variant, name, seed, n_frames,
                  round(st["ate_cm"], 3), round(st["max_pos_err_cm"], 3),
                  flush=True)
        print(json.dumps({"launches": cs._launches()}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
