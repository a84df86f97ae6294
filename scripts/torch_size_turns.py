#!/usr/bin/env python3
"""The five decoder kernel forms at every built decoder size, for several
checkouts in turns: outputs bit for bit and times.

    python3 scripts/torch_size_turns.py [--forms=K3,"K3 dx-only"] OLD_TREE . . OLD_TREE

Each argument is the root of a checkout of the repo (default: this one).
For each, in the order given, one process imports that tree's
``proudslam_tpu_torch``, builds its kernels and, at each size of that
tree's ``mlp_kernel.BUILT_SIZES`` ((16, 128, 128) is the resident plan,
the others the streamed, wide or parked one), runs K1
(``fused_render_forward``), K2 (``decoder_fwd``), K3 (``decoder_bwd``,
full and dx-only), K2-f32 and K3-f32 (``bf16=False``, full and dx-only).
K1's inputs are ``chip_smoke.py``'s (``kernel_inputs``: frame 0 of the
scan in a bench-capacity map, rays intersected and sampled, embeddings
from a seed; corners of in_dim values), the bf16 forms run on
K1's features, the f32 forms on the pcd branch's (PointNet, of output
width in_dim) features, each size's decoder is ``init_decoder``'s
from a seed and the cotangents 1e-2 N(0, 1) from a seed: the same inputs
in every turn. Per size and form the turn prints a SHA-256 of every
output at the tracking shape (1024 rays x 64 samples: out, feats, dx and
the 11 gradients) and the time of one call (``chip_smoke.py``'s
``_event_ms``: CUDA events around 10 back-to-back calls, median of 5; at
the wide sizes 5 calls, median of 3, ``REDUCED_REPS``) at the mapping (5 x
1024 rays) and tracking shapes. After the turns, each
turn's digests are compared with the first turn's at the sizes both
built, and the times of each tree are summed over its turns; with two
trees, the second's over the first's per size and form, and per form
summed over the sizes both built. ``--forms`` runs only the forms named
(comma-separated, as printed) and builds only their libraries. Needs one
card. Prints one JSON line per turn, the comparison and, last, the card's
name and power limit.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (a tree given as an
    argument may hold another)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# the forms, by the library each needs
FORM_LIBRARY = {"K1": "render_kernel", "K2": "mlp_kernel", "K3": "mlp_kernel",
                "K3 dx-only": "mlp_kernel", "K2-f32": "mlp_kernel_f32",
                "K3-f32": "mlp_kernel_f32", "K3-f32 dx-only": "mlp_kernel_f32"}


def turn(tree: str, only=None) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import proudslam_tpu_torch
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk
    from proudslam_tpu_torch.render.pcd_features import gather_pcd_features

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_size_turns: no CUDA device")
    if not mk.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {mk.__file__}, not {tree}'s")
    # the tree's libraries, one nvcc each, all started together
    from concurrent.futures import ThreadPoolExecutor

    from proudslam_tpu_torch.ops.kernels import build
    sizes = mk.BUILT_SIZES
    # the tree's own choice of plan (``bf16_source``; one from before in_dim
    # 128: by width)
    wide = getattr(mk, "wide_plan", mk.wide)

    def source(name, size):
        if name != "mlp_kernel_f32" and hasattr(mk, "bf16_source"):
            return mk.bf16_source(name.split("_")[0], size)
        return (cs.WIDE_LIBRARIES if wide(size)
                else cs.STREAM_LIBRARIES)[name]
    libraries = [name for name in cs.LIBRARIES
                 if only is None or name in {FORM_LIBRARY[f] for f in only}]
    jobs = [(name if size == build.DEFAULT_SIZE else source(name, size),
             size)
            for size in sizes for name in libraries]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(build.build, *job) for job in jobs]:
            f.result()
    device = torch.device("cuda", 0)
    inp = cs.kernel_inputs(device, dims=sorted({s[0] for s in sizes}))
    S = inp["bins"].shape[1]
    xp_by_dim = {}
    for d, pcd_args in inp["pcd_args_by_dim"].items():
        with torch.no_grad():
            xp = gather_pcd_features(*pcd_args)
        xp_by_dim[d] = xp.reshape(-1, xp.shape[-1]).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    g = 1e-2 * torch.randn((xp_by_dim[16].shape[0], 4), generator=gen,
                           device=device)
    res = {"tree": tree,
           "package": os.path.dirname(proudslam_tpu_torch.__file__),
           "sizes": {}}
    for size in sizes:
        fp = cs._decoder_at(device, size, 4)
        args = (inp["rb_by_dim"][size[0]], inp["keys_rb"], inp["bins"],
                inp["z"], inp["rays_o"], inp["rays_d"])
        xp = xp_by_dim[size[0]]
        st = res["sizes"]["x".join(map(str, size))] = {"digest": {}}
        reps = cs.REDUCED_REPS if size[1] > 256 else {}
        for shape, rays in (("mapping", inp["bins"].shape[0]),
                            ("tracking", cs.TRACK_RAYS)):
            rows = rays * S
            a = tuple(t[:rays].contiguous() for t in args) + (fp,
                                                              inp["voxel"])
            _, x = rk.fused_render_forward(*a)
            gn, xf = g[:rows].contiguous(), xp[:rows].contiguous()
            forms = {
                "K1": lambda: rk.fused_render_forward(*a),
                "K2": lambda: mk.decoder_fwd(x, fp),
                "K3": lambda: mk.decoder_bwd(x, gn, fp),
                "K3 dx-only": lambda: mk.decoder_bwd(x, gn, fp,
                                                     want_wgrad=False),
                "K2-f32": lambda: mk.decoder_fwd(xf, fp, bf16=False),
                "K3-f32": lambda: mk.decoder_bwd(xf, gn, fp, bf16=False),
                "K3-f32 dx-only": lambda: mk.decoder_bwd(
                    xf, gn, fp, want_wgrad=False, bf16=False),
            }
            for form, fn in forms.items():
                if only is not None and form not in only:
                    continue
                if shape == "tracking":
                    out = fn()
                    flat = [out[0], *(out[1] or ())] if form.startswith(
                        "K3") else list(out) if form == "K1" else [out]
                    st["digest"][form] = _digest(flat)
                st[f"{form} {shape} ms"] = cs._event_ms(fn, **reps)
    return res


def main() -> None:
    args = sys.argv[1:]
    forms = [a for a in args if a.startswith("--forms=")]
    only = forms[0].split("=", 1)[1].split(",") if forms else None
    args = [a for a in args if not a.startswith("--forms=")]
    if len(args) > 1 and args[0] == "--turn":
        print(json.dumps(turn(args[1], only)), flush=True)
        return
    turns = []
    for tree in args or ["."]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree, *forms],
                             stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    first = turns[0]["sizes"]
    differ = [(t["tree"], tag, form) for t in turns
              for tag, st in t["sizes"].items() if tag in first
              for form, dg in st["digest"].items()
              if dg != first[tag]["digest"][form]]
    totals = {}
    for t in turns:
        for tag, st in t["sizes"].items():
            for key, v in st.items():
                if key.endswith(" ms"):
                    tot = totals.setdefault(t["tree"], {}).setdefault(
                        tag, {})
                    tot[key] = tot.get(key, 0.0) + v
    ratio, summed = {}, {}
    trees = list(totals)
    if len(trees) == 2:
        a, b = trees
        both = [tag for tag in totals[a] if tag in totals[b]]
        ratio = {tag: {key: totals[b][tag][key] / totals[a][tag][key]
                       for key in totals[a][tag]} for tag in both}
        keys = totals[a][both[0]]
        summed = {key: sum(totals[b][tag][key] for tag in both)
                  / sum(totals[a][tag][key] for tag in both)
                  for key in keys}
    print(json.dumps({"bit_for_bit": not differ, "differ": differ,
                      "time_ratio_second_tree_over_first": ratio,
                      "summed_over_sizes": summed}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
