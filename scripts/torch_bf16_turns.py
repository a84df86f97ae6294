#!/usr/bin/env python3
"""K1, K2 and K3 of the PyTorch/CUDA port at the bench decoder's size
(16, 128, 128), timed for several checkouts in turns.

    python3 scripts/torch_bf16_turns.py OLD_TREE . . OLD_TREE

Each argument is the root of a checkout of the repo (default: this one).
For each, in the order given, one process imports that tree's
``proudslam_tpu_torch``, builds its kernels and times K1
(``fused_render_forward``), K2 (``decoder_fwd``) and K3 (``decoder_bwd``,
full and dx-only) at the vox path's two shapes: 5 x 1024 rays x 64
samples (a mapping iteration) and 1024 rays (a tracking iteration). K1's
inputs are ``chip_smoke.py``'s (``kernel_inputs``: frame 0 of the scan in
a bench-capacity map, rays intersected and sampled, embeddings and decoder
weights from a seed); K2 and K3 run on K1's features, K3 with cotangents
1e-2 N(0, 1) from the same seed. Each turn also holds each kernel against
its plain version (max abs error, logged). ``ms`` is ``chip_smoke.py``'s
time of one call (CUDA events around back-to-back calls); the helpers are
those of this checkout's ``chip_smoke.py``. Needs one card. Prints one
JSON line per turn and, last, the card's name and power limit.
"""

from __future__ import annotations

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


def turn(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import proudslam_tpu_torch
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_turns: no CUDA device")
    device = torch.device("cuda", 0)
    inp = cs.kernel_inputs(device)
    fp = inp["fp"]
    args = (inp["rb"], inp["keys_rb"], inp["bins"], inp["z"], inp["rays_o"],
            inp["rays_d"], fp, inp["voxel"])
    S = inp["bins"].shape[1]
    res = {"tree": tree,
           "package": os.path.dirname(proudslam_tpu_torch.__file__)}
    for shape, rays in (("mapping", inp["bins"].shape[0]),
                        ("tracking", cs.TRACK_RAYS)):
        a = tuple(t[:rays].contiguous() for t in args[:6]) + args[6:]
        out_k, x = rk.fused_render_forward(*a)
        out_p, _ = rk.fused_render_forward_plain(*a)
        g = 1e-2 * torch.randn((x.shape[0], 4), generator=inp["gen"],
                               device=device)
        dx_k, _ = mk.decoder_bwd(x, g, fp)
        dx_p, _ = mk.decoder_bwd_plain(x, g, fp, want_wgrad=False)
        st = dict(rows=rays * S,
                  k1_max_abs_err=(out_k - out_p).abs().max().item(),
                  k2_bitwise_k1=bool(torch.equal(mk.decoder_fwd(x, fp),
                                                 out_k)),
                  k3_dx_rel_err=((dx_k - dx_p).abs().max()
                                 / dx_p.abs().max()).item())
        st["k1_ms"] = cs._event_ms(lambda: rk.fused_render_forward(*a))
        st["k2_ms"] = cs._event_ms(lambda: mk.decoder_fwd(x, fp))
        st["k3_ms"] = cs._event_ms(lambda: mk.decoder_bwd(x, g, fp))
        st["k3_dx_only_ms"] = cs._event_ms(
            lambda: mk.decoder_bwd(x, g, fp, want_wgrad=False))
        res[shape] = st
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return
    for tree in sys.argv[1:] or ["."]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree], stdout=subprocess.PIPE,
                             text=True, check=True).stdout
        print(out.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
