#!/usr/bin/env python3
"""K3 (the bf16 decoder backward) against the bf16 ``torch.matmul`` chain at
every built decoder size, on the card, in one process.

    python3 scripts/torch_k3_chain.py [--cap=BYTES] [D,W,SD ...]

At each size of ``mlp_kernel.BUILT_SIZES`` (or the sizes given) and at
``chip_smoke.py``'s mapping (5 x 1024 rays x 64 samples) and tracking
(1024 rays) shapes, on that script's inputs (``kernel_inputs``: frame 0
of the scan, the trilinear features of corner embeddings of in_dim values
from a seed, here through K1's plain version; the size's ``init_decoder``
params from a seed; cotangents 1e-2 N(0, 1) from a seed) it times K3
full and dx-only (``decoder_bwd``), its two passes apart
(``chip_smoke._k3_pass_ms``: pass 1 with the reduce, pass 2 over the
call's chunks) and the decoder as a chain of bf16 ``torch.matmul`` calls,
forward and backward (``chip_smoke._matmul_chain``), each with
``chip_smoke._event_ms`` (5 x 10 calls; 3 x 5 above width 256; 3 x 2 at
the mapping shape above 512). Prints one JSON line per size with K3's
ratio to the chain and its bound share, then the (size, shape) pairs
where K3 takes longer than the chain, largest ratio first, and the card's
name and power limit. ``--cap``: K3 cuts its rows into chunks of at most
that many bytes of stored operands (``mlp_kernel.wgrad_plan``'s ``cap``)
instead of ``WGRAD_SCRATCH_CAP``. Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_chain: no CUDA device")
    args = sys.argv[1:]
    caps = [int(a.split("=", 1)[1]) for a in args if a.startswith("--cap=")]
    if caps:
        planner = mk.wgrad_plan
        mk.wgrad_plan = (lambda size, n_rows, sms, cap=caps[0]:
                         planner(size, n_rows, sms, cap))
    sizes = [tuple(int(v) for v in a.split(",")) for a in args
             if not a.startswith("--")]
    sizes = sizes or list(mk.BUILT_SIZES)
    device = torch.device("cuda", 0)
    inp = cs.kernel_inputs(device, dims=sorted({s[0] for s in sizes}))
    S = inp["bins"].shape[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    rows_map = inp["bins"].shape[0] * S
    g = 1e-2 * torch.randn((rows_map, 4), generator=gen, device=device)
    slower = []
    for size in sizes:
        fp = cs._decoder_at(device, size, 4)
        k1_args = (inp["rb_by_dim"][size[0]], inp["keys_rb"], inp["bins"],
                   inp["z"], inp["rays_o"], inp["rays_d"], fp, inp["voxel"])
        with torch.no_grad():
            x = rk.fused_render_forward_plain(*k1_args)[1].contiguous()
        chain, leaves = cs._matmul_chain(fp)
        flops = cs.dec_flops(size)
        plan = mk.wgrad_plan(size, rows_map, cs._sms(device))
        st = {"size": size,
              "chunks": len(mk.wgrad_chunks(plan, size, rows_map))}
        for shape, rows in (("mapping", rows_map),
                            ("tracking", cs.TRACK_RAYS * S)):
            reps = ({} if size[1] <= 256 else cs.PARK_REPS
                    if size[1] > 512 and shape == "mapping"
                    else cs.REDUCED_REPS)
            xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
            xg = xn.to(torch.bfloat16).requires_grad_(True)
            gb = gn.to(torch.bfloat16)

            def chain_fwd_bwd():
                for t in leaves + [xg]:
                    t.grad = None
                chain(xg).backward(gb)
            e = {"rows": rows}
            e["k3_ms"] = cs._event_ms(lambda: mk.decoder_bwd(xn, gn, fp),
                                      **reps)
            e["dx_only_ms"] = cs._event_ms(
                lambda: mk.decoder_bwd(xn, gn, fp, want_wgrad=False), **reps)
            e["pass1_ms"], e["pass2_ms"] = cs._k3_pass_ms(xn, gn, fp, reps)
            e["chain_ms"] = cs._event_ms(chain_fwd_bwd, **reps)
            e["ratio"] = e["k3_ms"] / e["chain_ms"]
            e["share"] = (3 * flops * rows / cs.PEAK_BF16 * 1e3) / e["k3_ms"]
            st[shape] = e
            if e["ratio"] > 1:
                slower.append((e["ratio"], size, shape, e["pass1_ms"],
                               e["pass2_ms"]))
        print(json.dumps(st), flush=True)
    slower.sort(reverse=True)
    print(json.dumps({"k3_slower_than_chain": [
        {"size": s, "shape": sh, "ratio": r, "pass1_ms": p1, "pass2_ms": p2}
        for r, s, sh, p1, p2 in slower]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
