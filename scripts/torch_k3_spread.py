#!/usr/bin/env python3
"""K3's gradients at a wide decoder against two plain versions: the spread
that bf16 rounding and ReLU-mask flips leave between correct
implementations.

    python3 scripts/torch_k3_spread.py

At (16, 512, 512) and, for comparison, (16, 256, 128), on
``chip_smoke.size_phase``'s data (the kernel phase's K1 inputs, the plain
K1's features at the mapping shape, that size's ``init_decoder`` params
and 1e-2 N(0, 1) cotangents from the same seeds), over the first 65,536
rows (the tracking shape) and all 327,680: K3 (``decoder_bwd``) against its
plain version on the card, and the plain version on the CPU against the
same plain version on the card; each output's largest absolute difference
over its largest magnitude. Needs one card; prints one JSON line per size
and row count, then the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((16, 512, 512), (16, 256, 128))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
    from proudslam_tpu_torch.ops.kernels import render_kernel as rk

    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_spread: no CUDA device")
    dev = torch.device("cuda", 0)
    inp = cs.kernel_inputs(dev, dims=(16,))

    def rel(a, b):
        a, b = a.cpu(), b.cpu()
        return float(f"{((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item():.3e}")

    for size in SIZES:
        d, w, sd = size
        dec = dataclasses.replace(bench_settings().decoder, in_dim=d,
                                  width=w, sdf_dim=sd)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)                     # size_phase's seed
        fp = mk.pack_params(init_decoder(gen, dec, dev), dec)
        fp = type(fp)(*[t.contiguous() for t in fp])
        base = (inp["rb_by_dim"][d], inp["keys_rb"], inp["bins"], inp["z"],
                inp["rays_o"], inp["rays_d"])
        x = rk.fused_render_forward_plain(*base, fp, inp["voxel"])[1]
        g = 1e-2 * torch.randn((x.shape[0], 4), generator=gen, device=dev)
        fp_cpu = type(fp)(*[t.cpu() for t in fp])
        for rows in (cs.TRACK_RAYS * inp["bins"].shape[1], x.shape[0]):
            xn, gn = x[:rows].contiguous(), g[:rows].contiguous()
            dx_k, gr_k = mk.decoder_bwd(xn, gn, fp)
            dx_p, gr_p = mk.decoder_bwd_plain(xn, gn, fp)
            dx_c, gr_c = mk.decoder_bwd_plain(xn.cpu(), gn.cpu(), fp_cpu)
            names = ("dx",) + mk.FusedParams._fields
            print(json.dumps({
                "size": size, "rows": rows,
                "kernel_vs_plain": {n: rel(a, b) for n, a, b in zip(
                    names, (dx_k, *gr_k), (dx_p, *gr_p))},
                "plain_cpu_vs_plain_card": {n: rel(a, b) for n, a, b in zip(
                    names, (dx_c, *gr_c), (dx_p, *gr_p))}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
