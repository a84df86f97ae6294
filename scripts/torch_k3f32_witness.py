#!/usr/bin/env python3
"""K3-f32 at every built decoder size through ``chip_smoke._k3_check``, on
one card, to count the rows whose dx misses its plain version and what the
float64 witness finds on them.

    python3 scripts/torch_k3f32_witness.py

Builds the libraries (``chip_smoke.build_phase``), then at each of
``mlp_kernel.BUILT_SIZES`` runs ``_k3_check`` (full and dx-only) on
327,680 rows of 0.3 N(0, 1) inputs with 1e-2 N(0, 1) cotangents and that
size's ``init_decoder`` params: the kernel's dx on the rows of margin >=
1e-6, every row whose dx misses witnessed in float64
(``_f64_mask_witness``: the ambiguous units, whether the kernel and cuBLAS
took the true masks), the gradients over all rows against 1e-4 plus those
rows' terms. Logs each check to standard error; prints one JSON line of
each size's result and the witnessed rows' totals, then the card's name
and power limit. Takes ~1.5 min of command.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    smi = cs.device_phase()
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    t0 = time.perf_counter()
    build_s, _, _ = cs.build_phase()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n = 327680
    x = 0.3 * torch.randn((n, 16), generator=gen, device=dev)
    g = 1e-2 * torch.randn((n, 4), generator=gen, device=dev)
    records = {}
    witness = cs._f64_mask_witness

    def kept(what, *a):
        moved, rec = witness(what, *a)
        records.setdefault(what, {r["row"]: r for r in rec})
        return moved, rec

    cs._f64_mask_witness = kept
    res = {}
    for size in mk.BUILT_SIZES:
        fp = cs._decoder_at(dev, size, 4)
        for wgrad in (True, False):
            what = f"K3-f32 at {size}"
            try:
                err, _ = cs._k3_check(what, x, g, fp, wgrad, False)
                res[f"{size} {'full' if wgrad else 'dx-only'}"] = err
            except AssertionError as e:
                res[f"{size} {'full' if wgrad else 'dx-only'}"] = str(e)
    rows = [r for rec in records.values() for r in rec.values()]
    print(json.dumps({
        "max_abs_err": res, "build_s": build_s,
        "witnessed_rows": len(rows),
        "kernel_true_masks": sum(r["kernel_true_masks"] for r in rows),
        "plain_true_masks": sum(r["plain_true_masks"] for r in rows),
        "largest_ambiguous_pre": max((abs(u[2]) for r in rows
                                      for u in r["ambiguous"][:1]),
                                     default=0.0),
        "largest_kernel_err": max((r["kernel_err"] for r in rows),
                                  default=0.0),
        "seconds": time.perf_counter() - t0}))
    print(smi)
    if any(isinstance(v, str) for v in res.values()):
        raise SystemExit("a K3-f32 check failed")


if __name__ == "__main__":
    main()
