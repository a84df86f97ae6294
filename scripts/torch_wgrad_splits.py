#!/usr/bin/env python3
"""The second passes' row splits under two rules, timed on the card.

    python3 scripts/torch_wgrad_splits.py [--sizes=16x128x128,...]

For K3's second pass (``decoder_wgrad``, bf16 operands) and K3-f32's
(``decoder_wgrad_f32``, f32 operands), at each size and at the mapping
shape (327,680 rows, in the chunks of ``mlp_kernel.wgrad_plan``), the
pass is timed with the splits of two rules for the SMs one row split
keeps busy (``mlp_kernel.wgrad_splits``): "tiles", its output tiles
counted, and "area", its output tiles weighted by their area in full
tiles (an x-side tile of 128 x 16 an eighth of a 128 x 128 one). Both run
on the same operands: the plain version of pass 1's
(``decoder_bwd_operands_plain``, packed as pass 1 stores them) for
``chip_smoke.py``'s decoder at that size (``_decoder_at``), rows x =
0.07 N(0, 1) and cotangents 1e-2 N(0, 1) from a seed. Each time is
``chip_smoke._event_ms``'s (10 back-to-back calls of the whole pass over
the chunks, median of 5), taken in the order tiles, area, area, tiles and
summed per rule. Needs one card. Prints one JSON line per size and form,
then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ROWS = 5 * 1024 * 64
SIZES = ((16, 128, 128), (16, 256, 128), (64, 256, 256), (16, 512, 512),
         (128, 768, 768), (16, 1024, 1024))
SEED = 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fill(size, bf16: bool, rule: str) -> float:
    """The SMs one split keeps busy under ``rule``."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if rule == "tiles":
        return mk.wgrad_tiles(size, bf16)
    tm, tn = mk.WGRAD_TILE if bf16 else mk.WGRAD_F32_TILE
    return sum(m * n for *_, m, n in mk.wgrad_jobs(size)) / (tm * tn)


def splits(size, rows: int, sms: int, bf16: bool, rule: str):
    """``mlp_kernel.wgrad_splits`` with the fill of ``rule``."""
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    ntiles = -(-rows // mk.TILE_ROWS)
    per = max(1, ntiles // math.ceil(sms / fill(size, bf16, rule)))
    return -(-ntiles // per), per


def main() -> None:
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not torch.cuda.is_available():
        raise SystemExit("torch_wgrad_splits: no CUDA device")
    sizes = SIZES
    for a in sys.argv[1:]:
        if a.startswith("--sizes="):
            sizes = [tuple(int(v) for v in s.split("x"))
                     for s in a.split("=", 1)[1].split(",")]
    cs = _chip_smoke()
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for size in sizes:
        fp = cs._decoder_at(device, size, 4)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        x = 0.07 * torch.randn((ROWS, size[0]), generator=gen, device=device)
        g = 1e-2 * torch.randn((ROWS, 4), generator=gen, device=device)
        for bf16 in (True, False):
            plan = mk.wgrad_plan(size, ROWS, sms, bf16=bf16)
            tile_rows = mk.wgrad_tile_rows(size, bf16)
            chunks = [(mk.pack_operands(mk.decoder_bwd_operands_plain(
                x[r0:r0 + rows], g[r0:r0 + rows], fp, bf16), tile_rows,
                bf16), rows)
                for r0, rows, _, _ in mk.wgrad_chunks(plan, size, ROWS,
                                                      bf16)]
            pass2 = mk.decoder_wgrad if bf16 else mk.decoder_wgrad_f32
            res = {"size": list(size), "form": "K3" if bf16 else "K3-f32",
                   "rows": ROWS, "chunks": len(chunks)}
            ms = {}
            for rule in ("tiles", "area", "area", "tiles"):
                cut = [splits(size, rows, sms, bf16, rule)
                       for _, rows in chunks]
                part = torch.empty((max(s for s, _ in cut)
                                    * mk.wgrad_part_floats(size),),
                                   device=device)

                def run():
                    for (scratch, rows), (s, per) in zip(chunks, cut):
                        pass2(scratch, size, rows, s, per, part)
                ms[rule] = ms.get(rule, 0.0) + cs._event_ms(run)
                res[f"{rule} splits x per split"] = [list(c) for c in cut]
            res.update({f"{rule} ms": v / 2 for rule, v in ms.items()})
            res["area / tiles"] = ms["area"] / ms["tiles"]
            print(json.dumps(res), flush=True)
            del chunks
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
