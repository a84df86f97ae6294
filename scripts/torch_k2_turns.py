#!/usr/bin/env python3
"""K2 of the PyTorch/CUDA port, timed for several checkouts in turns.

    python3 scripts/torch_k2_turns.py OLD_TREE . . OLD_TREE

Each argument is the root of a checkout of the repo (default: this one).
For each, in the order given, one process imports that tree's
``proudslam_tpu_torch``, builds its kernels and times K2
(``decoder_fwd``), its plain version and the decoder as a chain of bf16
``torch.matmul`` calls at the pcd path's two shapes: 327,680 rows (a
mapping iteration, 5 x 1024 rays x 64 samples) and 65,536 rows (a tracking
iteration, 1024 rays), and at one 64-row tile for each warpgroup of a
full grid (2 x the SM count: the blocks' start-up plus one tile). The
inputs come from a seed: x is standard normal
times 0.5 (the scale of trained trilinear features), the decoder weights
are ``init_decoder``'s. K2 does the same work whatever the values, so
times from these inputs stand for the path's. Each turn also holds K2
against its plain version (max abs error, logged). ``ms`` is
``chip_smoke.py``'s time of one call (CUDA events around back-to-back
calls); K2 also gets ``ms_one_call`` (events around a single call, so the
wrapper's host time before the launch counts, as in ``chip_smoke.py``
before it timed back-to-back calls) and ``device_ms`` (the kernel's
duration on the card's timeline, ``torch.profiler``). The bound and the
helpers are those of ``chip_smoke.py``. Needs one card.
Prints one JSON line per turn and, last, the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"mapping": 5 * 1024 * 64, "tracking": 1024 * 64}
SEED = 0


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (a tree given as an
    argument may hold another)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Mean duration on the card of the kernels named ``kernel`` that
    ``calls`` calls of ``fn`` launch (``torch.profiler``), after a warm-up
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(us) != calls:
        raise RuntimeError(f"{len(us)} {kernel} launches traced, expected "
                           f"{calls}")
    return sum(us) / len(us) / 1e3


def turn(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import proudslam_tpu_torch
    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_turns: no CUDA device")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dec = bench_settings().decoder
    fp = mk.pack_params(init_decoder(gen, dec, device), dec)
    fp = type(fp)(*[t.contiguous() for t in fp])
    x = 0.5 * torch.randn((max(SHAPES.values()), dec.in_dim),
                          generator=gen, device=device)
    chain, _ = cs._matmul_chain(fp)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {**SHAPES, "one tile per warpgroup": 2 * sms * mk.TILE_ROWS}
    res = {"tree": tree, "package": os.path.dirname(proudslam_tpu_torch.__file__)}
    for shape, rows in shapes.items():
        xn = x[:rows]
        xb = xn.to(torch.bfloat16)
        _, _, _, sdf, _, rgb = mk.decoder_fwd_plain(xn, fp)
        err = (mk.decoder_fwd(xn, fp) - torch.cat([rgb, sdf], 1)).abs().max()
        st = dict(rows=rows, max_abs_err=err.item())
        st["ms"] = cs._event_ms(lambda: mk.decoder_fwd(xn, fp))
        st["ms_one_call"] = cs._event_ms(lambda: mk.decoder_fwd(xn, fp),
                                         calls=1)
        st["device_ms"] = _device_ms(lambda: mk.decoder_fwd(xn, fp),
                                     "decoder_forward_kernel")
        st["plain_ms"] = cs._event_ms(lambda: mk.decoder_fwd_plain(xn, fp))
        with torch.no_grad():
            st["matmul_chain_ms"] = cs._event_ms(lambda: chain(xb))
        st["bound_ms"], st["bound_by"] = cs._bound(
            cs.DEC_FLOPS * rows, 0, cs._nbytes(xn, *fp) + rows * 4 * 4)
        st["share"] = st["bound_ms"] / st["ms"]
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
