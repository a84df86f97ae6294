#!/usr/bin/env python3
"""K2-f32 and K3-f32 of the PyTorch/CUDA port, timed for several checkouts
in turns.

    python3 scripts/torch_f32_turns.py OLD_TREE . . OLD_TREE
    python3 scripts/torch_f32_turns.py . .@--register-usage-level=10 .

Each argument is the root of a checkout of the repo (default: this one),
optionally followed by ``@`` and ptxas options (comma-separated): that
turn builds the tree's ``mlp_kernel_f32.cu`` with them added (``-Xptxas``,
into ``_build/variant/``) and runs it in place of the package's build.
For each, in the order given, one process imports that tree's
``proudslam_tpu_torch``, builds its f32 kernel library and times K2-f32
(``decoder_fwd`` with ``bf16=False``) and K3-f32 (``decoder_bwd`` with
``bf16=False``, full and dx-only) at the pcd path's two shapes: 327,680
rows (a mapping iteration, 5 x 1024 rays x 64 samples) and 65,536 rows (a
tracking iteration, 1024 rays). The inputs come from a seed: x is standard
normal times 0.07 (the scale of the pcd branch's features), the cotangent
1e-2 times standard normal, the decoder weights ``init_decoder``'s. The
kernels do the same work whatever the values, so times from these inputs
stand for the path's. Each turn also holds every form against its plain
version (max abs error over each output's largest magnitude, logged), and
reads the tree's build: registers and spills (``-Xptxas -v``) and HMMA,
HGMMA and FFMA counts (``cuobjdump -sass``) of each instance of both
kernel functions (K3-f32's full and dx-only ones where a tree has two).
``ms`` is ``chip_smoke.py``'s time of one call (CUDA events around 10
back-to-back calls, median of 5); ``device_ms`` is the kernel's mean
duration on the card's timeline (``torch.profiler``). The bounds are this
checkout's ``chip_smoke.py``'s: every decoder flop as a 3xTF32 product on
the tensor cores (``bound_ms``) and on the FP32 units
(``fp32_bound_ms``). Needs one card. Prints one JSON line per turn and,
last, the card's name and power limit.
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
KERNELS = {"k2": "decoder_forward_f32_kernel",
           "k3": "decoder_backward_f32_kernel"}


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
    call, over the launches the trace holds (it can drop a few)."""
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
    if not us:
        raise RuntimeError(f"no {kernel} launch traced")
    return sum(us) / len(us) / 1e3


def _rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _variant(build, flags) -> tuple:
    """``mlp_kernel_f32.cu`` at the default size built with the package's
    nvcc flags and ``flags`` added for ptxas -> (library path, ptxas
    output)."""
    out_dir = build.BUILD_DIR / "variant"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "_".join(f.strip("-").replace("=", "") for f in flags)
    so = out_dir / f"libmlp_kernel_f32_{tag}.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, *[f"-Xptxas={f}" for f in flags],
         *build.size_flags(build.DEFAULT_SIZE), "-o", str(so),
         str(build.CSRC / "mlp_kernel_f32.cu")], capture_output=True,
        text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc with {flags} failed:\n{res.stderr}")
    return so, res.stdout + res.stderr


def turn(arg: str) -> dict:
    tree, _, flags = arg.partition("@")
    flags = [f for f in flags.split(",") if f]
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import proudslam_tpu_torch
    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_turns: no CUDA device")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dec = bench_settings().decoder
    fp = mk.pack_params(init_decoder(gen, dec, device), dec)
    fp = type(fp)(*[t.contiguous() for t in fp])
    n = max(SHAPES.values())
    x = 0.07 * torch.randn((n, dec.in_dim), generator=gen, device=device)
    g = 1e-2 * torch.randn((n, 4), generator=gen, device=device)
    if flags:
        import ctypes

        lib, log = _variant(build, flags)
        cdll = ctypes.CDLL(str(lib))
        mk._bind_f32(cdll)
        build._libs["mlp_kernel_f32", build.DEFAULT_SIZE] = cdll
    else:
        lib = build.build("mlp_kernel_f32")
        log = build.build_log("mlp_kernel_f32")
    sass = cs.sass_counts(lib)
    ptxas = cs.ptxas_resources(log)
    res = {"tree": tree, "ptxas_flags": flags,
           "package": os.path.dirname(proudslam_tpu_torch.__file__),
           "build": {f[-60:]: {**c, **ptxas.get(f, {})}
                     for f, c in sass.items()
                     if any(fn in f for fn in KERNELS.values())}}
    for shape, rows in SHAPES.items():
        xn, gn = x[:rows], g[:rows]
        _, _, _, sdf, _, rgb = mk.decoder_fwd_plain(xn, fp, False)
        dx_p, gr_p = mk.decoder_bwd_plain(xn, gn, fp, bf16=False)
        dx_k, gr_k = mk.decoder_bwd(xn, gn, fp, bf16=False)
        dx_o, _ = mk.decoder_bwd(xn, gn, fp, want_wgrad=False, bf16=False)
        flops = cs.DEC_FLOPS * rows
        st = {"rows": rows,
              "k2_err": _rel_err(mk.decoder_fwd(xn, fp, bf16=False),
                                 torch.cat([rgb, sdf], 1)),
              "k3_err": max(_rel_err(a, b) for a, b in
                            zip((dx_k, *gr_k), (dx_p, *gr_p))),
              "k3_dx_only_err": _rel_err(dx_o, dx_p)}
        forms = {
            "k2": (lambda: mk.decoder_fwd(xn, fp, bf16=False), 1,
                   cs._nbytes(xn, *fp) + rows * 4 * 4),
            "k3": (lambda: mk.decoder_bwd(xn, gn, fp, bf16=False), 3,
                   cs._nbytes(xn, gn, *fp, xn, *gr_k)),
            "k3_dx_only": (lambda: mk.decoder_bwd(
                xn, gn, fp, want_wgrad=False, bf16=False), 2,
                cs._nbytes(xn, gn, *fp, xn)),
        }
        for form, (fn, passes, nbytes) in forms.items():
            st[f"{form}_ms"] = cs._event_ms(fn)
            st[f"{form}_device_ms"] = _device_ms(fn, KERNELS[form[:2]])
            st[f"{form}_bound_ms"], _ = cs._bound(0, 0, nbytes,
                                                  passes * flops)
            st[f"{form}_fp32_bound_ms"], _ = cs._bound(0, passes * flops,
                                                       nbytes)
            st[f"{form}_share"] = st[f"{form}_bound_ms"] / st[f"{form}_ms"]
        res[shape] = st
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return
    for tree in sys.argv[1:] or ["."]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        if run.returncode != 0:     # a variant ptxas refuses, say
            print(json.dumps({"tree": tree, "rc": run.returncode,
                              "error": run.stderr.strip()[-600:]}),
                  flush=True)
            continue
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
