#!/usr/bin/env python3
"""Where K2-f32 and K3-f32 spend their time: SM cycles per tile by phase.

    python3 scripts/torch_f32_phases.py [--size=D,W,SD ...] [--tree=DIR]

Without ``--size``: writes a copy of
``proudslam_tpu_torch/csrc/mlp_kernel_f32.cu`` with a block-wide barrier
and a ``clock64()`` reading of thread 0 inserted at the end of each phase
of a tile (``PHASES`` below names each phase by the source line that
follows it), and one around each weight staging (``ensure_stage``),
builds it with the package's ``nvcc`` flags into
``proudslam_tpu_torch/_build/phases/``, and runs K2-f32, K3-f32 and its
dx-only form once each at the pcd path's mapping and tracking shapes on
the inputs of ``scripts/torch_f32_turns.py`` (K3-f32's second pass,
``mlp_wgrad_f32.cu``, runs uninstrumented inside the full form's time).

With ``--size=D,W,SD`` (repeatable): the same for K3-f32's first pass in
``mlp_stream_f32.cu`` (the streamed plan) at that built size, full and
dx-only, on ``chip_smoke.py``'s ``init_decoder`` params at the size and
inputs from a seed. Its phases are the tree's own (``STREAM_PHASES``: the
first set whose anchor lines all stand in the source): the forward
recompute's four products, dzo and dhc, dfeat, dh2, dh1 and dx's x-side
products; besides them, thread 0's waits for the ring's chunks
(``acquire``) and for the operand stores to have read their tiles
(``wg::stored_read``) are counted apart (they lie inside the phases).
``--tree=DIR`` instruments and runs the checkout at DIR (its package and
its sources), so a parent unpacked into ``diag/`` is measured the same
way.

For each form it prints one JSON line: the call's CUDA-event time, and per
phase the SM cycles per tile (summed over the blocks, over the tiles of
the plan's height) and its share. The first phase of a block's first tile
also holds the block's start. The added barriers make the instrumented
kernels slower than the real ones (``scripts/torch_f32_turns.py`` and
``scripts/torch_size_turns.py`` time those); the shares are what the tool
is for. Needs one card and nvcc. Prints the card's name and power limit
last.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"mapping": 5 * 1024 * 64, "tracking": 1024 * 64}
SEED = 0
# (kernel function, [(phase, the first source line after it), ...]): the
# lines stand at the tile loop's top level; the last phase runs to the
# next tile's first barrier
PHASES = {
    "decoder_forward_f32_kernel": [
        ("color head, output (the tile before)",
         "// the last tile's readers"),
        ("load x",
         "    forward_feat(f, a, b, a, xs, w1s, stage, held, p, sdf);"),
        ("h1, h2, feat, sdf partials (stages w2, ws)",
         "    forward_color(f, b, a, xs, stage, held, p);"),
        ("hc (stages wc)", "    color_partials(part, b, p);"),
    ],
    "decoder_backward_f32_kernel": [
        ("dx (and the tile before's tail)", "// the last tile's readers"),
        ("load x, g", "    // forward recompute: h1 -> B0"),
        ("forward recompute, FFMA (stages w2, ws, wc)",
         "    // dzo = g_rgb * rgb * (1 - rgb), per row"),
        ("dzo, dwo, dbo", "    // dhc = (dzo wo^T) * (hc > 0)"),
        ("dhc", "    // with dhc (B3): dbc"),
        ("dbc", "    float dxa[1][1][4];"),
        ("dx part dhc wc_x^T", "    Acc acc;"),
        ("dfeat", "    // with dso = [dfeat (B2) | g_sdf]"),
        ("dbs, ws's sdf column", "    // dh2 = (dfeat ws"),
        ("dh2 (stages ws)", "    // db2; dh1"),
        ("db2", "    ensure_stage(stage, held, ST_W2, p);"),
        ("dh1 (stages w2)", "    // db1; dx"),
        ("db1", "    dx_mm(dxa, B1, w1s);"),
    ],
}
STAGING = 31          # the clock slot of the weight stagings
# mlp_stream_f32.cu's K3-f32 (decoder_backward_f32_kernel): per plan, the
# phases as (phase, anchor line, "before" | "after" it), in the order a
# tile runs them; the first phase runs from the tile before's last anchor
STREAM_PHASES = {
    "two live tiles, ReLU bit masks": [
        ("dh1 w1^T, dx out (the tile before); load x, g",
         "    // h1 = relu(x w1 + b1) -> A, its mask", "before"),
        ("h1 (FFMA)", "    // h2 = relu(h1 w2 + b2) -> B, its mask", "before"),
        ("h2 (FFMA), dws's sdf column",
         "    // feat = h2 ws[:, :SD] + bs[:SD] -> A", "before"),
        ("feat (FFMA)", "    // hc = relu(feat wc_f + x wc_x + bc) -> B",
         "before"),
        ("hc (FFMA)", "    // dzo = g_rgb * rgb * (1 - rgb), per row",
         "before"),
        ("dzo, dwo, dbo, dhc", "    // dx = dhc wc_x^T: every warp", "before"),
        ("dbc, dx part dhc wc_x^T", "    // dfeat = dhc wc_f^T -> A", "before"),
        ("dfeat, dbs", "    // dh2 = (dfeat ws[:, :SD]^T", "before"),
        ("dh2, db2", "    // dh1 = (dh2 w2^T) * (h1 > 0) -> A", "before"),
        ("dh1, db1", "    // dx += dh1 w1^T", "before"),
    ],
    "four tiles, 16-row wide tiles": [
        ("dh1 w1^T, dx out (the tile before); load x, g",
         "    // forward recompute on the FP32 units", "before"),
        ("h1 (FFMA)", "    f.store(h1, p.b1, true);", "after"),
        ("h2 (FFMA)", "    f.store(h2, p.b2, true);", "after"),
        ("feat (FFMA)", "    fs.store(feat, p.bs, false);", "after"),
        ("hc (FFMA)", "    f.store(B3, p.bc, true);", "after"),
        ("dzo, dwo, dbo, dhc",
         "    // with dhc (B3): dbc; dx's part dhc wc_x^T", "before"),
        ("dbc, dx part dhc wc_x^T", "    us.zero();\n    stream_mm(us, B3, N_WCT",
         "before"),
        ("dfeat, dbs, dws's sdf column",
         "    // dh2 = (dfeat ws[:, :SD]^T", "before"),
        ("dh2, db2", "    u.zero();\n    stream_mm(u, B3, N_W2T", "before"),
        ("dh1, db1", "    // db1; dx = dhc wc_x^T + dh1 w1^T", "before"),
    ],
}
RING, STORES = 30, 29   # the clock slots of the ring's and the stores' waits
HEADER = r"""
__device__ unsigned long long g_phase[1024][32];
#define PHASE(i) do { __syncthreads(); if (threadIdx.x == 0) { \
    const long long t_ = clock64(); \
    g_phase[blockIdx.x][i] += t_ - t_last_; t_last_ = t_; } } while (0)
"""
FOOTER = r"""
extern "C" int phase_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
extern "C" int phase_reset() {
  static unsigned long long zeros[1024][32];
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zeros, sizeof(g_phase)));
}
"""


def _insert_before(text: str, start: int, line: str, what: str) -> str:
    at = text.index(line, start)
    at = text.rindex("\n", 0, at) + 1
    return text[:at] + what + text[at:]


def _insert_after(text: str, start: int, line: str, what: str) -> str:
    at = text.index("\n", text.index(line, start)) + 1
    return text[:at] + what + text[at:]


def instrumented_source(src: str) -> str:
    """mlp_kernel_f32.cu with the phase clocks (see the module docstring)."""
    out = src.replace('#include "tf32x3.cuh"\n',
                      '#include "tf32x3.cuh"\n' + HEADER, 1)
    staged = "  if (held == want) return;\n  __syncthreads();\n"
    out = out.replace(staged,
                      staged + "  const long long t0_ = clock64();\n", 1)
    waited = "  copy_wait();\n  held = want;\n"
    out = out.replace(waited, waited + (
        f"  if (threadIdx.x == 0) g_phase[blockIdx.x][{STAGING}] += "
        "clock64() - t0_;\n"), 1)
    for fn, phases in PHASES.items():
        start = out.index(fn + "(")
        body = out.index("extern __shared__ __align__(16) float sm[];", start)
        nl = out.index("\n", body) + 1
        out = out[:nl] + "  long long t_last_ = clock64();\n" + out[nl:]
        for i, (_, line) in enumerate(phases):
            out = _insert_before(out, start, line, f"    PHASE({i});\n")
    return out + FOOTER


def stream_phases(src: str):
    """The (plan, phases) of STREAM_PHASES whose anchors all stand in
    mlp_stream_f32.cu's ``src``."""
    for plan, phases in STREAM_PHASES.items():
        if all(line in src for _, line, _ in phases):
            return plan, phases
    raise RuntimeError("mlp_stream_f32.cu: no STREAM_PHASES plan matches")


def instrumented_stream_source(src: str) -> str:
    """mlp_stream_f32.cu with the phase clocks in K3-f32's pass 1 and the
    ring's and the stores' waits timed (the module docstring)."""
    _, phases = stream_phases(src)
    out = src.replace('#include "tf32x3.cuh"\n',
                      '#include "tf32x3.cuh"\n' + HEADER, 1)
    wait = "  bulk::mbar_wait(r.bar + s, (r.phase >> s) & 1u);\n"
    out = out.replace(wait, (
        "  const long long w0_ = clock64();\n" + wait
        + f"  if (threadIdx.x == 0) g_phase[blockIdx.x][{RING}] += "
        "clock64() - w0_;\n"), 1)
    start = out.index("decoder_backward_f32_kernel(")
    body = out.index("extern __shared__ __align__(16) char smem[];", start)
    nl = out.index("\n", body) + 1
    out = out[:nl] + "  long long t_last_ = clock64();\n" + out[nl:]
    end = out.index("\n}\n", start)
    kernel = re.sub(
        r"wg::stored_read(_but<\w+>)?\(\);",
        lambda m: ("{ const long long s0_ = clock64(); " + m.group(0)
                   + f" g_phase[blockIdx.x][{STORES}] += clock64() - s0_; }}"),
        out[start:end])
    out = out[:start] + kernel + out[end:]
    for i, (_, line, where) in enumerate(phases):
        put = _insert_before if where == "before" else _insert_after
        out = put(out, start, line, f"    PHASE({i});\n")
    return out + FOOTER


def _compile(name: str, text: str, size=None):
    from proudslam_tpu_torch.ops.kernels import build

    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "" if size is None else "_" + "x".join(map(str, size))
    cu = out_dir / f"{name}_phases{tag}.cu"
    cu.write_text(text)
    so = out_dir / f"lib{name}_phases{tag}.so"
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    res = subprocess.run([build._nvcc(), *flags,
                          *build.size_flags(size or build.DEFAULT_SIZE),
                          f"-I{build.CSRC}", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.phase_read.argtypes = [ctypes.c_void_p]
    lib.phase_reset.argtypes = []
    lib.phase_read.restype = lib.phase_reset.restype = ctypes.c_int
    return lib


def build_instrumented():
    from proudslam_tpu_torch.ops.kernels import build

    return _compile("mlp_kernel_f32", instrumented_source(
        (build.CSRC / "mlp_kernel_f32.cu").read_text()))


def _measure(lib, forms, rows, tile_rows, names, extra):
    """Runs each form once to warm up, then once with the clocks reset ->
    prints one JSON line per form."""
    import torch

    from proudslam_tpu_torch.ops.kernels import build

    counts = np.zeros((1024, 32), np.uint64)
    tiles = -(-rows // tile_rows)
    for form, call in forms.items():
        call()
        torch.cuda.synchronize()
        build.check(lib.phase_reset(), "phase_reset")
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        torch.cuda.synchronize()
        build.check(lib.phase_read(counts.ctypes.data), "phase_read")
        per_tile = counts.sum(0).astype(float) / tiles
        total = per_tile[:len(names)].sum()
        print(json.dumps({
            "form": form, "rows": rows, "tile_rows": tile_rows,
            "instrumented_ms": s.elapsed_time(e),
            "cycles_per_tile": float(total),
            "phases": {name: [round(per_tile[i]),
                              round(per_tile[i] / total, 4)]
                       for i, name in enumerate(names)},
            **{k: round(per_tile[slot]) for k, slot in extra.items()}}),
            flush=True)


def resident_phases(device) -> None:
    """mlp_kernel_f32.cu at (16, 128, 128), the pcd path's size."""
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    lib = build_instrumented()
    mk._bind_f32(lib)
    # the package's wrappers launch from this library from here on
    build._libs["mlp_kernel_f32", build.DEFAULT_SIZE] = lib
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dec = bench_settings().decoder
    fp = mk.pack_params(init_decoder(gen, dec, device), dec)
    fp = type(fp)(*[t.contiguous() for t in fp])
    n = max(SHAPES.values())
    x = 0.07 * torch.randn((n, dec.in_dim), generator=gen, device=device)
    g = 1e-2 * torch.randn((n, 4), generator=gen, device=device)
    for shape, rows in SHAPES.items():
        xn, gn = x[:rows], g[:rows]
        for form, fn, call in (
                ("K2-f32", "decoder_forward_f32_kernel",
                 lambda: mk.decoder_fwd(xn, fp, bf16=False)),
                ("K3-f32", "decoder_backward_f32_kernel",
                 lambda: mk.decoder_bwd(xn, gn, fp, bf16=False)),
                ("K3-f32 dx-only", "decoder_backward_f32_kernel",
                 lambda: mk.decoder_bwd(xn, gn, fp, want_wgrad=False,
                                        bf16=False))):
            print(json.dumps({"shape": shape}), end=" ", flush=True)
            _measure(lib, {form: call}, rows, mk.TILE_ROWS,
                     [name for name, _ in PHASES[fn]],
                     {"staging_cycles_per_tile": STAGING})


def stream_phases_at(device, size) -> None:
    """mlp_stream_f32.cu's K3-f32 at ``size``, full and dx-only, at the
    mapping and tracking shapes."""
    import torch

    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    src = (build.CSRC / "mlp_stream_f32.cu").read_text()
    plan, phases = stream_phases(src)
    lib = _compile("mlp_stream_f32", instrumented_stream_source(src), size)
    mk._bind_stream_f32(lib)
    build._libs["mlp_stream_f32", size] = lib
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    fp = cs._decoder_at(device, size, 4)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    n = max(SHAPES.values())
    x = 0.07 * torch.randn((n, size[0]), generator=gen, device=device)
    g = 1e-2 * torch.randn((n, 4), generator=gen, device=device)
    tile_rows = mk.wgrad_tile_rows(size, False)
    for shape, rows in SHAPES.items():
        xn, gn = x[:rows], g[:rows]
        print(json.dumps({"size": list(size), "plan": plan, "shape": shape}),
              end=" ", flush=True)
        _measure(lib, {
            "K3-f32": lambda: mk.decoder_bwd(xn, gn, fp, bf16=False),
            "K3-f32 dx-only": lambda: mk.decoder_bwd(
                xn, gn, fp, want_wgrad=False, bf16=False)},
            rows, tile_rows, [name for name, _, _ in phases],
            {"ring_wait_cycles_per_tile": RING,
             "store_wait_cycles_per_tile": STORES})


def main() -> None:
    sizes, tree = [], ROOT
    for a in sys.argv[1:]:
        if a.startswith("--size="):
            sizes.append(tuple(int(v) for v in a.split("=", 1)[1].split(",")))
        elif a.startswith("--tree="):
            tree = os.path.abspath(a.split("=", 1)[1])
        else:
            raise SystemExit(__doc__)
    sys.path.insert(0, tree)
    import torch

    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not mk.__file__.startswith(tree):
        raise RuntimeError(f"imported {mk.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_phases: no CUDA device")
    device = torch.device("cuda", 0)
    if not sizes:
        resident_phases(device)
    for size in sizes:
        stream_phases_at(device, size)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
