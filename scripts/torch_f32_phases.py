#!/usr/bin/env python3
"""Where K2-f32 and K3-f32 spend their time: SM cycles per tile by phase.

    python3 scripts/torch_f32_phases.py

Writes a copy of ``proudslam_tpu_torch/csrc/mlp_kernel_f32.cu`` with a
block-wide barrier and a ``clock64()`` reading of thread 0 inserted at the
end of each phase of a tile (``PHASES`` below names each phase by the
source line that follows it), and one around each weight staging
(``ensure_stage``), builds it with the package's ``nvcc`` flags into
``proudslam_tpu_torch/_build/phases/``, and runs K2-f32, K3-f32 and its
dx-only form once each at the pcd path's mapping and tracking shapes on
the inputs of ``scripts/torch_f32_turns.py`` (K3-f32's second pass,
``mlp_wgrad_f32.cu``, runs uninstrumented inside the full form's time).
For each it prints one JSON
line: the call's CUDA-event time, and per phase the SM cycles per 64-row
tile (summed over the blocks, over the tiles) and its share. The first
phase of a block's first tile also holds the block's start (w1's copy).
The added barriers make the instrumented kernels slower than the real
ones (``scripts/torch_f32_turns.py`` times those); the shares are what the
tool is for. Needs one card and nvcc. Prints the card's name and power
limit last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
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


def build_instrumented():
    from proudslam_tpu_torch.ops.kernels import build

    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "mlp_kernel_f32_phases.cu"
    cu.write_text(instrumented_source((build.CSRC / "mlp_kernel_f32.cu")
                                      .read_text()))
    so = out_dir / "libmlp_kernel_f32_phases.so"
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    res = subprocess.run([build._nvcc(), *flags, f"-I{build.CSRC}", "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    return ctypes.CDLL(str(so))


def main() -> None:
    import torch

    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_phases: no CUDA device")
    device = torch.device("cuda", 0)
    lib = build_instrumented()
    mk._bind_f32(lib)
    lib.phase_read.argtypes = [ctypes.c_void_p]
    lib.phase_reset.argtypes = []
    lib.phase_read.restype = lib.phase_reset.restype = ctypes.c_int
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
    counts = np.zeros((1024, 32), np.uint64)
    for shape, rows in SHAPES.items():
        xn, gn = x[:rows], g[:rows]
        tiles = -(-rows // mk.TILE_ROWS)
        forms = {
            "K2-f32": ("decoder_forward_f32_kernel",
                       lambda: mk.decoder_fwd(xn, fp, bf16=False)),
            "K3-f32": ("decoder_backward_f32_kernel",
                       lambda: mk.decoder_bwd(xn, gn, fp, bf16=False)),
            "K3-f32 dx-only": ("decoder_backward_f32_kernel",
                               lambda: mk.decoder_bwd(xn, gn, fp,
                                                      want_wgrad=False,
                                                      bf16=False)),
        }
        for form, (fn, call) in forms.items():
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
            total = per_tile[:len(PHASES[fn])].sum()
            print(json.dumps({
                "form": form, "shape": shape, "rows": rows,
                "instrumented_ms": s.elapsed_time(e),
                "cycles_per_tile": float(total),
                "phases": {name: [round(per_tile[i]),
                                  round(per_tile[i] / total, 4)]
                           for i, (name, _) in enumerate(PHASES[fn])},
                "staging_cycles_per_tile": round(per_tile[STAGING])}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
