#!/usr/bin/env python3
"""The rate of ``mma.sync.m16n8k8`` with TF32 operands on this card.

    python3 scripts/torch_mma_rate.py

K2-f32 and K3-f32 (``proudslam_tpu_torch/csrc/mlp_kernel_f32.cu``) run
their 3xTF32 products on ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.
tf32.f32`` (HMMA.1688.F32.TF32 in the SASS); the card's 495 TFLOP/s TF32
peak is quoted for ``wgmma``. This script builds (``nvcc``, the package's
flags, into ``proudslam_tpu_torch/_build/mma_rate/``) a kernel whose warps
issue nothing but that instruction from registers, ``CHAINS`` independent
accumulators per warp, ``ITERS`` times, and times one launch of one block
per SM per ``warps`` in (4, 8, 16, 32) warps a block with CUDA events,
after a warm-up launch. It prints one JSON line per block size: the
TFLOP/s (2 * 16 * 8 * 8 flops per instruction), the same as three TF32
products per f32 product (the 3xTF32 ceiling of this instruction), and
cycles per instruction per SM sub-partition at the SM clock that
``nvidia-smi`` reads after the run; then the card's name and power limit.
Needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ITERS = 4096
CHAINS = 8
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_loop(float* out, int iters) {
  // TF32 operands (f32 bit patterns with 13 low bits zero) of small values
  const uint32_t a[4] = {0x3a800000u, 0x3a000000u, 0x39800000u, 0x3a400000u};
  const uint32_t b[2] = {0x3a800000u, 0x39c00000u};
  float d[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        cudaStream_t stream) {
  mma_loop<<<blocks, threads, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_library() -> ctypes.CDLL:
    from proudslam_tpu_torch.ops.kernels import build

    out_dir = build.BUILD_DIR / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "mma_rate.cu"
    cu.write_text(SOURCE)
    so = out_dir / "libmma_rate.so"
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    res = subprocess.run([build._nvcc(), *flags, f"-DCHAINS={CHAINS}", "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    return lib


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_mma_rate: no CUDA device")
    lib = build_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for warps in (4, 8, 16, 32):
        out = torch.empty(sms * warps * 32, device="cuda")

        def launch():
            err = lib.mma_rate(out.data_ptr(), sms, warps * 32, ITERS, stream)
            if err:
                raise RuntimeError(f"mma_rate: CUDA error {err}")
        launch()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        launch()
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e)
        instructions = sms * warps * ITERS * CHAINS
        tflops = instructions * 2 * 16 * 8 * 8 / ms / 1e9
        sm_mhz = float(_smi("clocks.sm"))
        cycles = ms * 1e-3 * sm_mhz * 1e6
        print(json.dumps({
            "warps_per_block": warps, "blocks": sms, "ms": ms,
            "tf32_tflops": tflops, "tf32x3_tflops": tflops / 3,
            "sm_mhz_after": sm_mhz,
            "cycles_per_mma_per_subpartition":
                cycles / (instructions / sms / 4)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
