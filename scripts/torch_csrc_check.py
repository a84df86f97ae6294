#!/usr/bin/env python3
"""The CUDA sources of the port compiled as C++ on a machine without
``nvcc``: every ``static_assert`` (a block's shared memory among them),
template and type at each decoder size, in seconds.

    python3 scripts/torch_csrc_check.py [--all] [SIZE ...]

Each (source, size) of ``mlp_kernel.BUILT_SIZES`` (``--all``; by default
the sizes of widths 768 and 1024, ``mlp_kernel.PARK_SIZES``; or the sizes given as
``D,W,SD``), and the size-free ``mlp_wgrad.cu`` and ``mlp_wgrad_f32.cu`` once, is compiled with ``g++ -std=c++20`` against stub
``cuda_runtime.h`` and ``cuda_bf16.h`` headers written to a temporary
directory: the CUDA qualifiers as no-ops, the intrinsics as plain C++,
every inline ``asm`` dropped, the ``<<<...>>>`` launch configurations
stripped, the dynamic shared-memory array a small static one. The
program then prints each kernel's shared-memory bytes (and K1's gather
dims a corner, ``G``, where it blends in passes). It proves nothing about
the device code's behaviour: no kernel runs.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "proudslam_tpu_torch", "csrc")

RUNTIME_H = r"""#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3s { unsigned x, y, z; };
inline thread_local dim3s threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline void __trap() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::max;
using std::min;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
"""

BF16_H = r"""#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u; std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  unsigned u = (unsigned)b.v << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
"""

# the constants each source prints: its kernels' shared-memory bytes
CONSTANTS = {
    "render_stream": ["SMEM"], "render_wide": ["SMEM"],
    "render_park": ["SMEM"],
    "mlp_stream": ["K2_SMEM", "K3_SMEM"], "mlp_wide": ["K2_SMEM", "K3_SMEM"],
    "mlp_park": ["K2_SMEM", "K3_SMEM"],
    "mlp_stream_f32": ["K2F_SMEM", "K3F_SMEM"],
    "mlp_wgrad": ["SMEM"],
}


def sources(size) -> list:
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if tuple(size) == (16, 128, 128):
        return ["render_kernel", "mlp_kernel", "mlp_kernel_f32"]
    return [f"{mk.bf16_source(b, size)}" for b in ("render", "mlp")] + [
        "mlp_stream_f32"]


def check(tmp: str, src: str, size) -> str:
    """Compile ``src`` at ``size`` and run it -> one line of result."""
    d, w, sd = size
    consts = CONSTANTS.get(src, []) + (
        ["G"] if src.startswith("render_") and d > 32 and src != "render_kernel"
        else []) + (
        # the wide plan's tile rows and chunk rows, both kernels'
        ["RT3", "CR3"] if src == "mlp_stream_f32" and w > 256 else [])
    main = os.path.join(tmp, f"{src}_{d}x{w}x{sd}.cpp")
    with open(main, "w") as fh:
        fh.write(f'#include "{src}.cu"\n#include <cstdio>\nint main() {{\n')
        for c in consts:
            fh.write(f'  std::printf("{c} %lld ", (long long)({c}));\n')
        fh.write("  return 0;\n}\n")
    exe = main[:-4]
    res = subprocess.run(
        ["g++", "-std=c++20", "-O0", "-w", f"-I{tmp}", "-DASM_STUB(...)=((void)0)",
         f"-DDEC_D={d}", f"-DDEC_W={w}", f"-DDEC_SD={sd}", main, "-o", exe],
        capture_output=True, text=True)
    if res.returncode:
        return f"FAIL {src} {size}\n{res.stderr[-4000:]}"
    out = subprocess.run([exe], capture_output=True, text=True).stdout
    return f"ok {src} {size} {out.strip()}"


def main() -> None:
    sys.path.insert(0, ROOT)
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    args = sys.argv[1:]
    sizes = [tuple(int(v) for v in a.split(",")) for a in args
             if a != "--all"]
    if not sizes:
        sizes = list(mk.BUILT_SIZES if "--all" in args else mk.PARK_SIZES)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cuda_runtime.h"), "w") as fh:
            fh.write(RUNTIME_H)
        with open(os.path.join(tmp, "cuda_bf16.h"), "w") as fh:
            fh.write(BF16_H)
        for name in os.listdir(CSRC):
            text = open(os.path.join(CSRC, name)).read()
            text = re.sub(r"<<<[^>]*>>>", "", text)
            text = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                          r"static \1 \2[16];", text)
            text = re.sub(r"\basm\s*(volatile\s*)?\(", "ASM_STUB(", text)
            with open(os.path.join(tmp, name), "w") as fh:
                fh.write(text)
        # the size-free second passes of K3 and K3-f32 once (their builds
        # take no size)
        jobs = [(src, size) for size in sizes for src in sources(size)]
        jobs += [("mlp_wgrad", sizes[0]), ("mlp_wgrad_f32", sizes[0])]
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            lines = list(pool.map(lambda j: check(tmp, *j), jobs))
    for line in lines:
        print(line)
    failed = sum(line.startswith("FAIL") for line in lines)
    print(f"{len(lines) - failed} of {len(lines)} compiled")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
