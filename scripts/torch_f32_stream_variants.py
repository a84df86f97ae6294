#!/usr/bin/env python3
"""Where the streamed K3-f32's time goes (``csrc/mlp_stream_f32.cu``):
copies of the source with one part changed, timed on one card.

    python3 scripts/torch_f32_stream_variants.py slab    # reads, red, half P
    python3 scripts/torch_f32_stream_variants.py parts   # stores, products

Each variant is a copy of ``csrc/`` in a temporary directory with
``mlp_stream_f32.cu`` edited, built by ``nvcc`` at the sizes below, and
timed through ``mlp_kernel.decoder_bwd`` (``chip_smoke._event_ms``) on
327,680 rows of 0.3 N(0, 1) inputs with 1e-2 N(0, 1) cotangents and
``init_decoder`` weights. ``slab``: the source as it is (``pairs``), the
slab's read-modify-write replaced by a store on the first tile and
``red.global.add.f32`` after (``red``), the slab reads dropped
(``nosread``, wrong results), each also with half the blocks
(``-halfP``); the gradients are checked for bitwise repeatability and
against ``pairs``. ``parts`` (timing only, wrong results): ``base``, the
weight gradients' slab stores dropped (``nostore``), their tensor-core
products dropped (``nomm``), the weight-gradient loop skipped
(``nowgrad``), each beside the dx-only form. Logs to standard error.
Needs one card.

A one-off diagnostic, kept for the K3-f32 times PERF.md cites from it:
its variants are text edits of ``mlp_stream_f32.cu`` that raise when the
source no longer holds the text they replace, and most of them compute
wrong results by design. ``chip_smoke.py`` is what checks the kernel.
"""

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from proudslam_tpu_torch.config import bench_settings  # noqa: E402
from proudslam_tpu_torch.models.decoder import init_decoder  # noqa: E402
from proudslam_tpu_torch.ops.kernels import build  # noqa: E402
from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk  # noqa: E402

PAIRS_RMW = '''      if (!first)
        tf::for_each_pair(acc, m0, n0,
                          [&](int m, int n, float& v0, float& v1) {
                            const float2 q = *reinterpret_cast<const float2*>(
                                out + m * LDO + n);
                            v0 += q.x;
                            v1 += q.y;
                          });
      tf::for_each_pair(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        *reinterpret_cast<float2*>(out + m * LDO + n) = make_float2(v0, v1);
      });'''
PAIRS_STORE = '''      tf::for_each_pair(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        *reinterpret_cast<float2*>(out + m * LDO + n) = make_float2(v0, v1);
      });'''
RED = '''
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\\n" ::"l"(p), "f"(v) : "memory");
}
'''
PRODUCT = "    tf::mm_kk<TM, TN, RT>(acc, act, cot, AP, m0, n0);\n"
LOOP = "  for (int t = threadIdx.x >> 5; t < MT * NT; t += NWARP) {"


def variants(mode: str, src: str) -> dict:
    for piece in (PAIRS_RMW, PRODUCT, LOOP):
        if piece not in src:
            raise RuntimeError("mlp_stream_f32.cu changed: update the variants")
    if mode == "slab":
        red = src.replace("// ---- products ----", RED + "// ---- products ----")
        red = red.replace(PAIRS_RMW, '''      if (first)
        tf::for_each_pair(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
          *reinterpret_cast<float2*>(out + m * LDO + n) = make_float2(v0, v1);
        });
      else
        tf::for_each_acc(acc, m0, n0, [&](int m, int n, float& v) {
          red_add(out + m * LDO + n, v);
        });''')
        return {"pairs": src, "red": red,
                "nosread": src.replace(PAIRS_RMW, PAIRS_RMW.replace(
                    "if (!first)", "if (false)"))}
    return {"base": src,
            "nostore": src.replace(PAIRS_STORE, "      if (acc[0][0][0] == "
                                   "12345.f) out[0] = acc[0][0][1];"),
            "nomm": src.replace(PRODUCT, ""),
            "nowgrad": src.replace(LOOP, LOOP.replace("t < MT * NT",
                                                      "t < 0"))}


def main(mode: str) -> None:
    log = cs.log
    log(cs.device_phase())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    N = 327680
    x = 0.3 * torch.randn((N, 16), generator=gen, device=dev)
    g = 1e-2 * torch.randn((N, 4), generator=gen, device=dev)
    sizes = ([(16, 256, 128), (16, 128, 64), (16, 256, 256)] if mode == "slab"
             else [(16, 256, 128), (16, 128, 64)])
    fps = {}
    for d, w, sd in sizes:
        dec = dataclasses.replace(bench_settings().decoder, in_dim=d, width=w,
                                  sdf_dim=sd)
        fp = mk.pack_params(init_decoder(gen, dec, dev), dec)
        fps[d, w, sd] = type(fp)(*[t.contiguous() for t in fp])
    tmp = tempfile.mkdtemp()
    jobs = []
    for name, text in variants(mode, (build.CSRC / "mlp_stream_f32.cu")
                               .read_text()).items():
        csrc = os.path.join(tmp, name)
        shutil.copytree(build.CSRC, csrc)
        with open(os.path.join(csrc, "mlp_stream_f32.cu"), "w") as f:
            f.write(text)
        for size in sizes:
            so = os.path.join(tmp, f"lib_{name}_{cs._size_tag(size)}.so")
            jobs.append((name, size, so, [
                build._nvcc(), *build.NVCC_FLAGS, *build.size_flags(size),
                "-o", so, os.path.join(csrc, "mlp_stream_f32.cu")]))
    with ThreadPoolExecutor(len(jobs)) as pool:
        runs = list(pool.map(lambda j: subprocess.run(
            j[3], capture_output=True, text=True), jobs))
    ref = {}
    orig_lib, orig_part = mk._f32_library, mk.backward_f32_stream_partition
    try:
        for (name, size, so, _), run in zip(jobs, runs):
            if run.returncode:
                log(f"{name} at {size}: build failed {run.stderr[-2000:]}")
                continue
            lib = ctypes.CDLL(so)
            mk._bind_stream_f32(lib)
            mk._f32_library = lambda s, d, lib=lib: (
                lib, [mk.packed_f32_weights(s, d)])
            fp = fps[size]
            regs = cs.ptxas_resources(run.stdout + run.stderr)
            halves = (False, True) if name in ("pairs", "red") else (False,)
            for half in (halves if mode == "slab" else (False,)):
                mk.backward_f32_stream_partition = (
                    (lambda n, s: orig_part(n, s // 2)) if half else orig_part)
                st = {"ms": cs._event_ms(
                    lambda: mk.decoder_bwd(x, g, fp, bf16=False))}
                if mode == "slab":
                    dx, gr = mk.decoder_bwd(x, g, fp, bf16=False)
                    dx2, gr2 = mk.decoder_bwd(x, g, fp, bf16=False)
                    st["repeatable"] = (torch.equal(dx, dx2) and all(
                        torch.equal(a, b) for a, b in zip(gr, gr2)))
                    if name == "pairs" and not half:
                        ref[size] = gr
                    st["max_diff_to_pairs"] = max(
                        (a - b).abs().max().item()
                        for a, b in zip(gr, ref[size]))
                else:
                    st["dx_only_ms"] = cs._event_ms(lambda: mk.decoder_bwd(
                        x, g, fp, want_wgrad=False, bf16=False))
                st["registers"] = [r.get("registers") for r in regs.values()]
                log(f"{name}{'-halfP' if half else ''} {size}: "
                    + json.dumps(st))
    finally:
        mk._f32_library = orig_lib
        mk.backward_f32_stream_partition = orig_part
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "parts")
