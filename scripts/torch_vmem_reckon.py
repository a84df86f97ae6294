#!/usr/bin/env python3
"""The VMEM a grid step of the JAX package's decoder backward
(``proudslam_tpu/ops/pallas/mlp_kernel.py::_run_bwd``) holds, reckoned from
its code, at decoder sizes (in_dim, width, sdf_dim) up to width 1024.

    python3 scripts/torch_vmem_reckon.py

A count from the shapes, not a measurement, and unverified on a TPU:
``_run_bwd`` passes the 11 params as whole arrays in VMEM (one copy each),
the 11 gradients as whole-array output blocks with a constant index map
and x, g and dx as (TILE, .) blocks (two buffers each, as the Pallas
pipeline double-buffers a blocked operand), and sets no
``vmem_limit_bytes``. To those this adds a lower bound of the kernel's
live f32 values: h1, h2 and hc of (TILE, width) and feat of (TILE,
sdf_dim), held from the forward recompute until their gradients, and one
(TILE, width) cotangent at a time. Prints one JSON line per size, in MiB.
The port's kernels are not counted here (they keep a block's tile in
shared memory, ``PERF.md``).
"""

from __future__ import annotations

import json

TILE = 2048      # mlp_kernel.py's row tile
MIB = 1 << 20


def nparam(d: int, w: int, sd: int) -> int:
    """Floats of the 11 packed params (FusedParams)."""
    return (d * w + w + w * w + w + w * (sd + 1) + (sd + 1) + sd * w
            + d * w + w + w * 3 + 3)


def reckon(d: int, w: int, sd: int) -> dict:
    params = 4 * nparam(d, w, sd)
    grads = 2 * params
    io = 2 * 4 * TILE * (d + 4 + d)
    live = 4 * TILE * (4 * w + sd)
    return {"size": [d, w, sd], "params_mib": params / MIB,
            "grads_mib": grads / MIB, "x_g_dx_mib": io / MIB,
            "live_f32_lower_bound_mib": live / MIB,
            "total_mib": (params + grads + io + live) / MIB}


def main() -> None:
    for d in (16, 64):
        for w in (128, 256, 512, 768, 1024):
            print(json.dumps(reckon(d, w, min(w, 512) if w > 512 else w)))
            if w > 512:
                print(json.dumps(reckon(d, w, w)))


if __name__ == "__main__":
    main()
