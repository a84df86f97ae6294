#!/usr/bin/env python3
"""The machine code of the decoder kernels of two checkouts, compared.

    python3 scripts/torch_sass_diff.py [--only=mlp_kernel,...] OLD_TREE NEW_TREE

For each tree, one process imports that tree's ``proudslam_tpu_torch`` and
builds (one ``nvcc`` each, all started together) its kernel libraries at
every decoder size of its ``mlp_kernel.BUILT_SIZES``: ``render_kernel``,
``mlp_kernel`` and ``mlp_kernel_f32`` at (16, 128, 128), their streamed
sources (``render_stream``, ``mlp_stream``, ``mlp_stream_f32``) at the
other sizes up to width 256 and their wide sources (``render_wide``,
``mlp_wide``, ``mlp_stream_f32``) at width 384 and 512 and at in_dim 128
(the tree's ``mlp_kernel.wide_plan``), its parked ones (``render_park``,
``mlp_park``) at widths 768 and 1024 (``mlp_kernel.bf16_source``). Then,
per library
both trees build and kernel function, the SASS of ``cuobjdump -sass`` is
compared: equal SASS is the same machine code, whatever the source text.
The libraries only one tree builds (a size the other does not take) are
counted. Lines are compared with their runs of spaces made one:
``cuobjdump`` pads each instruction to the module's widest, so a change
to one kernel moves the padding of every other's. ``--only`` builds and
compares only the named sources (``render_kernel``, ``mlp_kernel``,
``mlp_kernel_f32`` and their streamed, wide and parked forms). Needs
``nvcc`` and ``cuobjdump`` (the machine with the card).
Prints one JSON line per library and, last, a summary.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

SOURCES = {"render_kernel": "render_stream", "mlp_kernel": "mlp_stream",
           "mlp_kernel_f32": "mlp_stream_f32"}
WIDE_SOURCES = {"render_kernel": "render_wide", "mlp_kernel": "mlp_wide",
                "mlp_kernel_f32": "mlp_stream_f32"}


def _source(mk, name: str, size) -> str:
    """The source that builds ``name``'s kernels at a streamed ``size`` in
    the tree of ``mk``: its ``bf16_source`` (the streamed, wide or parked
    plan) for the bf16 forms where it has one, else by its wide predicate
    (a tree from before in_dim 128: width > 256)."""
    if name != "mlp_kernel_f32" and hasattr(mk, "bf16_source"):
        return mk.bf16_source(name.split("_")[0], size)
    wide = getattr(mk, "wide_plan", mk.wide)
    return (WIDE_SOURCES if wide(size) else SOURCES)[name]


def build_tree(tree: str, only=None) -> None:
    """Child: build the tree's libraries; print {name@size: path}."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, os.path.abspath(tree))
    from proudslam_tpu_torch.ops.kernels import build
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    jobs = [(name if size == build.DEFAULT_SIZE else
             _source(mk, name, size), size)
            for size in mk.BUILT_SIZES for name in SOURCES
            if only is None or name in only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: build.build(*job), jobs))
    print(json.dumps({f"{name}@{'x'.join(map(str, size))}": str(path)
                      for (name, size), path in zip(jobs, paths)}))


def sass(lib: str) -> dict:
    """{kernel function: its SASS lines} of a library. A function in an
    anonymous namespace carries a hash of its source file in its mangled
    name; that hash is dropped, so one function of two trees has one key."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = re.sub(r"(_GLOBAL__N__|_cu_)[0-9a-f]{8}", r"\1",
                        line.split("Function :")[1].strip())
            funcs[fn] = []
        elif fn is not None and line.strip():
            funcs[fn].append(" ".join(line.split()))
    return funcs


def main(old: str, new: str, only=None) -> None:
    libs = []
    for tree in (old, new):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--build", tree,
                              *([f"--only={','.join(only)}"] if only else [])],
                             capture_output=True, text=True,
                             check=True).stdout
        libs.append(json.loads(out.strip().splitlines()[-1]))
    same_all = True
    for key in libs[0]:
        if key not in libs[1]:
            continue
        a, b = sass(libs[0][key]), sass(libs[1][key])
        res = {}
        for fn in sorted(set(a) | set(b)):
            la, lb = a.get(fn, []), b.get(fn, [])
            res[fn[-48:]] = ("equal" if la == lb else
                             f"differ: {len(la)} / {len(lb)} lines, "
                             f"{sum(x != y for x, y in zip(la, lb))} "
                             "differing in place")
        same = all(v == "equal" for v in res.values())
        same_all &= same
        print(json.dumps({"library": key, "same_sass": same, **res}))
    both = [k for k in libs[0] if k in libs[1]]
    print(json.dumps({"all_same_sass": same_all, "libraries": len(both),
                      "only_old": [k for k in libs[0] if k not in libs[1]],
                      "only_new": [k for k in libs[1] if k not in libs[0]]}))


if __name__ == "__main__":
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    args = [a for a in sys.argv[1:] if not a.startswith("--only=")]
    if args[0] == "--build":
        build_tree(args[1], only[0] if only else None)
    else:
        main(args[0], args[1], only[0] if only else None)
