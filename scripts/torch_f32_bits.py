#!/usr/bin/env python3
"""The resident K2-f32 / K3-f32 (16, 128, 128) of two checkouts, bit for
bit, on one card.

    python3 scripts/torch_f32_bits.py OLD_TREE NEW_TREE

For each tree, one process imports that tree's ``proudslam_tpu_torch``,
builds its f32 library and computes, from seeded inputs (``init_decoder``
weights, 327,680 rows of 0.07 N(0, 1) features, 1e-2 N(0, 1)
cotangents), K2-f32's output and K3-f32's dx, 11 gradients and dx-only
dx; the parent process then compares the two trees' tensors with
``torch.equal`` and prints the result (one line per tensor, then all).
"""

import os
import subprocess
import sys
import tempfile


def compute(tree: str, out: str) -> None:
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from proudslam_tpu_torch.config import bench_settings
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk

    if not mk.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {mk.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dec = bench_settings().decoder
    fp = mk.pack_params(init_decoder(gen, dec, dev), dec)
    fp = type(fp)(*[t.contiguous() for t in fp])
    x = 0.07 * torch.randn((327680, 16), generator=gen, device=dev)
    g = 1e-2 * torch.randn((327680, 4), generator=gen, device=dev)
    res = {"out": mk.decoder_fwd(x, fp, bf16=False)}
    dx, grads = mk.decoder_bwd(x, g, fp, bf16=False)
    res["dx"] = dx
    res.update({f"d{k}": v for k, v in zip(mk.FusedParams._fields, grads)})
    res["dx_only"] = mk.decoder_bwd(x, g, fp, want_wgrad=False,
                                    bf16=False)[0]
    torch.save({k: v.cpu() for k, v in res.items()}, out)


def main(old: str, new: str) -> None:
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, tree in enumerate((old, new)):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--compute", tree, out], check=True)
            files.append(torch.load(out))
    same = {k: torch.equal(files[0][k], files[1][k]) for k in files[0]}
    for k, v in same.items():
        print(f"{k}: {'equal' if v else 'DIFFERENT'}")
    print(f"resident f32 bit for bit: {all(same.values())}")


if __name__ == "__main__":
    if sys.argv[1] == "--compute":
        compute(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], sys.argv[2])
