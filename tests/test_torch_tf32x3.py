"""The 3xTF32 arithmetic of K2-f32 and K3-f32, emulated on the CPU.

The f32-operand decoder kernels (``csrc/mlp_kernel_f32.cu``, with
``csrc/tf32x3.cuh``) run K2-f32's products and K3-f32's backward products
of width 16 or more on the tensor cores as three TF32 products (K3-f32
recomputes the forward, whose ReLU masks its backward takes, with true f32
FMAs): each f32 operand ``a`` is split as
``hi = rna_tf32(a)``, ``lo = rna_tf32(a - hi)`` (``cvt.rna.tf32.f32``:
round to nearest, ties away from zero, on the 13 low mantissa bits), and
``a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi`` with f32 sums. The sdf column
(N = 1), the color logits (N = 3) and the products with ``wo`` stay true
f32 (FMA). This module emulates that arithmetic in PyTorch (here, not in
the package: the package's plain versions stay true f32) and holds:

- the split: ``hi`` and ``lo`` have their 13 low bits zero, and
  ``hi + lo`` is ``a`` to within 2^-21 of |a| (a normal ``lo``) or 2^-137
  absolute (half a TF32 step where ``lo`` is denormal), over random and
  edge values;
- the decoder forward and backward through the port's plain versions with
  3xTF32 products, at 300 rows from a numpy seed, against the same plain
  versions with f32 products (``bf16=False``): within a tenth of
  ``chip_smoke.py``'s 1e-5 (forward, each column) and 1e-4 (backward, each
  output) of each output's largest magnitude, the backward both with every
  product 3xTF32 and as K3-f32 computes it (an f32 forward);
- one-product TF32 (``a_hi b_hi``) falls outside those tolerances, so the
  check can tell the two apart.

What the emulation cannot show at this size: on an H100, at 327,680 rows,
3xTF32 in the backward's forward recompute flipped the ReLU mask of
pre-activations within ~1e-6 of 0 against the plain version (dx off by up
to 4e-2 of its largest magnitude, the weight gradients by 3e-3), where
FFMA gives the plain version's masks; hence K3-f32's f32 forward.
"""

import numpy as np
import pytest
import torch

from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk

# chip_smoke.py's K2-f32 / K3-f32 tolerances (of each output's largest
# magnitude) and the margin the emulated arithmetic must keep inside them
TOL = {"fwd": 1e-5, "bwd": 1e-4}
MARGIN = 10.0
ROWS = 300
D, W = 16, 128


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 explicit mantissa bits,
    ties away from zero (add half a TF32 step to the magnitude's bits, clear
    the 13 low bits); inf and nan pass unchanged."""
    bits = a.contiguous().view(torch.int32)
    out = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(a), out, bits).view(torch.float32)


def split(a: torch.Tensor):
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)


def _tf32x3(a, b):
    (ahi, alo), (bhi, blo) = split(a), split(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _tf32x1(a, b):
    return rna_tf32(a) @ rna_tf32(b)


def kernel_dot(prod):
    """The kernels' product: ``prod`` where K and N are both 8 or more, the
    sdf column (the 129th row or column of ws) and the N = 3 / K = 3 heads
    as true f32 products."""
    def dot(a, b):
        if min(a.shape[1], b.shape[1]) < 8:
            return a @ b
        if b.shape[1] == W + 1:
            return torch.cat([dot(a, b[:, :-1]), a @ b[:, -1:]], dim=1)
        if a.shape[1] == W + 1:
            return dot(a[:, :-1], b[:-1]) + a[:, -1:] @ b[-1:]
        return prod(a, b)
    return dot


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_split(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        a = rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
    else:
        tiny = np.float32(2.0 ** -149)
        a = np.array([0.0, -0.0, tiny, -tiny, 3 * tiny, 1e-40, -2.5e-39,
                      2.0 ** -126 * 0.999, 2.0 ** -126, 1.1754944e-38 * 1.5,
                      1.0, 1 + 2.0 ** -23, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -12, 1e30, -1e30, 3e38, -3e38, 2.0 ** 127,
                      -(2.0 ** 127) * 1.9])
    a = torch.tensor(a, dtype=torch.float32)
    hi, lo = split(a)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    a64, err = a.double(), (hi.double() + lo.double() - a.double()).abs()
    bound = torch.maximum(2.0 ** -21 * a64.abs(),
                          torch.full_like(a64, 2.0 ** -137))
    assert (err <= bound).all(), float((err / bound).max())
    if kind == "edge":
        # ties go away from zero: 1 + 2^-11 is half a TF32 step above 1
        assert rna_tf32(torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
                        ).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
        assert rna_tf32(torch.tensor([1 + 2.0 ** -11 - 2.0 ** -23])
                        ).tolist() == [1.0]


def _decoder_inputs():
    """Decoder params with uniform(+-1/sqrt(fan_in)) weights and biases, x
    at the pcd branch's feature scale (rms 0.07) and cotangents, from a
    numpy seed."""
    rng = np.random.default_rng(7)
    shapes = [(D, W), (1, W), (W, W), (1, W), (W, W + 1), (1, W + 1),
              (W, W), (D, W), (1, W), (W, 3), (1, 3)]
    fan_in = [D, D, W, W, W, W, W + D, W + D, W + D, W, W]
    fp = tmk.FusedParams(*[
        torch.tensor(rng.uniform(-1, 1, s) / np.sqrt(f), dtype=torch.float32)
        for s, f in zip(shapes, fan_in)])
    x = torch.tensor(0.07 * rng.standard_normal((ROWS, D)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((ROWS, 4)), dtype=torch.float32)
    return fp, x, g


def _run(direction, fp, x, g):
    """(fwd: the 4 output columns | bwd: dx and the 11 gradients) as a list
    of tensors, through the port's plain versions with bf16=False."""
    if direction == "fwd":
        _, _, _, sdf, _, rgb = tmk.decoder_fwd_plain(x, fp, False)
        return list(torch.cat([rgb, sdf], dim=1).T)
    dx, grads = tmk.decoder_bwd_plain(x, g, fp, bf16=False)
    return [dx, *grads]


def _worst(direction, prod, monkeypatch):
    """Largest error of the emulated products against true f32 products,
    over each output's largest magnitude. ``bwd_f32_forward``: the backward
    with the emulated products and a true f32 forward (K3-f32's split)."""
    fp, x, g = _decoder_inputs()
    ref = _run(direction, fp, x, g)
    fwd_plain = tmk.decoder_fwd_plain

    def fwd_f32(*args):
        with monkeypatch.context() as m2:
            m2.setattr(tmk, "_make_dot", lambda bf16: lambda a, b: a @ b)
            return fwd_plain(*args)
    with monkeypatch.context() as m:
        m.setattr(tmk, "_make_dot", lambda bf16: kernel_dot(prod))
        if direction == "bwd_f32_forward":
            m.setattr(tmk, "decoder_fwd_plain", fwd_f32)
        got = _run(direction, fp, x, g)
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in
               zip(got, ref))


@pytest.mark.parametrize("direction", ["fwd", "bwd", "bwd_f32_forward"])
def test_tf32x3_decoder_within_f32_tolerance(direction, monkeypatch):
    err = _worst(direction, _tf32x3, monkeypatch)
    assert err * MARGIN <= TOL[direction[:3]], err


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_one_product_tf32_outside_tolerance(direction, monkeypatch):
    err = _worst(direction, _tf32x1, monkeypatch)
    assert err > TOL[direction], err
