"""The float64 witness of ``chip_smoke.py``'s K3-f32 check on the CPU, and
its helpers for the in_dim-32 sizes (``at_size``, ``k1_blend_flops``,
``size_table``).

Where a hidden pre-activation is within f32 rounding of 0, K3-f32 and its
plain version (cuBLAS on the card) may take different ReLU masks, and that
row's dx differs by a whole term. ``chip_smoke._k3_check`` accepts such a
row only when ``_f64_mask_witness`` explains it: the kernel's dx and
gradients there equal the exact float64 ones under masks that differ from
the true ones only on units inside ``_f32_rounding_bounds``. Here stand-in
"kernels" (the plain version with one mask flipped, or with a wrong term)
take the wrapper's place on CPU tensors, at a small decoder size.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk  # noqa: E402

SIZE = (16, 64, 64)
ROWS = 4096
NEAR = 5          # the row given a hidden pre-activation near 0
UNIT = 3          # its h1 unit


def _inputs():
    rng = np.random.default_rng(0)
    fp = cs._decoder_at(torch.device("cpu"), SIZE, 4)
    x = torch.as_tensor(0.3 * rng.standard_normal((ROWS, SIZE[0])),
                        dtype=torch.float32)
    g = torch.as_tensor(1e-2 * rng.standard_normal((ROWS, 4)),
                        dtype=torch.float32)
    # row NEAR's h1 pre-activation of unit UNIT to ~0 by its last input
    w1 = fp.w1.double()
    rest = (x[NEAR, :-1].double() @ w1[:-1, UNIT]) + fp.b1[0, UNIT].double()
    x[NEAR, -1] = float(-rest / w1[-1, UNIT])
    return x, g, fp


def _bwd_flipped(flip=True, extra=0.0):
    """The plain f32 backward with h1's mask of (NEAR, UNIT) flipped (a
    rounding-level flip) and ``extra`` of dx's largest magnitude added to
    row NEAR's dx (a fault no mask explains)."""
    def bwd(x, g, fp, want_wgrad=True, bf16=True):
        near = (x == x_near).all(1)
        h1, h2, feat, _, hc, rgb = mk.decoder_fwd_plain(x, fp, False)
        pre1 = x @ fp.w1 + fp.b1
        m1 = (h1 > 0).float()
        if flip:
            m1[near, UNIT] = 1.0 - m1[near, UNIT]
        h1 = m1 * pre1
        dzo = g[:, 0:3] * rgb * (1.0 - rgb)
        dhc = (dzo @ fp.wo.T) * (hc > 0)
        dso = torch.cat([dhc @ fp.wc_f.T, g[:, 3:4]], dim=1)
        dh2 = (dso @ fp.ws.T) * (h2 > 0)
        dh1 = (dh2 @ fp.w2.T) * m1
        dx = dh1 @ fp.w1.T + dhc @ fp.wc_x.T
        dx[near] += extra * dx_max
        if not want_wgrad:
            return dx, None
        col = lambda t: t.sum(dim=0, keepdim=True)  # noqa: E731
        return dx, mk.FusedParams(
            w1=x.T @ dh1, b1=col(dh1), w2=h1.T @ dh2, b2=col(dh2),
            ws=h2.T @ dso, bs=col(dso), wc_f=feat.T @ dhc, wc_x=x.T @ dhc,
            bc=col(dhc), wo=hc.T @ dzo, bo=col(dzo))
    x, g, fp = _inputs()
    x_near = x[NEAR].clone()
    dx_max = mk.decoder_bwd_plain(x, g, fp, False, False)[0].abs().max()
    return bwd


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "log", lambda msg: None)
    return monkeypatch


def test_f64_decoder_matches_plain_version():
    """With every mask the sign of its pre-activation, the float64 decoder
    is the plain f32 backward (per-row gradients summed) within f32
    rounding."""
    x, g, fp = _inputs()
    f64 = mk.FusedParams(*[t.double() for t in fp])
    _, dx64, gr64 = cs._f64_decoder(x.double(), g.double(), f64)
    dx, grads = mk.decoder_bwd_plain(x, g, fp, True, False)
    assert (dx64 - dx.double()).abs().max() <= 1e-5 * dx.abs().max()
    for name, a, b in zip(mk.FusedParams._fields, gr64, grads):
        assert a.sum(0).shape == b.shape, name
        assert ((a.sum(0) - b.double()).abs().max()
                <= 1e-5 * b.abs().max()), name


def test_rounding_bounds_hold():
    """Every f32 pre-activation, in the plain version's order and summed
    one term at a time, lies within its bound of the exact value; the
    constructed row's unit is within its bound of 0."""
    x, g, fp = _inputs()
    f64 = mk.FusedParams(*[t.double() for t in fp])
    pre, _, _ = cs._f64_decoder(x.double(), g.double(), f64)
    bounds = cs._f32_rounding_bounds(x.double(), f64, pre)
    h1, h2, feat, _, _, _ = mk.decoder_fwd_plain(x, fp, False)
    f32 = (x @ fp.w1 + fp.b1, h1 @ fp.w2 + fp.b2,
           feat @ fp.wc_f + x @ fp.wc_x + fp.bc)
    for p32, p64, e in zip(f32, pre, bounds):
        assert bool(((p32.double() - p64).abs() <= e).all())
    seq = torch.zeros_like(f32[0])
    for k in range(SIZE[0]):
        seq = seq + x[:, k:k + 1] * fp.w1[k]
    seq = seq + fp.b1
    assert bool(((seq.double() - pre[0]).abs() <= bounds[0]).all())
    assert abs(float(pre[0][NEAR, UNIT])) <= float(bounds[0][NEAR, UNIT])


@pytest.mark.parametrize("wgrad", [True, False])
def test_witness_takes_a_rounding_level_flip(on_cpu, wgrad):
    """A row whose dx misses by a mask flip inside the rounding bound
    passes: the witness finds the masks, and the gradients over all rows
    are held at the tolerance plus that row's terms."""
    x, g, fp = _inputs()
    on_cpu.setattr(mk, "decoder_bwd", _bwd_flipped())
    dx_k, _ = mk.decoder_bwd(x, g, fp, wgrad, False)
    dx_p, _ = mk.decoder_bwd_plain(x, g, fp, False, False)
    row_err = (dx_k - dx_p).abs().amax(1) / dx_p.abs().max()
    assert row_err[NEAR] > cs.TOL_F32_BWD        # the flip shows in dx
    assert int((row_err > cs.TOL_F32_BWD).sum()) == 1
    moved, records = cs._f64_mask_witness(
        "test", x, g, fp, torch.tensor([NEAR]), dx_k, dx_p, wgrad,
        cs.TOL_F32_BWD)
    assert records[0]["ambiguous"][0][:2] == [0, UNIT]
    # the flipped unit's column of w1 and b1 move by that row's whole
    # term; w2 and wo only by the unit's ~0 value carried forward
    assert moved["b1"] > 0
    assert moved["w1"] > 1e3 * max(moved["w2"], moved["wo"])
    assert not records[0]["kernel_true_masks"]
    assert records[0]["plain_true_masks"]
    cs._k3_check("test", x, g, fp, wgrad, False)


@pytest.mark.parametrize("wgrad", [True, False])
def test_witness_refuses_a_wrong_term(on_cpu, wgrad):
    """A row whose dx is off by a term no mask explains fails the check,
    though it is one row of 4,096 (under the 1% share) and its margin is
    under MARGIN_FLIP_F32."""
    x, g, fp = _inputs()
    on_cpu.setattr(mk, "decoder_bwd", _bwd_flipped(flip=False, extra=0.01))
    assert float(cs._margins(mk, x, fp, False)[NEAR]) < cs.MARGIN_FLIP_F32
    with pytest.raises(AssertionError, match="no rounding-level mask flip"):
        cs._k3_check("test", x, g, fp, wgrad, False)


def test_at_size_and_blend_flops():
    """``at_size`` sets the decoder size and the embeddings' width together
    (as ``settings_from_config`` reads both from ``decoder_specs.in_dim``)
    and leaves every other setting; K1's blend flops grow with in_dim."""
    from proudslam_tpu_torch.config import bench_settings

    base = bench_settings()
    s = cs.at_size(base, cs.D32_SIZE)
    assert (s.decoder.in_dim, s.decoder.width, s.decoder.sdf_dim,
            s.map.embed_dim) == (32, 256, 128, 32)
    assert s.render == base.render and s.mapper == base.mapper
    assert s.decoder.matmul_dtype == base.decoder.matmul_dtype
    assert cs.k1_blend_flops(16) == 272
    assert cs.k1_blend_flops(32) == 2 * 8 * 32 + 16
    assert mk.built_size(cs.D32_SIZE) == cs.D32_SIZE
    s = cs.at_size(base, cs.D64_SIZE)
    assert (s.decoder.in_dim, s.map.embed_dim) == (64, 64)
    assert cs.k1_blend_flops(64) == 2 * 8 * 64 + 16
    assert mk.built_size(cs.D64_SIZE) == cs.D64_SIZE
    s = cs.at_size(base, cs.D128_SIZE)
    assert (s.decoder.in_dim, s.decoder.width, s.decoder.sdf_dim,
            s.map.embed_dim) == (128, 256, 128, 128)
    assert cs.k1_blend_flops(128) == 2 * 8 * 128 + 16
    assert mk.built_size(cs.D128_SIZE) == cs.D128_SIZE


def test_size_table(monkeypatch):
    """One log line per kernel and size, joining its times at both shapes
    with its build; a kernel without sizes logs nothing."""
    lines = []
    monkeypatch.setattr(cs, "log", lines.append)
    shape = {"ms": 1.5, "share": 0.25, "bound_ms": 0.375, "plain_ms": 9.0,
             "matmul_chain_ms": 3.0, "dx_only_ms": 1.0, "rows": 64}
    record = {"kernels": [
        {"name": "decoder_backward",
         "sizes": {"32x64x64": {"max_abs_err": 2e-3, "shapes": {
             "mapping": shape, "tracking": dict(shape, ms=0.5)}}},
         "build_by_size": {"32x64x64": {
             "registers": 200, "spill_stores": 0, "spill_loads": 0,
             "HGMMA": 40, "HMMA": 0, "FFMA": 9}}},
        {"name": "fused_render_forward", "build_by_size": {}}]}
    cs.size_table(record)
    assert len(lines) == 1
    head, row = lines[0].split(": ", 1)[0], lines[0].split("32x64x64: ")[1]
    assert head == "size table"
    row = json.loads(row)
    assert row["registers"] == 200 and row["HGMMA"] == 40
    assert row["max_abs_err"] == 2e-3
    assert row["mapping"]["ms"] == 1.5 and row["tracking"]["ms"] == 0.5
    assert row["mapping"]["matmul_chain_ms"] == 3.0
    assert "rows" not in row["mapping"]


def test_wide_sizes_and_sources():
    """The wide sizes and the in_dim-128 ones: built with render_wide.cu and
    mlp_wide.cu, the parked sizes (widths 768 and 1024) with render_park.cu
    and mlp_park.cu (the f32 forms' streamed source at every streamed
    size); the size phases run in full at five slice sizes (the in_dim-16
    and -128 width-256 ones, the wide ones and the widest), reduced at the
    others, which time the kernels at both shapes at the parked sizes and
    at the tracking shape at the older ones (``size_timing``); the three
    wide padded sizes,
    the three in_dim-64 ones, the four in_dim-128 ones and the two parked
    ones pad as stated."""
    wide = [s for s in mk.BUILT_SIZES if mk.wide(s)]
    parked = [s for s in mk.BUILT_SIZES if mk.parked(s)]
    assert len(wide) == 29 and cs.W512_SIZE in wide
    assert cs.PCD_W512_SIZE in wide
    assert parked == list(mk.PARK_SIZES) and cs.W1024_SIZE in parked
    assert cs.FULL_SIZES == {cs.W256_SIZE, cs.D128_SIZE, cs.W512_SIZE,
                             cs.PCD_W512_SIZE, cs.W1024_SIZE}
    assert [s for s in mk.BUILT_SIZES if cs.full_size(s)] == [
        cs.W256_SIZE, cs.PCD_W512_SIZE, cs.W512_SIZE, cs.D128_SIZE,
        cs.W1024_SIZE]
    for size in ((16, 256, 128), (32, 64, 64), (64, 256, 128)):
        assert [cs.stream_library(lib, size) for lib in cs.LIBRARIES] == [
            "render_stream", "mlp_stream", "mlp_stream_f32"]
        assert list(cs.size_timing(size, cs.full_size(size))) == (
            ["mapping", "tracking"] if cs.full_size(size) else ["tracking"])
    for size in [s for s in wide if s not in parked] + list(mk.D128_SIZES):
        assert [cs.stream_library(lib, size) for lib in cs.LIBRARIES] == [
            "render_wide", "mlp_wide", "mlp_stream_f32"]
    for size in parked:
        assert [cs.stream_library(lib, size) for lib in cs.LIBRARIES] == [
            "render_park", "mlp_park", "mlp_stream_f32"]
        assert cs.size_timing(size, False) == {
            "mapping": (cs.PARK_REPS, None),
            "tracking": (cs.REDUCED_REPS, cs.REDUCED_REPS)}
    assert cs.size_timing(cs.W1024_SIZE, True)["mapping"] == (
        cs.PARK_REPS, cs.PARK_REPS)
    assert cs.size_timing(cs.W256_SIZE, True) == {
        "mapping": ({}, {}), "tracking": ({}, {})}
    assert cs.size_timing((32, 64, 64), False) == {
        "tracking": (cs.REDUCED_REPS, None)}
    assert [mk.built_size(s) for s in cs.PAD_SIZES[-12:]] == [
        (16, 384, 256), (32, 512, 512), (16, 384, 384), (64, 64, 64),
        cs.D64_SIZE, (64, 384, 256), (128, 128, 128), cs.D128_SIZE,
        (128, 512, 256), (128, 512, 512), (16, 768, 256), (128, 1024, 1024)]


def _k1_inputs(d, rays=1100, hits=4, samples=40):
    """Stand-in K1 inputs on the CPU: TRACK_RAYS + 76 rays of ``samples``
    samples over ``hits`` slots (== hits: invalid), corners of ``d``
    values."""
    gen = torch.Generator().manual_seed(3)
    c = torch.randint(-3, 4, (rays, hits, 3), generator=gen)
    keys = (((c[..., 0] + 512) << 20) | ((c[..., 1] + 512) << 10)
            | (c[..., 2] + 512)).to(torch.int32)
    corner = c.float()
    bins = torch.randint(0, hits + 1, (rays, samples), generator=gen)
    # sample points inside their slot's voxel, as the sampler places them
    h = bins.clamp_max(hits - 1)
    cen = (torch.gather(corner, 1, h[..., None].expand(-1, -1, 3))
           + torch.rand((rays, samples, 3), generator=gen)) * 0.2
    ro = torch.zeros((rays, 3))
    rd = cen[:, 0] / cen[:, 0].norm(dim=1, keepdim=True).clamp_min(1e-6)
    z = (cen * rd[:, None]).sum(-1)
    return {"rb_by_dim": {d: 0.5 * torch.randn((rays, hits, 8 * d),
                                                 generator=gen)},
            "keys_rb": keys, "bins": bins.to(torch.int32), "z": z,
            "rays_o": ro, "rays_d": rd, "voxel": 0.2}


@pytest.mark.parametrize("full", [True, False])
def test_size_phases_shapes(on_cpu, full):
    """``size_phase`` and ``f32_size_phase`` on CPU tensors (the wrappers'
    plain versions stand in for the kernels, ``_event_ms`` for the
    timing): full, the checks and the plain and chain times at both shapes;
    reduced at a size below width 768, the kernels timed at the tracking
    shape only (no mapping-shape entry, no plain or chain time). Every
    check passes, plain against plain."""
    timed = []
    on_cpu.setattr(cs, "_event_ms", lambda fn, **kw: timed.append(fn) or 1.0)
    size = (16, 64, 64)
    inp = _k1_inputs(size[0])
    out = cs.size_phase(torch.device("cpu"), inp, size, full=full)
    for name in ("fused_render_forward", "decoder_forward",
                 "decoder_backward"):
        shapes = out[name]["shapes"]
        assert shapes["tracking"]["rows"] == cs.TRACK_RAYS * 40
        assert shapes["tracking"]["ms"] == 1.0
        assert (shapes["tracking"]["plain_ms"] is None) == (not full)
        assert ("mapping" in shapes) == full
        if full:
            assert shapes["mapping"]["rows"] == 1100 * 40
            assert shapes["mapping"]["ms"] == 1.0
            assert shapes["mapping"]["plain_ms"] == 1.0
    # K3's two passes are timed apart at each timed shape too
    assert len(timed) == (24 if full else 6)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(0.07 * rng.standard_normal((700, 16)),
                        dtype=torch.float32)
    g = torch.as_tensor(1e-2 * rng.standard_normal((700, 4)),
                        dtype=torch.float32)
    out = cs.f32_size_phase(torch.device("cpu"), x, g, size, 300, full=full)
    for name in ("decoder_forward_f32", "decoder_backward_f32"):
        shapes = out[name]["shapes"]
        assert shapes["tracking"]["rows"] == 300
        assert (shapes["tracking"]["plain_ms"] is None) == (not full)
        assert ("mapping" in shapes) == full
        if full:
            assert shapes["mapping"]["rows"] == 700
            assert shapes["mapping"]["plain_ms"] == 1.0


def _bwd_off_on_kinks(everywhere=False):
    """The plain bf16 backward with dwc_x moved by 5e-2 of its largest
    magnitude when the rows hold one of margin under MARGIN_FLIP (as hc's
    mask flips move it at the wide sizes), or whatever the rows
    (``everywhere``: a fault no flip explains)."""
    def bwd(x, g, fp, want_wgrad=True, bf16=True):
        dx, grads = mk.decoder_bwd_plain(x, g, fp, want_wgrad, bf16)
        kinks = bool((cs._margins(mk, x, fp, bf16) < cs.MARGIN_FLIP).any())
        if grads is not None and (everywhere or kinks):
            grads = grads._replace(
                wc_x=grads.wc_x + 5e-2 * grads.wc_x.abs().max())
        return dx, grads
    return bwd


@pytest.mark.parametrize("everywhere", [False, True])
def test_wide_k3_gradients_on_kink_free_rows(on_cpu, everywhere):
    """K3 at a wide size: a weight gradient off over all rows passes when
    it agrees on the rows of margin >= MARGIN_FLIP (a second launch over
    them), and fails when it is off there too."""
    size = (16, 384, 128)
    fp = cs._decoder_at(torch.device("cpu"), size, 4)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(0.3 * rng.standard_normal((2000, 16)),
                        dtype=torch.float32)
    g = torch.as_tensor(1e-2 * rng.standard_normal((2000, 4)),
                        dtype=torch.float32)
    safe = cs._margins(mk, x, fp, True) >= cs.MARGIN_FLIP
    assert 0 < int(safe.sum()) < 2000
    on_cpu.setattr(mk, "decoder_bwd", _bwd_off_on_kinks(everywhere))
    if everywhere:
        with pytest.raises(AssertionError, match="disagrees"):
            cs._k3_check("test", x, g, fp, True, True)
    else:
        _, rels = cs._k3_check("test", x, g, fp, True, True)
        assert rels["wc_x"] > cs.TOL_GRAD_REL      # off over all rows
    # up to width 256 the gradients over all rows are held as before
    small = cs._decoder_at(torch.device("cpu"), (16, 256, 128), 4)
    with pytest.raises(AssertionError, match="disagrees"):
        cs._k3_check("test", x, g, small, True, True)


@pytest.mark.parametrize("fault", [0.0, 1e-3])
def test_k2_f32_float64_witness(on_cpu, fault):
    """K2-f32 off its plain version beyond TOL_F32_FWD in the sdf column:
    accepted when it is within TOL_F32_FWD of the float64 forward (here a
    stand-in that returns that forward itself, rounded to f32, while the
    plain version is made to drift), refused when it is off that too."""
    fp = cs._decoder_at(torch.device("cpu"), SIZE, 4)
    x = torch.as_tensor(0.07 * np.random.default_rng(3).standard_normal(
        (500, SIZE[0])), dtype=torch.float32)
    f64 = mk.FusedParams(*[t.double() for t in fp])
    _, _, _, sdf_e, _, rgb_e = mk.decoder_fwd_plain(x.double(), f64, False)
    exact = torch.cat([rgb_e, sdf_e], dim=1).float()
    plain = mk.decoder_fwd_plain

    def drifted(xx, ffp, bf16=True):     # f32 only: float64 stays exact
        h1, h2, feat, sdf, hc, rgb = plain(xx, ffp, bf16)
        if xx.dtype == torch.float32:
            sdf = sdf + 5e-5 * sdf.abs().max()
        return h1, h2, feat, sdf, hc, rgb
    on_cpu.setattr(mk, "decoder_fwd_plain", drifted)

    def kernel(xx, ffp, bf16=True):
        out = exact.clone()
        out[:, 3] += fault * out[:, 3].abs().max()
        return out
    on_cpu.setattr(mk, "decoder_fwd", kernel)
    if fault:
        with pytest.raises(AssertionError, match="disagrees"):
            cs._k2_check("test", x, fp, False, cs.TOL_F32_FWD)
    else:
        cs._k2_check("test", x, fp, False, cs.TOL_F32_FWD)
    with pytest.raises(AssertionError, match="disagrees"):
        cs._k2_check("test", x, fp, True, cs.TOL_F32_FWD)   # bf16: no witness


@pytest.mark.parametrize("rows", [700, 4096])
@pytest.mark.parametrize("size", cs.WGRAD_SIZES)
def test_wgrad_check_on_the_first_chunk(on_cpu, size, rows):
    """``wgrad_check`` on CPU tensors (the wrappers' plain versions stand
    in for the kernel and the reduce) holds each size of one plan on the
    rows of the first chunk K3 makes of the inputs, every row here, with
    the wrapper's splits, plain against plain."""
    on_cpu.setattr(cs, "WGRAD_SIZES", (size,))
    rng = np.random.default_rng(2)
    x = torch.as_tensor(0.3 * rng.standard_normal((rows, 16)),
                        dtype=torch.float32)
    g = torch.as_tensor(1e-2 * rng.standard_normal((rows, 4)),
                        dtype=torch.float32)
    fp0 = cs._decoder_at(torch.device("cpu"), (16, 128, 128), 4)
    st = cs.wgrad_check(torch.device("cpu"), x, g, fp0)[cs._size_tag(size)]
    assert st["rows"] == mk.wgrad_plan(size, rows, 1).chunk_rows == rows
    assert (st["splits"], st["per_split"]) == mk.wgrad_splits(size, rows, 1)
    assert max(st["rel_err"].values()) <= 1e-6


@pytest.mark.parametrize("size", [(16, 64, 64), (32, 64, 64),
                                  (16, 256, 128)])
def test_pass2_timed_on_the_rows_operands(on_cpu, size):
    """``_k3_pass_ms`` times pass 2 on each chunk's operands as pass 1
    stores them (not on a scratch of zeros): the scratches it hands
    ``decoder_wgrad`` are the packed plain operands of the rows."""
    seen = []
    real = mk.decoder_wgrad

    def wgrad(scratch, *a):
        seen.append(scratch)
        real(scratch, *a)
    on_cpu.setattr(mk, "decoder_wgrad", wgrad)
    on_cpu.setattr(cs, "_event_ms", lambda fn, **kw: [fn(), 1.0][1])
    rng = np.random.default_rng(3)
    x = torch.as_tensor(0.3 * rng.standard_normal((1000, size[0])),
                        dtype=torch.float32)
    g = torch.as_tensor(1e-2 * rng.standard_normal((1000, 4)),
                        dtype=torch.float32)
    fp = cs._decoder_at(torch.device("cpu"), size, 4)
    assert cs._k3_pass_ms(x, g, fp, {}) == (1.0, 1.0)
    want = mk.pack_operands(mk.decoder_bwd_operands_plain(x, g, fp))
    assert len(seen) == 1 and torch.equal(seen[0], want)
    assert bool(want.abs().max() > 0)
