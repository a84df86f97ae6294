"""Decoder sizes the CUDA kernels take by zero padding.

On the card a decoder size that no kernel is built for (in_dim <= 128,
width and sdf_dim <= 1024) runs the kernels at ``mlp_kernel.built_size`` on
zero-padded inputs and params (``pad_params``), and the outputs and
gradients are sliced back (``unpad_params``). Here the plain versions run
that way on the CPU, on the padded params at the built size, and are held
against the JAX package's Pallas kernels in interpret mode at the unpadded
size: K2 (``_run_fwd``) and K3 (``_run_bwd``) at bf16 and f32 operands,
K1 (``fused_render_forward``, bf16 operands) on features of in_dim
columns. Tolerances are those of the unpadded parity tests
(``test_torch_mlp_kernel.py``, ``test_torch_render_kernel.py``): padding
adds exact zeros to every real sum, so only f32 summation order differs.
And every padded gradient entry is exactly 0, so re-padding the sliced
gradients gives the padded ones bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.config import DecoderSettings
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.interp import corner_view as j_corner_view
from proudslam_tpu.ops.intersect import ray_intersect as j_intersect
from proudslam_tpu.ops.pallas import mlp_kernel as jmk
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu.ops.sampling import sample_rays_in_segments as j_sample
from proudslam_tpu_torch.models.decoder import params_from_jax
from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk
from proudslam_tpu_torch.ops.kernels import render_kernel as trk

from torch_parity import (MAP, RENDER, assert_close_scaled,
                          flipped_rows_zeroed, map_coords, n, port,
                          ray_batch, t)

FWD_TOL = {"bf16": 1e-3, "f32": 1e-5}
# (in_dim, width, sdf_dim) -> the built size that runs it
PADDED = {(8, 40, 24): (16, 64, 64), (16, 100, 72): (16, 128, 128),
          (12, 64, 192): (16, 192, 192), (16, 200, 256): (16, 256, 256),
          (24, 100, 72): (32, 128, 128), (20, 40, 24): (32, 64, 64),
          (16, 300, 200): (16, 384, 256), (24, 450, 500): (32, 512, 512),
          (16, 64, 320): (16, 384, 384), (48, 64, 64): (64, 64, 64),
          (40, 100, 72): (64, 128, 128), (100, 64, 64): (128, 128, 128),
          (72, 300, 200): (128, 512, 256), (16, 700, 200): (16, 768, 256)}


def _tag(size):
    return "x".join(map(str, size))


@pytest.fixture(scope="module", params=list(PADDED), ids=_tag)
def padded(request):
    """(size, JAX params, the port's packed params, built size, the packed
    params padded to it)."""
    d, w, sd = size = request.param
    dec = DecoderSettings(depth=2, width=w, in_dim=d, sdf_dim=sd,
                          matmul_dtype="bf16", use_fused_mlp=True)
    params = j_init(jax.random.PRNGKey(0), dec)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))
    built = tmk.built_size(size)
    return dict(size=size, dec=dec, params=params, fp=fp, built=built,
                fpb=tmk.pad_params(fp, built))


def test_built_size_and_roundtrip(padded):
    """``built_size`` maps the case as stated; the padded params have the
    built size's shapes and slice back to the params bit for bit."""
    assert padded["built"] == PADDED[padded["size"]]
    fpb = padded["fpb"]
    assert tmk.params_size(fpb) == padded["built"]
    back = tmk.unpad_params(fpb, padded["size"])
    assert all(torch.equal(a, b) for a, b in zip(back, padded["fp"]))
    # the sdf column stays last, the padded feature columns are zeros
    _, w, sd = padded["size"]
    sd_b = padded["built"][2]
    assert torch.equal(fpb.ws[:w, sd_b], padded["fp"].ws[:, sd])
    assert torch.equal(fpb.bs[:, sd_b], padded["fp"].bs[:, sd])
    assert not fpb.ws[:, sd:sd_b].any() and not fpb.bs[:, sd:sd_b].any()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_padded_fwd_matches_pallas(padded, dtype):
    d = padded["size"][0]
    x = np.random.default_rng(5).standard_normal(
        (jmk.TILE, d)).astype(np.float32)
    jfp = jmk.pack_params(padded["params"], padded["dec"])
    a = jmk._run_fwd(jnp.asarray(x), jfp, interpret=True, bf16=dtype == "bf16")
    _, _, _, sdf, _, rgb = tmk.decoder_fwd_plain(
        tmk.pad_rows(t(x), padded["built"][0]), padded["fpb"],
        dtype == "bf16")
    b = torch.cat([rgb, sdf], dim=1)
    assert b.shape == (jmk.TILE, 4)
    assert_close_scaled(b, a, FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_padded_bwd_matches_pallas(padded, dtype):
    """K3 at the built size on padded inputs, sliced back, against
    ``_run_bwd`` at the unpadded size (bf16: 1e-3 as the unpadded
    ``test_decoder_bwd_plain_matches_pallas``; f32: 1e-5), at a wide built
    size with the rows whose dx misses (ReLU-mask flips, at most FLIP_SHARE
    of them) zeroed in a second run (``flipped_rows_zeroed``); the padded
    entries of dx and of every gradient are exactly 0."""
    size, built = padded["size"], padded["built"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((jmk.TILE, size[0])).astype(np.float32)
    g = rng.standard_normal((jmk.TILE, 4)).astype(np.float32)
    bf16 = dtype == "bf16"
    jfp = jmk.pack_params(padded["params"], padded["dec"])

    def both(g):
        outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp,
                            interpret=True, bf16=bf16)
        return outs, tmk.decoder_bwd_plain(tmk.pad_rows(t(x), built[0]),
                                           t(g), padded["fpb"], bf16=bf16)
    outs, (dx_b, grads_b) = both(g)
    tol = 1e-3 if bf16 else FWD_TOL[dtype]
    if tmk.wide(built):
        outs, (dx_b, grads_b) = both(
            flipped_rows_zeroed(dx_b[:, :size[0]], outs[0], g, tol))
    assert_close_scaled(dx_b[:, :size[0]], outs[0], tol, "dx")
    grads = tmk.unpad_params(grads_b, size)
    for name, a, b in zip(jmk.FusedParams._fields, grads, outs[1:]):
        assert a.shape == b.shape, name
        assert_close_scaled(a, b, tol, name)
    assert not dx_b[:, size[0]:].any()
    again = tmk.pad_params(grads, built)
    assert all(torch.equal(a, b) for a, b in zip(again, grads_b))


def test_padded_k1_matches_pallas(padded):
    """K1's plain version on corner features padded from in_dim to the
    built in_dim (16, 32, 64 or 128) and the padded params, ``feats``
    sliced back, against the Pallas ``fused_render_forward`` at the
    unpadded size."""
    size, built = padded["size"], padded["built"]
    d = size[0]
    mp = dataclasses.replace(MAP, embed_dim=d)
    state = jvh.build_map_state_numpy(map_coords(0), mp)
    emb = (0.5 * np.random.default_rng(5).standard_normal(
        state.embeddings.shape)).astype(np.float32)
    state = state._replace(embeddings=jnp.asarray(emb))
    V = state.voxel_keys.shape[0]
    centers = (jvh.unpack_key(state.voxel_keys).astype(jnp.float32)
               + 0.5) * mp.voxel_size
    R = 40
    o, dirs = ray_batch(R, 2)
    inter = j_intersect(jnp.asarray(o), jnp.asarray(dirs), centers,
                        jnp.arange(V) < state.num_voxels, RENDER, exact=True)
    noise = np.random.default_rng(3).random(
        (R, RENDER.max_samples - RENDER.max_hits)).astype(np.float32)
    smp = j_sample(inter, RENDER, jnp.asarray(noise))
    H = RENDER.max_hits
    vidx = jnp.maximum(inter.voxel_idx, 0)
    bins = jnp.where(smp.voxel_idx >= 0, smp.bin, H).astype(jnp.int32)
    rb = j_corner_view(state.embeddings, state.voxel_vertex_ids, None)[vidx]
    keys_rb = state.voxel_keys[vidx]
    out_j, feats_j = jrk.fused_render_forward(
        rb, keys_rb, bins, smp.depth, jnp.asarray(o), jnp.asarray(dirs),
        padded["params"], RENDER, padded["dec"], interpret=True)
    rb_t = t(n(rb))
    rb_b = torch.nn.functional.pad(rb_t.reshape(R, H, 8, d),
                                   (0, built[0] - d)).reshape(R, H, -1)
    out_t, feats_b = trk.fused_render_forward_plain(
        rb_b, t(n(keys_rb)), t(n(bins)), t(n(smp.depth)), t(o), t(dirs),
        padded["fpb"], RENDER.voxel_size)
    assert float(np.abs(n(feats_j)).max()) > 0.1
    assert not feats_b[:, d:].any()
    np.testing.assert_allclose(n(feats_b[:, :d]), n(feats_j), atol=1e-5)
    np.testing.assert_allclose(n(out_t), n(out_j), atol=1e-3)


def test_cpu_wrappers_run_plain_unpadded(padded):
    """On CPU tensors the wrappers run the plain versions at the true size
    (no padding, no launch): the same outputs as the padded plain versions
    within f32 summation order, the exact zeros aside."""
    size, built = padded["size"], padded["built"]
    rng = np.random.default_rng(9)
    x = t(rng.standard_normal((100, size[0])).astype(np.float32))
    g = t(rng.standard_normal((100, 4)).astype(np.float32))
    before = (tmk.decoder_fwd_f32.launches, tmk.decoder_bwd_f32.launches)
    out = tmk.decoder_fwd(x, padded["fp"], bf16=False)
    dx, grads = tmk.decoder_bwd(x, g, padded["fp"], bf16=False)
    assert (tmk.decoder_fwd_f32.launches,
            tmk.decoder_bwd_f32.launches) == before
    assert out.shape == (100, 4) and dx.shape == x.shape
    assert tmk.params_size(grads) == size
    _, _, _, sdf, _, rgb = tmk.decoder_fwd_plain(
        tmk.pad_rows(x, built[0]), padded["fpb"], False)
    assert_close_scaled(out, torch.cat([rgb, sdf], dim=1), 1e-6)
    dx_b, grads_b = tmk.decoder_bwd_plain(tmk.pad_rows(x, built[0]), g,
                                          padded["fpb"], bf16=False)
    assert_close_scaled(dx, dx_b[:, :size[0]], 1e-6, "dx")
    for name, a, b in zip(tmk.FusedParams._fields, grads,
                          tmk.unpad_params(grads_b, size)):
        assert_close_scaled(a, b, 1e-6, name)
