"""The decoder widths 768 and 1024: the parked plan's sizes.

The CUDA kernels are built at six sizes of width 768 or 1024
(``mlp_kernel.PARK_SIZES``) and take every other size with in_dim <= 128
and width, sdf_dim <= 1024 zero-padded to one of them. Here, on the CPU,
the plain versions at a built size, (16, 768, 256), and on params padded
from (16, 600, 300) to (16, 768, 768) are held against the JAX package's
Pallas kernels in interpret mode at the unpadded size: K2 (``_run_fwd``)
and K3 (``_run_bwd``) at bf16 and f32 operands on 2048 rows of N(0, 1)
inputs made from a numpy seed, bf16 1e-3 and f32 1e-5 of each output's
largest magnitude (f32 summation order only: the rounding points are the
same), K3 on the rows of margin (``torch_parity.flipped_rows_zeroed``, as
at every wide size); K1's plain version (``fused_render_forward_plain``)
at the padded size against the Pallas ``fused_render_forward``. Also:
``built_size`` on sizes above width 512, the ``pad_params`` /
``unpad_params`` round trip, and the refusal of width or sdf_dim 1025 and
of in_dim 129, naming the form.
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
                          flipped_rows_zeroed, map_coords, n,
                          one_torch_thread, port, ray_batch, t)  # noqa: F401

FWD_TOL = {"bf16": 1e-3, "f32": 1e-5}
BUILT = (16, 768, 256)
PADDED = (16, 600, 300)


def _tag(size):
    return "x".join(map(str, size))


@pytest.fixture(scope="module", params=[BUILT, PADDED], ids=_tag)
def case(request, one_torch_thread):
    """(size, its settings, JAX params, the built size, the port's packed
    params padded to it)."""
    d, w, sd = size = request.param
    dec = DecoderSettings(depth=2, width=w, in_dim=d, sdf_dim=sd,
                          matmul_dtype="bf16", use_fused_mlp=True)
    params = j_init(jax.random.PRNGKey(0), dec)
    fp = tmk.pack_params(params_from_jax(params, device="cpu"), port(dec))
    built = tmk.built_size(size)
    return dict(size=size, dec=dec, params=params, built=built,
                fpb=tmk.pad_params(fp, built))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fwd_plain_matches_pallas(case, dtype):
    d = case["size"][0]
    x = np.random.default_rng(5).standard_normal(
        (jmk.TILE, d)).astype(np.float32)
    jfp = jmk.pack_params(case["params"], case["dec"])
    a = jmk._run_fwd(jnp.asarray(x), jfp, interpret=True, bf16=dtype == "bf16")
    _, _, _, sdf, _, rgb = tmk.decoder_fwd_plain(
        tmk.pad_rows(t(x), case["built"][0]), case["fpb"], dtype == "bf16")
    assert_close_scaled(torch.cat([rgb, sdf], dim=1), a, FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bwd_plain_matches_pallas(case, dtype):
    """dx and the 11 gradients, sliced back from the built size, on the
    rows of margin; the padded entries are exactly 0."""
    size, built = case["size"], case["built"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((jmk.TILE, size[0])).astype(np.float32)
    g = rng.standard_normal((jmk.TILE, 4)).astype(np.float32)
    bf16 = dtype == "bf16"
    tol = FWD_TOL[dtype]
    jfp = jmk.pack_params(case["params"], case["dec"])

    def both(g):
        outs = jmk._run_bwd(jnp.asarray(x), jnp.asarray(g), jfp,
                            interpret=True, bf16=bf16)
        return outs, tmk.decoder_bwd_plain(tmk.pad_rows(t(x), built[0]),
                                           t(g), case["fpb"], bf16=bf16)
    outs, (dx_b, _) = both(g)
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


def test_k1_plain_matches_pallas(one_torch_thread):
    """K1's plain version on the padded params at (16, 768, 768) against
    the Pallas ``fused_render_forward`` at (16, 600, 300): features 1e-5,
    outputs 1e-3."""
    d, w, sd = PADDED
    dec = DecoderSettings(depth=2, width=w, in_dim=d, sdf_dim=sd,
                          matmul_dtype="bf16", use_fused_mlp=True)
    params = j_init(jax.random.PRNGKey(0), dec)
    built = tmk.built_size(PADDED)
    fpb = tmk.pad_params(tmk.pack_params(
        params_from_jax(params, device="cpu"), port(dec)), built)
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
        params, RENDER, dec, interpret=True)
    out_t, feats_t = trk.fused_render_forward_plain(
        t(n(rb)), t(n(keys_rb)), t(n(bins)), t(n(smp.depth)), t(o), t(dirs),
        fpb, RENDER.voxel_size)
    assert float(np.abs(n(feats_j)).max()) > 0.1
    np.testing.assert_allclose(n(feats_t), n(feats_j), atol=1e-5)
    np.testing.assert_allclose(n(out_t), n(out_j), atol=1e-3)


@pytest.mark.parametrize("size,built", [
    ((16, 600, 300), (16, 768, 768)), ((16, 700, 200), (16, 768, 256)),
    ((100, 600, 100), (128, 768, 768)), ((40, 900, 1000), (128, 1024, 1024)),
    ((16, 1024, 1024), (16, 1024, 1024)), ((16, 513, 1), (16, 768, 256)),
    ((16, 769, 1), (16, 1024, 512)), ((1, 1, 513), (16, 768, 768)),
    ((16, 1000, 600), (16, 1024, 1024)), ((17, 513, 1), (128, 768, 768)),
    ((128, 1024, 769), (128, 1024, 1024)), ((16, 512, 512), (16, 512, 512))])
def test_built_size_above_512(size, built):
    """The covering built size with the fewest forward flops a row: above
    width or sdf_dim 512 one of the six PARK_SIZES (in_dim 17 to 128 at
    the in_dim-128 ones); the sizes up to 512 keep theirs."""
    assert tmk.built_size(size) == built
    assert tmk.parked(built) == (built[1] > 512)


@pytest.mark.parametrize("size", [(16, 600, 300), (40, 900, 1000),
                                  (128, 1024, 1024)], ids=_tag)
def test_pad_roundtrip(size):
    """``pad_params`` to the built size and ``unpad_params`` back: bit for
    bit, the padded entries exactly 0 and the sdf column last."""
    d, w, sd = size
    rng = np.random.default_rng(sum(size))
    fp = tmk.FusedParams(*[t(rng.standard_normal(s).astype(np.float32))
                           for s in tmk.param_shapes(size)])
    built = tmk.built_size(size)
    fpb = tmk.pad_params(fp, built)
    assert tmk.params_size(fpb) == built
    assert all(torch.equal(a, b)
               for a, b in zip(tmk.unpad_params(fpb, size), fp))
    sd_b = built[2]
    assert torch.equal(fpb.ws[:w, sd_b], fp.ws[:, sd])
    assert not fpb.ws[:, sd:sd_b].any() and not fpb.w2[w:].any()
    assert not fpb.w1[d:].any() and not fpb.wc_f[sd:].any()
    assert (int(fpb.w2.ne(0).sum()) == w * w
            and int(fpb.bs.ne(0).sum()) == sd + 1)


@pytest.mark.parametrize("form", tmk.FORMS)
def test_refused_above_the_end(form):
    """Every form takes width and sdf_dim up to 1024 and in_dim up to 128,
    built or padded, and refuses 1025 and in_dim 129 naming the form."""
    for size in ((16, 1024, 1024), (128, 1024, 1024), (40, 900, 1000),
                 (128, 1, 1024), (1, 1024, 1)):
        tmk.check_size(size, form)
    for size in ((16, 1025, 64), (16, 64, 1025), (129, 64, 64),
                 (128, 1025, 1025)):
        with pytest.raises(ValueError,
                           match=f"{form}.*width, sdf_dim <= 1024"):
            tmk.check_size(size, form)


@pytest.mark.parametrize("mode,dtype,form", [
    ("vox", "bf16", "K1"), ("pcd", "bf16", "K2"), ("pcd", "f32", "K2-f32")])
def test_config_refused_above_the_end(mode, dtype, form):
    """``check_kernel_sizes`` (which ``run_slam.check_config`` and
    ``SlamSystem`` call on a CUDA device) takes a fused configuration at
    (16, 1024, 1024) and refuses width 1025, sdf_dim 1025 and in_dim 129
    before it runs, naming the first form the path launches."""
    base = port(DecoderSettings(depth=2, width=1024, in_dim=16,
                                sdf_dim=1024, matmul_dtype=dtype,
                                use_fused_mlp=True))
    tmk.check_kernel_sizes(base, mode)
    for kw in (dict(width=1025), dict(sdf_dim=1025), dict(in_dim=129)):
        with pytest.raises(ValueError, match=form):
            tmk.check_kernel_sizes(dataclasses.replace(base, **kw), mode)
