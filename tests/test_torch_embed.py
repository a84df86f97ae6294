"""Decoder architectures parity: the port's input embedders (identity,
NeRF, Gaussian Fourier) and skip connections against the JAX package's
``models/decoder.py``, at bf16 and f32 matmul operands: ``embedded_size``,
``embed_input``, the parameter shapes of ``init_decoder`` (the Gaussian
embedder's ``gaussian_B`` leaf included, in JAX's leaf order),
``decoder_values`` and its gradients w.r.t. every parameter and the input;
the unfused ``render_rays`` with the NeRF embedder and a skip; and the
checkpoint interchange of a decoder that holds ``gaussian_B``.

Tolerances: the embedding 1e-6 of its largest magnitude (sin/cos of two
libraries), the Gaussian one 5e-5 (its product's f32 sums, in another
order, reach |x @ B| ~ 40, where an ulp is 4e-6, before the sine); with f32
operands the decoder's outputs 1e-5 and its gradients 1e-4 of each one's
largest magnitude; with bf16 operands an embedded value one ulp apart can
round to the neighbouring bf16 value, so outputs 2e-3 and gradients 5e-3
of each one's largest magnitude (``test_torch_renderer.py``'s bf16
tolerances). The render case takes ``test_torch_renderer.py``'s unfused
tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.config import DecoderSettings, LossSettings
from proudslam_tpu.engine.slam import SlamSystem as JSlam
from proudslam_tpu.models import decoder as jd
from proudslam_tpu.render.losses import compute_loss as j_loss
from proudslam_tpu.render.renderer import render_rays as j_render
from proudslam_tpu.utils import checkpoint as jck
from proudslam_tpu_torch.engine.slam import SlamSystem as TSlam
from proudslam_tpu_torch.models import decoder as td
from proudslam_tpu_torch.render import losses as tl
from proudslam_tpu_torch.render import renderer as tr
from proudslam_tpu_torch.utils import checkpoint as tck

from test_torch_checkpoint import _assert_leaves_equal, _jax_leaves
from test_torch_refine import unfused_settings
from test_torch_renderer import UNFUSED_TOL, case  # noqa: F401
from torch_parity import (RENDER, assert_close_scaled, n, port, port_system,
                          t)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EMBEDDERS = ("none", "nerf", "gaussian")
TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-3, 5e-3)}


def dec_settings(embedder, skips, dtype="f32"):
    return DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64,
                           matmul_dtype=dtype, use_fused_mlp=True,
                           embedder=embedder, multires=4, skips=skips)


def _inputs(rows=300, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (rows, 16))).astype(np.float32)


def _leaf_shapes(tree):
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("embedder", EMBEDDERS)
def test_embedding_and_init_match(embedder):
    dec = dec_settings(embedder, (0,))
    assert td.embedded_size(port(dec)) == jd.embedded_size(dec)
    jp = jd.init_decoder(jax.random.PRNGKey(1), dec)
    tp = td.init_decoder(torch.Generator().manual_seed(1),
                         port(dec), "cpu")
    assert sorted(tp) == sorted(jp)
    assert [tuple(x.shape) for x in td.tree_leaves(tp)] == _leaf_shapes(jp)
    x = _inputs()
    want = jd.embed_input(dec, jp, jnp.asarray(x))
    got = td.embed_input(port(dec), td.params_from_jax(jp, device="cpu"),
                         t(x))
    assert got.shape == (x.shape[0], jd.embedded_size(dec))
    assert_close_scaled(got, want, 5e-5 if embedder == "gaussian" else 1e-6,
                        "embed_input")
    if embedder == "gaussian":     # 25 * N(0, 1), as the JAX package draws
        assert 20.0 < float(tp["gaussian_B"].std()) < 30.0


def test_unknown_embedder_raises():
    dec = port(dec_settings("siren", ()))
    with pytest.raises(ValueError, match="siren"):
        td.embedded_size(dec)
    with pytest.raises(ValueError, match="siren"):
        td.embed_input(dec, {}, t(_inputs(4)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("skips", [(), (0,)], ids=["noskip", "skip0"])
@pytest.mark.parametrize("embedder", EMBEDDERS)
def test_decoder_values_and_grads_match(embedder, skips, dtype):
    """Outputs and gradients w.r.t. every parameter (``gaussian_B``
    included) and the input."""
    dec = dec_settings(embedder, skips, dtype)
    jp = jd.init_decoder(jax.random.PRNGKey(2), dec)
    x = _inputs(seed=1)
    g = np.random.default_rng(3).standard_normal((x.shape[0], 4)).astype(
        np.float32)

    def jf(p, x_):
        out = jd.decoder_values(p, dec, x_)
        return jnp.sum(out * g), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = td.params_from_jax(jp, device="cpu")
    leaves = td.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    x_t = t(x).requires_grad_(True)
    out_t = td.decoder_values(tp, port(dec), x_t)
    (out_t * t(g)).sum().backward()

    tol_out, tol_grad = TOL[dtype]
    assert_close_scaled(out_t, out_j, tol_out, "decoder_values")
    assert_close_scaled(x_t.grad, gx_j, tol_grad, "d_x")
    j_leaves = jax.tree.leaves(gp_j)
    assert len(leaves) == len(j_leaves)
    for a, b in zip(leaves, j_leaves):
        assert_close_scaled(a.grad, b, tol_grad, "params")
    if embedder == "gaussian":
        assert float(np.abs(n(tp["gaussian_B"].grad)).max()) > 0


def test_skip_and_color_head_take_the_embedded_input():
    """With the NeRF embedder, the skip and the color head concatenate the
    EMBEDDED input (80 columns here), not the raw 16-column features."""
    dec = dec_settings("nerf", (0,))
    jp = jd.init_decoder(jax.random.PRNGKey(4), dec)
    assert jp["layers"][1]["w"].shape[0] == 64 + 16 * 9
    assert jp["color0"]["w"].shape[0] == 64 + 16 * 9
    x = _inputs(seed=5)
    want = jd.decoder_values(jp, dec, jnp.asarray(x))
    got = td.decoder_values(td.params_from_jax(jp, device="cpu"), port(dec),
                            t(x))
    assert_close_scaled(got, want, 1e-5, "decoder_values")


def test_unfused_render_rays_with_nerf_match(case):  # noqa: F811
    """``render_rays`` with the NeRF embedder and a skip (which the fused
    gate sends to the unfused branch in both packages): outputs, loss and
    gradients w.r.t. embeddings, rays and decoder params."""
    state, _, o, d, noise, gt_c, gt_d = case
    dec = dec_settings("nerf", (0,), "f32")
    params = jd.init_decoder(jax.random.PRNGKey(1), dec)
    ls = LossSettings()

    def jf(emb, o_, d_, p):
        out = j_render(o_, d_, state, emb, p, dec, RENDER, jnp.asarray(noise))
        loss, _ = j_loss(out, jnp.asarray(gt_c), jnp.asarray(gt_d), ls,
                         weight_depth_loss=True)
        return loss, out

    (lj, out_j), gj = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(
        state.embeddings, jnp.asarray(o), jnp.asarray(d), params)

    ts = td.map_state_from_numpy(state, device="cpu")
    emb = ts.embeddings.clone().requires_grad_(True)
    o_t = t(o).requires_grad_(True)
    d_t = t(d).requires_grad_(True)
    p_t = td.params_from_jax(params, device="cpu")
    for p in td.tree_leaves(p_t):
        p.requires_grad_(True)
    out_t = tr.render_rays(o_t, d_t, ts, emb, p_t, port(dec), port(RENDER),
                           t(noise))
    lt, _ = tl.compute_loss(out_t, t(gt_c), t(gt_d), port(ls),
                            weight_depth_loss=True)
    lt.backward()

    tol_out, tol_loss, tol_grad = UNFUSED_TOL["f32"]
    assert n(out_j.hit_mask).mean() > 0.5
    np.testing.assert_array_equal(n(out_t.sample_mask), n(out_j.sample_mask))
    for f in ("color", "depth", "sdf", "weights"):
        np.testing.assert_allclose(n(getattr(out_t, f)),
                                   n(getattr(out_j, f)), atol=tol_out,
                                   err_msg=f)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol_loss)
    assert_close_scaled(emb.grad, gj[0], tol_grad, "d_embeddings")
    assert_close_scaled(o_t.grad, gj[1], tol_grad, "d_o")
    assert_close_scaled(d_t.grad, gj[2], tol_grad, "d_d")
    for a, b in zip(td.tree_leaves(p_t), jax.tree.leaves(gj[3])):
        assert_close_scaled(a.grad, b, tol_grad, "params")


def test_checkpoint_with_gaussian_B_interchanges(tmp_path):
    """A system whose decoder holds ``gaussian_B`` (and its Adam moments):
    JAX save -> port load, port save -> JAX load, leaf for leaf; a port
    round trip bit for bit."""
    from proudslam_tpu.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=1, width=32, height=24)
    s = unfused_settings()
    s = dataclasses.replace(s, decoder=dataclasses.replace(
        s.decoder, embedder="gaussian"))
    hw = (ds.height, ds.width)
    js = JSlam(s, ds.intrinsics, hw, seed=0)
    assert "gaussian_B" in js.decoder_params
    # distinct Adam moments, so a misplaced leaf shows
    js.opt = js.opt._replace(decoder=jax.tree.map(
        lambda a: a + 0.5 if a.ndim else a, js.opt.decoder))
    jck.save_checkpoint(str(tmp_path / "j"), js)
    ts = tck.load_checkpoint(str(tmp_path / "j"),
                             TSlam(port_system(s), ds.intrinsics, hw, seed=4,
                                   device="cpu"))
    _assert_leaves_equal(tck._leaves(ts), _jax_leaves(js))
    np.testing.assert_array_equal(n(ts.decoder_params["gaussian_B"]),
                                  np.asarray(js.decoder_params["gaussian_B"]))
    ts.decoder_params["gaussian_B"] += 0.25
    tck.save_checkpoint(str(tmp_path / "t"), ts)
    j2 = jck.load_checkpoint(str(tmp_path / "t"),
                             JSlam(s, ds.intrinsics, hw, seed=1))
    _assert_leaves_equal(_jax_leaves(j2), tck._leaves(ts))
    t2 = tck.load_checkpoint(str(tmp_path / "t"),
                             TSlam(port_system(s), ds.intrinsics, hw, seed=7,
                                   device="cpu"))
    _assert_leaves_equal(tck._leaves(t2), tck._leaves(ts))
