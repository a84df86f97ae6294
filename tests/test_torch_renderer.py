"""Render + loss parity: the port's ``render_rays`` and ``compute_loss``
against the JAX package's with its fused Pallas branches forced on
(interpret mode, as ``tests/test_fused_render.py`` does), on the same map,
rays and noise. Outputs and the gradients the SLAM loops consume
(embeddings for mapping, ray origins/directions for tracking, decoder
params) are compared, for the vox branch (kernel K1; also at the
reference's wider decoder, (in_dim, width, sdf_dim) = (16, 256, 128),
which the CUDA kernels take through their streamed plan), the unfused vox
branch (``use_fused_mlp=False``: ``gather_ray_features`` + the plain
decoder, at f32 and bf16 decoder operands) and the pcd branch (PointNet
features, kernels K2/K3; there the PointNet params' gradients too). The JAX pcd branch reaches K2 only on a TPU backend, so
``fused_applicable`` is patched to skip that check and
``decoder_values_fused`` to run in interpret mode.

Tolerances: rendered color/depth/sdf 2e-3 (bf16 decoder operands in both,
f32 summation order differs); loss 1e-3 relative; gradients 5e-3 of each
gradient's largest magnitude (the same, through the normalized weights).
The unfused branch with f32 operands has no bf16 rounding to flip: 1e-4
on outputs, 1e-5 relative on the loss, 1e-4 of each gradient's largest
magnitude.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.config import LossSettings
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.models.pointnet import init_pointnet as j_init_pn
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.pallas import mlp_kernel as jmk
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu.render import pcd_features as jpf
from proudslam_tpu.render.losses import compute_loss as j_loss
from proudslam_tpu.render.renderer import render_rays as j_render
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax,
                                                point_store_from_numpy,
                                                tree_leaves)
from proudslam_tpu_torch.render import losses as tl
from proudslam_tpu_torch.render import renderer as tr

from torch_parity import (DEC, MAP, RENDER, SIZED_DEC, assert_close_scaled,
                          map_coords, n, port, ray_batch, t)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def case(monkeypatch):
    monkeypatch.setattr(jrk, "fused_render_applicable",
                        lambda dec: dec.use_fused_mlp and dec.depth == 2
                        and not dec.skips and dec.embedder == "none")
    state = jvh.build_map_state_numpy(map_coords(0), MAP)
    emb = (0.3 * np.random.default_rng(5).standard_normal(
        state.embeddings.shape)).astype(np.float32)
    state = state._replace(embeddings=jnp.asarray(emb))
    params = j_init(jax.random.PRNGKey(1), DEC)
    R = 48
    o, d = ray_batch(R, 2)
    noise = np.random.default_rng(3).random(
        (R, RENDER.max_samples - RENDER.max_hits)).astype(np.float32)
    gt_c = np.random.default_rng(4).random((R, 3)).astype(np.float32)
    gt_d = np.random.default_rng(6).uniform(0.5, 1.5, R).astype(np.float32)
    return state, params, o, d, noise, gt_c, gt_d


UNFUSED_TOL = {"f32": (1e-4, 1e-5, 1e-4), "bf16": (2e-3, 1e-3, 5e-3)}


@pytest.mark.parametrize("depth_variance,dec", [
    (False, DEC), (True, DEC),
    (True, dataclasses.replace(DEC, use_fused_mlp=False,
                               matmul_dtype="f32")),
    (True, dataclasses.replace(DEC, use_fused_mlp=False)),
    (True, SIZED_DEC["16x256x128"])],
    ids=["False", "True", "unfused-f32", "unfused-bf16", "fused-16x256x128"])
def test_render_and_loss_match(case, depth_variance, dec):
    if (dec.width, dec.sdf_dim) != (DEC.width, DEC.sdf_dim):
        case = case[:1] + (j_init(jax.random.PRNGKey(1), dec),) + case[2:]
    _check_render_and_loss(case, depth_variance, dec, RENDER)


def _check_render_and_loss(case, depth_variance, dec, rnd):
    state, params, o, d, noise, gt_c, gt_d = case
    ls = LossSettings()
    ray_w = np.linspace(0.2, 1.0, o.shape[0]).astype(np.float32)
    tol_out, tol_loss, tol_grad = (UNFUSED_TOL[dec.matmul_dtype]
                                   if not dec.use_fused_mlp
                                   else (2e-3, 1e-3, 5e-3))

    def jf(emb, o_, d_, p):
        out = j_render(o_, d_, state, emb, p, dec, rnd, jnp.asarray(noise))
        loss, _ = j_loss(out, jnp.asarray(gt_c), jnp.asarray(gt_d), ls,
                         weight_depth_loss=depth_variance,
                         ray_weights=jnp.asarray(ray_w))
        return loss, out

    (lj, out_j), gj = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        state.embeddings, jnp.asarray(o), jnp.asarray(d), params)

    ts = map_state_from_numpy(state, device="cpu")
    emb = ts.embeddings.clone().requires_grad_(True)
    o_t = t(o).requires_grad_(True)
    d_t = t(d).requires_grad_(True)
    p_t = params_from_jax(params, device="cpu")
    for p in tree_leaves(p_t):
        p.requires_grad_(True)
    out_t = tr.render_rays(o_t, d_t, ts, emb, p_t, port(dec), port(rnd),
                           t(noise))
    lt, _ = tl.compute_loss(out_t, t(gt_c), t(gt_d), port(ls),
                            weight_depth_loss=depth_variance,
                            ray_weights=t(ray_w))
    lt.backward()

    assert n(out_j.hit_mask).mean() > 0.5
    np.testing.assert_array_equal(n(out_t.hit_mask), n(out_j.hit_mask))
    np.testing.assert_array_equal(n(out_t.sample_mask), n(out_j.sample_mask))
    for f in ("color", "depth", "sdf", "weights"):
        np.testing.assert_allclose(n(getattr(out_t, f)),
                                   n(getattr(out_j, f)), atol=tol_out,
                                   err_msg=f)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol_loss)
    assert_close_scaled(emb.grad, gj[0], tol_grad, "d_embeddings")
    assert_close_scaled(o_t.grad, gj[1], tol_grad, "d_o")
    assert_close_scaled(d_t.grad, gj[2], tol_grad, "d_d")
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(gj[3])):
        assert_close_scaled(a.grad, b, tol_grad, "params")


def test_pcd_render_and_loss_match(case, monkeypatch):
    """pcd branch: outputs, loss and the gradients w.r.t. ray origins and
    directions (pose), PointNet and decoder params, at the vox branch's
    tolerances."""
    monkeypatch.setattr(jmk, "fused_applicable",
                        lambda dec: dec.use_fused_mlp and dec.depth == 2
                        and not dec.skips and dec.embedder == "none")
    monkeypatch.setattr(jmk, "decoder_values_fused", functools.partial(
        jmk.decoder_values_fused, interpret=True))
    state, params, o, d, noise, gt_c, gt_d = case
    rnd = dataclasses.replace(RENDER, feature_mode="pcd")
    rng = np.random.default_rng(8)
    coords = map_coords(0)
    pick = coords[rng.integers(0, len(coords) // 2, 1500)]
    pts = ((pick + rng.uniform(0.01, 0.99, pick.shape))
           * MAP.voxel_size).astype(np.float32)
    store = jpf.insert_frame_points(
        jpf.init_point_store(MAP, 8), state, jnp.asarray(pts),
        jnp.asarray(rng.random(pts.shape), jnp.float32),
        jnp.ones(len(pts), bool), MAP)
    pn = j_init_pn(jax.random.PRNGKey(4), 16)
    ls = LossSettings()

    def jf(o_, d_, p, pn_):
        out = j_render(o_, d_, state, state.embeddings, p, DEC, rnd,
                       jnp.asarray(noise), point_store=store,
                       pointnet_params=pn_)
        loss, _ = j_loss(out, jnp.asarray(gt_c), jnp.asarray(gt_d), ls,
                         weight_depth_loss=True)
        return loss, out

    (lj, out_j), gj = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(o), jnp.asarray(d), params, pn)

    ts = map_state_from_numpy(state, device="cpu")
    o_t = t(o).requires_grad_(True)
    d_t = t(d).requires_grad_(True)
    p_t = params_from_jax(params, device="cpu")
    pn_t = params_from_jax(pn, device="cpu")
    for p in tree_leaves(p_t) + tree_leaves(pn_t):
        p.requires_grad_(True)
    out_t = tr.render_rays(o_t, d_t, ts, ts.embeddings,
                           {**p_t, "pointnet": pn_t}, port(DEC), port(rnd),
                           t(noise), point_store=point_store_from_numpy(
                               store, device="cpu"))
    lt, _ = tl.compute_loss(out_t, t(gt_c), t(gt_d), port(ls),
                            weight_depth_loss=True)
    lt.backward()

    assert n(out_j.hit_mask).mean() > 0.5
    np.testing.assert_array_equal(n(out_t.sample_mask), n(out_j.sample_mask))
    for f in ("color", "depth", "sdf", "weights"):
        np.testing.assert_allclose(n(getattr(out_t, f)),
                                   n(getattr(out_j, f)), atol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    assert_close_scaled(o_t.grad, gj[0], 5e-3, "d_o")
    assert_close_scaled(d_t.grad, gj[1], 5e-3, "d_d")
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(gj[2])):
        assert_close_scaled(a.grad, b, 5e-3, "decoder params")
    for a, b in zip(tree_leaves(pn_t), jax.tree.leaves(gj[3])):
        assert_close_scaled(a.grad, b, 5e-3, "pointnet params")


def test_fresh_fraction_and_median_match():
    from proudslam_tpu.render.losses import _masked_median as j_med
    from proudslam_tpu.render.renderer import _fresh_fraction as j_fresh
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 50, (30, 6)).astype(np.int32)
    a = j_fresh(jnp.asarray(idx), 50, RENDER, jnp.int32(35))
    b = tr._fresh_fraction(t(idx), 50, port(RENDER), 35)
    np.testing.assert_allclose(n(b), n(a), atol=1e-7)
    x = rng.random(31).astype(np.float32)
    for m in (rng.random(31) > 0.5, np.zeros(31, bool)):
        np.testing.assert_array_equal(n(tl._masked_median(t(x), t(m))),
                                      n(j_med(jnp.asarray(x), jnp.asarray(m))))


def test_unported_branches_raise(case):
    """Once the refusal of the branches not yet ported; every branch runs
    now. The last one refused, ``intersect_mode="dda"``, held against the
    JAX package on the unfused vox branch at bf16 operands (the other
    branches with DDA: ``test_torch_dda.py``)."""
    _check_render_and_loss(
        case, True, dataclasses.replace(DEC, use_fused_mlp=False),
        dataclasses.replace(RENDER, intersect_mode="dda"))
