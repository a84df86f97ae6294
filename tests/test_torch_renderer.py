"""Render + loss parity on the fused branch: the port's ``render_rays`` and
``compute_loss`` against the JAX package's with its fused Pallas branch
forced on (interpret mode, as ``tests/test_fused_render.py`` does), on the
same map, rays and noise. Outputs and the gradients the SLAM loops consume
(embeddings for mapping, ray origins/directions for tracking, decoder
params) are compared.

Tolerances: rendered color/depth/sdf 2e-3 (bf16 decoder operands in both,
f32 summation order differs); loss 1e-3 relative; gradients 5e-3 of each
gradient's largest magnitude (the same, through the normalized weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.config import LossSettings
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu.render.losses import compute_loss as j_loss
from proudslam_tpu.render.renderer import render_rays as j_render
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax, tree_leaves)
from proudslam_tpu_torch.render import losses as tl
from proudslam_tpu_torch.render import renderer as tr

from torch_parity import (DEC, MAP, RENDER, assert_close_scaled, map_coords,
                          n, port, ray_batch, t)


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


@pytest.mark.parametrize("depth_variance", [False, True])
def test_render_and_loss_match(case, depth_variance):
    state, params, o, d, noise, gt_c, gt_d = case
    ls = LossSettings()
    ray_w = np.linspace(0.2, 1.0, o.shape[0]).astype(np.float32)

    def jf(emb, o_, d_, p):
        out = j_render(o_, d_, state, emb, p, DEC, RENDER, jnp.asarray(noise))
        loss, _ = j_loss(out, jnp.asarray(gt_c), jnp.asarray(gt_d), ls,
                         weight_depth_loss=depth_variance,
                         ray_weights=jnp.asarray(ray_w))
        return loss, out

    (lj, out_j), gj = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        state.embeddings, jnp.asarray(o), jnp.asarray(d), params)

    ts = map_state_from_numpy(state)
    emb = ts.embeddings.clone().requires_grad_(True)
    o_t = t(o).requires_grad_(True)
    d_t = t(d).requires_grad_(True)
    p_t = params_from_jax(params)
    for p in tree_leaves(p_t):
        p.requires_grad_(True)
    out_t = tr.render_rays(o_t, d_t, ts, emb, p_t, port(DEC), port(RENDER),
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
                                   n(getattr(out_j, f)), atol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    assert_close_scaled(emb.grad, gj[0], 5e-3, "d_embeddings")
    assert_close_scaled(o_t.grad, gj[1], 5e-3, "d_o")
    assert_close_scaled(d_t.grad, gj[2], 5e-3, "d_d")
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(gj[3])):
        assert_close_scaled(a.grad, b, 5e-3, "params")


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


def test_unported_branches_raise():
    import dataclasses
    ts = map_state_from_numpy(jvh.build_map_state_numpy(map_coords(0), MAP))
    o, d = ray_batch(4)
    unfused = dataclasses.replace(port(DEC), use_fused_mlp=False)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tr.render_rays(t(o), t(d), ts, ts.embeddings, {}, unfused,
                       port(RENDER), torch.rand(4, 18))
