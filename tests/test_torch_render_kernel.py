"""Kernel-K1 parity: ``fused_render_forward_plain`` (the plain version of
the CUDA render kernel) against the JAX package's Pallas
``fused_render_forward`` in interpret mode, and the gradients of the
port's ``FusedFeatsDecode`` against ``jax.grad`` of ``fused_feats_decode``.

Tolerances: features 1e-5 (the same f32 blend formula); decoder outputs
1e-3 (bf16 operands in both; f32 summation order may flip the bf16
rounding of an intermediate); gradients 2e-3 of each gradient's largest
magnitude (the same, through the backward's bf16-rounded cotangents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.interp import corner_view as j_corner_view
from proudslam_tpu.ops.intersect import ray_intersect as j_intersect
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu.ops.sampling import sample_rays_in_segments as j_sample
from proudslam_tpu_torch.models.decoder import params_from_jax, tree_leaves
from proudslam_tpu_torch.ops.kernels import mlp_kernel as tmk
from proudslam_tpu_torch.ops.kernels import render_kernel as trk

from torch_parity import (DEC, MAP, RENDER, assert_close_scaled, map_coords,
                          n, port, ray_batch, t)


@pytest.fixture(scope="module")
def case():
    state = jvh.build_map_state_numpy(map_coords(0), MAP)
    # trained-map-scale embeddings, so the decoder sees varied features
    emb = (0.5 * np.random.default_rng(5).standard_normal(
        state.embeddings.shape)).astype(np.float32)
    state = state._replace(embeddings=jnp.asarray(emb))
    V = state.voxel_keys.shape[0]
    centers = (jvh.unpack_key(state.voxel_keys).astype(jnp.float32)
               + 0.5) * MAP.voxel_size
    R = 40
    o, d = ray_batch(R, 2)
    inter = j_intersect(jnp.asarray(o), jnp.asarray(d), centers,
                        jnp.arange(V) < state.num_voxels, RENDER, exact=True)
    noise = np.random.default_rng(3).random(
        (R, RENDER.max_samples - RENDER.max_hits)).astype(np.float32)
    smp = j_sample(inter, RENDER, jnp.asarray(noise))
    valid = smp.voxel_idx >= 0
    H = RENDER.max_hits
    vidx = jnp.maximum(inter.voxel_idx, 0)
    bins = jnp.where(valid, smp.bin, H).astype(jnp.int32)
    EV = j_corner_view(state.embeddings, state.voxel_vertex_ids, None)
    params = j_init(jax.random.PRNGKey(1), DEC)
    return dict(EV=EV, vidx=vidx, keys_rb=state.voxel_keys[vidx], bins=bins,
                z=smp.depth, o=o, d=d, params=params,
                w_out=np.random.default_rng(7).standard_normal(
                    (R * RENDER.max_samples, 4)).astype(np.float32))


def test_forward_plain_matches_pallas(case):
    c = case
    rb = c["EV"][c["vidx"]]
    out_j, feats_j = jrk.fused_render_forward(
        rb, c["keys_rb"], c["bins"], c["z"], jnp.asarray(c["o"]),
        jnp.asarray(c["d"]), c["params"], RENDER, DEC, interpret=True)
    fp = tmk.pack_params(params_from_jax(c["params"]), port(DEC))
    out_t, feats_t = trk.fused_render_forward_plain(
        t(n(rb)), t(n(c["keys_rb"])), t(n(c["bins"])), t(n(c["z"])),
        t(c["o"]), t(c["d"]), fp, RENDER.voxel_size)
    assert float(np.abs(n(feats_j)).max()) > 0.1
    np.testing.assert_allclose(n(feats_t), n(feats_j), atol=1e-5)
    np.testing.assert_allclose(n(out_t), n(out_j), atol=1e-3)
    # the wrapper takes the plain version for CPU tensors
    before = trk.fused_render_forward.launches
    out_w, _ = trk.fused_render_forward(
        t(n(rb)), t(n(c["keys_rb"])), t(n(c["bins"])), t(n(c["z"])),
        t(c["o"]), t(c["d"]), fp, RENDER.voxel_size)
    assert torch.equal(out_w, out_t)
    assert trk.fused_render_forward.launches == before


def test_gradients_match_jax(case):
    c = case
    W = jnp.asarray(c["w_out"])

    def jloss(EV, o, d, params):
        out = jrk.fused_feats_decode(EV, c["keys_rb"], c["vidx"], c["bins"],
                                     c["z"], o, d, params, RENDER, DEC)
        return jnp.sum(out * W)

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        c["EV"], jnp.asarray(c["o"]), jnp.asarray(c["d"]), c["params"])

    EV = t(n(c["EV"])).requires_grad_(True)
    o = t(c["o"]).requires_grad_(True)
    d = t(c["d"]).requires_grad_(True)
    params = params_from_jax(c["params"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    out = trk.fused_feats_decode(
        EV, t(n(c["keys_rb"])), t(n(c["vidx"])), t(n(c["bins"])),
        t(n(c["z"])), o, d, params, port(RENDER), port(DEC))
    (out * t(c["w_out"])).sum().backward()

    assert_close_scaled(EV.grad, gj[0], 2e-3, "dEV")
    assert_close_scaled(o.grad, gj[1], 2e-3, "d_o")
    assert_close_scaled(d.grad, gj[2], 2e-3, "d_d")
    for a, b in zip(tree_leaves(params), jax.tree.leaves(gj[3])):
        assert_close_scaled(a.grad, b, 2e-3, "params")
