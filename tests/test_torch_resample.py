"""Per-iteration resampling (``fixed_sample_batch=False``, the reference's
semantics) in the port's ``track_frame`` and ``map_step`` against the JAX
package's, with both pixel samplers.

As ``test_torch_engine.py``: the JAX fused render branch forced on
(interpret mode), the same map, decoder and keyframes, and the same random
draws. Here every iteration draws its own pixel batch and noise; the test
reproduces them from JAX's own per-step key splits (``tracker.py`` step:
``k, k_pix, k_noise = split(k, 3)``; ``mapper.py`` step: ``k, k_batch =
split(k)``, then ``k_noise, k_pix = split(k_batch)`` and one pixel key per
window frame) through the JAX package's ``sample_frame_pixels``, and hands
them to the port with a leading iteration axis.

Tolerances: those of ``test_torch_engine.py`` (pose 1e-3 m / rad, loss 2%,
Adam updates of embeddings and decoder to 5% in L2 and the step bound);
the final iteration's hit ratio within one ray, since each iteration
intersects at its current pose, which differs between the two engines at
float level.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.engine import mapper as jmapper
from proudslam_tpu.engine import state as jstate
from proudslam_tpu.engine import tracker as jtracker
from proudslam_tpu.geometry import se3 as jse3
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops.sampling import sample_frame_pixels as j_pixels
from proudslam_tpu_torch.engine import mapper as tmapper
from proudslam_tpu_torch.engine import state as tstate
from proudslam_tpu_torch.engine import tracker as ttracker
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax, tree_leaves)

from test_torch_engine import (assert_adam_updates_close, dataset,  # noqa: F401
                               fused_jax, seeded_map, settings)
from torch_parity import n, port_system, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def resample_settings(sampler: str, track_iters: int = 12):
    s = settings()
    return dataclasses.replace(
        s, render=dataclasses.replace(s.render, pixel_sampler=sampler),
        tracker=dataclasses.replace(s.tracker, fixed_sample_batch=False,
                                    num_iterations=track_iters),
        mapper=dataclasses.replace(s.mapper, fixed_sample_batch=False))


def track_draws(key, s, num_pixels):
    """(iters, n) pixels and (iters, n, S - H) noise from JAX's step keys."""
    nr = s.tracker.n_rays
    SJ = s.render.max_samples - s.render.max_hits
    pix, noise = [], []
    k = key
    for _ in range(s.tracker.num_iterations):
        k, k_pix, k_noise = jax.random.split(k, 3)
        pix.append(j_pixels(k_pix, None, nr, method=s.render.pixel_sampler,
                            num_pixels=num_pixels))
        noise.append(jax.random.uniform(k_noise, (nr, SJ)))
    return t(n(jnp.stack(pix))), t(n(jnp.stack(noise)))


def map_draws(key, s, wsel, num_pixels):
    """(iters, Wsel, n) pixels and (iters, Wsel, n, S - H) noise from JAX's
    step keys."""
    nr = s.mapper.n_rays_each
    SJ = s.render.max_samples - s.render.max_hits
    pix, noise = [], []
    k = key
    for _ in range(s.mapper.num_iterations):
        k, k_batch = jax.random.split(k)
        k_noise, k_pix = jax.random.split(k_batch)
        pix.append(jnp.stack([
            j_pixels(kk, None, nr, method=s.render.pixel_sampler,
                     num_pixels=num_pixels)
            for kk in jax.random.split(k_pix, wsel)]))
        noise.append(jax.random.uniform(k_noise, (wsel, nr, SJ)))
    return t(n(jnp.stack(pix))), t(n(jnp.stack(noise)))


@pytest.mark.parametrize("sampler", ["uniform", "gumbel"])
def test_track_frame_resampling_matches(dataset, sampler):  # noqa: F811
    s = resample_settings(sampler)
    ms, rays = seeded_map(s, dataset)
    params = j_init(jax.random.PRNGKey(1), s.decoder)
    _, rgb, depth, _, _ = dataset[1]
    prev = jse3.tangent_from_matrix(jnp.asarray(dataset.poses[0],
                                                jnp.float32))
    key = jax.random.PRNGKey(21)
    fn = jax.jit(functools.partial(jtracker.track_frame, settings=s))
    rj = fn(ms, params, prev, rays, jnp.asarray(rgb), jnp.asarray(depth), key)
    tm = map_state_from_numpy(ms, device="cpu")
    nv = tm.num_voxels
    view = tm._replace(voxel_keys=tm.voxel_keys[:nv],
                       voxel_vertex_ids=tm.voxel_vertex_ids[:nv])
    draws = track_draws(key, s, rgb.shape[0] * rgb.shape[1])
    assert draws[0].shape == (s.tracker.num_iterations, s.tracker.n_rays)
    rt = ttracker.track_frame(view, params_from_jax(params, device="cpu"),
                              t(n(prev)), t(n(rays)), t(rgb), t(depth),
                              port_system(s), draws)
    assert float(rj.hit_ratio) > 0.5
    assert abs(float(rt.hit_ratio) - float(rj.hit_ratio)) <= (
        1.0 / s.tracker.n_rays + 1e-6)
    np.testing.assert_allclose(n(rt.pose), n(rj.pose), atol=1e-3)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=2e-2)
    assert rt.adam_t == int(rj.adam_t)
    assert np.abs(n(rj.pose) - n(prev)).max() > 1e-3


@pytest.mark.parametrize("sampler", ["uniform", "gumbel"])
def test_map_step_resampling_matches(dataset, sampler):  # noqa: F811
    s = resample_settings(sampler)
    ms, rays = seeded_map(s, dataset)
    params = j_init(jax.random.PRNGKey(1), s.decoder)
    H, W = dataset.height, dataset.width
    store = jstate.init_keyframe_store(s.mapper.max_keyframes, H, W)
    rng = np.random.default_rng(0)
    for slot in range(3):
        _, rgb, depth, _, pose = dataset[slot]
        p6 = jse3.tangent_from_matrix(jnp.asarray(pose, jnp.float32))
        p6 = p6 + jnp.asarray(0.003 * rng.standard_normal(6), jnp.float32)
        store = jstate.write_frame(store, jnp.int32(slot), jnp.asarray(rgb),
                                   jnp.asarray(depth), jnp.int32(min(slot, 1)),
                                   p6, jnp.zeros(6), jnp.zeros(6),
                                   jnp.int32(30 * slot))
    sel, valid = [0, 1, 2], [True, True, True]
    opt = jmapper.init_map_opt(ms.embeddings, params)
    key = jax.random.PRNGKey(22)
    fn = jax.jit(functools.partial(jmapper.map_step, settings=s))
    rj = fn(ms, params, store, opt, rays, jnp.asarray(sel, jnp.int32),
            jnp.asarray(valid), key)

    tms = map_state_from_numpy(ms, device="cpu")
    nv = tms.num_voxels
    view = tms._replace(voxel_keys=tms.voxel_keys[:nv],
                        voxel_vertex_ids=tms.voxel_vertex_ids[:nv])
    tst = tstate.KeyframeStore(
        rgb=t(n(store.rgb)), depth=t(n(store.depth)),
        stamps=t(n(store.stamps)), poses=t(n(store.poses)),
        adam_m=t(n(store.pose_adam.m)), adam_v=t(n(store.pose_adam.v)),
        adam_t=t(n(store.pose_adam.t)))
    tp = params_from_jax(params, device="cpu")
    draws = map_draws(key, s, 3, H * W)
    assert draws[0].shape == (s.mapper.num_iterations, 3,
                              s.mapper.n_rays_each)
    rt = tmapper.map_step(view, tp, tst,
                          tmapper.init_map_opt(tms.embeddings, tp),
                          t(n(rays)), sel, valid, port_system(s), draws)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=2e-2)
    iters = s.mapper.num_iterations
    assert_adam_updates_close(rt.embeddings, rj.map_state.embeddings,
                              ms.embeddings, iters * s.mapper.embed_lr)
    for a, b, a0 in zip(tree_leaves(rt.decoder_params),
                        jax.tree.leaves(rj.decoder_params),
                        jax.tree.leaves(params)):
        assert_adam_updates_close(a, b, a0, iters * s.mapper.decoder_lr)
    np.testing.assert_allclose(n(tst.poses), n(rj.store.poses), atol=1e-3)
    np.testing.assert_array_equal(n(tst.adam_t), n(rj.store.pose_adam.t))
    np.testing.assert_array_equal(n(tst.poses)[0], n(store.poses)[0])
