"""Stratified segment sampling parity: the same intersections and the
same numpy noise through the JAX package's ``sample_rays_in_segments`` and
the port's. Slot indices and bins match exactly; depths and distances to
1e-5 (same f32 formulas).

Pixel samplers: the port's ``gumbel_sample_pixels`` on JAX's uniforms
(drawn in the test from JAX's key) gives JAX's indices exactly, with the
JAX package's log-probabilities and with the port's own for the all-ones
mask; Gumbel draws are without replacement (per keyframe in
``map_draws``), and the uniform draws of the fixed-batch engine are the
ones it made before the Gumbel sampler existed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.intersect import ray_intersect as j_intersect
from proudslam_tpu.ops import sampling as jsampling
from proudslam_tpu.ops.sampling import sample_rays_in_segments as j_sample
from proudslam_tpu_torch.config import bench_settings
from proudslam_tpu_torch.engine.mapper import map_draws
from proudslam_tpu_torch.engine.tracker import track_draws
from proudslam_tpu_torch.ops.intersect import Intersections
from proudslam_tpu_torch.ops.sampling import (gumbel_sample_pixels,
                                              sample_frame_pixels,
                                              sample_rays_in_segments)

from torch_parity import MAP, RENDER, map_coords, n, port, ray_batch, t


@pytest.mark.parametrize("R,step,seed", [(64, 0.05, 0), (48, 0.01, 1)])
def test_samples_match_jax(R, step, seed):
    rs = dataclasses.replace(RENDER, step_size=step)
    state = jvh.build_map_state_numpy(map_coords(seed), MAP)
    V = state.voxel_keys.shape[0]
    centers = (jvh.unpack_key(state.voxel_keys).astype(jnp.float32)
               + 0.5) * MAP.voxel_size
    o, d = ray_batch(R, seed)
    inter = j_intersect(jnp.asarray(o), jnp.asarray(d), centers,
                        jnp.arange(V) < state.num_voxels, rs, exact=True)
    noise = np.random.default_rng(seed + 10).random(
        (R, rs.max_samples - rs.max_hits)).astype(np.float32)
    a = j_sample(inter, rs, jnp.asarray(noise))
    ti = Intersections(*[t(n(x)) for x in inter])
    b = sample_rays_in_segments(ti, port(rs), t(noise))
    np.testing.assert_array_equal(n(b.voxel_idx), n(a.voxel_idx))
    np.testing.assert_array_equal(n(b.bin), n(a.bin))
    np.testing.assert_allclose(n(b.depth), n(a.depth), atol=1e-5)
    np.testing.assert_allclose(n(b.dist), n(a.dist), atol=1e-5)
    assert (n(a.voxel_idx) >= 0).sum() > R


def test_uniform_pixel_sampler_range():
    g = torch.Generator().manual_seed(0)
    pix = sample_frame_pixels(g, 4096, 300)
    assert pix.shape == (4096,)
    assert int(pix.min()) >= 0 and int(pix.max()) < 300
    assert len(torch.unique(pix)) == 300


@pytest.mark.parametrize("P,num,seed", [(3072, 256, 0), (76800, 1024, 1),
                                        (500, 500, 2)])
def test_gumbel_matches_jax(P, num, seed):
    """JAX's uniforms through the port: the same indices, in order; and
    the all-ones-mask draw of ``sample_frame_pixels(method="gumbel")``."""
    key = jax.random.PRNGKey(seed)
    logp = jnp.asarray(np.random.default_rng(seed).normal(size=P),
                       jnp.float32)
    u = jax.random.uniform(key, (P,))
    ref = jsampling.gumbel_sample_pixels(key, logp, num)
    got = gumbel_sample_pixels(t(n(u)), t(n(logp)), num)
    np.testing.assert_array_equal(n(got), n(ref))
    # the all-ones mask: the port's log-probabilities are the JAX package's
    ref = jsampling.sample_frame_pixels(key, None, num, method="gumbel",
                                        num_pixels=P)
    flat = torch.ones(P)
    logp_t = torch.log(flat / (flat.sum() + 1e-7) + 1e-7)
    got = gumbel_sample_pixels(t(n(u)), logp_t, num)
    np.testing.assert_array_equal(n(got), n(ref))


def test_gumbel_without_replacement():
    g = torch.Generator().manual_seed(3)
    for num, P in ((300, 300), (1024, 3072), (5, 6)):
        pix = sample_frame_pixels(g, num, P, method="gumbel")
        assert pix.shape == (num,)
        assert len(torch.unique(pix)) == num
        assert int(pix.min()) >= 0 and int(pix.max()) < P
    with pytest.raises(ValueError, match="pixel sampler"):
        sample_frame_pixels(g, 4, 8, method="stratified")


@pytest.mark.parametrize("fixed", [True, False])
def test_engine_draws(fixed):
    """``map_draws``: one Gumbel draw per keyframe (no duplicates within a
    keyframe's row, duplicates across keyframes allowed); shapes with and
    without the per-iteration axis; with the uniform sampler the fixed
    batch's draws are a ``randint`` over all rays, then the noise."""
    s = bench_settings()
    s = dataclasses.replace(
        s, tracker=dataclasses.replace(s.tracker, n_rays=64,
                                       fixed_sample_batch=fixed),
        mapper=dataclasses.replace(s.mapper, n_rays_each=64,
                                   fixed_sample_batch=fixed))
    P, wsel, SJ = 80, 3, s.render.max_samples - s.render.max_hits
    it_t = () if fixed else (s.tracker.num_iterations,)
    it_m = () if fixed else (s.mapper.num_iterations,)
    gs = dataclasses.replace(s, render=dataclasses.replace(
        s.render, pixel_sampler="gumbel"))
    g = torch.Generator().manual_seed(4)
    pix, noise = map_draws(g, gs, wsel, P)
    assert pix.shape == (*it_m, wsel, 64) and noise.shape == (*it_m, wsel,
                                                                64, SJ)
    rows = pix.reshape(-1, 64)
    assert all(len(torch.unique(r)) == 64 for r in rows)
    # 64 of 80 pixels per keyframe: two keyframes share some
    assert len(torch.unique(pix.reshape(-1))) < pix.numel()
    pix, noise = track_draws(g, gs, P)
    assert pix.shape == (*it_t, 64) and noise.shape == (*it_t, 64, SJ)
    assert all(len(torch.unique(r)) == 64 for r in pix.reshape(-1, 64))
    if fixed:
        g1 = torch.Generator().manual_seed(5)
        g2 = torch.Generator().manual_seed(5)
        pix, noise = map_draws(g1, s, wsel, P)
        ref = torch.randint(0, P, (wsel * 64,), generator=g2)
        assert torch.equal(pix, ref.reshape(wsel, 64))
        assert torch.equal(noise, torch.rand((wsel, 64, SJ), generator=g2))
