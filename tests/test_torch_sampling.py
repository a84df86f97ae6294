"""Stratified segment sampling parity: the same intersections and the
same numpy noise through the JAX package's ``sample_rays_in_segments`` and
the port's. Slot indices and bins match exactly; depths and distances to
1e-5 (same f32 formulas)."""

import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.intersect import ray_intersect as j_intersect
from proudslam_tpu.ops.sampling import sample_rays_in_segments as j_sample
from proudslam_tpu_torch.ops.intersect import Intersections
from proudslam_tpu_torch.ops.sampling import (sample_frame_pixels,
                                              sample_rays_in_segments)

from torch_parity import MAP, RENDER, map_coords, n, port, ray_batch, t


@pytest.mark.parametrize("R,step,seed", [(64, 0.05, 0), (48, 0.01, 1)])
def test_samples_match_jax(R, step, seed):
    import dataclasses
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
    import torch
    g = torch.Generator().manual_seed(0)
    pix = sample_frame_pixels(g, 4096, 300)
    assert pix.shape == (4096,)
    assert int(pix.min()) >= 0 and int(pix.max()) < 300
    assert len(torch.unique(pix)) == 300
