"""Brute-force intersection parity: the port's exact ``torch.topk``
selection against the JAX package's ``ray_intersect(exact=True)``. Hit
sets and slot order match exactly; entry/exit depths to 1e-5 (the same f32
slab arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.intersect import ray_intersect as j_intersect
from proudslam_tpu_torch.ops.intersect import ray_intersect as t_intersect

from torch_parity import MAP, RENDER, map_coords, n, port, ray_batch, t


def _inputs(R, count, seed):
    coords = map_coords(seed, count)
    if count <= RENDER.max_hits:          # fewer voxels than hit slots
        coords = np.array([[0, 0, k] for k in range(count)])
    state = jvh.build_map_state_numpy(coords, MAP)
    V = state.voxel_keys.shape[0]
    centers = np.asarray((jvh.unpack_key(state.voxel_keys).astype(jnp.float32)
                          + 0.5) * MAP.voxel_size)
    valid = np.arange(V) < int(state.num_voxels)
    if count <= RENDER.max_hits:          # table sliced to the live voxels
        centers, valid = centers[:count], valid[:count]
    o, d = ray_batch(R, seed)
    # a few axis-aligned rays (zero direction components: the NaN rule)
    d[:4, :2] = 0.0
    return o, d, centers, valid


@pytest.mark.parametrize("R,count,seed", [(64, 400, 0), (96, 40, 1),
                                          (32, 3, 2)])
def test_hits_match_exact_jax(R, count, seed):
    o, d, centers, valid = _inputs(R, count, seed)
    a = j_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
                    jnp.asarray(valid), RENDER, exact=True)
    b = t_intersect(t(o), t(d), t(centers), t(valid), port(RENDER))
    np.testing.assert_array_equal(n(b.voxel_idx), n(a.voxel_idx))
    np.testing.assert_array_equal(n(b.hit_mask), n(a.hit_mask))
    np.testing.assert_allclose(n(b.t_near), n(a.t_near), atol=1e-5)
    np.testing.assert_allclose(n(b.t_far), n(a.t_far), atol=1e-5)
    assert n(a.hit_mask).any()
    # the same hit set per ray, whatever the order
    for ra, rb_ in zip(n(a.voxel_idx), n(b.voxel_idx)):
        assert set(ra.tolist()) == set(rb_.tolist())
