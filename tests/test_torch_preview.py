"""Full-image preview parity: the port's ``render_preview`` against the JAX
package's on a small map (frame 0 of the synthetic room inserted, trained-
scale embeddings), with the unfused f32 decoder of the configs and the same
noise: the test reproduces the JAX function's chunk keys (``key, k =
split(key)`` per chunk from ``PRNGKey(seed)``) and hands the port each
chunk's uniforms. The view is 40x30 of the 64x48 capture in chunks of 512
rays, so the last chunk is short.

Tolerances: rgb and depth 1e-4, the renderer's for the unfused f32 branch
(``test_torch_renderer.py``); which pixels miss, and their zeros, exactly.
``scaled_intrinsics`` equals the JAX package's exactly. The preview uses a
generator of its own, so it leaves the engine's untouched; with
``feature_mode="pcd"`` it raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.geometry import camera as jcam
from proudslam_tpu.geometry import se3 as jse3
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.render.preview import render_preview as j_preview
from proudslam_tpu_torch.geometry import camera as tcam
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax)
from proudslam_tpu_torch.render.preview import render_preview

from test_torch_engine import dataset, seeded_map, settings  # noqa: F401
from torch_parity import n, port_system, t
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W_R, H_R, CHUNK, SEED = 40, 30, 512, 3


def preview_settings():
    s = settings()
    return dataclasses.replace(s, decoder=dataclasses.replace(
        s.decoder, matmul_dtype="f32", use_fused_mlp=False))


def test_scaled_intrinsics_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        K = tuple(float(v) for v in rng.uniform(10, 900, 4))
        sizes = [int(v) for v in rng.integers(16, 1300, 4)]
        assert tcam.scaled_intrinsics(K, *sizes) == jcam.scaled_intrinsics(
            K, *sizes)


def test_render_preview_matches(dataset):  # noqa: F811
    s = preview_settings()
    ms, _ = seeded_map(s, dataset)
    params = j_init(jax.random.PRNGKey(1), s.decoder)
    # frame 1's pose turned by 0.3 rad about x: part of the view leaves
    # the map
    pose6 = jse3.tangent_from_matrix(jnp.asarray(dataset.poses[1],
                                                 jnp.float32)).at[3].add(0.3)
    full = (dataset.width, dataset.height)
    rj, dj = j_preview(ms, params, pose6, s, W_R, H_R, dataset.intrinsics,
                       full, chunk=CHUNK, seed=SEED)

    SJ = s.render.max_samples - s.render.max_hits
    key = jax.random.PRNGKey(SEED)
    noise = []
    for _ in range(-(-W_R * H_R // CHUNK)):
        key, k = jax.random.split(key)
        noise.append(t(n(jax.random.uniform(k, (CHUNK, SJ)))))
    tm = map_state_from_numpy(ms, device="cpu")
    nv = tm.num_voxels
    view = tm._replace(voxel_keys=tm.voxel_keys[:nv],
                       voxel_vertex_ids=tm.voxel_vertex_ids[:nv])
    rt, dt = render_preview(view, params_from_jax(params, device="cpu"),
                            t(n(pose6)), port_system(s), W_R, H_R,
                            dataset.intrinsics, full, chunk=CHUNK,
                            noise_fn=lambda c: noise[c])
    assert rt.shape == (H_R, W_R, 3) and dt.shape == (H_R, W_R)
    miss = dj == 0
    assert 0.05 < miss.mean() < 0.5
    np.testing.assert_array_equal(dt == 0, miss)
    np.testing.assert_array_equal(rt[miss], 0.0)
    np.testing.assert_allclose(rt, rj, atol=1e-4)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


def test_preview_own_generator_and_pcd(dataset):  # noqa: F811
    """The default noise comes from a generator seeded with ``seed`` (the
    same images twice, another seed other samples); pcd raises."""
    s = port_system(preview_settings())
    ms, _ = seeded_map(preview_settings(), dataset)
    tm = map_state_from_numpy(ms, device="cpu")
    params = params_from_jax(j_init(jax.random.PRNGKey(1),
                                    preview_settings().decoder),
                             device="cpu")
    pose6 = t(n(jse3.tangent_from_matrix(jnp.asarray(dataset.poses[1],
                                                     jnp.float32))))
    args = (tm, params, pose6, s, 16, 12, dataset.intrinsics,
            (dataset.width, dataset.height))
    state = torch.random.get_rng_state()
    a = render_preview(*args, seed=1)
    b = render_preview(*args, seed=1)
    c = render_preview(*args, seed=2)
    assert torch.equal(torch.random.get_rng_state(), state)
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])
    pcd = dataclasses.replace(s, render=dataclasses.replace(
        s.render, feature_mode="pcd"))
    with pytest.raises(ValueError, match="point store"):
        render_preview(tm, params, pose6, pcd, 16, 12, dataset.intrinsics,
                       (dataset.width, dataset.height))
