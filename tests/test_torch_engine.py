"""Engine parity: the port's ``track_frame`` and ``map_step`` against the
JAX package, with the JAX fused render branch forced on (interpret mode,
as ``tests/test_fused_render.py`` does) and the same random draws: the
port consumes pixel indices and noise computed from JAX's own key splits
(``tracker.py:118-125``, ``mapper.py:123-152``) on the same map, decoder
and keyframes.

Tolerances: a single tracking call's pose 1e-3 (m / rad); a mapping
call's embedding and decoder updates to 5% in L2 (see
``assert_adam_updates_close``), its poses to 1e-3. The multi-frame
lockstep is ``test_torch_slam.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.config import (DecoderSettings, LossSettings, MapSettings,
                                  MapperSettings, RenderSettings,
                                  SystemSettings, TrackerSettings)
from proudslam_tpu.data.synthetic import SyntheticDataset
from proudslam_tpu.engine import mapper as jmapper
from proudslam_tpu.engine import state as jstate
from proudslam_tpu.engine import tracker as jtracker
from proudslam_tpu.geometry import camera as jcam
from proudslam_tpu.geometry import se3 as jse3
from proudslam_tpu.models.decoder import init_decoder as j_init
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.ops.pallas import render_kernel as jrk
from proudslam_tpu_torch.engine import mapper as tmapper
from proudslam_tpu_torch.engine import state as tstate
from proudslam_tpu_torch.engine import tracker as ttracker
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax, tree_leaves)

from torch_parity import n, port_system, t


def settings(**render) -> SystemSettings:
    """tests/test_slam_e2e.py's small settings, on the slice's path: fused
    render branch, bf16 decoder, fixed per-round ray batches."""
    return SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02, truncation=0.1,
                              max_distance=10.0, max_hits=12, max_samples=72,
                              **render),
        map=MapSettings(voxel_size=0.2, num_embeddings=8192, embed_dim=16,
                        voxel_capacity=4096, frame_voxel_capacity=1024,
                        frame_voxel_capacity_steady=256),
        decoder=DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64,
                                matmul_dtype="bf16", use_fused_mlp=True),
        tracker=TrackerSettings(n_rays=256, num_iterations=30,
                                learning_rate=0.01, fixed_sample_batch=True),
        mapper=MapperSettings(n_rays_each=256, window_size=2,
                              num_iterations=5, keyframe_gap=8,
                              max_keyframes=16, init_iterations=30,
                              fixed_sample_batch=True, insert_stride=2),
        loss=LossSettings())


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setattr(jrk, "fused_render_applicable",
                        lambda dec: dec.use_fused_mlp and dec.depth == 2
                        and not dec.skips and dec.embedder == "none")


@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num_frames=5, width=64, height=48)


def track_draws(key, s, num_pixels):
    """The port's (pix, noise) from a JAX tracker key."""
    _, k_pix, k_noise = jax.random.split(key, 3)
    nr = s.tracker.n_rays
    pix = jax.random.randint(k_pix, (nr,), 0, num_pixels, dtype=jnp.int32)
    noise = jax.random.uniform(
        k_noise, (nr, s.render.max_samples - s.render.max_hits))
    return t(n(pix)), t(n(noise))


def map_draws(key, s, wsel, num_pixels):
    """The port's (pix, noise) from a JAX mapper key."""
    _, k_batch = jax.random.split(key)
    k_noise, k_pix = jax.random.split(k_batch)
    nr = s.mapper.n_rays_each
    pix = jax.vmap(lambda kk: jax.random.randint(
        kk, (nr,), 0, num_pixels, dtype=jnp.int32))(
            jax.random.split(k_pix, wsel))
    noise = jax.random.uniform(
        k_noise, (wsel, nr, s.render.max_samples - s.render.max_hits))
    return t(n(pix)), t(n(noise))


def assert_adam_updates_close(new_t, new_j, old, bound):
    """Adam moves each coordinate by at most ~lr per step whatever its
    gradient's size, so a coordinate whose gradient sits at float-noise
    level can step either way in either implementation. Held: the update
    vectors agree to 5% in L2, and no coordinate differs by more than the
    Adam step bound (iterations x lr)."""
    du_t = n(new_t) - n(old)
    du_j = n(new_j) - n(old)
    assert np.abs(du_j).max() > 0
    assert (np.linalg.norm(du_t - du_j)
            <= 0.05 * np.linalg.norm(du_j)), "update direction"
    assert np.abs(du_t - du_j).max() <= bound


def seeded_map(s, dataset):
    """Frame 0 inserted into a fresh JAX map, trained-scale embeddings."""
    _, rgb, depth, K, pose = dataset[0]
    rays = jcam.pixel_ray_directions(dataset.width, dataset.height,
                                     *dataset.intrinsics)
    pts = jcam.transform_points(jcam.backproject(rays, depth).reshape(-1, 3),
                                jnp.asarray(pose[:3, :3], jnp.float32),
                                jnp.asarray(pose[:3, 3], jnp.float32))
    ms = jvh.init_map_state(s.map, jax.random.PRNGKey(0))
    ms = jvh.insert_points(ms, pts, jnp.asarray(depth.reshape(-1) > 0), s.map)
    emb = 0.2 * jax.random.normal(jax.random.PRNGKey(9), ms.embeddings.shape)
    return ms._replace(embeddings=emb), rays


def test_track_frame_matches(dataset):
    s = settings(fresh_window_frames=5)
    ms, rays = seeded_map(s, dataset)
    params = j_init(jax.random.PRNGKey(1), s.decoder)
    _, rgb, depth, _, pose1 = dataset[1]
    prev = jse3.tangent_from_matrix(jnp.asarray(dataset.poses[0],
                                                jnp.float32))
    key = jax.random.PRNGKey(11)
    thresh = int(ms.num_voxels) - 40
    fn = jax.jit(functools.partial(jtracker.track_frame, settings=s))
    rj = fn(ms, params, prev, rays, jnp.asarray(rgb), jnp.asarray(depth),
            key, fresh_thresh=jnp.int32(thresh))
    ts = port_system(s)
    tm = map_state_from_numpy(ms)
    nv = tm.num_voxels
    view = tm._replace(voxel_keys=tm.voxel_keys[:nv],
                       voxel_vertex_ids=tm.voxel_vertex_ids[:nv])
    rt = ttracker.track_frame(view, params_from_jax(params), t(n(prev)),
                              t(n(rays)), t(rgb), t(depth), ts,
                              track_draws(key, s, rgb.shape[0] * rgb.shape[1]),
                              fresh_thresh=thresh)
    assert float(rj.hit_ratio) > 0.5
    np.testing.assert_allclose(float(rt.hit_ratio), float(rj.hit_ratio),
                               atol=1e-6)
    np.testing.assert_allclose(n(rt.pose), n(rj.pose), atol=1e-3)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=2e-2)
    assert rt.adam_t == int(rj.adam_t)
    # the pose moved: tracking did work in both
    assert np.abs(n(rj.pose) - n(prev)).max() > 1e-3


@pytest.mark.parametrize("padded", [False, True])
def test_map_step_matches(dataset, padded):
    s = settings()
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
    sel, valid = ([0, 0, 2], [True, False, True]) if padded else \
        ([0, 1, 2], [True, True, True])
    opt = jmapper.init_map_opt(ms.embeddings, params)
    key = jax.random.PRNGKey(12)
    fn = jax.jit(functools.partial(jmapper.map_step, settings=s))
    rj = fn(ms, params, store, opt, rays, jnp.asarray(sel, jnp.int32),
            jnp.asarray(valid), key)

    tms = map_state_from_numpy(ms)
    nv = tms.num_voxels
    view = tms._replace(voxel_keys=tms.voxel_keys[:nv],
                        voxel_vertex_ids=tms.voxel_vertex_ids[:nv])
    tst = tstate.KeyframeStore(
        rgb=t(n(store.rgb)), depth=t(n(store.depth)),
        stamps=t(n(store.stamps)), poses=t(n(store.poses)),
        adam_m=t(n(store.pose_adam.m)), adam_v=t(n(store.pose_adam.v)),
        adam_t=t(n(store.pose_adam.t)))
    tp = params_from_jax(params)
    rt = tmapper.map_step(view, tp, tst, tmapper.init_map_opt(tms.embeddings,
                                                             tp),
                          t(n(rays)), sel, valid, port_system(s),
                          map_draws(key, s, 3, H * W))
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
    # the anchor (gauge flag 0) and padded rows stay where they were
    np.testing.assert_array_equal(n(tst.poses)[0], n(store.poses)[0])
    if padded:
        np.testing.assert_array_equal(n(tst.poses)[1], n(store.poses)[1])
