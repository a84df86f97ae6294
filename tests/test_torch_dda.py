"""Grid-marching (DDA) intersection parity: the port's ``dda_num_points``,
``build_occupancy``, ``ray_intersect_dda`` and ``ray_intersect_scan``
against the JAX package's, the JAX package's four DDA property tests
(``tests/test_intersect.py``) on the port, and ``render_rays`` with
``intersect_mode="dda"`` on both render branches.

Tolerances: counts, occupancy grids, hit slots and hit masks exactly (the
march points are computed in the same f32 operations in both); entry and
exit depths 1e-5 (the same slab arithmetic). The property tests keep the
JAX tests' own bounds; the render cases ``test_torch_renderer.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from proudslam_tpu.config import LossSettings, RenderSettings
from proudslam_tpu.ops import intersect as ji
from proudslam_tpu.ops import voxel_hash as jvh
from proudslam_tpu.render.losses import compute_loss as j_loss
from proudslam_tpu.render.renderer import render_rays as j_render
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax, tree_leaves)
from proudslam_tpu_torch.ops import intersect as ti
from proudslam_tpu_torch.render import losses as tl
from proudslam_tpu_torch.render import renderer as tr

from test_intersect import DDA_SET, _Map
from test_torch_renderer import UNFUSED_TOL, case  # noqa: F401
from torch_parity import (DEC, RENDER, assert_close_scaled, n, port, t)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PSET = port(DDA_SET)


def _centers_valid(m):
    keys = np.asarray(m.voxel_keys)
    centers = ((np.asarray(jvh.unpack_key(jnp.asarray(keys)))
                .astype(np.float32) + 0.5) * DDA_SET.voxel_size)
    return centers, np.arange(len(keys)) < int(m.num_voxels)


def _rays(rng, R):
    """The JAX property test's pinhole-like rays (|d| bounded)."""
    o = rng.normal(0, 0.5, (R, 3)).astype(np.float32)
    d = rng.normal(0, 1.0, (R, 3)).astype(np.float32)
    d = d / np.maximum(np.abs(d[:, 2:3]), 0.2)
    d = np.clip(d, -1.2, 1.2)
    d[:4, :2] = 0.0               # axis-aligned rays: the NaN slab rule
    return o, d


def _dda(o, d, m, **kw):
    return ti.ray_intersect_dda(t(o), t(d), t(m.voxel_keys),
                                int(m.num_voxels), PSET, **kw)


@pytest.mark.parametrize("settings", [
    DDA_SET, RenderSettings(), dataclasses.replace(
        RenderSettings(), max_distance=4.0, dda_step_frac=0.3,
        dda_dir_bound=1.5)], ids=["test", "default", "short"])
def test_dda_num_points_match(settings):
    assert ti.dda_num_points(port(settings)) == ji.dda_num_points(settings)


def test_dda_num_points_at_the_bench_settings():
    from proudslam_tpu_torch.config import bench_settings
    # 10 m x 1.25 / (0.45 x 0.2 m), rounded up to a multiple of 8
    assert ti.dda_num_points(bench_settings().render) == 144


def test_build_occupancy_matches():
    """Live voxels inside and outside the extent, dead slots past
    ``num_voxels`` holding real-looking keys."""
    rng = np.random.default_rng(0)
    coords = np.concatenate([rng.integers(-14, 14, (300, 3)),
                             [[40, 0, 0], [-33, 0, 0], [0, 31, 5]]])
    m = _Map(coords)
    keys = np.asarray(m.voxel_keys).copy()
    nv = int(m.num_voxels)
    keys[nv:nv + 5] = keys[:5]           # dead slots: never in the grid
    want = ji.build_occupancy(jnp.asarray(keys), jnp.int32(nv - 3), DDA_SET)
    got = ti.build_occupancy(t(keys), nv - 3, PSET)
    np.testing.assert_array_equal(n(got), n(want))
    inside = ((m.coords[:nv - 3] >= -32) & (m.coords[:nv - 3] < 32)).all(1)
    assert 0 < (~inside).sum()
    assert (n(got) >= 0).sum() == inside.sum()


@pytest.mark.parametrize("seed,count,extent,R", [
    (3, 400, 6, 128), (5, 2500, 14, 256), (7, 60, 3, 96)])
def test_dda_and_scan_match_jax(seed, count, extent, R):
    """Seeded random maps (``count`` draws in a cube of side 2 * extent
    voxels) and rays: the DDA and the scan oracle of each package, slot
    for slot."""
    rng = np.random.default_rng(seed)
    m = _Map(rng.integers(-extent, extent, size=(count, 3)), capacity=4096)
    o, d = _rays(rng, R)
    a = ji.ray_intersect_dda(jnp.asarray(o), jnp.asarray(d), m.voxel_keys,
                             m.num_voxels, DDA_SET)
    b = _dda(o, d, m)
    np.testing.assert_array_equal(n(b.voxel_idx), n(a.voxel_idx))
    np.testing.assert_array_equal(n(b.hit_mask), n(a.hit_mask))
    np.testing.assert_allclose(n(b.t_near), n(a.t_near), atol=1e-5)
    np.testing.assert_allclose(n(b.t_far), n(a.t_far), atol=1e-5)
    assert (n(a.voxel_idx) >= 0).sum() > R // 2, "too few hits to compare"
    centers, valid = _centers_valid(m)
    a = ji.ray_intersect_scan(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(centers), jnp.asarray(valid),
                              DDA_SET, chunk=1024)
    b = ti.ray_intersect_scan(t(o), t(d), t(centers), t(valid), PSET,
                              chunk=1024)
    np.testing.assert_array_equal(n(b.voxel_idx), n(a.voxel_idx))
    np.testing.assert_array_equal(n(b.hit_mask), n(a.hit_mask))
    np.testing.assert_allclose(n(b.t_near), n(a.t_near), atol=1e-5)
    np.testing.assert_allclose(n(b.t_far), n(a.t_far), atol=1e-5)


def test_dda_with_prebuilt_occupancy_equal():
    rng = np.random.default_rng(11)
    m = _Map(rng.integers(-14, 14, size=(400, 3)))
    o, d = _rays(rng, 64)
    occ = ti.build_occupancy(t(m.voxel_keys), int(m.num_voxels), PSET)
    a, b = _dda(o, d, m), _dda(o, d, m, occupancy=occ)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(x), n(y))


# --- the JAX package's DDA property tests, on the port ----------------------


def test_dda_matches_scan_oracle_random():
    """DDA == the exact scan, up to corner grazes (chord < march spacing),
    which stay under 2% of the hit slots; depths within 1e-4; DDA output
    sorted by entry depth."""
    rng = np.random.default_rng(3)
    m = _Map(rng.integers(-14, 14, size=(400, 3)))
    centers, valid = _centers_valid(m)
    R = 128
    o, d = _rays(rng, R)
    got = _dda(o, d, m)
    want = ti.ray_intersect_scan(t(o), t(d), t(centers), t(valid), PSET)
    gi_all, wi_all = n(got.voxel_idx), n(want.voxel_idx)
    graze = 0
    for r in range(R):
        wi = [int(v) for v in wi_all[r] if v >= 0]
        gi = [int(v) for v in gi_all[r] if v >= 0]
        for v in wi[:DDA_SET.max_hits]:
            if v not in gi:
                k = wi.index(v)
                chord = float(want.t_far[r, k] - want.t_near[r, k]) * float(
                    np.linalg.norm(d[r]))
                assert chord < 0.45 * 0.2 + 1e-5, (r, v, chord)
                graze += 1
        for k, v in enumerate(gi):
            if v in wi:
                kw = wi.index(v)
                np.testing.assert_allclose(float(got.t_near[r, k]),
                                           float(want.t_near[r, kw]),
                                           atol=1e-4)
                np.testing.assert_allclose(float(got.t_far[r, k]),
                                           float(want.t_far[r, kw]),
                                           atol=1e-4)
        tn = n(got.t_near[r])[:len(gi)]
        assert np.all(np.diff(tn) >= -1e-5), tn
    assert graze < 0.02 * R * DDA_SET.max_hits, graze


def test_dda_wall_straight_on():
    xs, ys = np.meshgrid(np.arange(-2, 3), np.arange(-2, 3))
    m = _Map(np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 5)], -1))
    got = _dda(np.zeros((1, 3), np.float32),
               np.array([[0.0, 0.0, 1.0]], np.float32), m)
    assert bool(got.hit_mask[0])
    assert int(got.voxel_idx[0, 0]) >= 0
    np.testing.assert_allclose(float(got.t_near[0, 0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(got.t_far[0, 0]), 1.2, atol=1e-5)
    assert int(got.voxel_idx[0, 1]) == -1


def test_dda_origin_inside_voxel():
    m = _Map(np.array([[0, 0, 0]]))
    got = _dda(np.array([[0.1, 0.1, 0.1]], np.float32),
               np.array([[0.0, 0.0, 1.0]], np.float32), m)
    assert bool(got.hit_mask[0])
    np.testing.assert_allclose(float(got.t_near[0, 0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(got.t_far[0, 0]), 0.1, atol=1e-6)


def test_dda_respects_max_hits_order():
    # a corridor of 20 voxels along +z; only the first 8 fit in max_hits
    m = _Map(np.stack([np.zeros(20, int), np.zeros(20, int),
                       np.arange(3, 23)], -1))
    got = _dda(np.array([[0.05, 0.05, 0.0]], np.float32),
               np.array([[0.0, 0.0, 1.0]], np.float32), m)
    assert np.all(n(got.voxel_idx[0]) >= 0)
    np.testing.assert_allclose(n(got.t_near[0]), 0.6 + 0.2 * np.arange(8),
                               atol=1e-5)


# --- render_rays with intersect_mode="dda" ----------------------------------


@pytest.mark.parametrize("dec", [DEC, dataclasses.replace(
    DEC, use_fused_mlp=False, matmul_dtype="f32")],
    ids=["fused", "unfused-f32"])
def test_render_rays_dda_match(case, dec):  # noqa: F811
    """Both vox branches (kernel K1's plain version, and the unfused gather
    + plain decoder) with DDA hits: outputs, loss and gradients w.r.t.
    embeddings, rays and decoder params, at the renderer test's
    tolerances."""
    state, params, o, d, noise, gt_c, gt_d = case
    rnd = dataclasses.replace(RENDER, intersect_mode="dda")
    ls = LossSettings()
    tol_out, tol_loss, tol_grad = (UNFUSED_TOL["f32"]
                                   if not dec.use_fused_mlp
                                   else (2e-3, 1e-3, 5e-3))

    def jf(emb, o_, d_, p):
        out = j_render(o_, d_, state, emb, p, dec, rnd, jnp.asarray(noise))
        loss, _ = j_loss(out, jnp.asarray(gt_c), jnp.asarray(gt_d), ls,
                         weight_depth_loss=True)
        return loss, out

    (lj, out_j), gj = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(
        state.embeddings, jnp.asarray(o), jnp.asarray(d), params)

    ts = map_state_from_numpy(state, device="cpu")
    nv = ts.num_voxels     # the engine renders a view sliced to the live count
    view = ts._replace(voxel_keys=ts.voxel_keys[:nv],
                       voxel_vertex_ids=ts.voxel_vertex_ids[:nv])
    emb = ts.embeddings.clone().requires_grad_(True)
    o_t = t(o).requires_grad_(True)
    d_t = t(d).requires_grad_(True)
    p_t = params_from_jax(params, device="cpu")
    for p in tree_leaves(p_t):
        p.requires_grad_(True)
    out_t = tr.render_rays(o_t, d_t, view, emb, p_t, port(dec), port(rnd),
                           t(noise))
    lt, _ = tl.compute_loss(out_t, t(gt_c), t(gt_d), port(ls),
                            weight_depth_loss=True)
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
