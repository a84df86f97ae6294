"""Marching tetrahedra parity: the port's ``ops/marching.py`` against the
JAX package's on the same SDF grids (a sphere, a smooth random field), and
the JAX package's own property tests (``tests/test_marching.py``) run on
the port.

Tolerances: face counts equal; every welded vertex of either within 1e-6
m of one of the other's; the faces, as sets of vertex
triples with vertices closer than 1e-6 m taken as one, equal. The two
compute vertex positions that differ by up to ~5e-8 m (f32 rounding), so a
pair of vertices 1e-5 m apart can weld differently. The tables are numpy
copies and must be equal.
"""

import numpy as np
import pytest
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from proudslam_tpu.ops import marching as jm
from proudslam_tpu_torch.ops import marching as tm

from test_marching import sphere_grid
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _centers(lo, hi, voxel_size):
    r = range(lo, hi)
    return np.array([[(i + 0.5) * voxel_size, (j + 0.5) * voxel_size,
                      (k + 0.5) * voxel_size]
                     for i in r for j in r for k in r], dtype=np.float32)


def _field(kind):
    if kind == "sphere":
        vs = 0.25
        c = _centers(-3, 3, vs)
        return sphere_grid(np.zeros(3), 0.4, c, 8, vs).astype(np.float32), \
            c, vs
    # a smooth random field: sum of random plane waves, 4^3 voxels, R = 6
    vs = 0.2
    c = _centers(-2, 2, vs)
    rng = np.random.default_rng(0)
    lin = np.linspace(-0.5, 0.5, 6) * vs
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    pts = c[:, None, None, None, :] + g[None]
    k = rng.normal(0, 6.0, (5, 3))
    ph = rng.uniform(0, 2 * np.pi, 5)
    sdf = np.sum(np.cos(pts @ k.T + ph), axis=-1) * 0.05 + 0.02
    return sdf.astype(np.float32), c, vs


def _face_sets(vt, ft, vj, fj, tol=1e-6):
    """Both meshes' faces as sets of sorted triples of vertex classes:
    JAX vertices within ``tol`` of each other form one class, and each
    port vertex takes the class of its nearest JAX vertex (which must lie
    within ``tol``)."""
    tree = cKDTree(vj)
    _, cls = connected_components(tree.sparse_distance_matrix(
        tree, tol, output_type="coo_matrix"), directed=False)
    d, near = tree.query(vt)
    assert d.max() <= tol
    as_set = lambda f: {tuple(sorted(x)) for x in f.tolist()}  # noqa: E731
    return as_set(cls[near][ft]), as_set(cls[fj])


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_marching_matches_jax(kind):
    sdf, c, vs = _field(kind)
    vj, fj = jm.marching_tets(sdf, c, vs, chunk=64)
    vt, ft = tm.marching_tets(sdf, c, vs, chunk=37)
    assert len(fj) > 100
    assert len(ft) == len(fj)
    assert cKDTree(vt).query(vj)[0].max() <= 1e-6
    got, ref = _face_sets(vt, ft, vj, fj)
    assert got == ref


def test_tables_match():
    for name in ("CUBE_OFFSETS", "TETS", "TET_EDGES", "TET_TABLE"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


def _sphere(voxel_size=0.25, radius=0.4, lo=-3, hi=3, res=8):
    c = _centers(lo, hi, voxel_size)
    sdf = sphere_grid(np.zeros(3), radius, c, res, voxel_size)
    return tm.marching_tets(sdf, c, voxel_size, chunk=64)


def _table_structure():
    assert (tm.TET_TABLE[0] == -1).all()
    assert (tm.TET_TABLE[15] == -1).all()
    for case in range(1, 15):
        n_neg = bin(case).count("1")
        assert (tm.TET_TABLE[case, :, 0] >= 0).sum() == (2 if n_neg == 2
                                                         else 1)


def _sphere_surface():
    verts, faces = _sphere()
    assert len(verts) > 100 and len(faces) > 100
    np.testing.assert_allclose(np.linalg.norm(verts, axis=-1), 0.4,
                               atol=0.02)
    assert faces.min() >= 0 and faces.max() < len(verts)


def _normals_outward():
    verts, faces = _sphere()
    tri = verts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert ((nrm * tri.mean(axis=1)).sum(-1) > 0).mean() > 0.99


def _no_surface():
    verts, faces = tm.marching_tets(np.ones((4, 8, 8, 8), np.float32),
                                    np.zeros((4, 3), np.float32), 0.2)
    assert len(verts) == 0 and len(faces) == 0


def _watertight():
    verts, faces = _sphere(voxel_size=0.5, radius=0.55, lo=-2, hi=2, res=9)
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=-1)
    assert len(verts) - len(np.unique(edges, axis=0)) + len(faces) == 2


@pytest.mark.parametrize("check", [_table_structure, _sphere_surface,
                                   _normals_outward, _no_surface,
                                   _watertight],
                         ids=lambda f: f.__name__.strip("_"))
def test_marching_properties(check):
    check()
