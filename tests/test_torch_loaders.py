"""Loader, registry and native point store parity: the port's copies
(``proudslam_tpu_torch/data/{replica,scannet,arkit,registry}.py``,
``proudslam_tpu_torch/native.py``) against the JAX package's on
``tests/test_loaders.py``'s fixture directories and on random points.

Tolerances: every loader output identical (frames, intrinsics, poses,
initial pose, errors); the registry's synthetic dataset frame for frame;
the point store's stored points and KNN neighbours identical, KNN squared
distances within 1e-6 (the JAX package's library is built with
``-march=native``, whose fused multiply-adds round the distances
differently).
"""

import numpy as np
import pytest

from proudslam_tpu.config import Config
from proudslam_tpu.data import arkit as ja
from proudslam_tpu.data import registry as jr
from proudslam_tpu.data import replica as jrep
from proudslam_tpu.data import scannet as js
from proudslam_tpu.native import PointStore as JPointStore
from proudslam_tpu.native import native_available
from proudslam_tpu_torch.data import arkit as ta
from proudslam_tpu_torch.data import registry as tr
from proudslam_tpu_torch.data import replica as trep
from proudslam_tpu_torch.data import scannet as ts
from proudslam_tpu_torch.native import PointStore

from test_loaders import arkit_dir, replica_dir, scannet_dir  # noqa: F401


def _same(a, b):
    assert len(a) == len(b)
    assert a.intrinsics == b.intrinsics
    np.testing.assert_array_equal(a.get_init_pose(), b.get_init_pose())
    for i in range(len(b)):
        try:
            ref = b[i]
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                a[i]
            continue
        got = a[i]
        assert got[0] == ref[0]
        for x, y in zip(got[1:], ref[1:]):
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("kw", [{}, {"max_depth": 1.5, "use_gt": True}])
def test_replica_matches(replica_dir, kw):  # noqa: F811
    _same(trep.ReplicaDataset(replica_dir, **kw),
          jrep.ReplicaDataset(replica_dir, **kw))


@pytest.mark.parametrize("kw", [{}, {"scale_factor": 1, "crop": 8},
                                {"use_gt": True, "depth_scale": 500.0}])
def test_scannet_matches(scannet_dir, kw):  # noqa: F811
    _same(ts.ScanNetDataset(scannet_dir, **kw),
          js.ScanNetDataset(scannet_dir, **kw))


@pytest.mark.parametrize("kw", [{}, {"transpose": True}])
def test_arkit_matches(arkit_dir, kw):  # noqa: F811
    _same(ta.ARKitDataset(arkit_dir, **kw), ja.ARKitDataset(arkit_dir, **kw))


def test_registry_matches(replica_dir, scannet_dir, arkit_dir):  # noqa: F811
    for name, path in (("replica", replica_dir), ("scannet", scannet_dir),
                       ("arkit", arkit_dir)):
        cfg = {"dataset": name, "data_specs": {"data_path": path}}
        a, b = tr.get_dataset(Config(cfg)), jr.get_dataset(Config(cfg))
        assert type(a).__module__.startswith("proudslam_tpu_torch.")
        _same(a, b)
    cfg = {"dataset": "synthetic",
           "data_specs": {"num_frames": 2, "width": 32, "height": 24}}
    _same(tr.get_dataset(Config(cfg)), jr.get_dataset(Config(cfg)))
    with pytest.raises(ValueError, match="unknown dataset"):
        tr.get_dataset(Config({"dataset": "kitti"}))


def test_point_store_matches():
    if not native_available():
        pytest.skip("the JAX package's point store did not build")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    cols = rng.random((3000, 3)).astype(np.float32)
    a, b = PointStore(0.3, 1024, 4), JPointStore(0.3, 1024, 4)
    a.insert(pts, cols)
    b.insert(pts, cols)
    a.insert(pts[:100])
    b.insert(pts[:100])
    assert (a.num_voxels, a.num_dropped) == (b.num_voxels, b.num_dropped)
    for x, y in zip(a.export_points(), b.export_points()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.voxel_centers(), b.voxel_centers())
    q = rng.uniform(-1.2, 1.2, (200, 3)).astype(np.float32)
    (xa, ca, da), (xb, cb, db) = a.knn(q, 6), b.knn(q, 6)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(da, db, atol=1e-6)
    a.close()
    a.close()
