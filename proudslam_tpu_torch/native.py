"""ctypes bindings of the native point store (``native/pointstore``).

Port of ``proudslam_tpu/native.py``. :class:`PointStore` is a host-side
incremental voxel-hash point cloud with KNN queries (at most
``points_per_voxel`` points per voxel, ring-replaced; KNN over the 3^3
neighbourhood of the query's voxel). The CLI deduplicates the mesh-cleaning
depth cloud through it. ``pointstore.cpp`` is compiled by ``g++`` at first
use into ``proudslam_tpu_torch/_build/`` (``ops/kernels/build.py``); a
failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from proudslam_tpu_torch.ops.kernels import build

SOURCE = build.PKG_DIR.parent / "native" / "pointstore" / "pointstore.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build.build_host(SOURCE)))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ps_create.restype = vp
        lib.ps_create.argtypes = [ctypes.c_float, i64, i32]
        lib.ps_destroy.restype = None
        lib.ps_destroy.argtypes = [vp]
        lib.ps_num_voxels.restype = i64
        lib.ps_num_voxels.argtypes = [vp]
        lib.ps_num_dropped.restype = i64
        lib.ps_num_dropped.argtypes = [vp]
        lib.ps_insert.restype = None
        lib.ps_insert.argtypes = [vp, i64, f32p, f32p]
        lib.ps_knn.restype = None
        lib.ps_knn.argtypes = [vp, i64, f32p, i32, f32p, f32p, f32p]
        lib.ps_export_voxels.restype = None
        lib.ps_export_voxels.argtypes = [vp, f32p]
        lib.ps_export_points.restype = None
        lib.ps_export_points.argtypes = [vp, f32p, f32p, i32p]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PointStore:
    """Voxel-hash point cloud: bounded points per voxel, 3^3-neighbourhood
    KNN."""

    def __init__(self, voxel_size: float, max_voxels: int = 1 << 17,
                 points_per_voxel: int = 10):
        self._lib = _load()
        self.points_per_voxel = points_per_voxel
        self._h = ctypes.c_void_p(self._lib.ps_create(
            ctypes.c_float(voxel_size), max_voxels, points_per_voxel))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ps_destroy(self._h)
            self._h = None

    __del__ = close

    @property
    def num_voxels(self) -> int:
        return int(self._lib.ps_num_voxels(self._h))

    @property
    def num_dropped(self) -> int:
        return int(self._lib.ps_num_dropped(self._h))

    def insert(self, xyz: np.ndarray, rgb: Optional[np.ndarray] = None):
        xyz = np.ascontiguousarray(xyz, dtype=np.float32).reshape(-1, 3)
        if rgb is not None:
            rgb = np.ascontiguousarray(rgb, dtype=np.float32).reshape(-1, 3)
            if rgb.shape != xyz.shape:
                raise ValueError(f"rgb {rgb.shape} for xyz {xyz.shape}")
        self._lib.ps_insert(self._h, len(xyz), _fptr(xyz),
                            None if rgb is None else _fptr(rgb))

    def knn(self, xyz: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (neighbours (N, k, 3), colors (N, k, 3), dist2 (N, k)); -1
        pads missing neighbours."""
        xyz = np.ascontiguousarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = len(xyz)
        out_xyz = np.empty((n, k, 3), np.float32)
        out_rgb = np.empty((n, k, 3), np.float32)
        out_d2 = np.empty((n, k), np.float32)
        self._lib.ps_knn(self._h, n, _fptr(xyz), k, _fptr(out_xyz),
                         _fptr(out_rgb), _fptr(out_d2))
        return out_xyz, out_rgb, out_d2

    def voxel_centers(self) -> np.ndarray:
        out = np.empty((self.num_voxels, 3), np.float32)
        if len(out):
            self._lib.ps_export_voxels(self._h, _fptr(out))
        return out

    def export_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (xyz (V, ppv, 3), rgb (V, ppv, 3), counts (V,))."""
        v = self.num_voxels
        ppv = self.points_per_voxel
        xyz = np.zeros((v, ppv, 3), np.float32)
        rgb = np.zeros((v, ppv, 3), np.float32)
        counts = np.zeros((v,), np.int32)
        if v:
            self._lib.ps_export_points(
                self._h, _fptr(xyz), _fptr(rgb),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return xyz, rgb, counts
