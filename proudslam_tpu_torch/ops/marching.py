"""Isosurface extraction: marching tetrahedra over per-voxel SDF grids.

Port of ``proudslam_tpu/ops/marching.py``. Each cell of a voxel's
(R, R, R) SDF grid is split into 6 tetrahedra around its 0-7 diagonal; the
16-case tetrahedron table (at most 2 triangles per case) is derived from
first principles below, and every cell of every voxel is processed at once
as tensor code on the grids' device. Triangles are flipped so their normal
follows the cell's SDF gradient (inside -> outside). The host then welds
the triangle soup's vertices at 1e-5 m and drops degenerate faces.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# cube corners in (x, y, z)-bit order: corner j -> (j>>2 & 1, j>>1 & 1, j & 1)
CUBE_OFFSETS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                         for z in (0, 1)], dtype=np.float32)

# 6-tetrahedra decomposition of the cube around the 0-7 diagonal
TETS = np.array([
    [0, 4, 6, 7],
    [0, 6, 2, 7],
    [0, 2, 3, 7],
    [0, 3, 1, 7],
    [0, 1, 5, 7],
    [0, 5, 4, 7],
], dtype=np.int32)

TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                     dtype=np.int32)


def _edge_id(a: int, b: int) -> int:
    for i, (u, v) in enumerate(TET_EDGES):
        if {u, v} == {a, b}:
            return i
    raise ValueError((a, b))


def _build_tet_table() -> np.ndarray:
    """(16, 2, 3) triangle table: per sign case (bit i set = corner i
    negative), up to 2 triangles of tet edge ids (-1 padding). 1 vs 3
    corners give one triangle, 2 vs 2 a quad."""
    table = np.full((16, 2, 3), -1, dtype=np.int32)
    for case in range(16):
        neg = [i for i in range(4) if (case >> i) & 1]
        pos = [i for i in range(4) if not (case >> i) & 1]
        tris = []
        if len(neg) == 1:
            a = neg[0]
            tris.append([_edge_id(a, p) for p in pos])
        elif len(neg) == 3:
            a = pos[0]
            tris.append([_edge_id(a, n) for n in neg])
        elif len(neg) == 2:
            a, b = neg
            c, d = pos
            e_ac, e_ad = _edge_id(a, c), _edge_id(a, d)
            e_bc, e_bd = _edge_id(b, c), _edge_id(b, d)
            tris.append([e_ac, e_ad, e_bd])
            tris.append([e_ac, e_bd, e_bc])
        for ti, tri in enumerate(tris):
            table[case, ti] = tri
    return table


TET_TABLE = _build_tet_table()


def marching_tets_chunk(sdf: torch.Tensor, centers: torch.Tensor,
                        voxel_size: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangle soup of a batch of voxels.

    Args:
      sdf: (B, R, R, R) per-voxel SDF grids sampled on
        ``linspace(-0.5, 0.5, R) * voxel_size + center`` per axis.
      centers: (B, 3) voxel centers.

    Returns:
      verts: (B, C, 6, 2, 3, 3) triangle vertex positions (world);
      mask: (B, C, 6, 2) bool, the valid triangles. C = (R-1)^3 cells.
    """
    dev = sdf.device
    B, R = sdf.shape[0], sdf.shape[1]
    r = R - 1
    C = r * r * r

    # 8 corner values per cell via shifted slices, (B, C, 8)
    corner_vals = torch.stack([
        sdf[:, dx:dx + r, dy:dy + r, dz:dz + r].reshape(B, C)
        for dx, dy, dz in CUBE_OFFSETS.astype(np.int64).tolist()], dim=-1)

    ii, jj, kk = torch.meshgrid(torch.arange(r, device=dev),
                                torch.arange(r, device=dev),
                                torch.arange(r, device=dev), indexing="ij")
    base = torch.stack([ii, jj, kk], dim=-1).reshape(C, 3).float()
    offs = torch.as_tensor(CUBE_OFFSETS, device=dev)            # (8, 3)
    grid_pos = base[:, None, :] + offs[None, :, :]              # (C, 8, 3)
    local = (grid_pos / r - 0.5) * voxel_size
    corner_pos = centers[:, None, None, :] + local[None]        # (B, C, 8, 3)

    tets = torch.as_tensor(TETS, device=dev).long()             # (6, 4)
    tet_vals = corner_vals[:, :, tets]                          # (B, C, 6, 4)
    tet_pos = corner_pos[:, :, tets]                         # (B, C, 6, 4, 3)

    bits = (tet_vals < 0).long()
    case = (bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2]
            + 8 * bits[..., 3])
    tri_edges = torch.as_tensor(TET_TABLE, device=dev).long()[case]
    valid = tri_edges[..., 0] >= 0                              # (B, C, 6, 2)

    edges = torch.as_tensor(TET_EDGES, device=dev).long()
    ab = edges[tri_edges.clamp_min(0)]                          # (..., 3, 2)
    N = B * C * 6
    vals = tet_vals.reshape(N, 4)
    pos = tet_pos.reshape(N, 4, 3)
    ea = ab[..., 0].reshape(N, 6)
    eb = ab[..., 1].reshape(N, 6)
    va = torch.gather(vals, 1, ea).reshape(N, 2, 3)
    vb = torch.gather(vals, 1, eb).reshape(N, 2, 3)
    pa = torch.gather(pos, 1, ea[..., None].expand(N, 6, 3))
    pb = torch.gather(pos, 1, eb[..., None].expand(N, 6, 3))
    pa, pb = pa.reshape(N, 2, 3, 3), pb.reshape(N, 2, 3, 3)

    t = torch.clamp(va / (va - vb + 1e-12), 0.0, 1.0)
    verts = (pa + t[..., None] * (pb - pa)).reshape(B, C, 6, 2, 3, 3)

    # orient: flip triangles whose normal opposes the SDF gradient
    normal = torch.linalg.cross(verts[..., 1, :] - verts[..., 0, :],
                                verts[..., 2, :] - verts[..., 0, :])
    cv = corner_vals
    gx = cv[..., 4:8].mean(-1) - cv[..., 0:4].mean(-1)
    gy = cv[..., [2, 3, 6, 7]].mean(-1) - cv[..., [0, 1, 4, 5]].mean(-1)
    gz = cv[..., 1::2].mean(-1) - cv[..., 0::2].mean(-1)
    grad = torch.stack([gx, gy, gz], dim=-1)                    # (B, C, 3)
    flip = torch.sum(normal * grad[:, :, None, None, :], dim=-1) < 0
    verts = torch.where(flip[..., None, None], verts.flip(-2), verts)
    return verts, valid


def weld(soup: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(M, 3, 3) triangles -> (verts (N, 3) f32, faces (M', 3) int32):
    vertices merged where they round to one 1e-5 m grid point (the first
    occurrence is kept), degenerate faces dropped."""
    flat = soup.reshape(-1, 3)
    keys = np.round(flat / 1e-5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    first = np.full(len(uniq), len(flat), dtype=np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    verts = flat[first].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def marching_tets(sdf_grids, centers, voxel_size: float, chunk: int = 512
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh of every voxel grid with a sign change, computed on the grids'
    device (the CPU for arrays).

    Args:
      sdf_grids: (V, R, R, R) tensor or array; centers: (V, 3).
      chunk: voxels per :func:`marching_tets_chunk` call (memory bound:
        ~0.4 MB per voxel at R = 8).
    Returns:
      (verts (N, 3) float32, faces (M, 3) int32) as numpy.
    """
    sdf_grids = torch.as_tensor(sdf_grids)
    centers = torch.as_tensor(centers, device=sdf_grids.device)
    flat = sdf_grids.reshape(sdf_grids.shape[0], -1)
    # only voxels whose grid changes sign hold a surface
    keep = torch.nonzero((flat.amin(1) <= 0) & (flat.amax(1) >= 0))[:, 0]
    tris = []
    for i in range(0, keep.shape[0], chunk):
        sel = keep[i:i + chunk]
        verts, mask = marching_tets_chunk(sdf_grids[sel].float(),
                                          centers[sel].float(),
                                          float(voxel_size))
        tris.append(verts.reshape(-1, 3, 3)[mask.reshape(-1)].cpu().numpy())
    if not tris or not sum(len(t) for t in tris):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return weld(np.concatenate(tris))
