"""Mesh extraction from the neural voxel map.

Port of ``proudslam_tpu/mesher.py``:

1. decode a per-voxel (res, res, res) SDF/color grid: trilinear blend of
   the corner embeddings + the plain decoder (``decoder_values`` at the
   config's ``matmul_dtype``, as the JAX mesher; no kernel), in chunks of
   voxels on the map's device;
2. isosurface by marching tetrahedra (``ops/marching.py``);
3. optionally keep only faces with a vertex near the observed depth cloud
   (scipy ``cKDTree`` ball query);
4. optionally color the vertices by decoding at their positions in their
   containing voxel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from proudslam_tpu_torch.config import DecoderSettings, MapSettings
from proudslam_tpu_torch.models.decoder import decoder_values
from proudslam_tpu_torch.ops import voxel_hash as vh
from proudslam_tpu_torch.ops.interp import (gather_voxel_features,
                                            voxel_centers_of)
from proudslam_tpu_torch.ops.marching import marching_tets

# voxels per decode call of grid_scores: 4096 x 8^3 points (2.1M decoder
# rows, ~1 GB of f32 activations at width 128)
GRID_CHUNK = 4096
# vertices per decode call of eval_vertex_colors
COLOR_CHUNK = 1 << 18


@dataclasses.dataclass
class Mesh:
    verts: np.ndarray                    # (N, 3) float32
    faces: np.ndarray                    # (M, 3) int32
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]


def _decode(map_state: vh.MapState, decoder_params, map_settings,
            decoder_settings, pts, idx) -> torch.Tensor:
    feats = gather_voxel_features(pts, idx, map_state.voxel_keys,
                                  map_state.voxel_vertex_ids,
                                  map_state.embeddings,
                                  map_settings.voxel_size)
    return decoder_values(decoder_params, decoder_settings, feats)


@torch.no_grad()
def grid_scores(map_state: vh.MapState, decoder_params,
                map_settings: MapSettings, decoder_settings: DecoderSettings,
                res: int = 8, chunk: int = GRID_CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, res, res, res, 4) rgb + sdf grids of the live voxels, sampled at
    ``linspace(-0.5, 0.5, res) * voxel_size`` per axis around each center,
    and the (V, 3) centers, on the map's device."""
    dev = map_state.embeddings.device
    num = map_state.num_voxels
    centers = voxel_centers_of(map_state.voxel_keys[:num],
                               map_settings.voxel_size)
    lin = np.linspace(-0.5, 0.5, res) * map_settings.voxel_size
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    local = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
                            .astype(np.float32), device=dev)
    grids = []
    for i in range(0, num, chunk):
        c = centers[i:i + chunk]
        B = c.shape[0]
        pts = (c[:, None, :] + local[None]).reshape(-1, 3)
        idx = torch.arange(i, i + B, device=dev).repeat_interleave(res ** 3)
        out = _decode(map_state, decoder_params, map_settings,
                      decoder_settings, pts, idx)
        grids.append(out.reshape(B, res, res, res, 4))
    if not grids:
        return torch.zeros((0, res, res, res, 4), device=dev), centers
    return torch.cat(grids), centers


@torch.no_grad()
def eval_vertex_colors(map_state: vh.MapState, decoder_params,
                       map_settings: MapSettings,
                       decoder_settings: DecoderSettings,
                       verts: np.ndarray, chunk: int = COLOR_CHUNK
                       ) -> np.ndarray:
    """Decoder RGB at each vertex, in its containing voxel (0 where that
    voxel is not in the map)."""
    dev = map_state.embeddings.device
    v = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    coords = torch.floor(v / map_settings.voxel_size).to(torch.int32)
    slots = vh.lookup_voxel_slots(map_state, vh.pack_coords(coords))
    colors = []
    for i in range(0, len(verts), chunk):
        colors.append(_decode(map_state, decoder_params, map_settings,
                              decoder_settings, v[i:i + chunk],
                              slots[i:i + chunk])[:, :3])
    out = torch.cat(colors) if colors else v.new_zeros((0, 3))
    return torch.where((slots >= 0)[:, None], out, 0.0).cpu().numpy()


def clean_mesh_faces(verts: np.ndarray, faces: np.ndarray,
                     depth_points: np.ndarray, radius: float) -> np.ndarray:
    """Keep faces with any vertex within ``radius`` of the observed depth
    cloud."""
    from scipy.spatial import cKDTree
    counts = cKDTree(depth_points).query_ball_point(verts, radius,
                                                     return_length=True)
    vert_ok = np.asarray(counts) > 0
    return faces[vert_ok[faces].any(axis=-1)]


def downsample_points(points: np.ndarray, cell: float = 0.01) -> np.ndarray:
    """Voxel-grid downsample: the first point of each ``cell``-sized cube,
    in the order of the cubes' integer coordinates."""
    keys = np.floor(points / cell).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return points[first]


def extract_mesh(map_state: vh.MapState, decoder_params,
                 map_settings: MapSettings,
                 decoder_settings: DecoderSettings, res: int = 8,
                 depth_points: Optional[np.ndarray] = None,
                 require_color: bool = True) -> Mesh:
    """The whole pipeline: grids -> marching tetrahedra -> optional
    cleaning against ``depth_points`` (within half a voxel) -> optional
    vertex colors."""
    grids, centers = grid_scores(map_state, decoder_params, map_settings,
                                 decoder_settings, res=res)
    verts, faces = marching_tets(grids[..., 3], centers,
                                 map_settings.voxel_size)
    if depth_points is not None and len(verts):
        faces = clean_mesh_faces(verts, faces,
                                 downsample_points(depth_points),
                                 map_settings.voxel_size * 0.5)
    colors = None
    if require_color and len(verts):
        colors = eval_vertex_colors(map_state, decoder_params, map_settings,
                                    decoder_settings, verts)
    return Mesh(verts=verts, faces=faces, colors=colors)


def save_ply(path: str, mesh: Mesh) -> None:
    """ASCII PLY: vertices (with uchar colors if any) and triangles."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mesh.colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if mesh.colors is not None:
            cols = np.clip(mesh.colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(mesh.verts, cols):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in mesh.verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
