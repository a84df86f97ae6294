"""Flat sparse voxel map: sorted cell table + append-only voxel table.

Port of ``proudslam_tpu/ops/voxel_hash.py``. Same tables, same packed
keys (10 bits per axis, bias 512), same allocation order, so the integer
tables match the JAX package exactly:

* cell table — sorted packed corner-cell keys with a stable embedding row
  per key and the voxel slot of SURFACE cells;
* voxel table — SURFACE voxels in allocation order with their 8 corner
  embedding rows;
* inverse vertex map — embedding row -> up to 8 (voxel*8 + corner) entries.

JAX's static-size ``unique(size=F, fill_value=SENTINEL)`` becomes an
explicit pad/truncate, its stable ``argsort`` a ``stable=True`` sort, and
every ``.at[].set(mode="drop")`` an explicit mask. Each scatter below
writes unique destinations (the new-voxel guard and the per-row ranks make
them so), so ``index_put_`` stays deterministic on CUDA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from proudslam_tpu_torch.config import MapSettings

SENTINEL = 2**31 - 1

# corner offsets, z fastest, then y, then x (corner j = (j>>2, (j>>1)&1, j&1))
CORNER_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int32)


class MapState(NamedTuple):
    """Capacity-bounded sparse voxel map (tensors on one device)."""

    cell_keys: torch.Tensor         # (C,) int32 packed coords, ascending
    cell_ids: torch.Tensor          # (C,) int32 embedding row per key
    cell_vslot: torch.Tensor        # (C,) int32 voxel slot if SURFACE else -1
    num_cells: int
    voxel_keys: torch.Tensor        # (V,) int32 packed coords, SENTINEL pad
    voxel_vertex_ids: torch.Tensor  # (V, 8) int32 embedding rows (0 pad)
    num_voxels: int
    embeddings: torch.Tensor        # (E, D) float32
    inv_map: torch.Tensor           # (E, 8) int32 voxel*8+corner, -1 pad


def init_map_state(settings: MapSettings, generator: torch.Generator,
                   device) -> MapState:
    """Empty map; embeddings ~ N(0, 0.01) drawn from ``generator``."""
    C = settings.num_embeddings
    V = settings.voxel_capacity
    i32 = dict(dtype=torch.int32, device=device)
    emb = 0.01 * torch.randn((C, settings.embed_dim), generator=generator,
                             dtype=torch.float32, device=generator.device)
    return MapState(
        cell_keys=torch.full((C,), SENTINEL, **i32),
        cell_ids=torch.zeros((C,), **i32),
        cell_vslot=torch.full((C,), -1, **i32),
        num_cells=0,
        voxel_keys=torch.full((V,), SENTINEL, **i32),
        voxel_vertex_ids=torch.zeros((V, 8), **i32),
        num_voxels=0,
        embeddings=emb.to(device),
        inv_map=torch.full((C, 8), -1, **i32))


def build_map_state_numpy(coords, settings: MapSettings, seed: int = 0,
                          device="cpu") -> MapState:
    """MapState for given integer voxel coords, built in numpy (the JAX
    package's ``build_map_state_numpy``, same tables and embeddings)."""
    coords = np.unique(np.asarray(coords, np.int64), axis=0)
    n = len(coords)
    assert n <= settings.voxel_capacity
    bits = settings.coord_bits
    bias = 1 << (bits - 1)

    def pack(c):
        b = c + bias
        return ((b[..., 0] << (2 * bits)) | (b[..., 1] << bits)
                | b[..., 2]).astype(np.int64)

    corner = (coords[:, None, :]
              + np.asarray(CORNER_OFFSETS, np.int64)).reshape(-1, 3)
    cell_coords = np.unique(corner, axis=0)
    m = len(cell_coords)
    assert m <= settings.num_embeddings
    cell_keys = pack(cell_coords).astype(np.int32)
    cell_ids = np.arange(m, dtype=np.int32)
    vox_keys = pack(coords).astype(np.int32)
    corner_keys = pack(corner).reshape(n, 8).astype(np.int32)
    vvids = cell_ids[np.searchsorted(cell_keys, corner_keys.reshape(-1))
                     ].reshape(n, 8)

    C = settings.num_embeddings
    V = settings.voxel_capacity
    ck = np.full((C,), SENTINEL, np.int32)
    ck[:m] = cell_keys
    ci = np.zeros((C,), np.int32)
    ci[:m] = cell_ids
    cv = np.full((C,), -1, np.int32)
    cv[np.searchsorted(cell_keys, vox_keys)] = np.arange(n, dtype=np.int32)
    vk = np.full((V,), SENTINEL, np.int32)
    vk[:n] = vox_keys
    vv = np.zeros((V, 8), np.int32)
    vv[:n] = vvids
    rng = np.random.default_rng(seed)
    emb = (0.01 * rng.standard_normal(
        (C, settings.embed_dim))).astype(np.float32)
    inv = np.full((C, 8), -1, np.int32)
    flat_e = vvids.reshape(-1)
    flat_i = np.arange(n * 8, dtype=np.int32)
    order = np.argsort(flat_e, kind="stable")
    se, si = flat_e[order], flat_i[order]
    rank = np.arange(n * 8) - np.searchsorted(se, se, side="left")
    inv[se, rank] = si
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return MapState(cell_keys=t(ck), cell_ids=t(ci), cell_vslot=t(cv),
                    num_cells=m, voxel_keys=t(vk), voxel_vertex_ids=t(vv),
                    num_voxels=n, embeddings=t(emb), inv_map=t(inv))


# ---------------------------------------------------------------------------
# coordinate packing
# ---------------------------------------------------------------------------


def pack_coords(coords: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Pack (..., 3) int32 grid coords into sortable int32 keys
    (out-of-range coords -> SENTINEL)."""
    bias = 1 << (bits - 1)
    limit = (1 << bits) - 1
    b = coords + bias
    in_range = torch.all((b >= 0) & (b <= limit), dim=-1)
    key = (b[..., 0] << (2 * bits)) | (b[..., 1] << bits) | b[..., 2]
    return torch.where(in_range, key.to(torch.int32),
                       torch.full_like(key, SENTINEL, dtype=torch.int32))


def unpack_key(keys: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Inverse of :func:`pack_coords` -> (..., 3) int32."""
    bias = 1 << (bits - 1)
    mask = (1 << bits) - 1
    return torch.stack([(keys >> (2 * bits)) & mask, (keys >> bits) & mask,
                        keys & mask], dim=-1).to(torch.int32) - bias


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def _find(state: MapState, flat: torch.Tensor):
    pos = torch.searchsorted(state.cell_keys, flat)
    pos = pos.clamp(0, state.cell_keys.shape[0] - 1)
    found = (state.cell_keys[pos] == flat) & (flat != SENTINEL)
    return pos, found


def lookup_cells(state: MapState, query_keys: torch.Tensor) -> torch.Tensor:
    """Embedding row for each packed key, or -1 where absent."""
    flat = query_keys.reshape(-1).contiguous()
    pos, found = _find(state, flat)
    ids = torch.where(found, state.cell_ids[pos], -1)
    return ids.reshape(query_keys.shape)


def lookup_voxel_slots(state: MapState,
                       query_keys: torch.Tensor) -> torch.Tensor:
    """Voxel slot for each packed key, or -1 if not a SURFACE voxel."""
    flat = query_keys.reshape(-1).contiguous()
    pos, found = _find(state, flat)
    slots = torch.where(found, state.cell_vslot[pos], -1)
    return slots.reshape(query_keys.shape)


def _unique_padded(keys: torch.Tensor, size: int) -> torch.Tensor:
    """Sorted unique values, truncated or SENTINEL-padded to ``size``
    (``jnp.unique(size=size, fill_value=SENTINEL)``)."""
    u = torch.unique(keys, sorted=True)[:size]
    out = torch.full((size,), SENTINEL, dtype=torch.int32, device=keys.device)
    out[:u.shape[0]] = u
    return out


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------


def insert_points(state: MapState, points: torch.Tensor, valid: torch.Tensor,
                  settings: MapSettings,
                  frame_capacity: Optional[int] = None) -> MapState:
    """Insert a world-space point cloud; allocate voxels + corner cells.

    ``frame_capacity``: budget of NEW voxels for this call (default: the
    full ``settings.frame_voxel_capacity``). New voxels beyond it are
    dropped and allocated when observed again.
    """
    dev = points.device
    F = settings.frame_voxel_capacity
    C = state.cell_keys.shape[0]
    V = state.voxel_keys.shape[0]
    E = state.inv_map.shape[0]
    bits = settings.coord_bits
    i32 = dict(dtype=torch.int32, device=dev)

    coords = torch.floor(points / settings.voxel_size).to(torch.int32)
    keys = torch.where(valid, pack_coords(coords, bits), SENTINEL)

    frame_keys = _unique_padded(keys, F)
    frame_valid = frame_keys != SENTINEL
    if frame_capacity and frame_capacity < F:
        # steady state: only NEW voxels, compacted to the small budget
        slot0 = lookup_voxel_slots(state, frame_keys)
        sel = torch.where(frame_valid & (slot0 < 0), frame_keys, SENTINEL)
        frame_keys = torch.sort(sel).values[:frame_capacity]
        frame_valid = frame_keys != SENTINEL
        F = frame_capacity

    offs = torch.as_tensor(CORNER_OFFSETS, device=dev)
    corner_coords = unpack_key(frame_keys, bits)[:, None, :] + offs[None]
    corner_keys = torch.where(frame_valid[:, None],
                              pack_coords(corner_coords, bits), SENTINEL)

    # ---- cell allocation -------------------------------------------------
    cand = _unique_padded(corner_keys.reshape(-1), 8 * F)
    new_cell = (lookup_cells(state, cand) < 0) & (cand != SENTINEL)
    new_ids = state.num_cells + torch.cumsum(new_cell.to(torch.int32), 0) - 1
    fits = new_cell & (new_ids < C)
    new_rows = torch.stack([
        torch.where(fits, cand, SENTINEL),
        torch.where(fits, new_ids, 0).to(torch.int32),
        torch.full((8 * F,), -1, **i32)], dim=1)
    old_rows = torch.stack([state.cell_keys, state.cell_ids,
                            state.cell_vslot], dim=1)
    # stable merge of the sorted table with the candidates, table rows
    # first on ties (only SENTINEL rows tie, and those are all identical)
    rows = torch.cat([old_rows, new_rows], dim=0)
    order = torch.sort(rows[:, 0], stable=True).indices[:C]
    merged = rows[order]
    num_cells = min(state.num_cells + int(fits.sum()), C)
    state = state._replace(
        cell_keys=merged[:, 0].contiguous(), cell_ids=merged[:, 1].contiguous(),
        cell_vslot=merged[:, 2].contiguous(), num_cells=num_cells)

    # ---- voxel allocation ------------------------------------------------
    is_new = frame_valid & (lookup_voxel_slots(state, frame_keys) < 0)
    new_slots = (state.num_voxels
                 + torch.cumsum(is_new.to(torch.int32), 0) - 1)
    vfits = is_new & (new_slots < V)
    slot_for = torch.where(vfits, new_slots, V).to(torch.int32)

    corner_ids = lookup_cells(state, corner_keys)                 # (F, 8)
    voxel_keys = state.voxel_keys.clone()
    voxel_vertex_ids = state.voxel_vertex_ids.clone()
    kept = slot_for[vfits].long()
    voxel_keys[kept] = frame_keys[vfits]
    voxel_vertex_ids[kept] = corner_ids[vfits].clamp_min(0)
    num_voxels = min(state.num_voxels + int(vfits.sum()), V)

    # FEATURE -> SURFACE upgrade of the voxels' own cells
    pos, found = _find(state, frame_keys)
    hit = found & vfits
    cell_vslot = state.cell_vslot.clone()
    cell_vslot[pos[hit]] = slot_for[hit]

    # ---- inverse vertex map ---------------------------------------------
    # row slot = current occupancy + rank among this batch's duplicates
    ecand = torch.where(vfits[:, None] & (corner_ids >= 0), corner_ids, E)
    flat_e = ecand.reshape(-1)
    vals = (slot_for[:, None] * 8
            + torch.arange(8, **i32)[None, :]).reshape(-1)
    order_e = torch.argsort(flat_e, stable=True)
    se = flat_e[order_e].contiguous()
    sv = vals[order_e]
    rank = (torch.arange(8 * F, device=dev)
            - torch.searchsorted(se, se, side="left"))
    cnt = (state.inv_map[se.clamp_max(E - 1).long()] >= 0).sum(dim=1)
    off = cnt + rank
    ok = (se < E) & (off < 8)
    inv_map = state.inv_map.clone().reshape(-1)
    inv_map[(se[ok].long() * 8 + off[ok])] = sv[ok]

    return state._replace(
        voxel_keys=voxel_keys, voxel_vertex_ids=voxel_vertex_ids,
        num_voxels=num_voxels, cell_vslot=cell_vslot,
        inv_map=inv_map.reshape(E, 8))
