"""The (dp, mp) engine mesh on ``torch.distributed``, and the collectives
the engine writes out.

Port of ``proudslam_tpu/parallel/engine.py``. JAX shards the production
engine with sharding constraints and lets GSPMD insert the collectives;
each torch rank is a single-device program, so the port places the state
by hand and calls every collective itself:

* ``dp`` — the per-iteration ray batches (tracking: (N, ...) rays,
  mapping: (Wsel, N, ...) rays per window frame) are split into
  contiguous blocks, one per dp index (the rays GSPMD gives device i);
  the loss's normalizing statistics and the gradients of replicated
  parameters are all-reduced over the dp group.
* ``mp`` — every map table (cell table, voxel table, inverse vertex map,
  embeddings) is stored row-sharded: a rank keeps rows
  ``[i * n / mp, (i + 1) * n / mp)`` of each, so its map memory is
  O(V/mp + E/mp); the counters replicate. Rendering and insertion read the
  full view, all-gathered inside the mp group.

Ranks are laid out process-major: rank = dp_index * mp + mp_index. The
ranks of one dp row (an mp group) render the same rays.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# Newer torch renames the two collectives below (``all_gather_single``,
# ``reduce_scatter_single``) and warns on every call of the old names;
# older torch has only the old names, which both keep.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

# the map tables stored row-sharded under mp (``map_state_shardings`` of
# the JAX package); the counters replicate
ROW_FIELDS = ("cell_keys", "cell_ids", "cell_vslot", "voxel_keys",
              "voxel_vertex_ids", "embeddings", "inv_map")


@dataclasses.dataclass(frozen=True)
class EngineMesh:
    """This rank's place in a (dp, mp) grid of ranks, with its groups."""

    dp: int
    mp: int
    rank: int
    dp_index: int
    mp_index: int
    group: object       # every rank of the mesh
    dp_group: object    # the dp ranks sharing this rank's mp index
    mp_group: object    # the mp ranks of this rank's dp row
    device: torch.device

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}


def _default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_engine_mesh(n_devices: Optional[int] = None, mp: int = 1,
                     device=None) -> EngineMesh:
    """(dp, mp) mesh over the process group's ranks (collective: every
    rank calls it, in the same order as any other group creation).

    A rank is one device, so ``n_devices`` (default: the world size) must
    be the world size; it must divide by ``mp``.
    """
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the "
                         f"process group has {world}")
    if n % mp != 0:
        raise ValueError(f"mp={mp} does not divide {n} devices")
    dp = n // mp
    rank = dist.get_rank()
    dp_groups = [_group([i * mp + j for i in range(dp)]) for j in range(mp)]
    mp_groups = [_group([i * mp + j for j in range(mp)]) for i in range(dp)]
    return EngineMesh(
        dp=dp, mp=mp, rank=rank, dp_index=rank // mp, mp_index=rank % mp,
        group=dist.group.WORLD, dp_group=dp_groups[rank % mp],
        mp_group=mp_groups[rank // mp],
        device=torch.device(device) if device is not None
        else _default_device())


def _group(ranks: List[int]):
    """A process group of ``ranks`` (the world's own group when they are
    every rank: no new communicator). Collective over the world."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


# ---------------------------------------------------------------------------
# collectives (group sizes: each tensor's leading dim splits evenly)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, as a new tensor."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """Sum each tensor over ``group`` in one collective (f32 tensors)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' row blocks of ``group``, concatenated in rank
    order (each rank's ``t`` has the same shape)."""
    t = t.detach().contiguous()
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter_rows(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """This rank's row block of the sum of ``t`` over the ``size`` ranks
    of ``group`` (the transpose of :func:`all_gather_rows`)."""
    t = t.detach().contiguous()
    out = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def rows(total: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``total`` rows split into ``parts``."""
    if total % parts != 0:
        raise ValueError(f"{total} rows do not split into {parts} blocks")
    n = total // parts
    return slice(index * n, (index + 1) * n)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def shard_ray_batch(mesh: Optional[EngineMesh], batch_dim: int, *tensors):
    """This rank's contiguous block of each tensor's ``batch_dim`` axis
    over dp (the tensors unchanged when ``mesh`` is None)."""
    if mesh is None:
        return tensors
    out = []
    for t in tensors:
        s = rows(t.shape[batch_dim], mesh.dp, mesh.dp_index)
        out.append(t.narrow(batch_dim, s.start, s.stop - s.start))
    return tuple(out)


def shard_embeddings(mesh: Optional[EngineMesh], embeddings: torch.Tensor):
    """This rank's rows of an (E, ...) table over mp (the table when
    ``mesh`` is None or has no mp extent)."""
    if mesh is None or mesh.mp <= 1:
        return embeddings
    return embeddings[rows(embeddings.shape[0], mesh.mp, mesh.mp_index)]


def gather_embeddings(mesh: Optional[EngineMesh], t: torch.Tensor):
    """The whole (E, ...) table from every mp rank's rows ``t`` (the
    inverse of :func:`shard_embeddings`; ``t`` when there is no mp
    extent)."""
    if mesh is None or mesh.mp <= 1:
        return t
    return all_gather_rows(t, mesh.mp_group, mesh.mp)


def map_state_shardings(mesh: EngineMesh, map_state) -> dict:
    """The row block of each map table this rank stores (None for the
    replicated counters)."""
    return {name: (rows(getattr(map_state, name).shape[0], mesh.mp,
                        mesh.mp_index) if name in ROW_FIELDS else None)
            for name in map_state._fields}


def place_map_state(mesh: Optional[EngineMesh], map_state):
    """The map as this rank stores it: each table's row block under mp
    (the map unchanged when ``mesh`` is None or has no mp extent)."""
    if mesh is None or mesh.mp <= 1:
        return map_state
    spec = map_state_shardings(mesh, map_state)
    return map_state._replace(**{
        name: getattr(map_state, name)[s].clone()
        for name, s in spec.items() if s is not None})


def gather_map_state(mesh: Optional[EngineMesh], map_state):
    """The full map from every mp rank's row blocks (what rendering and
    insertion read); unchanged when there is no mp extent."""
    if mesh is None or mesh.mp <= 1:
        return map_state
    return map_state._replace(**{
        name: all_gather_rows(getattr(map_state, name), mesh.mp_group,
                              mesh.mp)
        for name in ROW_FIELDS})
