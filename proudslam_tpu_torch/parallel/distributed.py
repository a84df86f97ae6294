"""Process-group bring-up: ``torch.distributed`` initialization.

Port of ``proudslam_tpu/parallel/distributed.py``. JAX runs one SPMD
program over every host's devices; the port runs one process per device
(a rank), and every collective is written out (``parallel/engine.py``).
Each process calls :func:`initialize` once; :func:`global_engine_mesh`
then lays the ranks out as the (dp, mp) engine mesh.

The backend follows the device: NCCL on CUDA (each rank pinned to
``cuda:{LOCAL_RANK}``), gloo on the CPU. A failed NCCL initialization is
an error: there is no fallback to gloo or to the single-device engine.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Arguments default to torch's standard environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``, ``RANK``;
    ``LOCAL_RANK`` picks the card). ``device="cuda"`` uses NCCL,
    ``device="cpu"`` gloo.
    """
    kind = torch.device(device).type
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev = torch.device("cpu")
        backend = "gloo"
    else:
        raise ValueError(f"initialize: unsupported device {device!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dev


def global_engine_mesh(mp: int = 1, device=None):
    """(dp, mp) engine mesh over every rank (call after
    :func:`initialize`).

    Ranks are laid out process-major (rank = dp_index * mp + mp_index), so
    with L ranks per host (``LOCAL_WORLD_SIZE``) and ``mp`` dividing L,
    each mp group stays inside one host: the embedding all-gathers stay on
    the host's links and only the dp gradient reductions cross hosts.
    """
    from proudslam_tpu_torch.parallel.engine import make_engine_mesh

    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local % mp != 0:
        raise ValueError(f"mp={mp} does not divide the {local} ranks of a "
                         "host: an mp group would span hosts")
    return make_engine_mesh(dist.get_world_size(), mp=mp, device=device)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()
