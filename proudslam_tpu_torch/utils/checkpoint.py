"""Checkpoint / resume of the whole SLAM state, in the JAX package's files.

Port of ``proudslam_tpu/utils/checkpoint.py``: one ``.npz`` of arrays
``leaf_0 .. leaf_{n-1}`` plus a ``.meta.json`` sidecar with the host-side
bookkeeping (``num_kf``, ``kf_stamps``, ``frame_poses`` as (reference
keyframe, 4x4 relative pose) pairs, ``num_leaves``). The leaves are in the
order of JAX's ``tree_flatten`` over ``{map_state, decoder_params, opt,
store, last_pose6}`` (dict keys sorted, named tuples in field order), so a
checkpoint written by either package resumes in the other:

  ======================  ============================================
  leaves                  contents (dtype)
  ======================  ============================================
  decoder_params          ``models.decoder.tree_leaves`` order: each
                          dict's keys sorted, lists in order (f32)
  last_pose6              (6,) f32; zeros before ``initialize``
  map_state               cell_keys, cell_ids, cell_vslot, num_cells (0-d
                          int32), voxel_keys, voxel_vertex_ids,
                          num_voxels (0-d int32), embeddings (f32),
                          inv_map
  opt.embed               m, v (E, D) f32, t (0-d int32)
  opt.decoder             m leaves, v leaves (decoder order), t (0-d
                          int32)
  store                   rgb, depth, stamps, poses, pose Adam m, v
                          (K, 6) f32, t (K,) int32
  ======================  ============================================

Like the JAX package's, a checkpoint holds no pcd point store, no
previous pose (the velocity prior restarts from the last pose) and no
host RNG or insert history. Under an mp mesh the file holds the whole map
and embedding moments (gathered; every rank of the mp group saves), and a
load keeps the rank's rows.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, List

import numpy as np
import torch

from proudslam_tpu_torch.engine.adam import AdamState
from proudslam_tpu_torch.engine.mapper import MapOptState
from proudslam_tpu_torch.engine.state import KeyframeStore
from proudslam_tpu_torch.models.decoder import tree_leaves, tree_unflatten
from proudslam_tpu_torch.ops.voxel_hash import MapState
from proudslam_tpu_torch.parallel.engine import (gather_embeddings,
                                                 place_map_state,
                                                 shard_embeddings)

if TYPE_CHECKING:
    from proudslam_tpu_torch.engine.slam import SlamSystem


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(slam: "SlamSystem") -> List[np.ndarray]:
    """The state's leaves in the table's order, as host arrays."""
    last = (slam.last_pose6 if slam.last_pose6 is not None
            else np.zeros((6,), np.float32))
    # under an mp mesh: the full map and moments, gathered from the ranks
    ms, opt, st = slam.gathered_map_state(), slam.opt, slam.store
    opt = opt._replace(embed=opt.embed._replace(
        m=[gather_embeddings(slam.mesh, t) for t in opt.embed.m],
        v=[gather_embeddings(slam.mesh, t) for t in opt.embed.v]))
    i32 = np.int32
    leaves = list(tree_leaves(slam.decoder_params)) + [last]
    leaves += [ms.cell_keys, ms.cell_ids, ms.cell_vslot, i32(ms.num_cells),
               ms.voxel_keys, ms.voxel_vertex_ids, i32(ms.num_voxels),
               ms.embeddings, ms.inv_map]
    leaves += [*opt.embed.m, *opt.embed.v, i32(opt.embed.t)]
    leaves += [*opt.decoder.m, *opt.decoder.v, i32(opt.decoder.t)]
    leaves += [st.rgb, st.depth, st.stamps, st.poses, st.adam_m, st.adam_v,
               st.adam_t]
    return [_np(x) for x in leaves]


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, slam: "SlamSystem") -> None:
    leaves = _leaves(slam)
    np.savez_compressed(_base(path) + ".npz",
                        **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    meta = {
        "num_kf": slam.num_kf,
        "kf_stamps": [int(s) for s in slam.kf_stamps],
        "frame_poses": [(int(ref), _np(rel).tolist())
                        for ref, rel in slam.frame_poses],
        "num_leaves": len(leaves),
    }
    with open(_base(path) + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, slam: "SlamSystem") -> "SlamSystem":
    """Restore a checkpoint of either package into ``slam`` (constructed
    with the settings it was saved under), on ``slam``'s device."""
    dev = slam.device
    with np.load(_base(path) + ".npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n_dec = len(tree_leaves(slam.decoder_params))
    if len(arrays) != 3 * n_dec + 21:
        raise ValueError(f"{path}: {len(arrays)} leaves, expected "
                         f"{3 * n_dec + 21} for these settings")
    it = iter(arrays)

    def take(n=None):
        if n is None:
            return torch.as_tensor(next(it), device=dev)
        return [take() for _ in range(n)]

    slam.decoder_params = tree_unflatten(slam.decoder_params, take(n_dec))
    slam.last_pose6 = take()
    ck, ci, cv, nc, vk, vv, nv, emb, inv = take(9)
    slam.map_state = place_map_state(slam.mesh, MapState(
        cell_keys=ck, cell_ids=ci, cell_vslot=cv, num_cells=int(nc),
        voxel_keys=vk, voxel_vertex_ids=vv, num_voxels=int(nv),
        embeddings=emb, inv_map=inv))
    em, ev, et = take(3)
    em, ev = shard_embeddings(slam.mesh, em), shard_embeddings(slam.mesh, ev)
    dm, dv, dt = take(n_dec), take(n_dec), take()
    slam.opt = MapOptState(embed=AdamState(m=[em], v=[ev], t=int(et)),
                           decoder=AdamState(m=dm, v=dv, t=int(dt)))
    slam.store = KeyframeStore(*take(7))
    with open(_base(path) + ".meta.json") as f:
        meta = json.load(f)
    slam.num_kf = meta["num_kf"]
    slam.kf_stamps = list(meta["kf_stamps"])
    slam.frame_poses = [
        (int(ref), torch.as_tensor(np.asarray(rel, np.float32), device=dev))
        for ref, rel in meta["frame_poses"]]
    return slam
