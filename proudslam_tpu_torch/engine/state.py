"""Device-resident SLAM state: keyframe store + per-keyframe pose Adam.

Port of ``proudslam_tpu/engine/state.py``. Every tracked frame is written
to the provisional slot ``num_kf``; BA optimizes a keyframe window plus
that slot; the host commits the slot by advancing ``num_kf``. ``stamps``
holds 0/1 gauge flags (0 freezes the pose in BA), as in the JAX package.
Unlike the JAX arrays, the store is updated in place (it holds every
keyframe image; copying it per frame would be the largest cost of a
write).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KeyframeStore(NamedTuple):
    rgb: torch.Tensor      # (K, H, W, 3) float32 in [0, 1]
    depth: torch.Tensor    # (K, H, W) float32 meters (0 = invalid)
    stamps: torch.Tensor   # (K,) int32 gauge flags (-1 = empty)
    poses: torch.Tensor    # (K, 6) SE(3) tangent [t, w]
    adam_m: torch.Tensor   # (K, 6) pose Adam moments
    adam_v: torch.Tensor   # (K, 6)
    adam_t: torch.Tensor   # (K,) int32 step counts


def init_keyframe_store(capacity: int, height: int, width: int,
                        device) -> KeyframeStore:
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeStore(
        rgb=torch.zeros((capacity, height, width, 3), **f32),
        depth=torch.zeros((capacity, height, width), **f32),
        stamps=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        poses=torch.zeros((capacity, 6), **f32),
        adam_m=torch.zeros((capacity, 6), **f32),
        adam_v=torch.zeros((capacity, 6), **f32),
        adam_t=torch.zeros((capacity,), dtype=torch.int32, device=device))


def write_frame(store: KeyframeStore, slot: int, rgb, depth, stamp: int,
                pose, adam_m, adam_v, adam_t) -> None:
    """Write a tracked frame into ``slot`` (in place)."""
    with torch.no_grad():
        store.rgb[slot] = rgb
        store.depth[slot] = depth
        store.stamps[slot] = stamp
        store.poses[slot] = pose
        store.adam_m[slot] = adam_m
        store.adam_v[slot] = adam_v
        store.adam_t[slot] = adam_t
