"""Per-voxel corner-embedding view.

Port of ``corner_view`` and ``CORNER_BITS`` from
``proudslam_tpu/ops/interp.py``. Corner j's offset bits are
``(j>>2, (j>>1)&1, j&1)`` (z fastest). The JAX package folds the corner
view's cotangent onto embedding rows through an inverse-map gather, a TPU
scatter workaround; here autograd's index backward (a scatter-add) does it.
"""

from __future__ import annotations

import numpy as np
import torch

CORNER_BITS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.float32)


def corner_view(embeddings: torch.Tensor,
                vertex_ids: torch.Tensor) -> torch.Tensor:
    """(E, D), (V, 8) -> (V, 8D) per-voxel corner embeddings."""
    V = vertex_ids.shape[0]
    return embeddings[vertex_ids.reshape(-1).long()].reshape(V, -1)
