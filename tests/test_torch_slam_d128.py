"""The engine lockstep of ``test_torch_slam.py`` at in_dim 128, the CUDA
kernels' fourth built in_dim: a decoder of in_dim 128 (width 64, which the
kernels run padded to (128, 128, 128) on the card) on embeddings of 128
values, ``initialize`` (10 mapping iterations, two rounds, to keep the
interpreted Pallas kernels' time down) and one frame of the port's
``SlamSystem`` against the JAX package's, with the JAX fused render branch
in interpret mode and the same random draws, at that file's tolerances
(per-frame poses 1e-4, maps and keyframe commits exactly). A file of its
own, so that the test runner can give it a worker beside
``test_torch_slam.py`` and ``test_torch_slam_d64.py``.
"""

import dataclasses

import pytest

from test_torch_engine import settings
from test_torch_slam import _lockstep, dataset, fused_jax  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_slam_lockstep_in_dim_128(dataset):
    s = settings(fresh_window_frames=3)
    s = dataclasses.replace(
        s, map=dataclasses.replace(s.map, embed_dim=128),
        decoder=dataclasses.replace(s.decoder, in_dim=128),
        mapper=dataclasses.replace(s.mapper, init_iterations=10))
    _lockstep(dataset, s, 2)
