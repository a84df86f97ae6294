"""The port's process-group bring-up (``proudslam_tpu_torch/parallel/
distributed.py``) and its production steps across processes, on gloo.

Each rank is a fresh Python process that joins through
``distributed.initialize()`` from torch's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as ranks started by a launcher
do: the counterparts of ``test_distributed.py`` (a cross-process
collective on the global engine mesh) and ``test_multihost_slam.py``
(``track_frame`` and ``map_step`` over the process boundary against the
same calls on one process). The tolerances are the JAX test's: pose atol
2e-4, losses 1e-3 relative, the owned embedding rows atol 5e-3.
"""

import numpy as np

from torch_parallel import run_ranks


def test_four_process_collective(tmp_path):
    """Four ranks as two hosts of two: ``global_engine_mesh(mp=2)`` is
    (2, 2) with each mp group inside one host, and a dp-split array sums
    across hosts."""
    out = run_ranks(tmp_path, 4, "collective_job", from_env=True,
                    local_world=2)
    want = np.arange(16, dtype=np.float32).reshape(8, 2).sum(0)
    for r, res in enumerate(out):
        assert res["shape"] == {"dp": 2, "mp": 2}
        assert res["rank"] == r
        assert (res["dp_index"], res["mp_index"]) == (r // 2, r % 2)
        np.testing.assert_allclose(res["total"], want)
        np.testing.assert_array_equal(res["mp_ranks"],
                                      [2 * (r // 2), 2 * (r // 2) + 1])


def test_production_steps_across_two_processes(tmp_path):
    """``track_frame`` and ``map_step`` on a (2, 1) and a (1, 2) mesh of
    two processes against the same calls on one process."""
    out = run_ranks(tmp_path, 2, "production_job", from_env=True,
                    local_world=2)
    for res in out:
        g = res["local"]
        for mp in (1, 2):
            d = res[mp]
            assert d["shape"] == {"dp": 2 // mp, "mp": mp}
            np.testing.assert_allclose(d["pose"], g["pose"], atol=2e-4)
            for k in ("track_loss", "map_loss"):
                assert abs(d[k] - g[k]) < 1e-3 * max(abs(g[k]), 1.0), k
            np.testing.assert_allclose(d["hit_ratio"], g["hit_ratio"],
                                       atol=1e-6)
            np.testing.assert_allclose(d["poses"], g["poses"], atol=2e-4)
            E = g["embeddings"].shape[0]
            own = slice(d["mp_index"] * E // mp, (d["mp_index"] + 1) * E // mp)
            assert d["embeddings"].shape == (E // mp, g["embeddings"].shape[1])
            np.testing.assert_allclose(d["embeddings"], g["embeddings"][own],
                                       atol=5e-3)
