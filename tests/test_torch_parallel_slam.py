"""The port's ``SlamSystem`` on a (dp, mp) mesh of gloo ranks — the
production track/map/insert pipeline with ray batches split over dp and
the map tables stored row-sharded over mp — against the single-process
port with the same seed: the counterpart of ``test_multichip_slam.py``,
at its settings (6 frames at 64x48, 20 tracking and 4 mapping
iterations), then ``global_refine(rounds=1)``.

Bounds are the JAX test's: trajectories within 5 mm, embeddings within
0.1, each run's unaligned ATE under 8 cm (reduction order differs across
ranks, and the engine amplifies float-level differences). Under mp every
rank stores exactly its V/mp rows of each voxel table, C/mp of each cell
table and E/mp embedding rows with their Adam moments, and after every
insert the gathered map equals ``insert_points`` of the gathered map
before it on one process; a checkpoint saved under the mesh loads into a
single-process ``SlamSystem`` as the whole map.
"""

import numpy as np
import pytest

import test_multichip_slam as jt
from proudslam_tpu_torch.data.synthetic import SyntheticDataset
from proudslam_tpu_torch.engine.slam import SlamSystem
from proudslam_tpu_torch.utils.metrics import ate_rmse
from torch_parallel import Ranks
from torch_parity import one_torch_thread, port_system  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 6
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    settings = port_system(jt.engine_settings())
    tmp = tmp_path_factory.mktemp("slam")
    ranks = {m: Ranks(tmp, m[0] * m[1], "slam_job", timeout=400,
                      settings=settings, dp=m[0], mp=m[1],
                      n_frames=N_FRAMES) for m in MESHES}
    ds = SyntheticDataset(num_frames=N_FRAMES, width=64, height=48)
    slam = SlamSystem(settings, ds.intrinsics, (ds.height, ds.width),
                      seed=0, device="cpu")
    _, rgb, depth, _, pose0 = ds[0]
    slam.initialize(rgb, depth, pose0, stamp=0)
    for i in range(1, len(ds)):
        _, rgb, depth, _, _ = ds[i]
        slam.process_frame(i, rgb, depth)
    slam.global_refine(rounds=1)
    assert slam.num_kf >= 2     # the refinement sweeps a window
    single = dict(trajectory=slam.get_trajectory(),
                  embeddings=slam.map_state.embeddings.numpy())
    return settings, ds, single, {m: r.wait() for m, r in ranks.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}-mp{m[1]}")
def test_full_engine_on_mesh_matches_single_process(runs, mesh):
    settings, ds, single, meshed = runs
    gt = np.stack(ds.poses)
    est_1 = single["trajectory"]
    ate_1 = ate_rmse(est_1, gt, align=False)
    assert ate_1 < 0.08, f"single ATE {ate_1 * 100:.2f} cm"
    dp, mp = mesh
    V, C = settings.map.voxel_capacity, settings.map.num_embeddings
    D = settings.map.embed_dim
    for rank in meshed[mesh]:
        assert rank["shape"] == {"dp": dp, "mp": mp}
        est_m = rank["trajectory"]
        ate_m = ate_rmse(est_m, gt, align=False)
        assert ate_m < 0.08, f"sharded ATE {ate_m * 100:.2f} cm"
        dt = np.linalg.norm(est_m[:, :3, 3] - est_1[:, :3, 3], axis=-1)
        assert dt.max() < 5e-3, f"divergence {dt.max() * 100:.3f} cm"
        assert np.abs(rank["embeddings"] - single["embeddings"]).max() < 0.1
        # the map as this rank stores it
        st = rank["stored"]
        assert st["voxel_keys"] == (V // mp,)
        assert st["voxel_vertex_ids"] == (V // mp, 8)
        for f in ("cell_keys", "cell_ids", "cell_vslot"):
            assert st[f] == (C // mp,)
        assert st["inv_map"] == (C // mp, 8)
        assert st["embeddings"] == (C // mp, D)
        assert rank["moments"] == [(C // mp, D)] * 2
        # insertion on the gathered map: the single-process table
        assert len(rank["inserts"]) == N_FRAMES and all(rank["inserts"])
        # its checkpoint holds the whole map (a plain SlamSystem loads it)
        assert rank["ckpt_equal"]
    # every rank holds the same trajectory
    for rank in meshed[mesh][1:]:
        np.testing.assert_array_equal(rank["trajectory"],
                                      meshed[mesh][0]["trajectory"])
