"""Rank runner and rank jobs of the ``test_torch_parallel_*`` tests.

:func:`run_ranks` starts ``world`` Python processes (one gloo rank each,
one PyTorch thread each) that import this module and nothing of JAX, runs
one job function of it on every rank and returns each rank's result. The
test files build the inputs with the JAX package (numpy arrays, and the
port's settings dataclasses, which pickle without JAX) and hold the ranks'
results against the JAX forms.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """``world`` rank processes running one job; :meth:`wait` returns
    their results by rank."""

    def __init__(self, tmp_path, world: int, job: str, timeout: float = 240,
                 from_env: bool = False, local_world: int = None, **kwargs):
        d = tmp_path / f"{job}_{world}_{free_port()}"
        d.mkdir(parents=True)
        with open(d / "args.pkl", "wb") as f:
            pickle.dump(kwargs, f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=os.pathsep.join([ROOT, TESTS]), TP_DIR=str(d),
                   TP_JOB=job, WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        if local_world is not None:
            env["LOCAL_WORLD_SIZE"] = str(local_world)
        if from_env:
            env.update(MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(free_port()))
        else:
            env["TP_INIT"] = f"file://{d / 'store'}"
        self.dir, self.job, self.world, self.timeout = d, job, world, timeout
        self.procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import torch_parallel; torch_parallel.child()"],
            cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            (self.dir / f"log_{r}.txt").write_text(log)
            assert p.returncode == 0, \
                f"rank {r} of {self.job}:\n{log[-4000:]}"
        out = []
        for r in range(self.world):
            with open(self.dir / f"out_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def run_ranks(tmp_path, world: int, job: str, **kwargs) -> list:
    """Run ``job(**kwargs)`` of this module on ``world`` gloo ranks and
    return their results by rank (:class:`Ranks`: ``from_env`` joins
    through ``distributed.initialize()`` with torch's environment,
    ``MASTER_ADDR``/``MASTER_PORT``, else through a ``file://`` store)."""
    return Ranks(tmp_path, world, job, **kwargs).wait()


def child() -> None:
    import torch
    import torch.distributed as dist

    from proudslam_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    d = os.environ["TP_DIR"]
    with open(os.path.join(d, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    distributed.initialize(init_method=os.environ.get("TP_INIT"),
                           device="cpu")
    out = globals()[os.environ["TP_JOB"]](**kwargs)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "proudslam_tpu")]
    with open(os.path.join(d, f"out_{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# conversions (numpy <-> the port, inside a rank)
# ---------------------------------------------------------------------------


def to_numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    return x


def port_map(arrays: dict):
    from proudslam_tpu_torch.models.decoder import map_state_from_numpy

    return map_state_from_numpy(SimpleNamespace(**arrays), device="cpu")


def port_params(tree):
    from proudslam_tpu_torch.models.decoder import params_from_jax

    return params_from_jax(tree, device="cpu")


def tensors(*arrays):
    import torch

    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def collective_job():
    """``global_engine_mesh(mp=2)`` over the ranks (two per host), and a
    sum over the dp group of a dp-split (8, 2) array."""
    import torch
    import torch.distributed as dist

    from proudslam_tpu_torch.parallel import distributed
    from proudslam_tpu_torch.parallel.engine import (all_gather_rows,
                                                     all_reduce)

    assert distributed.is_initialized()
    mesh = distributed.global_engine_mesh(mp=2)
    full = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    block = full[mesh.dp_index * 8 // mesh.dp:(mesh.dp_index + 1) * 8
                 // mesh.dp]
    total = all_reduce(block.sum(0), mesh.dp_group)
    mp_ranks = all_gather_rows(torch.tensor([dist.get_rank()]),
                               mesh.mp_group, mesh.mp)
    return dict(shape=mesh.shape, rank=mesh.rank, dp_index=mesh.dp_index,
                mp_index=mesh.mp_index, total=to_numpy(total),
                mp_ranks=to_numpy(mp_ranks))


def sharded_job(settings, state, params, batch, mps):
    """One sharded BA step for each mp extent of ``mps`` (None: the
    default of ``make_mesh``); every rank returns the whole results."""
    from proudslam_tpu_torch.parallel.sharded import (make_mesh,
                                                      make_sharded_ba_step)

    ms, dec = port_map(state), port_params(params)
    out = []
    for mp in mps:
        mesh = make_mesh(mp=mp)
        step = make_sharded_ba_step(mesh, settings)
        out.append(dict(shape=mesh.shape,
                        result=to_numpy(step(ms, dec, *tensors(*batch)))))
    return out


def tp_decoder_job(cases):
    """``tp_decoder_values`` with the trunk split over every rank (dp=1,
    mp=world) against the plain ``decoder_values``, for each
    ``DecoderSettings`` of ``cases``: the largest error of the outputs,
    and of the gradients (of a fixed projection of the outputs) w.r.t. the
    input and every decoder leaf, each over its largest magnitude. A split
    leaf's gradient is its owner's block: summed over the ranks first, as
    the sharded step sums it."""
    import torch

    import torch.distributed as dist

    from proudslam_tpu_torch.models.decoder import (decoder_values,
                                                    init_decoder, tree_leaves,
                                                    tree_unflatten)
    from proudslam_tpu_torch.parallel.engine import (all_reduce,
                                                     make_engine_mesh)
    from proudslam_tpu_torch.parallel.sharded import (_split_leaves,
                                                      tp_decoder_values)

    mesh = make_engine_mesh(mp=dist.get_world_size())
    out = []
    for dec in cases:
        gen = torch.Generator().manual_seed(3)
        params = init_decoder(gen, dec, "cpu")
        x = torch.randn((200, dec.in_dim), generator=gen)
        proj = torch.randn((200, 4), generator=gen)
        errs, res = {}, []
        for fn in (lambda p, x: tp_decoder_values(mesh, p, dec, x),
                   lambda p, x: decoder_values(p, dec, x)):
            leaves = [t.clone().requires_grad_(True)
                      for t in tree_leaves(params)]
            xi = x.clone().requires_grad_(True)
            y = fn(tree_unflatten(params, leaves), xi)
            res.append([y] + list(torch.autograd.grad(
                (y * proj).sum(), [xi] + leaves)))
        split = [False, False] + _split_leaves(params)
        res[0] = [all_reduce(g, mesh.group) if s else g
                  for g, s in zip(res[0], split)]
        for i, (a, b) in enumerate(zip(*res)):
            errs[i] = float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
        out.append(errs)
    return out


def spatial_job(settings, state, params, batch, descent_steps=5):
    """The spatial BA step once at lr 1e-2; ``descent_steps`` steps at lr
    5e-2 (losses and the final table); and this rank's ``spatial_grads``
    beside the gradient of the whole batch on this rank alone (the plain
    loss, no collective)."""
    import torch

    from proudslam_tpu_torch.geometry import se3
    from proudslam_tpu_torch.parallel.spatial import (make_joint_mesh,
                                                      make_spatial_ba_step,
                                                      plain_decoder,
                                                      spatial_grads)
    from proudslam_tpu_torch.render.losses import compute_loss
    from proudslam_tpu_torch.render.renderer import render_rays

    mesh = make_joint_mesh()
    step = make_spatial_ba_step(mesh, settings)
    ms, dec = port_map(state), port_params(params)
    poses, dirs, gt_c, gt_d, noise = tensors(*batch)
    out = dict(shape=mesh.shape, rank=mesh.rank, size=mesh.size,
               once=to_numpy(step(ms, dec, poses, dirs, gt_c, gt_d, noise)))

    losses, m, d, p = [], ms, dec, poses
    for _ in range(descent_steps):
        emb, d, p, loss = step(m, d, p, dirs, gt_c, gt_d, noise, lr=5e-2)
        m = m._replace(embeddings=emb)
        losses.append(float(loss))
    out.update(losses=losses, emb_final=to_numpy(m.embeddings))

    loss, g_own, _, _ = spatial_grads(mesh, settings, ms, dec, poses, dirs,
                                      gt_c, gt_d, noise)
    s = plain_decoder(settings)
    F, N = dirs.shape[:2]
    table = ms.embeddings.clone().requires_grad_(True)
    R = se3.exp_rotation(poses[:, 3:6])
    world_d = torch.einsum("fnd,fed->fne", dirs, R).reshape(-1, 3)
    world_o = poses[:, None, 0:3].expand(F, N, 3).reshape(-1, 3)
    outputs = render_rays(world_o, world_d, ms, table, dec, s.decoder,
                          s.render, noise=noise.reshape(F * N, -1))
    ref, _ = compute_loss(outputs, gt_c.reshape(-1, 3), gt_d.reshape(-1),
                          s.loss)
    (g_full,) = torch.autograd.grad(ref, [table])
    out.update(grad_loss=float(loss), g_own=to_numpy(g_own),
               loss_ref=float(ref), g_full=to_numpy(g_full))
    return out


def schur_job(settings, state, params, batch, anchor, reference=False):
    """The Schur GN step at damping 1e-3 and 1e-4; the step with every
    pose anchored (map-only GN) and the residual norm after moving the
    embeddings along it by each step size of a backtracking search; with
    ``reference``, rank 0 also returns ``dense_gn_reference`` at 1e-3."""
    import torch
    import torch.distributed as dist

    from proudslam_tpu_torch.parallel.schur import (dense_gn_reference,
                                                    make_schur_gn_step)
    from proudslam_tpu_torch.parallel.spatial import make_joint_mesh

    mesh = make_joint_mesh()
    ms, dec = port_map(state), port_params(params)
    poses, dirs, gt_d, noise = tensors(*batch)
    anchor = torch.as_tensor(anchor)
    step3 = make_schur_gn_step(mesh, settings, damping=1e-3)
    step4 = make_schur_gn_step(mesh, settings, damping=1e-4)
    out = dict(d3=to_numpy(tuple(step3(ms, dec, poses, dirs, gt_d, noise,
                                       anchor))),
               d4=to_numpy(tuple(step4(ms, dec, poses, dirs, gt_d, noise,
                                       anchor))))
    all_anchored = torch.ones_like(anchor)
    res = step3(ms, dec, poses, dirs, gt_d, noise, all_anchored)
    search = []
    for alpha in (1.0, 0.5, 0.2, 0.05):
        m2 = ms._replace(embeddings=ms.embeddings + alpha * res.d_emb)
        search.append(float(step3(m2, dec, poses, dirs, gt_d, noise,
                                  all_anchored).r_norm))
    out.update(map_only=to_numpy(tuple(res)), search=search)
    if reference and dist.get_rank() == 0:
        out["dense"] = dense_gn_reference(ms, dec, poses, dirs, gt_d, noise,
                                          settings, anchor, damping=1e-3)
    return out


def production_job():
    """``track_frame`` and ``map_step`` on a (2, 1) and a (1, 2) mesh of
    the two ranks, beside the same calls on this rank alone: frame 1 of a
    3-frame synthetic sequence against a map built from frame 0's depth
    (the JAX package's multi-process test, with the port's inputs)."""
    import torch

    from proudslam_tpu_torch.config import (DecoderSettings, LossSettings,
                                            MapperSettings, MapSettings,
                                            RenderSettings, SystemSettings,
                                            TrackerSettings)
    from proudslam_tpu_torch.data.synthetic import SyntheticDataset
    from proudslam_tpu_torch.engine import state as kfstate
    from proudslam_tpu_torch.engine.adam import AdamState
    from proudslam_tpu_torch.engine.mapper import (init_map_opt, map_draws,
                                                   map_step)
    from proudslam_tpu_torch.engine.tracker import track_draws, track_frame
    from proudslam_tpu_torch.geometry import camera, se3
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops import voxel_hash as vh
    from proudslam_tpu_torch.parallel import distributed
    from proudslam_tpu_torch.parallel.engine import shard_embeddings

    settings = SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.05, truncation=0.1,
                              max_distance=10.0, max_hits=8, max_samples=48),
        map=MapSettings(voxel_size=0.2, num_embeddings=4096, embed_dim=16,
                        voxel_capacity=2048, frame_voxel_capacity=1024),
        decoder=DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64),
        tracker=TrackerSettings(n_rays=256, num_iterations=5,
                                learning_rate=0.01),
        mapper=MapperSettings(n_rays_each=256, window_size=1,
                              num_iterations=3, max_keyframes=4),
        loss=LossSettings())
    ds = SyntheticDataset(num_frames=3, width=64, height=48)
    H, W = ds.height, ds.width
    rays_dir = camera.pixel_ray_directions(W, H, *ds.intrinsics,
                                           device="cpu")
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    _, rgb0, depth0, _, pose0 = ds[0]
    _, rgb1, depth1, _, pose1 = ds[1]
    p0 = se3.tangent_from_matrix(f32(pose0))
    pts = camera.transform_points(
        camera.backproject(rays_dir, f32(depth0)).reshape(-1, 3),
        se3.exp_rotation(p0[3:6]), p0[0:3]).numpy()
    coords = np.unique(np.floor(pts / 0.2).astype(np.int64), axis=0)
    state = vh.build_map_state_numpy(coords, settings.map, device="cpu")
    gen = torch.Generator().manual_seed(1)
    dec = init_decoder(gen, settings.decoder, "cpu")
    zeros6 = torch.zeros(6)
    store = kfstate.init_keyframe_store(settings.mapper.max_keyframes, H, W,
                                        "cpu")
    kfstate.write_frame(store, 0, f32(rgb0), f32(depth0), 0, p0, zeros6,
                        zeros6, 0)
    kfstate.write_frame(store, 1, f32(rgb1), f32(depth1), 1,
                        se3.tangent_from_matrix(f32(pose1)), zeros6, zeros6,
                        0)
    opt = init_map_opt(state.embeddings, dec)
    t_draws = track_draws(gen, settings, H * W)
    m_draws = map_draws(gen, settings, 2, H * W)

    def run(mesh):
        st = kfstate.KeyframeStore(*[t.clone() for t in store])
        o = opt
        if mesh is not None:
            o = opt._replace(embed=AdamState(
                m=[shard_embeddings(mesh, opt.embed.m[0])],
                v=[shard_embeddings(mesh, opt.embed.v[0])], t=0))
        t = track_frame(state, dec, p0, rays_dir, f32(rgb1), f32(depth1),
                        settings, t_draws, mesh=mesh)
        m = map_step(state, dec, st, o, rays_dir, [0, 1], [True, True],
                     settings, m_draws, mesh=mesh)
        return dict(pose=to_numpy(t.pose), track_loss=float(t.loss),
                    hit_ratio=float(t.hit_ratio), map_loss=float(m.loss),
                    embeddings=to_numpy(m.embeddings),
                    poses=to_numpy(st.poses[:2]))

    out = dict(local=run(None))
    for mp in (1, 2):
        mesh = distributed.global_engine_mesh(mp=mp)
        out[mp] = dict(run(mesh), shape=mesh.shape, mp_index=mesh.mp_index)
    return out


def slam_job(settings, dp, mp, n_frames):
    """``SlamSystem`` on a (dp, mp) mesh over ``n_frames`` synthetic
    frames at 64x48 and ``global_refine(rounds=1)``. After every insert the gathered map is held against
    ``insert_points`` of the gathered map before it, on this rank alone;
    returns the trajectory, the gathered embeddings, the shapes this rank
    stores and the insert checks."""
    import torch

    from proudslam_tpu_torch.data.synthetic import SyntheticDataset
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.ops import voxel_hash as vh
    from proudslam_tpu_torch.parallel.engine import make_engine_mesh

    inserts = []

    class Checked(SlamSystem):
        def _insert(self, rgb, depth, pose6, big=False):
            before = self.gathered_map_state()
            super()._insert(rgb, depth, pose6, big)
            st = self.point_stride
            d = depth[::st, ::st]
            pts = camera_points(self, d, pose6)
            want = vh.insert_points(
                before, pts, (d > 0).reshape(-1), self.settings.map,
                frame_capacity=None if big else self._steady_cap)
            got = self.gathered_map_state()
            inserts.append(all(
                (got.num_voxels == want.num_voxels,
                 got.num_cells == want.num_cells)) and all(
                torch.equal(getattr(got, f), getattr(want, f))
                for f in ("cell_keys", "cell_ids", "cell_vslot",
                          "voxel_keys", "voxel_vertex_ids", "inv_map")))

    ds = SyntheticDataset(num_frames=n_frames, width=64, height=48)
    mesh = make_engine_mesh(dp * mp, mp=mp, device="cpu")
    slam = Checked(settings, ds.intrinsics, (ds.height, ds.width), seed=0,
                   device="cpu", mesh=mesh)
    _, rgb, depth, _, pose0 = ds[0]
    slam.initialize(rgb, depth, pose0, stamp=0)
    for i in range(1, len(ds)):
        _, rgb, depth, _, _ = ds[i]
        slam.process_frame(i, rgb, depth)
    slam.global_refine(rounds=1)
    # a checkpoint holds the whole map: a plain SlamSystem loads it
    from proudslam_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    path = os.path.join(os.environ["TP_DIR"], f"ckpt_{mesh.rank}")
    save_checkpoint(path, slam)
    plain = load_checkpoint(path, SlamSystem(
        settings, ds.intrinsics, (ds.height, ds.width), device="cpu"))
    full = slam.gathered_map_state()
    ckpt_equal = (np.array_equal(plain.get_trajectory(),
                                 slam.get_trajectory())
                  and all(torch.equal(getattr(plain.map_state, f),
                                      getattr(full, f))
                          for f in ("embeddings", "voxel_keys", "inv_map")))
    ms = slam.map_state
    return dict(ckpt_equal=ckpt_equal,
        shape=mesh.shape, trajectory=slam.get_trajectory(),
        embeddings=to_numpy(slam.gathered_map_state().embeddings),
        stored={f: tuple(getattr(ms, f).shape)
                for f in ms._fields if not isinstance(getattr(ms, f), int)},
        moments=[tuple(t.shape) for t in slam.opt.embed.m + slam.opt.embed.v],
        inserts=inserts)


def camera_points(slam, depth, pose6):
    """World points of a (strided) depth map at ``pose6``, as
    ``SlamSystem._insert`` forms them."""
    from proudslam_tpu_torch.geometry import camera, se3

    st = slam.point_stride
    pts = camera.backproject(slam.rays_dir[::st, ::st], depth).reshape(-1, 3)
    return camera.transform_points(pts, se3.exp_rotation(pose6[3:6]),
                                   pose6[0:3])


def dryrun_job(n):
    from proudslam_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(n, device="cpu")
    return n
