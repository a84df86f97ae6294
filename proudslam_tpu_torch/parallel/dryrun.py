"""Entry points: the render + loss forward, and the multi-device dry run.

Port of the repository's ``__graft_entry__.py``:

* :func:`entry` — ``(fn, example_args)``: the differentiable SDF volume
  render + SLAM loss over a wall of 169 voxels, 256 rays;
* :func:`dryrun_multichip` — every multi-device form on the ranks of the
  caller's process group (``parallel/distributed.initialize``), with the
  JAX dry run's settings and assertions: the production ``SlamSystem`` on
  an (n/mp, mp) mesh against the single-device run, the sharded, spatial
  and Schur BA steps, and the engine with its map stored over all ranks
  (dp=1, mp=n).

Unlike the JAX dry run, the engine forms keep the decoder kernels on
(``use_fused_mlp`` as configured): a rank is a single-device program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _tiny_setup(voxel_capacity: int = 512, n_rays: int = 256,
                device="cuda"):
    from proudslam_tpu_torch.config import (DecoderSettings, MapSettings,
                                            RenderSettings, SystemSettings)
    from proudslam_tpu_torch.models.decoder import init_decoder
    from proudslam_tpu_torch.ops import voxel_hash as vh

    settings = SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02, max_hits=12,
                              max_samples=60),
        map=MapSettings(voxel_size=0.2, num_embeddings=2048, embed_dim=16,
                        voxel_capacity=voxel_capacity,
                        frame_voxel_capacity=256),
        decoder=DecoderSettings(),
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    # a wall of voxels at z ~ 1
    xs, ys = np.meshgrid(np.arange(-6, 7), np.arange(-6, 7))
    coords = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 5)], axis=-1)
    state = vh.build_map_state_numpy(coords, settings.map, device=device)
    params = init_decoder(gen, settings.decoder, device)
    rays_d = torch.cat([
        0.3 * torch.randn((n_rays, 2), generator=gen, device=device),
        torch.ones((n_rays, 1), device=device)], dim=-1)
    rays_o = torch.zeros((n_rays, 3), device=device)
    noise = torch.rand(
        (n_rays, settings.render.max_samples - settings.render.max_hits),
        generator=gen, device=device)
    return settings, state, params, rays_o, rays_d, noise


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model — the
    differentiable SDF volume renderer + SLAM loss over a voxel map."""
    from proudslam_tpu_torch.render.losses import compute_loss
    from proudslam_tpu_torch.render.renderer import render_rays

    settings, state, params, rays_o, rays_d, noise = _tiny_setup(
        device=device)

    def fn(decoder_params, map_state, rays_o, rays_d, noise):
        outputs = render_rays(
            rays_o, rays_d, map_state, map_state.embeddings,
            decoder_params, settings.decoder, settings.render, noise=noise)
        gt_c = torch.full(outputs.color.shape, 0.5, device=rays_o.device)
        gt_d = torch.full(outputs.depth.shape, 1.05, device=rays_o.device)
        loss, _ = compute_loss(outputs, gt_c, gt_d, settings.loss)
        return loss

    return fn, (params, state, rays_o, rays_d, noise)


def _engine_settings(track_iters: int, init_iters: int):
    from proudslam_tpu_torch.config import (DecoderSettings, LossSettings,
                                            MapSettings, MapperSettings,
                                            RenderSettings, SystemSettings,
                                            TrackerSettings)

    return SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02,
                              max_hits=12, max_samples=72),
        map=MapSettings(voxel_size=0.2, num_embeddings=8192, embed_dim=16,
                        voxel_capacity=4096, frame_voxel_capacity=1024),
        decoder=DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64),
        tracker=TrackerSettings(n_rays=256, num_iterations=track_iters,
                                learning_rate=0.01),
        mapper=MapperSettings(n_rays_each=256, window_size=2,
                              num_iterations=3, keyframe_gap=4,
                              max_keyframes=16, init_iterations=init_iters),
        loss=LossSettings(),
    )


def _run_engine(settings, ds, device, mesh):
    from proudslam_tpu_torch.engine.slam import SlamSystem

    slam = SlamSystem(settings, ds.intrinsics, (ds.height, ds.width),
                      seed=0, device=device, mesh=mesh)
    _, rgb, depth, _, pose0 = ds[0]
    slam.initialize(rgb, depth, pose0, stamp=0)
    for i in range(1, len(ds)):
        _, rgb, depth, _, _ = ds[i]
        slam.process_frame(i, rgb, depth)
    return slam


def _dryrun_full_engine(n_devices: int, device) -> None:
    """The production ``SlamSystem`` (track + map + insert) for several
    frames on an (n/mp, mp) mesh; its trajectory must stay within 5 mm of
    the single-device run's."""
    from proudslam_tpu_torch.data.synthetic import SyntheticDataset
    from proudslam_tpu_torch.parallel.engine import make_engine_mesh

    settings = _engine_settings(track_iters=10, init_iters=12)
    ds = SyntheticDataset(num_frames=4, width=64, height=48)
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_engine_mesh(n_devices, mp=mp, device=device)
    est_mesh, est_single = (_run_engine(settings, ds, device,
                                        m).get_trajectory()
                            for m in (mesh, None))
    dt = np.linalg.norm(
        est_mesh[:, :3, 3] - est_single[:, :3, 3], axis=-1).max()
    assert np.isfinite(est_mesh).all()
    assert dt < 5e-3, f"mesh-vs-single trajectory divergence {dt:.4f} m"
    print(f"dryrun_multichip({n_devices}): FULL ENGINE mesh={mesh.shape} "
          f"{len(ds)} frames, trajectory matches single-device "
          f"(max divergence {dt * 1000:.2f} mm) OK", flush=True)


def _dryrun_spatial_engine(n_devices: int, device) -> None:
    """The ``SlamSystem`` with its map stored over every rank (dp=1,
    mp=n): each rank keeps V/n voxel rows and E/n embedding rows through
    track, map and insert."""
    from proudslam_tpu_torch.data.synthetic import SyntheticDataset
    from proudslam_tpu_torch.parallel.engine import make_engine_mesh

    settings = _engine_settings(track_iters=8, init_iters=9)
    ds = SyntheticDataset(num_frames=3, width=64, height=48)
    mesh = make_engine_mesh(n_devices, mp=n_devices, device=device)
    slam = _run_engine(settings, ds, device, mesh)
    est = slam.get_trajectory()
    assert np.isfinite(est).all()
    ms, m = slam.map_state, settings.map
    assert ms.voxel_keys.shape[0] == m.voxel_capacity // n_devices
    assert ms.embeddings.shape[0] == m.num_embeddings // n_devices
    print(f"dryrun_multichip({n_devices}): SPATIAL production engine "
          f"mesh={mesh.shape} {len(ds)} frames, map row-sharded over "
          f"{n_devices} ranks OK", flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every multi-device form over the process group's
    ``n_devices`` ranks (each rank calls it), as the JAX dry run does:

    1. the production ``SlamSystem`` on a (dp, mp) mesh, trajectory
       within 5 mm of the single-device run;
    2. the sharded BA step (rays on dp, embedding rows and decoder width
       on mp, ``parallel/sharded.py``);
    3. the spatial BA step (voxel table, embedding rows and rays over
       every rank, ``parallel/spatial.py``);
    4. the Schur-structured Gauss-Newton step (``parallel/schur.py``);
    5. the ``SlamSystem`` with its map stored over every rank.
    """
    from proudslam_tpu_torch.parallel.schur import make_schur_gn_step
    from proudslam_tpu_torch.parallel.sharded import (make_mesh,
                                                      make_sharded_ba_step)
    from proudslam_tpu_torch.parallel.spatial import (make_joint_mesh,
                                                      make_spatial_ba_step)

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a process group "
                         f"of {dist.get_world_size()} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    _dryrun_full_engine(n_devices, device)

    settings, state, params, _, _, _ = _tiny_setup(device=device)
    mesh = make_mesh(n_devices, device=device)
    step = make_sharded_ba_step(mesh, settings)
    F, N = 2, 128
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    SJ = settings.render.max_samples - settings.render.max_hits
    dirs = torch.cat([
        0.3 * torch.randn((F, N, 2), generator=gen, device=device),
        torch.ones((F, N, 1), device=device)], dim=-1)
    gt_c = torch.rand((F, N, 3), generator=gen, device=device)
    gt_d = 1.0 + 0.1 * torch.rand((F, N), generator=gen, device=device)
    noise = torch.rand((F, N, SJ), generator=gen, device=device)
    poses = torch.zeros((F, 6), device=device)

    new_emb, _, new_poses, loss = step(state, params, poses, dirs, gt_c,
                                       gt_d, noise)
    assert np.isfinite(float(loss)), float(loss)
    assert torch.isfinite(new_emb).all() and torch.isfinite(new_poses).all()
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
          f"loss={float(loss):.4f} OK", flush=True)

    jmesh = make_joint_mesh(n_devices, device=device)
    sstep = make_spatial_ba_step(jmesh, settings)
    semb, _, sposes, sloss = sstep(state, params, poses, dirs, gt_c, gt_d,
                                   noise)
    assert np.isfinite(float(sloss)), float(sloss)
    assert torch.isfinite(semb).all() and torch.isfinite(sposes).all()
    print(f"dryrun_multichip({n_devices}): spatial mesh={jmesh.shape} "
          f"loss={float(sloss):.4f} OK", flush=True)

    gstep = make_schur_gn_step(jmesh, settings)
    anchor = torch.zeros((F,), dtype=torch.bool, device=device)
    anchor[0] = True
    gres = gstep(state, params, poses, dirs, gt_d, noise, anchor)
    assert torch.isfinite(gres.d_poses).all()
    assert torch.isfinite(gres.d_emb).all()
    assert np.isfinite(float(gres.r_norm))
    print(f"dryrun_multichip({n_devices}): Schur GN step "
          f"|r|={float(gres.r_norm):.4f} "
          f"|dT|={float(gres.d_poses.abs().max()):.5f} OK", flush=True)

    _dryrun_spatial_engine(n_devices, device)
