"""Command-line entry point of the port:

    python -m proudslam_tpu_torch.run_slam configs/synthetic/room.yaml \
        [--seed N] [--resume CKPT] [--no-mesh] [--device cuda] \
        [--key value ...]

Port of ``scripts/run_slam.py``. Loads the YAML config (with
``base_config`` inheritance and dotted overrides such as
``--tracker_specs.num_iterations 20``), builds the dataset and the
``SlamSystem``, initializes from frame 0 (or resumes a checkpoint), runs
track + map over the sequence with a per-frame guard that skips corrupt
frames, then the optional ``finalize``, ``global_refine`` (+ optional
``rebake_map``), and writes the trajectory (``misc/frame_poses.npy``), the
ATE (``metrics.jsonl``), a checkpoint (``ckpt/final_ckpt.npz`` +
``.meta.json``), the mesh (``mesh/final_mesh.ply``) and the config
(``bak/``) under ``<log_dir>/<exp_name>/<timestamp>/``. With
``debug_args.render_freq > 0`` every ``render_freq``-th frame also gets a
rendered-vs-ground-truth panel at ``debug_args.render_res``
(``imgs/render_<frame>.png``, ``RunLogger.log_images``), from the preview's
own noise: the panels do not change the run's trajectory.

The system runs on ``--device`` (default ``cuda``, which must exist; the
tests pass ``cpu``). :func:`main` also returns a summary of the run.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_overrides(extra: List[str]) -> Dict[str, object]:
    """``["--a.b", "3", "--c", "true"]`` -> ``{"a.b": 3, "c": True}``
    (ints, then floats, then the words true/false; else the string)."""
    out = {}
    i = 0
    while i < len(extra):
        key = extra[i].lstrip("-")
        val = extra[i + 1]
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if val in ("true", "True"):
            val = True
        elif val in ("false", "False"):
            val = False
        out[key] = val
        i += 2
    return out


def accumulate_depth_cloud(dataset, traj: np.ndarray, start: int, settings,
                           max_frames: int = 60,
                           pixel_stride: int = 4) -> np.ndarray:
    """World-space depth points of up to ``max_frames`` frames, each pixel
    ``pixel_stride`` in both directions, deduplicated through the native
    ``PointStore`` (2 points per quarter-voxel cube), for mesh cleaning.

    Trajectory entry ``j`` is paired with ``dataset[start + j]``, as in the
    JAX CLI: with ``start`` past the initial frame, frame j + 1 is
    back-projected at pose j, and frames past the end of the dataset are
    skipped (a reference quirk the port keeps, so its mesh matches)."""
    from proudslam_tpu_torch.native import PointStore

    n = len(traj)
    frame_stride = max(1, n // max_frames)
    fx, fy, cx, cy = dataset.intrinsics
    store = PointStore(settings.map.voxel_size * 0.25, max_voxels=1 << 19,
                       points_per_voxel=2)
    for j in range(0, n, frame_stride):
        try:
            _, _, depth, _, _ = dataset[start + j]
        except (IndexError, OSError, ValueError):
            continue
        d = np.asarray(depth)[::pixel_stride, ::pixel_stride]
        h, w = d.shape
        iy, ix = np.mgrid[0:h, 0:w] * pixel_stride
        dirs = np.stack([(ix - cx) / fx, (iy - cy) / fy, np.ones_like(d)],
                        axis=-1)
        pts_cam = (dirs * d[..., None]).reshape(-1, 3)
        valid = d.reshape(-1) > 0
        T = traj[j]
        store.insert((pts_cam[valid] @ T[:3, :3].T + T[:3, 3])
                     .astype(np.float32))
    xyz, _, counts = store.export_points()
    store.close()
    return xyz[np.arange(xyz.shape[1])[None, :] < counts[:, None]]


def resize_bicubic(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W) or (H, W, C) f32 image -> (height, width[, C]), bicubic with
    antialiasing (``torch.nn.functional.interpolate``'s form of PIL's
    bicubic ``resize``, which the JAX CLI calls)."""
    t = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(
        t, size=(height, width), mode="bicubic", antialias=True,
        align_corners=False)[0]
    return (out[0] if image.ndim == 2 else out.permute(1, 2, 0)).numpy()


def preview_targets(rgb, depth, width: int, height: int):
    """The panel's ground truth at the preview size: rgb through the JAX
    CLI's uint8 quantization (``(rgb * 255).astype(uint8)``), resized and
    rounded back to uint8, then scaled to [0, 1]; depth resized in f32."""
    q = (np.asarray(rgb) * 255).astype(np.uint8).astype(np.float32)
    gt_rgb = np.clip(np.round(resize_bicubic(q, width, height)), 0, 255)
    return (gt_rgb / 255.0,
            resize_bicubic(np.asarray(depth, np.float32), width, height))


def check_config(cfg):
    """The run's ``SystemSettings``, with the checks the CLI makes before
    it loads any data: raises on a setting the port does not run, so that
    a run is refused at once rather than at its first frame."""
    from proudslam_tpu_torch.config import settings_from_config

    s = settings_from_config(cfg)
    todo = []
    if s.render.intersect_mode != "brute":
        todo.append(f"intersect_mode={s.render.intersect_mode!r}")
    if s.mapper.covis_angle_deg > 0:
        todo.append("covis_angle_deg > 0")
    if s.decoder.embedder != "none":
        todo.append(f"embedder={s.decoder.embedder!r}")
    if todo:
        raise NotImplementedError(
            f"not ported yet (ROADMAP Queue 1): {', '.join(todo)}")
    if s.render.pixel_sampler not in ("uniform", "gumbel"):
        raise ValueError(f"unknown pixel_sampler {s.render.pixel_sampler!r}")
    dbg = cfg.get("debug_args", {})
    if dbg.get("render_freq", 0) > 0:
        res = list(dbg.get("render_res", [200, 160]))
        if not (len(res) == 2 and all(isinstance(v, int) and v > 0
                                      for v in res)):
            raise ValueError(f"debug_args.render_res {res}: expected "
                             "[width, height]")
        if s.render.feature_mode == "pcd":
            raise ValueError("debug_args.render_freq > 0 with feature_mode "
                             "'pcd': the preview panels render without the "
                             "point store (set render_freq 0)")
    return s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m proudslam_tpu_torch.run_slam")
    parser.add_argument("config")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--no-mesh", action="store_true")
    parser.add_argument("--device", default="cuda")
    args, extra = parser.parse_known_args(argv)

    from proudslam_tpu_torch.config import load_config
    from proudslam_tpu_torch.data.registry import get_dataset
    from proudslam_tpu_torch.engine.slam import SlamSystem
    from proudslam_tpu_torch.mesher import extract_mesh
    from proudslam_tpu_torch.render.preview import render_preview
    from proudslam_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    from proudslam_tpu_torch.utils.logger import RunLogger
    from proudslam_tpu_torch.utils.metrics import ate_rmse

    cfg = load_config(args.config, parse_overrides(extra))
    settings = check_config(cfg)
    device = torch.device(args.device)
    dataset = get_dataset(cfg)

    _, rgb0, depth0, _, _ = dataset[0]
    h, w = depth0.shape
    slam = SlamSystem(settings, dataset.intrinsics, (h, w), seed=args.seed,
                      device=device)
    logger = RunLogger(cfg.get("log_dir", "./logs"),
                       cfg.get("exp_name", "run"))
    logger.log_config(args.config, cfg.to_dict())

    start = cfg.get("tracker_specs", {}).get("start_frame", 0)
    end = cfg.get("tracker_specs", {}).get("end_frame", -1)
    if end <= 0:
        end = len(dataset)

    t_init = time.perf_counter()
    if args.resume:
        load_checkpoint(args.resume, slam)
        start = len(slam.frame_poses)
        print(f"resumed at frame {start}")
    else:
        slam.initialize(rgb0, depth0, dataset.get_init_pose(), stamp=start)
        start += 1
    _sync(device)
    init_s = time.perf_counter() - t_init
    n_init_maps = len(slam.clock.marks.get("map", []))

    render_freq = cfg.get("debug_args", {}).get("render_freq", 0)
    w_r, h_r = cfg.get("debug_args", {}).get("render_res", [200, 160])
    panels = []
    t0 = time.perf_counter()
    skipped = 0
    for i in range(start, end):
        # per-frame guard: an unreadable or corrupt frame is skipped
        try:
            _, rgb, depth, _, _ = dataset[i]
            slam.validate_frame(rgb, depth)
        except (OSError, ValueError) as e:
            skipped += 1
            print(f"frame {i}: skipped ({type(e).__name__}: {e})",
                  file=sys.stderr)
            slam.skip_frame(i)
            continue
        slam.process_frame(i, rgb, depth)
        if i % 25 == 0:
            fps = (i - start + 1) / (time.perf_counter() - t0)
            c = slam.counters(exact=True)
            print(f"frame {i}/{end}  {fps:.2f} fps  "
                  f"voxels={c['num_voxels']}/{c['voxel_capacity']} "
                  f"cells={c['num_cells']}/{c['cell_capacity']} "
                  f"kf={slam.num_kf}")
        if render_freq > 0 and (i + 1) % render_freq == 0:
            prgb, pdepth = render_preview(
                slam._render_view(), slam.decoder_params, slam.last_pose6,
                settings, w_r, h_r, dataset.intrinsics,
                (depth.shape[1], depth.shape[0]))
            panels.append(logger.log_images(
                i, *preview_targets(rgb, depth, w_r, h_r), prgb, pdepth))
    _sync(device)
    loop_s = time.perf_counter() - t0
    n_loop_maps = len(slam.clock.marks.get("map", [])) - n_init_maps

    t_r = time.perf_counter()
    mspec = cfg.get("mapper_specs", {})
    final_iter = mspec.get("final_iter", 0)
    if final_iter:
        slam.finalize(final_iter)
    refine_rounds = mspec.get("global_refine_rounds", 2)
    rebake_iters = mspec.get("rebake_iterations", 0)
    if refine_rounds:
        slam.global_refine(rounds=refine_rounds)
        if rebake_iters:
            slam.rebake_map(iterations=rebake_iters)
            slam.global_refine(rounds=1)
    _sync(device)
    refine_s = time.perf_counter() - t_r
    if refine_rounds:
        print(f"global refine ({refine_rounds} rounds"
              + (f" + rebake {rebake_iters}" if rebake_iters else "")
              + f"): {refine_s:.1f}s")

    traj = slam.get_trajectory()
    logger.log_numpy(traj, "frame_poses")
    n_frames = end - start
    phase_ms = slam.clock.ms()
    maps = phase_ms.get("map", [])[n_init_maps:n_init_maps + n_loop_maps]
    result = {
        "dir": logger.dir, "device": str(device), "frames": n_frames,
        "skipped": skipped, "fps": (n_frames - skipped) / max(loop_s, 1e-9),
        "init_s": init_s, "loop_s": loop_s, "refine_s": refine_s,
        "track_ms": float(np.mean(phase_ms["track"]))
        if phase_ms.get("track") else None,
        "map_ms": float(np.mean(maps)) if maps else None,
        "insert_ms": float(np.mean(phase_ms["insert"][1:]))
        if len(phase_ms.get("insert", [])) > 1 else None,
        "num_voxels": slam.map_state.num_voxels,
        "num_keyframes": slam.num_kf,
        "intrinsics": tuple(float(v) for v in dataset.intrinsics),
        "image_hw": (h, w), "panels": panels,
    }
    print(f"{n_frames} frames in {loop_s:.1f} s: {result['fps']:.2f} fps; "
          f"per frame: track {result['track_ms']} ms, map "
          f"{result['map_ms']} ms, insert {result['insert_ms']} ms")

    gt = getattr(dataset, "gt_pose", None)
    if gt is None and hasattr(dataset, "poses"):
        gt = np.stack(dataset.poses)
    if gt is not None:
        gt = np.asarray(gt).reshape(-1, 4, 4)[:len(traj)]
        ate = ate_rmse(traj, gt, align=False) * 100
        ate_al = ate_rmse(traj, gt, align=True) * 100
        print(f"ATE RMSE: {ate:.3f} cm (aligned {ate_al:.3f} cm)")
        logger.log_metrics(end, {"ate_rmse_cm": ate,
                                 "ate_rmse_aligned_cm": ate_al,
                                 "skipped_frames": skipped})
        result.update(ate_cm=ate, ate_aligned_cm=ate_al)

    save_checkpoint(f"{logger.ckpt_dir}/final_ckpt.npz", slam)

    if not args.no_mesh:
        t_m = time.perf_counter()
        depth_points = None
        if mspec.get("mesh_clean", True):
            depth_points = accumulate_depth_cloud(dataset, traj, start,
                                                  settings)
        mesh = extract_mesh(slam.map_state, slam.decoder_params,
                            settings.map, settings.decoder,
                            res=mspec.get("mesh_res", 8),
                            depth_points=depth_points)
        logger.log_mesh(mesh)
        result.update(mesh_s=time.perf_counter() - t_m,
                      mesh_verts=len(mesh.verts), mesh_faces=len(mesh.faces))
        print(f"mesh: {len(mesh.verts)} verts, {len(mesh.faces)} faces"
              + (" (cleaned)" if depth_points is not None else ""))

    print(f"artifacts in {logger.dir}")
    return result


if __name__ == "__main__":
    main()
