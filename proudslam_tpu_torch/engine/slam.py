"""The SLAM system: deterministic track/map interleave.

Port of ``proudslam_tpu/engine/slam.py``. Per frame:

  track (Adam on the pose) -> write the frame to the provisional keyframe
  slot -> map round (BA over a keyframe window + that slot) -> insert the
  frame's depth cloud every ``insert_stride`` frames -> keyframe commit.

The trajectory is kept as (reference keyframe, relative pose) pairs and
recomposed with the final keyframe poses. The JAX package's machinery for
a remote TPU (background scalar fetches, staged device scalars,
power-of-two render buckets, compile prewarm threads) is left out: the
port renders a view of the voxel table sliced to the live count, which
the validity masks make equivalent. Kept as they are: the uint8/uint16
frame quantization of ``upload_frame``, the numpy ``default_rng(seed)``
keyframe-window choice, the freshness threshold from the per-insert voxel
count history, and the fixed lags of the rotation keyframe trigger and of
the covisibility angles that weight the window draw.

With ``feature_mode="pcd"`` (or ``map.store_points``) the system also keeps
a per-voxel point store, filled with each inserted frame's points and
colors; in pcd mode the PointNet params ride in the decoder dict, so the
mapper's joint Adam trains them.

After the frame loop: ``finalize`` (map-only rounds, poses and decoder
frozen), ``global_refine`` (pose-updating BA sweeps over every keyframe,
optionally anchored to slot 0) and ``rebake_map`` (embeddings re-drawn and
re-trained at the refined poses). Frames that fail ``validate_frame`` are
recorded by ``skip_frame``, which keeps the trajectory index-aligned.

With ``mesh`` (``parallel/engine.EngineMesh``) every rank runs this
controller on its own device: ray batches split over dp, and under mp
each rank stores its row blocks of the map tables and of the embedding
moments (``map_state`` holds them; ``gathered_map_state`` is the full
map). Every rank draws the whole batch from the same seeded generator and
renders its block, inserts each frame into the gathered full map and
keeps its rows, and holds the same keyframe store, trajectory and host
logic. Unlike the JAX engine, which swaps its single-device Pallas decoder
for XLA under a mesh, the kernels stay on: a rank is a single-device
program.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from proudslam_tpu_torch.config import SystemSettings
from proudslam_tpu_torch.engine import state as kfstate
from proudslam_tpu_torch.engine.adam import init_adam
from proudslam_tpu_torch.engine.mapper import (init_map_opt, map_draws,
                                               map_step)
from proudslam_tpu_torch.engine.tracker import track_draws, track_frame
from proudslam_tpu_torch.geometry import camera, se3
from proudslam_tpu_torch.models.decoder import init_decoder
from proudslam_tpu_torch.models.pointnet import init_pointnet
from proudslam_tpu_torch.ops import voxel_hash as vh
from proudslam_tpu_torch.ops.kernels.mlp_kernel import check_kernel_sizes
from proudslam_tpu_torch.parallel.engine import (gather_map_state,
                                                 place_map_state,
                                                 shard_embeddings)
from proudslam_tpu_torch.render.pcd_features import (init_point_store,
                                                     insert_frame_points)


class PhaseClock:
    """Per-phase elapsed times: CUDA events on a GPU (no synchronization
    inside the loop), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self.marks.setdefault(name, []).append((start, end))

    def ms(self) -> Dict[str, List[float]]:
        """Elapsed ms of every recorded phase, by name."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [s.elapsed_time(e) for s, e in v]
                    for k, v in self.marks.items()}
        return {k: [(e - s) * 1e3 for s, e in v]
                for k, v in self.marks.items()}


class SlamSystem:
    """Host-side controller owning the device state."""

    def __init__(self, settings: SystemSettings,
                 intrinsics: Tuple[float, float, float, float],
                 image_hw: Tuple[int, int], seed: int = 0,
                 point_stride: int = 1, device="cuda",
                 draw_source: Optional[Callable] = None, mesh=None):
        """``draw_source(kind, wsel)``: optional provider of the random
        draws, for runs that must consume externally chosen draws: for
        ``kind`` "track" or "map" it returns ``(pix, noise)`` in the shapes
        of ``track_draws`` / ``map_draws`` (with a leading iteration axis
        under ``fixed_sample_batch=False``), for "rebake" the (E, D)
        standard normal draw that ``rebake_map`` scales by 0.01. By default
        they come from a ``torch.Generator`` seeded with ``seed``.

        ``mesh``: an ``EngineMesh`` on this rank's ``device``; the voxel
        and embedding capacities must divide by its mp extent."""
        if settings.map.coord_bits != 10:
            raise ValueError("the render stack assumes coord_bits == 10")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("SlamSystem(device='cuda'): no CUDA device")
            # a fused decoder of a size its kernels are not built for
            check_kernel_sizes(settings.decoder, settings.render.feature_mode)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, SlamSystem on "
                                 f"{self.device}")
            for name in ("voxel_capacity", "num_embeddings"):
                if getattr(settings.map, name) % mesh.mp:
                    raise ValueError(f"map.{name} does not divide by "
                                     f"mp={mesh.mp}")
        self.mesh = mesh
        self.settings = settings
        self.height, self.width = image_hw
        fx, fy, cx, cy = intrinsics
        self.rays_dir = camera.pixel_ray_directions(
            self.width, self.height, fx, fy, cx, cy, device=self.device)
        self.point_stride = point_stride
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draw_source = draw_source

        self.map_state = vh.init_map_state(settings.map, self.generator,
                                           self.device)
        self.decoder_params = init_decoder(self.generator, settings.decoder,
                                           self.device)
        self._use_pcd = (settings.render.feature_mode == "pcd"
                         or settings.map.store_points)
        self.point_store = None
        if self._use_pcd:
            if settings.render.feature_mode == "pcd":
                self.decoder_params["pointnet"] = init_pointnet(
                    self.generator, settings.decoder.in_dim, self.device)
            self.point_store = init_point_store(
                settings.map, settings.map.points_per_voxel, self.device)
        # under mp the map is stored row-sharded, the embedding moments
        # with it
        self.map_state = place_map_state(mesh, self.map_state)
        self.opt = init_map_opt(self.map_state.embeddings,
                                self.decoder_params)
        self.store = kfstate.init_keyframe_store(
            settings.mapper.max_keyframes, self.height, self.width,
            self.device)

        self.num_kf = 0
        self.kf_stamps: List[int] = []
        self.frame_poses: List[Tuple[int, torch.Tensor]] = []
        self.last_pose6: Optional[torch.Tensor] = None
        self.prev_pose6: Optional[torch.Tensor] = None
        self.rng = np.random.default_rng(seed)
        self._depth_quant = 65535.0 / settings.render.max_distance
        self._steady_cap = settings.map.frame_voxel_capacity_steady or None
        # live voxel count after each insert (freshness threshold history)
        self._nv_hist: deque = deque(
            maxlen=max(settings.render.fresh_window_frames + 1, 2))
        # rotation trigger: angles measured at commit time, consumed after
        # a fixed lag of _ang_lag frames (the JAX engine's schedule)
        self._ang_lag = 2
        self._ang_pending: deque = deque()
        self._last_angle = 0.0
        # covisibility window: (K,) angles of every keyframe-store pose to
        # the frame's slot, measured after each frame's write and consumed
        # two frames later (the JAX engine's fixed lag)
        self._covis_pending: deque = deque()
        self._covis_host: Optional[np.ndarray] = None
        self._capacity_warned = False
        self.clock = PhaseClock(self.device)
        # per-frame telemetry (device scalars, read by get_track_stats)
        self._track_losses: List[torch.Tensor] = []
        self._hit_ratios: List[torch.Tensor] = []
        self._map_losses: List[torch.Tensor] = []
        self._tracked_pose6: List[torch.Tensor] = []
        self._refined_pose6: List[torch.Tensor] = []

    # ------------------------------------------------------------------

    def _draws(self, kind: str, wsel: int = 0):
        if self.draw_source is not None:
            return self.draw_source(kind, wsel)
        npix = self.height * self.width
        if kind == "track":
            return track_draws(self.generator, self.settings, npix)
        if kind == "rebake":
            E, D = self.map_state.embeddings.shape
            mp = 1 if self.mesh is None else self.mesh.mp
            return torch.randn((E * mp, D), generator=self.generator,
                               device=self.device)
        return map_draws(self.generator, self.settings, wsel, npix)

    def gathered_map_state(self) -> vh.MapState:
        """The full map (under mp, all-gathered from every rank's row
        blocks: a collective, called by every rank of the mp group)."""
        return gather_map_state(self.mesh, self.map_state)

    def _render_view(self) -> vh.MapState:
        """The voxel table sliced to the live voxels (what the renderer
        reads); embeddings stay the full table.

        The JAX engine renders the full table under ``intersect_mode="dda"``.
        The slice gives the same hits: the occupancy grid holds live slots
        only, and the DDA path's clamp of a slot to the table's last row
        reaches only invalid slots, whose results are masked."""
        ms = self.gathered_map_state()
        nv = ms.num_voxels
        return ms._replace(voxel_keys=ms.voxel_keys[:nv],
                           voxel_vertex_ids=ms.voxel_vertex_ids[:nv])

    def _insert(self, rgb, depth, pose6, big: bool = False) -> None:
        """Backproject a depth map at ``pose6`` and allocate voxels (and
        store its points when the point store is on); ``big`` uses the
        full per-insert capacity (first frame)."""
        with self.clock.phase("insert"), torch.no_grad():
            st = self.point_stride
            d = depth[::st, ::st]
            pts_cam = camera.backproject(self.rays_dir[::st, ::st],
                                         d).reshape(-1, 3)
            valid = (d > 0).reshape(-1)
            R = se3.exp_rotation(pose6[3:6])
            pts = camera.transform_points(pts_cam, R, pose6[0:3])
            full = vh.insert_points(
                self.gathered_map_state(), pts, valid, self.settings.map,
                frame_capacity=None if big else self._steady_cap)
            if self._use_pcd:
                self.point_store = insert_frame_points(
                    self.point_store, full, pts,
                    rgb[::st, ::st].reshape(-1, 3), valid, self.settings.map)
            self.map_state = place_map_state(self.mesh, full)
        self._nv_hist.append(self.map_state.num_voxels)
        self._check_capacity()

    def _check_capacity(self) -> None:
        """Warn once when the map nears its capacities (beyond them new
        allocations are dropped)."""
        if self._capacity_warned:
            return
        V = self.settings.map.voxel_capacity
        C = self.settings.map.num_embeddings
        ms = self.map_state
        if ms.num_voxels >= 0.9 * V or ms.num_cells >= 0.9 * C:
            self._capacity_warned = True
            print(f"proudslam_tpu_torch WARNING: map at >=90% capacity "
                  f"(voxels {ms.num_voxels}/{V}, cells {ms.num_cells}/{C})",
                  file=sys.stderr, flush=True)

    def _fresh_thresh(self) -> int:
        """The live voxel count ``fresh_window_frames`` inserts ago (0
        until that much history exists)."""
        W = self.settings.render.fresh_window_frames
        if W <= 0 or len(self._nv_hist) <= W:
            return 0
        return self._nv_hist[0]

    def upload_frame(self, rgb, depth) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize a host frame to uint8 rgb / uint16 depth (the datasets'
        native encoding) and decode it to f32 on the device; f32 device
        tensors pass through."""
        if isinstance(rgb, torch.Tensor) and rgb.dtype == torch.float32:
            return rgb, depth
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        if depth.dtype != np.uint16:
            depth = np.clip(depth * self._depth_quant + 0.5, 0.0,
                            65535.0).astype(np.uint16)
        rgb_q = torch.from_numpy(rgb).to(self.device)
        depth_q = torch.from_numpy(depth.astype(np.int32)).to(self.device)
        return (rgb_q.float() * (1.0 / 255.0),
                depth_q.float() * (1.0 / self._depth_quant))

    def _map(self, sel: List[int], valid: List[bool],
             update_pose: bool = True, update_decoder: bool = True):
        with self.clock.phase("map"):
            res = map_step(self._render_view(), self.decoder_params,
                           self.store, self.opt, self.rays_dir, sel, valid,
                           self.settings, self._draws("map", len(sel)),
                           point_store=self.point_store,
                           update_pose=update_pose,
                           update_decoder=update_decoder, mesh=self.mesh)
        self.map_state = self.map_state._replace(embeddings=res.embeddings)
        self.decoder_params = res.decoder_params
        self.opt = res.opt
        return res

    def _select_window(self) -> Tuple[List[int], List[bool]]:
        """Random keyframe window (latest keyframe always in) padded to
        ``window_size``, plus the provisional slot last."""
        w = self.settings.mapper.window_size
        committed = list(range(self.num_kf))
        if len(committed) <= w:
            window = committed
        else:
            last = self.num_kf - 1
            fixed = [last]
            pool = committed[:-1]
            if self.settings.mapper.window_include_anchor:
                fixed = [0, last]
                pool = committed[1:-1]
            n_rand = w - len(fixed)
            ang = self.settings.mapper.covis_angle_deg
            cv = self._covis_host
            if ang > 0 and cv is not None and len(cv) >= last:
                # covisibility-weighted: keyframes looking the way the
                # current frame looks enter the window preferentially
                weights = np.exp(-np.asarray(cv, np.float64)[pool] / ang)
                weights /= weights.sum()
                rest = self.rng.choice(pool, size=n_rand, replace=False,
                                       p=weights)
            else:
                rest = self.rng.choice(pool, size=n_rand, replace=False)
            window = sorted(set(list(rest) + fixed))
        slot = min(self.num_kf, self.settings.mapper.max_keyframes - 1)
        pad = w - len(window)
        return ([int(s) for s in window] + [0] * pad + [slot],
                [True] * len(window) + [False] * pad + [True])

    def _append_trajectory(self, slot: int) -> None:
        ref = max(self.num_kf - 1, 0)
        poses = self.store.poses
        rel = (se3.inverse_matrix(se3.matrix_from_tangent(poses[ref]))
               @ se3.matrix_from_tangent(poses[slot]))
        self.frame_poses.append((ref, rel))

    def _covis_angles(self, slot: int) -> torch.Tensor:
        """(K,) rotation angle (deg) of every keyframe-store pose to the
        pose at ``slot``: the covisibility proxy of the window draw."""
        R = se3.exp_rotation(self.store.poses[:, 3:6])           # (K, 3, 3)
        Rb = se3.exp_rotation(self.store.poses[slot, 3:6])
        c = ((R * Rb).sum(dim=(1, 2)) - 1.0) * 0.5
        return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))

    def _kf_angle(self, kf: int, slot: int) -> float:
        """Rotation angle (deg) between two keyframe-store poses."""
        Ra = se3.exp_rotation(self.store.poses[kf, 3:6])
        Rb = se3.exp_rotation(self.store.poses[slot, 3:6])
        c = (torch.trace(Ra.T @ Rb) - 1.0) * 0.5
        return float(torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0))))

    # ------------------------------------------------------------------

    def initialize(self, rgb, depth, init_pose, stamp: int = 0) -> None:
        """Seed the map from the first frame at the given pose."""
        pose6 = se3.tangent_from_matrix(
            torch.as_tensor(np.asarray(init_pose), dtype=torch.float32,
                            device=self.device))
        rgb = torch.as_tensor(np.asarray(rgb), dtype=torch.float32,
                              device=self.device)
        depth = torch.as_tensor(np.asarray(depth), dtype=torch.float32,
                                device=self.device)
        zeros6 = torch.zeros(6, device=self.device)
        kfstate.write_frame(self.store, 0, rgb, depth, 0, pose6, zeros6,
                            zeros6, 0)
        self.num_kf = 1
        self.kf_stamps = [stamp]
        self._insert(rgb, depth, pose6, big=True)
        wsel = self.settings.mapper.window_size + 1
        sel = [0] * wsel
        valid = [True] + [False] * (wsel - 1)
        n_rounds = max(1, self.settings.mapper.init_iterations
                       // self.settings.mapper.num_iterations)
        for _ in range(n_rounds):
            self._map(sel, valid)
        self.last_pose6 = pose6
        self._append_trajectory(0)

    def _predict(self) -> torch.Tensor:
        """Constant-velocity prior: M_last @ (M_prev^-1 @ M_last)."""
        m_last = se3.matrix_from_tangent(self.last_pose6)
        m_prev = se3.matrix_from_tangent(self.prev_pose6)
        vel = se3.inverse_matrix(m_prev) @ m_last
        return se3.tangent_from_matrix(m_last @ vel)

    def process_frame(self, stamp: int, rgb, depth) -> None:
        """Track + map one frame."""
        rgb_d, depth_d = self.upload_frame(rgb, depth)
        s = self.settings
        if s.tracker.motion_model == "velocity" and self.prev_pose6 is not None:
            prior = self._predict()
        else:
            prior = self.last_pose6

        with self.clock.phase("track"):
            result = track_frame(self._render_view(), self.decoder_params,
                                 prior, self.rays_dir, rgb_d, depth_d, s,
                                 self._draws("track"),
                                 fresh_thresh=self._fresh_thresh(),
                                 point_store=self.point_store,
                                 mesh=self.mesh)
        self._track_losses.append(result.loss)
        self._hit_ratios.append(result.hit_ratio)

        slot = min(self.num_kf, s.mapper.max_keyframes - 1)
        flag = 0 if slot < s.mapper.anchor_keyframes else 1
        kfstate.write_frame(self.store, slot, rgb_d, depth_d, flag,
                            result.pose, result.adam_m, result.adam_v,
                            result.adam_t)
        if s.mapper.covis_angle_deg > 0:
            self._covis_pending.append(self._covis_angles(slot))
            while len(self._covis_pending) > 2:
                self._covis_host = self._covis_pending.popleft().cpu().numpy()
        sel, valid = self._select_window()
        self._map_losses.append(self._map(sel, valid).loss)

        refined = self.store.poses[slot].clone()
        self._tracked_pose6.append(result.pose)
        self._refined_pose6.append(refined)
        stride = s.mapper.insert_stride
        if stride <= 1 or stamp % stride == 0:
            self._insert(rgb_d, depth_d, refined)

        # keyframe commit: stamp gap (denser early on) or rotation trigger
        gap = s.mapper.keyframe_gap
        if self.num_kf <= s.mapper.early_keyframes:
            gap = min(gap, s.mapper.early_keyframe_gap)
        rot_deg = s.mapper.keyframe_rotation_deg
        if rot_deg > 0:
            while len(self._ang_pending) > self._ang_lag:
                val, ref = self._ang_pending.popleft()
                if ref == self.num_kf - 1:
                    self._last_angle = val
        rotated = rot_deg > 0 and self._last_angle > rot_deg
        if ((stamp - self.kf_stamps[self.num_kf - 1] > gap or rotated)
                and self.num_kf < s.mapper.max_keyframes - 1):
            self.num_kf += 1
            self.kf_stamps.append(stamp)
            self._last_angle = 0.0
        if rot_deg > 0:
            self._ang_pending.append(
                (self._kf_angle(self.num_kf - 1, slot), self.num_kf - 1))

        self._append_trajectory(slot)
        self.prev_pose6 = self.last_pose6
        self.last_pose6 = refined

    @staticmethod
    def validate_frame(rgb, depth) -> None:
        """Reject a corrupt sensor frame (non-finite values, all-zero
        depth) before it reaches the map: raises ``ValueError``."""
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        if not np.isfinite(rgb).all():
            raise ValueError("rgb contains non-finite values")
        if not np.isfinite(depth).all():
            raise ValueError("depth contains non-finite values")
        if float(np.abs(depth).sum()) == 0.0:
            raise ValueError("all-zero depth frame")

    def skip_frame(self, stamp: int) -> None:
        """Record a skipped frame: repeat the last trajectory entry (the
        identity at keyframe 0 before any), so the trajectory stays
        index-aligned with the input sequence."""
        if self.frame_poses:
            self.frame_poses.append(self.frame_poses[-1])
        else:
            self.frame_poses.append(
                (0, torch.eye(4, dtype=torch.float32, device=self.device)))

    def counters(self, exact: bool = False) -> dict:
        """Map occupancy. The port keeps the live counts on the host, so
        ``exact`` (a blocking refresh in the JAX package) changes nothing."""
        ms = self.map_state
        return {"num_voxels": ms.num_voxels, "num_cells": ms.num_cells,
                "voxel_capacity": self.settings.map.voxel_capacity,
                "cell_capacity": self.settings.map.num_embeddings}

    def finalize(self, final_rounds: int = 0) -> None:
        """Final map-only rounds over random keyframe windows, poses and
        decoder frozen."""
        for _ in range(final_rounds):
            sel, valid = self._select_window()
            self._map(sel, valid, update_pose=False, update_decoder=False)

    def global_refine(self, rounds: int = 2, anchored: bool = False) -> None:
        """Pose-updating BA sweeping overlapping windows over every
        keyframe and the provisional slot (slot 0 stays the anchor).
        ``anchored``: every window leads with slot 0, followed by
        consecutive keyframes."""
        w0 = min(self.num_kf + 1, self.settings.mapper.window_size + 1)
        if self.num_kf < 2 or w0 < 2:
            return
        width = w0 - 1 if anchored else w0
        first = 1 if anchored else 0
        stride = max(width - 1, 1)   # consecutive windows overlap by one
        for _ in range(rounds):
            for start in range(first, self.num_kf, stride):
                start = min(start, self.num_kf + 1 - width)
                if start < first:
                    break
                run = list(range(start, start + width))
                self._map([0] + run if anchored else run, [True] * w0)

    def rebake_map(self, iterations: int = 200) -> None:
        """Re-draw the embeddings (0.01 * N(0, 1)) and re-train them from
        every stored keyframe at the current poses, poses frozen (the
        decoder is kept and trained)."""
        if self.num_kf < 1:
            return
        emb = shard_embeddings(self.mesh, 0.01 * self._draws("rebake"))
        self.map_state = self.map_state._replace(embeddings=emb)
        self.opt = self.opt._replace(embed=init_adam([emb]))
        w0 = min(self.num_kf + 1, self.settings.mapper.window_size + 1)
        stride = max(w0 - 1, 1)
        rounds = max(1, iterations // self.settings.mapper.num_iterations)
        for _ in range(rounds):
            for start in range(0, self.num_kf, stride):
                start = min(start, self.num_kf + 1 - w0)
                if start < 0:
                    break
                self._map(list(range(start, start + w0)), [True] * w0,
                          update_pose=False)

    def get_track_stats(self) -> Dict[str, np.ndarray]:
        """Per-frame telemetry as host arrays: track_loss, hit_ratio and
        map_loss (each step's final iteration), tracked_pose6 (before BA)
        and refined_pose6 (after it)."""
        out = {}
        for name, buf in (("track_loss", self._track_losses),
                          ("hit_ratio", self._hit_ratios),
                          ("map_loss", self._map_losses),
                          ("tracked_pose6", self._tracked_pose6),
                          ("refined_pose6", self._refined_pose6)):
            out[name] = (torch.stack(buf).cpu().numpy() if buf
                         else np.zeros((0,), np.float32))
        return out

    def get_trajectory(self) -> np.ndarray:
        """(N, 4, 4) world poses recomposed with the final keyframe poses."""
        kf_mats = se3.matrix_from_tangent(self.store.poses)
        refs = torch.as_tensor([r for r, _ in self.frame_poses],
                               device=self.device)
        rels = torch.stack([rel for _, rel in self.frame_poses])
        return torch.einsum("nij,njk->nik", kf_mats[refs],
                            rels).cpu().numpy()
