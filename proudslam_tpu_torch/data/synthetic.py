"""Synthetic RGB-D sequence generator (ground-truth oracle).

The reference's datasets (Replica/ScanNet/ARKit) are disk-based captures we
cannot ship; for tests and benchmarks we ray-march an analytic SDF scene
(a box room containing spheres) to produce pixel-perfect RGB-D frames with
known poses. Serves the role the Replica 200-frame clip plays in
BASELINE.json config 1, and doubles as a golden oracle: SLAM output can be
compared against exact geometry and trajectory.

Pure numpy, host-side; generate once and cache.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticScene:
    room_center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0]))
    room_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([2.0, 1.5, 2.0]))
    sphere_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([
            [0.6, 0.4, 0.8], [-0.7, -0.3, -0.5], [0.0, 0.6, -0.9]]))
    sphere_radii: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.35, 0.45, 0.3]))

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """(N, 3) -> (N,) signed distance; negative inside solid matter.

        The room is hollow: solid = outside the box OR inside a sphere, so
        the SDF seen from inside the room is distance-to-nearest-wall /
        sphere surface.
        """
        q = np.abs(p - self.room_center) - self.room_half
        # inside-room distance to walls (positive inside the hollow room)
        wall = -np.max(q, axis=-1)
        spheres = np.linalg.norm(
            p[:, None, :] - self.sphere_centers[None], axis=-1
        ) - self.sphere_radii[None]
        return np.minimum(wall, spheres.min(axis=-1))

    def albedo(self, p: np.ndarray) -> np.ndarray:
        """Smooth procedural RGB albedo in [0.05, 0.95]."""
        phases = np.array([[0.0, 2.1, 4.2]])
        freq = np.array([[2.0], [2.6], [3.2]])
        vals = np.stack([
            np.sin(freq[c, 0] * p[:, c % 3] + phases[0, c]) for c in range(3)
        ], axis=-1)
        return 0.5 + 0.45 * vals * np.cos(1.7 * p[:, ::-1])


def _ray_march(scene: SyntheticScene, origins: np.ndarray, dirs: np.ndarray,
               max_depth: float = 12.0, iters: int = 128) -> np.ndarray:
    """Sphere-trace along (unit-norm scaled) dirs; returns hit parameter t
    (in units of the *given* dirs, i.e. camera z-depth for pinhole dirs)."""
    norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
    unit = dirs / norms
    t = np.full(origins.shape[0], 1e-3)
    alive = np.ones(origins.shape[0], dtype=bool)
    for _ in range(iters):
        p = origins + unit * t[:, None]
        d = scene.sdf(p)
        t = np.where(alive, t + np.maximum(d, 1e-5) * 0.9, t)
        alive = alive & (np.abs(d) > 1e-4) & (t < max_depth)
        if not alive.any():
            break
    hit = t < max_depth
    # convert from euclidean distance to z-depth units of the input dirs
    z = t / norms[:, 0]
    return np.where(hit, z, 0.0)


def look_poses(num_frames: int, step: float = 0.012) -> List[np.ndarray]:
    """Smooth camera trajectory inside the room: gentle arc + slow yaw.

    Per-frame motion is ~``step`` meters (default 1.2 cm) with ~0.3 deg of
    yaw — matching the inter-frame motion of real RGB-D captures (Replica
    sequences move ~1-2 cm/frame), which is the scale SLAM tracking's
    constant-position motion model assumes.

    Returns world-from-camera 4x4s (camera: x right, y down, z forward).
    """
    poses = []
    for i in range(num_frames):
        t = i * step
        yaw = 0.35 * t
        pos = np.array([
            0.8 * t,
            0.05 * np.sin(2.0 * t),
            -1.2 + 0.55 * t,
        ])
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return poses


def render_frame(scene: SyntheticScene, pose: np.ndarray,
                 width: int, height: int,
                 fx: float, fy: float, cx: float, cy: float,
                 max_depth: float = 12.0) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rgb (H, W, 3) in [0,1], depth (H, W) meters, 0 invalid)."""
    ix, iy = np.meshgrid(np.arange(width), np.arange(height))
    dirs_cam = np.stack([(ix - cx) / fx, (iy - cy) / fy,
                         np.ones_like(ix, dtype=np.float64)], axis=-1)
    dirs_cam = dirs_cam.reshape(-1, 3)
    R, t = pose[:3, :3], pose[:3, 3]
    dirs_w = dirs_cam @ R.T
    origins = np.broadcast_to(t, dirs_w.shape)
    z = _ray_march(scene, origins, dirs_w, max_depth=max_depth)
    pts = origins + dirs_w * z[:, None]
    rgb = np.clip(scene.albedo(pts), 0.0, 1.0)
    rgb = np.where((z > 0)[:, None], rgb, 0.0)
    return (rgb.reshape(height, width, 3).astype(np.float32),
            z.reshape(height, width).astype(np.float32))


def _analytic_boxes():
    """Box layout of the AnalyticScene: 4 corner pillars, 4 low plinths,
    a clutter ring of mid-size boxes at radius ~2.6-3.2, and thin wall
    slabs so no view is a bare plane (Replica-room-class geometric
    richness — flat texture-poor walls make tangential camera motion
    unobservable to depth/SDF losses, which no real indoor capture does)."""
    centers = [
        [3.9, 0.0, 3.9], [-3.9, 0.0, 3.9],
        [3.9, 0.0, -3.9], [-3.9, 0.0, -3.9],
        [0.0, -1.2, 4.6], [4.6, -1.2, 0.0],
        [-4.6, -1.2, 0.0], [0.0, -1.2, -4.6],
    ]
    halves = [
        [0.35, 1.6, 0.35], [0.35, 1.6, 0.35],
        [0.35, 1.6, 0.35], [0.35, 1.6, 0.35],
        [1.0, 0.4, 0.55], [0.55, 0.4, 1.0],
        [0.55, 0.4, 1.0], [1.0, 0.4, 0.55],
    ]
    # clutter ring (visible in every outward-looking orbit view)
    for k in range(10):
        a = 2.0 * np.pi * (k + 0.35) / 10.0
        r = 2.6 + 0.6 * ((k * 7) % 3) / 2.0
        h = 0.22 + 0.1 * ((k * 5) % 4) / 3.0
        y = -1.25 + 0.45 * ((k * 3) % 5) / 4.0
        centers.append([r * np.sin(a), y, r * np.cos(a)])
        halves.append([h, 0.3 + 0.15 * ((k * 2) % 3), h])
    # wall slabs (relief on each wall at varying heights/offsets)
    for k in range(8):
        off = -3.6 + 7.2 * (k % 4) / 3.0
        y = -0.5 + 1.0 * (k % 3) / 2.0
        if k < 4:
            centers.append([off, y, 5.82 if k % 2 == 0 else -5.82])
            halves.append([0.8, 0.5, 0.18])
        else:
            centers.append([5.82 if k % 2 == 0 else -5.82, y, off])
            halves.append([0.18, 0.5, 0.8])
    # floor/ceiling beams (structure on the two biggest flat surfaces)
    for k in range(3):
        off = -3.0 + 3.0 * k
        centers.append([off, -1.45, 0.0])
        halves.append([0.16, 0.16, 5.4])
        centers.append([0.0, 1.45, off])
        halves.append([5.4, 0.16, 0.16])
    return np.array(centers), np.array(halves)


@dataclasses.dataclass
class AnalyticScene:
    """Reference-scale benchmark scene with *closed-form* ray intersections.

    A 10x3x10 m hollow room with interior pillars and spheres — sized so a
    full sweep grows the voxel map past the reference's operating point
    (~8-10k SURFACE voxels at 0.2 m, the scale of Replica room0 under
    the reference's `configs/replica/replica.yaml`). Rendering is exact
    ray/box/sphere intersection (no sphere-trace loop), so generating a
    multi-hundred-frame sequence on host costs seconds, not minutes.
    """

    room_half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([6.0, 1.6, 6.0]))
    box_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: _analytic_boxes()[0])
    box_halves: np.ndarray = dataclasses.field(
        default_factory=lambda: _analytic_boxes()[1])
    sphere_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([
            [1.9, -1.0, 1.9], [-2.0, -0.9, -1.8], [-2.3, 0.1, 2.3],
            [2.2, 0.3, -2.4], [0.0, -1.1, -3.1], [-3.1, -1.1, 0.0],
            [3.1, 0.0, 0.0], [2.6, 1.1, 2.6], [-2.6, 1.1, -2.6],
            [-2.7, -1.0, 2.0], [2.4, -1.0, -2.0],
        ]))
    sphere_radii: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [0.55, 0.65, 0.45, 0.5, 0.5, 0.55, 0.45,
             0.4, 0.4, 0.45, 0.45]))

    def albedo(self, p: np.ndarray) -> np.ndarray:
        """Multi-octave procedural RGB albedo.

        Replica-class indoor captures carry texture down to cm scale; a
        single ~5 m-period sinusoid (the original form) leaves sideways
        motion along flat walls photometrically unobservable, which no real
        SLAM workload does. Octave periods: ~4 m, ~1.3 m, ~0.5 m.
        """
        phases = np.array([[0.0, 2.1, 4.2]])
        freq = np.array([[1.1], [1.45], [1.8]])
        vals = np.stack([
            np.sin(freq[c, 0] * p[:, c % 3] + phases[0, c]) for c in range(3)
        ], axis=-1)
        base = 0.5 + 0.25 * vals * np.cos(0.9 * p[:, ::-1])
        o2 = np.sin(4.8 * p[:, 0] + 3.1 * p[:, 1] + 2.2 * p[:, 2])
        o3 = (np.sin(12.0 * p[:, 0] + 1.7) * np.sin(11.0 * p[:, 2] + 0.6)
              + np.sin(13.0 * p[:, 1] + 4.0))
        detail = (0.12 * o2 + 0.04 * o3)[:, None] * np.array([[1.0, 0.9, 1.1]])
        return base + detail

    def surface_distance(self, p: np.ndarray) -> np.ndarray:
        """(N, 3) points -> exact unsigned distance to the scene surface.

        Closed-form per primitive (room walls, box SDF, sphere SDF),
        minimized over all primitives — the ground truth for quantitative
        mesh accuracy (reconstructed vertices should lie on the surface;
        the reference has no mesh eval at all, `mesh_util.py`)."""
        d_room = np.min(self.room_half[None, :] - np.abs(p), axis=1)
        dists = [np.abs(d_room)]
        for c, h in zip(self.box_centers, self.box_halves):
            q = np.abs(p - c[None]) - h[None]
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
            inside = np.minimum(np.max(q, axis=1), 0.0)
            dists.append(np.abs(outside + inside))
        for c, r in zip(self.sphere_centers, self.sphere_radii):
            dists.append(np.abs(np.linalg.norm(p - c[None], axis=1) - r))
        return np.min(np.stack(dists), axis=0)

    def trace(self, origins: np.ndarray, dirs: np.ndarray,
              max_depth: float = 10.0) -> np.ndarray:
        """Exact first-hit parameter t (in units of the given dirs, i.e.
        camera z-depth for pinhole dirs) for rays starting inside the room."""
        o, d = origins, dirs
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            # hollow room: depth to the walls = exit t of the room box
            lo = (-self.room_half[None] - o) * inv
            hi = (self.room_half[None] - o) * inv
            t = np.min(np.maximum(lo, hi), axis=-1)       # (N,) wall depth

            # solid pillars/boxes: entry t if in front of the camera
            blo = (self.box_centers[None] - self.box_halves[None]
                   - o[:, None]) * inv[:, None]            # (N, B, 3)
            bhi = (self.box_centers[None] + self.box_halves[None]
                   - o[:, None]) * inv[:, None]
            tn = np.max(np.minimum(blo, bhi), axis=-1)
            tf = np.min(np.maximum(blo, bhi), axis=-1)
            bhit = (tn <= tf) & (tn > 1e-4)
            t = np.minimum(t, np.min(np.where(bhit, tn, np.inf), axis=-1))

        # spheres (quadratic, unnormalized dirs)
        oc = o[:, None] - self.sphere_centers[None]        # (N, S, 3)
        A = np.sum(d * d, axis=-1)[:, None]
        B = 2.0 * np.sum(oc * d[:, None], axis=-1)
        C = np.sum(oc * oc, axis=-1) - self.sphere_radii[None] ** 2
        disc = B * B - 4.0 * A * C
        shit = disc > 0.0
        ts = np.where(shit, (-B - np.sqrt(np.abs(disc))) / (2.0 * A), np.inf)
        ts = np.where(ts > 1e-4, ts, np.inf)
        t = np.minimum(t, np.min(ts, axis=-1))
        return np.where(t < max_depth, t, 0.0)

    def render(self, pose: np.ndarray, width: int, height: int,
               fx: float, fy: float, cx: float, cy: float,
               max_depth: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb (H, W, 3) in [0,1], z-depth (H, W) meters, 0 invalid)."""
        ix, iy = np.meshgrid(np.arange(width), np.arange(height))
        dirs_cam = np.stack([(ix - cx) / fx, (iy - cy) / fy,
                             np.ones_like(ix, dtype=np.float64)], axis=-1)
        dirs_cam = dirs_cam.reshape(-1, 3)
        R, tr = pose[:3, :3], pose[:3, 3]
        dirs_w = dirs_cam @ R.T
        origins = np.broadcast_to(tr, dirs_w.shape)
        z = self.trace(origins, dirs_w, max_depth=max_depth)
        pts = origins + dirs_w * z[:, None]
        rgb = np.clip(self.albedo(pts), 0.0, 1.0)
        rgb = np.where((z > 0)[:, None], rgb, 0.0)
        return (rgb.reshape(height, width, 3).astype(np.float32),
                z.reshape(height, width).astype(np.float32))


def orbit_poses(num_frames: int, radius: float = 2.2,
                total_yaw: float = 2.0 * np.pi,
                height_wobble: float = 0.08,
                yaw_wobble: float = 0.0,
                yaw_cycles: float = 4.0,
                yaw_phase: float = 0.5 * np.pi,
                pitch_wobble: float = 0.0,
                pitch_cycles: float = 4.0) -> List[np.ndarray]:
    """Slow orbit, optionally with a back-and-forth yaw sweep (a
    Replica-style room scan), position returning to the start.

    ``yaw_wobble`` (radians) superimposes ``yaw_cycles`` sinusoidal pan
    sweeps on the orbital yaw so the camera re-views scene sectors
    multiple times instead of exactly once. Revisits keep incremental
    SLAM drift *bounded* (per-frame tracking noise re-anchors against
    already-mapped geometry rather than integrating) — the regime the
    reference's Replica captures operate in; a monotonic sweep
    (yaw_wobble=0) is a strictly harder corridor-style workload with
    random-walk drift growth. ``yaw_phase`` pi/2 makes d(yaw)/da == 1 at
    a == 0 (gentle start while the map is immature); the wobble term is
    offset so yaw(0) == 0 for any phase.

    Per-frame motion: ``total_yaw*radius/N`` meters with up to
    ``(1 + yaw_wobble*yaw_cycles) * total_yaw/N`` of yaw.
    """
    poses = []
    s0 = np.sin(yaw_phase)
    for i in range(num_frames):
        a = total_yaw * i / num_frames
        yaw = a + yaw_wobble * (np.sin(yaw_cycles * a + yaw_phase) - s0)
        pitch = pitch_wobble * np.sin(pitch_cycles * a)
        pos = np.array([radius * np.sin(a),
                        height_wobble * np.sin(5.0 * a),
                        radius * np.cos(a)])
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
        if pitch_wobble:
            cp, sp = np.cos(pitch), np.sin(pitch)
            # camera-frame pitch (about x): y down, z forward
            R = R @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return poses


def corridor_poses(num_frames: int, span: float = 3.0,
                   look_wobble: float = 0.35,
                   look_cycles: float = 6.0) -> List[np.ndarray]:
    """Straight push along -z->+z across the room with sinusoidal
    look-around yaw nods (corridor-style forward exploration)."""
    poses = []
    for i in range(num_frames):
        a = i / max(num_frames - 1, 1)
        yaw = look_wobble * np.sin(look_cycles * np.pi * a)
        pos = np.array([0.3 * np.sin(2.0 * np.pi * a),
                        0.06 * np.sin(7.0 * np.pi * a),
                        -span / 2.0 + span * a])
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return poses


class SyntheticDataset:
    """In-memory RGB-D sequence matching the reference loader protocol
    (`src/dataset/replica.py`): __len__, __getitem__ ->
    (index, rgb, depth, K, gt_pose), get_init_pose()."""

    def __init__(self, num_frames: int = 40, width: int = 80, height: int = 60,
                 seed: int = 0):
        self.scene = SyntheticScene()
        self.width, self.height = width, height
        self.fx = self.fy = 0.9 * width
        self.cx, self.cy = (width - 1) / 2.0, (height - 1) / 2.0
        self.poses = look_poses(num_frames)
        self.frames = [
            render_frame(self.scene, p, width, height,
                         self.fx, self.fy, self.cx, self.cy)
            for p in self.poses
        ]

    @property
    def intrinsics(self):
        return (self.fx, self.fy, self.cx, self.cy)

    def get_init_pose(self) -> np.ndarray:
        return self.poses[0]

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, i):
        rgb, depth = self.frames[i]
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1.0]])
        return i, rgb, depth, K, self.poses[i]


class BenchDataset:
    """Reference-scale benchmark sequence over an :class:`AnalyticScene`.

    Frames are stored *quantized* (uint8 rgb, uint16 depth at the dataset's
    ``max_depth`` scale — the native encoding of real RGB-D captures and of
    ``SlamSystem.upload_frame``), so a 480-frame 320x240 sequence costs
    ~450 MB of host RAM instead of ~1.9 GB of float32.
    """

    def __init__(self, num_frames: int = 480, width: int = 320,
                 height: int = 240, radius: float = 1.1,
                 max_depth: float = 10.0, depth_noise: float = 0.0,
                 seed: int = 0, trajectory: str = "scan"):
        self.scene = AnalyticScene()
        self.width, self.height = width, height
        self.max_depth = max_depth
        self.fx = self.fy = 0.9 * width
        self.cx, self.cy = (width - 1) / 2.0, (height - 1) / 2.0
        if trajectory == "scan":
            # half-circle room scan with pan sweeps and a gentle pitch nod
            # (floor/ceiling coverage): <= ~1 cm + 1.3 deg/frame of motion
            # — Replica-class statistics; see orbit_poses on why
            # revisit-heavy scanning is the reference workload regime
            self.poses = orbit_poses(num_frames, radius=radius,
                                     total_yaw=np.pi, yaw_wobble=1.0,
                                     yaw_cycles=3.0, pitch_wobble=0.22,
                                     pitch_cycles=4.0)
        elif trajectory == "monotonic":
            # strictly monotonic sweep — every sector viewed exactly once;
            # random-walk drift growth (no re-anchoring). Harder than the
            # reference's Replica captures.
            self.poses = orbit_poses(num_frames, radius=radius,
                                     total_yaw=np.pi, yaw_wobble=0.0,
                                     pitch_wobble=0.22, pitch_cycles=4.0)
        elif trajectory == "corridor":
            # straight push across the room with small look-around nods:
            # forward-dominant exploration, frontier always ahead (the
            # voxel-allocation-rate regime an absolute freshness margin
            # mis-tunes for, VERDICT r4 weak #9)
            self.poses = corridor_poses(num_frames, span=2.0 * radius)
        else:
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.depth_quant = 65535.0 / max_depth
        rng = np.random.default_rng(seed)
        self.frames = []
        for p in self.poses:
            rgb, depth = self.scene.render(
                p, width, height, self.fx, self.fy, self.cx, self.cy,
                max_depth=max_depth)
            if depth_noise > 0.0:
                noise = rng.normal(0.0, depth_noise, depth.shape)
                depth = np.where(depth > 0.0, np.maximum(
                    depth + noise.astype(np.float32) * depth, 0.01), 0.0)
            self.frames.append(self.quantize(rgb, depth))

    def quantize(self, rgb: np.ndarray, depth: np.ndarray):
        return (np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8),
                np.clip(depth * self.depth_quant + 0.5, 0,
                        65535.0).astype(np.uint16))

    @property
    def intrinsics(self):
        return (self.fx, self.fy, self.cx, self.cy)

    def get_init_pose(self) -> np.ndarray:
        return self.poses[0]

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, i):
        rgb, depth = self.frames[i]
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1.0]])
        return i, rgb, depth, K, self.poses[i]

    def dequantized(self, i):
        """Float32 (rgb, depth) of frame i (for initialization paths)."""
        rgb, depth = self.frames[i]
        return (rgb.astype(np.float32) / 255.0,
                depth.astype(np.float32) / self.depth_quant)
