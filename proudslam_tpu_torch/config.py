"""Configuration system (numpy/yaml only; a copy of the JAX package's
``config.py``, which cannot be imported without JAX, plus
:func:`bench_settings`).

YAML configs with recursive ``base_config`` inheritance and programmatic
overrides, mirroring the reference semantics (`demo/parser.py:9-56` of the
reference: leaf config values recursively merged over the base config, then
exposed for CLI override).

On top of the free-form dict config we derive frozen, hashable settings
structs that are passed as *static* arguments to jitted functions — every
capacity / shape knob lives here so compiled programs have fully static
shapes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import yaml


def _update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Merge ``src`` into ``dst``, recursing into nested dicts.

    Mirrors `demo/parser.py:48-56` (reference).
    """
    for key, value in src.items():
        if key not in dst:
            dst[key] = {}
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _update_recursive(dst[key], value)
        else:
            dst[key] = value


def load_yaml_with_bases(path: str) -> Dict[str, Any]:
    """Load a YAML file, recursively resolving ``base_config`` references.

    Mirrors `demo/parser.py:23-37` (reference): the leaf file's values win
    over its base's; ``base_config`` may chain arbitrarily deep. Relative
    base paths are resolved against the current working directory first
    (reference behavior) and then against the directory of the referring
    file.
    """
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    base_path = raw.pop("base_config", None)
    if base_path is None:
        return raw
    if not os.path.exists(base_path):
        candidate = os.path.join(os.path.dirname(path), base_path)
        if os.path.exists(candidate):
            base_path = candidate
    merged = load_yaml_with_bases(base_path)
    _update_recursive(merged, raw)
    return merged


class Config:
    """Attribute/dict hybrid view over a nested config mapping."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = dict(data or {})

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            value = self._data[name]
        except KeyError as e:
            raise AttributeError(f"config has no key {name!r}") from e
        return value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def override(self, dotted_key: str, value: Any) -> None:
        """Set ``a.b.c`` style keys, creating intermediate dicts."""
        parts = dotted_key.split(".")
        node = self._data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    cfg = Config(load_yaml_with_bases(path))
    for key, value in (overrides or {}).items():
        cfg.override(key, value)
    return cfg


# ---------------------------------------------------------------------------
# Frozen settings structs (static args for jit)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static shapes + scalars of the differentiable renderer.

    The reference pads ray-hit topology to data-dependent maxima
    (`voxel_helpers.py:582-585,359-362`); on TPU everything is padded to the
    static capacities below and masked.
    """

    voxel_size: float = 0.2
    # step size in meters (reference: cfg step_size * voxel_size,
    # `mapping.py:59-60`, `tracking.py:34-38`)
    step_size: float = 0.02
    truncation: float = 0.1          # criteria.sdf_truncation
    max_distance: float = 10.0       # data_specs.max_depth
    max_hits: int = 24               # static cap on ray/voxel intersections
    max_samples: int = 96            # static cap on samples per ray
    # sentinel depth for invalid samples (reference MAX_DEPTH,
    # voxel_helpers.py)
    max_depth_sentinel: float = 10000.0
    # coarsen the per-ray step when the intersected arc exceeds the sample
    # budget (instead of truncating coverage at max_samples * step_size);
    # rays within budget behave exactly like the reference's fixed step
    adaptive_step: bool = True
    # --- ray/voxel intersection backend ---
    # "brute": O(R*V) slab matrix + approx_min_k — fastest measured form up
    #   to ~20k voxels (the matrix stays HBM-bandwidth-cheap at SLAM scales).
    # "dda": march a dense occupancy grid along each ray — O(path length)
    #   per ray, independent of the live voxel count (the TPU-native analog
    #   of the reference's octree DFS, `intersect_gpu.cu:191-270`). XLA's
    #   per-lane gathers make it slower than brute below ~20k voxels;
    #   use for maps beyond brute's comfortable range.
    intersect_mode: str = "brute"
    # dense occupancy grid extent, in voxel units (world extent =
    # [origin*voxel, (origin+dims)*voxel] per axis)
    grid_dims: tuple = (192, 48, 192)
    grid_origin: tuple = (-96, -24, -96)
    # euclidean march spacing as a fraction of voxel_size; < 0.5 guarantees
    # any voxel whose in-voxel chord exceeds that spacing is detected
    dda_step_frac: float = 0.45
    # bound on |rays_d| (pinhole dirs are unit-z, norm <= ~1.22 at wide FOV)
    dda_dir_bound: float = 1.25
    # sample feature source: "vox" = trilinear vertex-embedding blend (the
    # reference's live path, `render_helpers.py:484`); "pcd" = PointNet over
    # the sample's voxel's stored points with softmax inverse-distance
    # blending (the reference's disabled branch, `render_helpers.py:168-238`,
    # implemented in render/pcd_features.py — requires a VoxelPointStore and
    # pointnet params)
    feature_mode: str = "vox"
    # per-iteration pixel batch sampler: "gumbel" = reference's top-k
    # Gumbel without replacement (`sample_util.py:4-20`); "uniform" =
    # independent uniform draws (identical distribution over the all-ones
    # mask up to ~7 expected duplicates per 1024-batch, ~10x cheaper on
    # TPU — see ops/sampling.py:sample_frame_pixels)
    pixel_sampler: str = "uniform"
    # voxel slots are allocated in insertion order, so slot index is an
    # age signal: slots within this margin of the live count are "fresh"
    # (their SDF is still half-trained). > 0 exposes a per-ray fresh-hit
    # fraction the tracker uses to discount unreliable rays; 0 = off.
    fresh_voxel_margin: int = 0
    # scale-free alternative to fresh_voxel_margin: "fresh" = allocated
    # within the last N frames. The engine tracks the live voxel count per
    # insertion and passes the count from N inserts ago as the freshness
    # threshold — the margin then automatically follows the scene's actual
    # allocation rate (an absolute slot margin is scene/voxel-size
    # dependent, VERDICT r4 weak #9). > 0 overrides fresh_voxel_margin.
    fresh_window_frames: int = 0


@dataclasses.dataclass(frozen=True)
class MapSettings:
    """Static capacities of the sparse voxel map."""

    voxel_size: float = 0.2
    num_embeddings: int = 20000      # vertex embedding rows (mapper_specs)
    embed_dim: int = 16              # decoder_specs.in_dim
    voxel_capacity: int = 20000      # max SURFACE voxels
    frame_voxel_capacity: int = 8192  # max unique new voxels per insertion
    # smaller per-insert capacity for steady-state frames (0 = same as
    # frame_voxel_capacity). The insert step's sort/unique/scatter sizes
    # all scale with the frame capacity (measured 25.5/11/8.6 ms at
    # F=4096/1024/512, probe_insert.py) while a steady frame allocates
    # only ~30-50 new voxels; the first frame (seeding a big chunk of the
    # scene) uses the full capacity. Overflow is self-healing: a voxel
    # dropped by the truncated unique is re-observed and allocated on the
    # next frame.
    frame_voxel_capacity_steady: int = 0
    # integer coordinate packing: coords biased by +2^(bits-1), bits per axis
    coord_bits: int = 10
    # keep a per-voxel point cloud (VoxelPointStore) alongside the voxel
    # hash — required by the "pcd" feature branch; mirrors the reference
    # octree's <= max_num points per SURFACE leaf (`octree.cpp:175`)
    store_points: bool = False
    points_per_voxel: int = 8


@dataclasses.dataclass(frozen=True)
class DecoderSettings:
    """SDF+color MLP architecture (reference `nrgbd.py:80-135`)."""

    depth: int = 2
    width: int = 128
    in_dim: int = 16
    sdf_dim: int = 128
    skips: tuple = ()
    embedder: str = "none"
    multires: int = 0
    # use the fused Pallas MLP kernel on TPU when the architecture allows.
    # Off by default: at render shapes (~100k x 16 features) the XLA path
    # fuses the MLP into the surrounding gather/integration and measures
    # ~1 ms/iteration FASTER than the standalone kernel (ablate_iter.py on
    # v5e); the kernel remains for large standalone decodes (meshing).
    use_fused_mlp: bool = False
    # matmul compute dtype for the MLP: "bf16" runs the MXU at 2x f32
    # throughput with f32 accumulation (preferred_element_type). Geometry
    # (poses, point transforms) always stays f32 — the round-2 accuracy
    # collapse came from bf16 *geometry*, not bf16 MLP activations.
    matmul_dtype: str = "f32"


@dataclasses.dataclass(frozen=True)
class TrackerSettings:
    n_rays: int = 1024
    num_iterations: int = 30
    learning_rate: float = 0.01
    depth_variance: bool = True      # tracking.py:146 (weight_depth_loss)
    # initial pose guess for each frame: "velocity" extrapolates the last
    # inter-frame motion (standard SLAM constant-velocity prior);
    # "position" is the reference's constant-position prior
    # (`tracking.py:130-131` starts from the previous frame's pose), which
    # systematically lags the optimizer along weakly-observable directions.
    motion_model: str = "velocity"
    # exponential per-iteration lr decay: lr_i = lr * final_lr_frac^(i/(N-1)).
    # The final iterate of a fixed-lr Adam run on stochastic ray batches
    # oscillates with ~lr amplitude (~1 cm at lr 0.01); decaying to
    # lr*frac anneals that noise out. 1.0 = reference behavior (fixed lr).
    final_lr_frac: float = 0.1
    # minimum weight for rays dominated by fresh voxels (only active when
    # render.fresh_voxel_margin > 0): ray weight = 1-(1-floor)*fresh_frac
    fresh_ray_floor: float = 0.2
    # sample ONE pixel batch per tracked frame and reuse it across all
    # Adam iterations (the reference re-samples every iteration,
    # `render_helpers.py:702-757`). Intersection + stratified sampling
    # hoist out of the pose scan (~1/3 of the iteration cost); the 6-dof
    # pose from 1024 rays is ~170x over-determined, so a fixed batch
    # changes the estimate negligibly (validated: BENCH_NOTES r5).
    fixed_sample_batch: bool = False


@dataclasses.dataclass(frozen=True)
class MapperSettings:
    n_rays_each: int = 1024
    window_size: int = 4
    num_iterations: int = 10
    keyframe_gap: int = 50           # mapping.py:136 (stamp gap rule)
    max_keyframes: int = 256
    embed_lr: float = 5e-3           # mapping.py:81
    decoder_lr: float = 5e-3         # mapping.py:82
    pose_lr: float = 1e-3            # frame.py:27
    init_iterations: int = 30        # first-frame map warmup steps
    # denser keyframes while the map is immature: the first
    # ``early_keyframes`` commits use ``early_keyframe_gap`` instead of
    # ``keyframe_gap`` — early tracking errors otherwise bake a permanent
    # offset into the map gauge before the first regular commit
    early_keyframe_gap: int = 12
    early_keyframes: int = 3
    # also commit when the camera has rotated this many degrees since the
    # last keyframe (0 disables). The reference's stamp-gap-only rule
    # (`mapping.py:136`) under-anchors fast pans into unmapped territory —
    # its overlap-based alternative exists only as dead code
    # (`mapping.py:52`, `octree.cpp:381-417`); rotation-triggered commits
    # are the standard motion-based keyframing fix.
    keyframe_rotation_deg: float = 10.0
    # voxel-insertion cadence: insert every Nth frame's depth cloud
    # (the reference inserts every frame, `mapping.py:258-295`, but at
    # ~1 cm/frame motion consecutive clouds allocate nearly identical
    # voxel sets — the insert step's sort/scatter cost amortizes at
    # stride 2 with the frontier appearing one frame later, which the
    # fresh-ray weighting already discounts). 1 = reference behavior.
    insert_stride: int = 1
    # per-BA-round fixed ray batches (see TrackerSettings
    # .fixed_sample_batch): one pixel batch per window frame per round,
    # intersect+sample hoisted out of the 10-iteration BA scan
    fixed_sample_batch: bool = False
    # number of leading keyframes whose poses stay FROZEN (gauge
    # anchors). The reference anchors only the first frame
    # (`render_helpers.py:594-596`); with one anchor the gauge can bend
    # slowly around it (rotation drift of the whole map+trajectory).
    # Early keyframes are the most accurately tracked (seconds from
    # init), so pinning the first few is near-free and resists bending.
    # (Measured: >1 HURT on the bench — frozen slightly-wrong poses
    # poison the map; BENCH_NOTES r5.)
    anchor_keyframes: int = 1
    # always include keyframe 0 (the frozen gauge anchor) in the BA
    # window, alongside the always-included latest keyframe: every BA
    # round then re-asserts the anchor's sector of the map, so drifted
    # revisit keyframes are pulled toward the anchor-consistent map
    # instead of bending it (the observed failure mode: one rigid gauge
    # shift mid-run, ~1.3 cm aligned vs 2-5 cm unaligned ATE).
    window_include_anchor: bool = False
    # covisibility-weighted BA window selection: sample committed
    # keyframes with probability ~ exp(-view_angle / covis_angle_deg)
    # to the current frame instead of uniformly. Revisit-heavy scans then
    # regularly co-optimize the current pose against keyframes that SAW
    # the same sector long ago — the loop-closure pressure the
    # reference's uniform-random rule (`mapping.py:220-234`) lacks, and
    # the main counter to slow gauge drift. 0 = uniform (reference).
    covis_angle_deg: float = 0.0


@dataclasses.dataclass(frozen=True)
class LossSettings:
    rgb_weight: float = 0.5
    depth_weight: float = 1.0
    sdf_weight: float = 5000.0
    fs_weight: float = 10.0
    truncation: float = 0.1
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class SystemSettings:
    """Bundle of every static settings struct — one hashable static arg."""

    render: RenderSettings = RenderSettings()
    map: MapSettings = MapSettings()
    decoder: DecoderSettings = DecoderSettings()
    tracker: TrackerSettings = TrackerSettings()
    mapper: MapperSettings = MapperSettings()
    loss: LossSettings = LossSettings()


def settings_from_config(cfg: Config) -> SystemSettings:
    """Build the static settings bundle from a YAML config."""
    crit = cfg.get("criteria", {})
    dec = cfg.get("decoder_specs", {})
    trk = cfg.get("tracker_specs", {})
    mpr = cfg.get("mapper_specs", {})
    data = cfg.get("data_specs", {})
    tpu = cfg.get("tpu_specs", {})  # engine additions beyond the reference

    voxel_size = mpr.get("voxel_size", 0.2)
    max_depth = data.get("max_depth", 10.0)
    render = RenderSettings(
        voxel_size=voxel_size,
        step_size=mpr.get("step_size", 0.1) * voxel_size,
        truncation=crit.get("sdf_truncation", 0.1),
        max_distance=max_depth,
        max_hits=tpu.get("max_hits", 24),
        max_samples=tpu.get("max_samples", 96),
        adaptive_step=bool(tpu.get("adaptive_step", True)),
        intersect_mode=tpu.get("intersect_mode", "brute"),
        grid_dims=tuple(tpu.get("grid_dims", (192, 48, 192))),
        grid_origin=tuple(tpu.get("grid_origin", (-96, -24, -96))),
        dda_step_frac=tpu.get("dda_step_frac", 0.45),
        pixel_sampler=tpu.get("pixel_sampler", "uniform"),
        feature_mode=tpu.get("feature_mode", "vox"),
        fresh_voxel_margin=tpu.get("fresh_voxel_margin", 0),
        fresh_window_frames=tpu.get("fresh_window_frames", 0),
    )
    map_settings = MapSettings(
        voxel_size=voxel_size,
        num_embeddings=mpr.get("num_embeddings", 20000),
        embed_dim=dec.get("in_dim", 16),
        voxel_capacity=tpu.get("voxel_capacity", 20000),
        frame_voxel_capacity=tpu.get("frame_voxel_capacity", 8192),
        frame_voxel_capacity_steady=tpu.get(
            "frame_voxel_capacity_steady", 0),
        store_points=bool(tpu.get("store_points", False)),
        points_per_voxel=tpu.get("points_per_voxel", 8),
    )
    decoder = DecoderSettings(
        depth=dec.get("depth", 2),
        width=dec.get("width", 128),
        in_dim=dec.get("in_dim", 16),
        sdf_dim=dec.get("sdf_dim", 128),
        skips=tuple(dec.get("skips", ()) or ()),
        embedder=dec.get("embedder", "none"),
        multires=dec.get("multires", 0),
        use_fused_mlp=bool(tpu.get("fused_mlp", False)),
        matmul_dtype=tpu.get("matmul_dtype", "f32"),
    )
    tracker = TrackerSettings(
        n_rays=trk.get("N_rays", 1024),
        num_iterations=trk.get("num_iterations", 30),
        learning_rate=trk.get("learning_rate", 0.01),
        depth_variance=bool(trk.get("depth_variance", True)),
        motion_model=trk.get("motion_model", "velocity"),
        final_lr_frac=trk.get("final_lr_frac", 0.1),
        fresh_ray_floor=trk.get("fresh_ray_floor", 0.2),
        fixed_sample_batch=bool(tpu.get("fixed_sample_batch", False)),
    )
    mapper = MapperSettings(
        n_rays_each=mpr.get("N_rays_each", 1024),
        window_size=mpr.get("window_size", 4),
        num_iterations=mpr.get("num_iterations", 10),
        keyframe_gap=mpr.get("keyframe_gap", 50),
        max_keyframes=tpu.get("max_keyframes", 256),
        init_iterations=tpu.get("init_iterations", 30),
        early_keyframe_gap=tpu.get("early_keyframe_gap", 12),
        early_keyframes=tpu.get("early_keyframes", 3),
        keyframe_rotation_deg=tpu.get("keyframe_rotation_deg", 10.0),
        insert_stride=tpu.get("insert_stride", 1),
        fixed_sample_batch=bool(tpu.get("fixed_sample_batch", False)),
        anchor_keyframes=tpu.get("anchor_keyframes", 1),
        window_include_anchor=bool(tpu.get("window_include_anchor",
                                           False)),
        covis_angle_deg=tpu.get("covis_angle_deg", 0.0),
    )
    loss = LossSettings(
        rgb_weight=crit.get("rgb_weight", 0.5),
        depth_weight=crit.get("depth_weight", 1.0),
        sdf_weight=crit.get("sdf_weight", 5000.0),
        fs_weight=crit.get("fs_weight", 10.0),
        truncation=crit.get("sdf_truncation", 0.1),
        max_depth=max_depth,
    )
    return SystemSettings(
        render=render, map=map_settings, decoder=decoder,
        tracker=tracker, mapper=mapper, loss=loss,
    )


def bench_settings() -> SystemSettings:
    """The benchmark operating point of ``bench.py::bench_settings`` with
    the fused render branch on (``use_fused_mlp=True``): S=64 samples and
    H=12 hit slots per ray, 30x1024-ray tracking and 10x(5x1024)-ray BA
    iterations with per-round fixed ray batches, bf16 decoder operands,
    the 1024-voxel steady insert budget and insert stride 2. Every other
    field equals the JAX package's bench configuration."""
    return SystemSettings(
        render=RenderSettings(voxel_size=0.2, step_size=0.02, truncation=0.1,
                              max_distance=10.0, max_hits=12, max_samples=64,
                              intersect_mode="brute",
                              fresh_window_frames=50),
        map=MapSettings(voxel_size=0.2, num_embeddings=40960, embed_dim=16,
                        voxel_capacity=20480, frame_voxel_capacity=4096,
                        frame_voxel_capacity_steady=1024),
        decoder=DecoderSettings(depth=2, width=128, in_dim=16, sdf_dim=128,
                                matmul_dtype="bf16", use_fused_mlp=True),
        tracker=TrackerSettings(n_rays=1024, num_iterations=30,
                                learning_rate=0.01,
                                fixed_sample_batch=True,
                                fresh_ray_floor=0.05),
        mapper=MapperSettings(n_rays_each=1024, window_size=4,
                              num_iterations=10, keyframe_gap=12,
                              max_keyframes=64, init_iterations=200,
                              fixed_sample_batch=True, insert_stride=2),
        loss=LossSettings(),
    )
