"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port (on the CPU, where
every kernel wrapper of the port runs its plain version)."""

import numpy as np
import torch

from proudslam_tpu.config import DecoderSettings, MapSettings, RenderSettings

# small sizes: width 64, H=6 hit slots, S=24 samples
MAP = MapSettings(voxel_size=0.2, num_embeddings=4096, embed_dim=16,
                  voxel_capacity=512, frame_voxel_capacity=64)
RENDER = RenderSettings(voxel_size=0.2, step_size=0.05, max_hits=6,
                        max_samples=24)
DEC = DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64,
                      matmul_dtype="bf16", use_fused_mlp=True)


def port(settings):
    """The port's copy of a JAX settings dataclass (same fields)."""
    import proudslam_tpu_torch.config as pc
    return getattr(pc, type(settings).__name__)(**{
        f: getattr(settings, f) for f in settings.__dataclass_fields__})


def port_system(settings):
    import proudslam_tpu_torch.config as pc
    return pc.SystemSettings(**{f: port(getattr(settings, f))
                                for f in settings.__dataclass_fields__})


def t(a, dtype=None):
    """numpy/JAX array -> CPU torch tensor (copy)."""
    a = np.array(a)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def map_coords(seed=0, count=400, lo=-6, hi=6):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(lo, hi, (count, 3)), axis=0)


def ray_batch(R, seed=2):
    """(o, d) numpy rays from inside the random map's extent."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([0.4 * rng.standard_normal((R, 2)),
                        np.ones((R, 1))], axis=-1).astype(np.float32)
    o = np.tile(np.array([[0.05, 0.02, -0.1]], np.float32), (R, 1))
    return o, d


def assert_close_scaled(a, b, atol, what=""):
    """|a - b| <= atol * max|b| elementwise."""
    a, b = n(a), n(b)
    scale = float(np.max(np.abs(b))) + 1e-12
    np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=what)
