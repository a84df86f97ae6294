"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port (on the CPU, where
every kernel wrapper of the port runs its plain version)."""

import numpy as np
import pytest
import torch

from proudslam_tpu.config import DecoderSettings, MapSettings, RenderSettings

# small sizes: width 64, H=6 hit slots, S=24 samples
MAP = MapSettings(voxel_size=0.2, num_embeddings=4096, embed_dim=16,
                  voxel_capacity=512, frame_voxel_capacity=64)
RENDER = RenderSettings(voxel_size=0.2, step_size=0.05, max_hits=6,
                        max_samples=24)
DEC = DecoderSettings(depth=2, width=64, in_dim=16, sdf_dim=64,
                      matmul_dtype="bf16", use_fused_mlp=True)
# the decoder sizes (in_dim, width, sdf_dim) of the kernel parity cases:
# the small default, the reference's wider decoder (width 256), the
# smallest in_dim-32 and in_dim-64 sizes the kernels are built for, the
# widest, and in_dim 128 (built at width 128 and up: 128x64x64 runs padded
# to (128, 128, 128) on the card)
SIZED_DEC = {"16x64x64": DEC,
             "16x256x128": DecoderSettings(
                 depth=2, width=256, in_dim=16, sdf_dim=128,
                 matmul_dtype="bf16", use_fused_mlp=True),
             "32x64x64": DecoderSettings(
                 depth=2, width=64, in_dim=32, sdf_dim=64,
                 matmul_dtype="bf16", use_fused_mlp=True),
             "64x64x64": DecoderSettings(
                 depth=2, width=64, in_dim=64, sdf_dim=64,
                 matmul_dtype="bf16", use_fused_mlp=True),
             "16x512x512": DecoderSettings(
                 depth=2, width=512, in_dim=16, sdf_dim=512,
                 matmul_dtype="bf16", use_fused_mlp=True),
             "128x64x64": DecoderSettings(
                 depth=2, width=64, in_dim=128, sdf_dim=64,
                 matmul_dtype="bf16", use_fused_mlp=True)}


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


# Backward parity at a wide decoder (width 384 or 512): the plain versions
# and the Pallas kernels sum in other orders, so where a hidden
# pre-activation lies within rounding of 0 (f32 rounding at f32 operands;
# with bf16 operands a neighbouring activation's other bf16 rounding moves
# it by up to ~1e-3) they can take different ReLU masks, and that row's dx
# and its terms of the weight gradients differ by a whole term (up to
# ~2.5e-2 of a gradient's largest magnitude over a 2048-row tile). With
# N(0, 1) inputs such a tile of a wide decoder holds such a row at any
# seed; at the narrower sizes none of these cases does. So there the rows
# whose dx misses the tolerance may be at most FLIP_SHARE of all
# (chip_smoke.py's TOL_FLIP_SHARE), and every output, dx and each weight
# and bias gradient, is then held at the full tolerance on a second run of
# both with those rows' cotangents zeroed (``flipped_rows_zeroed``): a
# zero cotangent adds nothing to any gradient and gives dx 0 whichever
# masks are taken.
FLIP_SHARE = 1e-2


def flipped_rows_zeroed(dx, dx_ref, g, atol):
    """``g`` (numpy) with the rows where ``dx`` misses ``dx_ref`` by more
    than ``atol`` of its largest magnitude zeroed; asserts they are at most
    FLIP_SHARE of the rows."""
    dx, dx_ref = n(dx), n(dx_ref)
    scale = float(np.max(np.abs(dx_ref))) + 1e-12
    miss = np.abs(dx - dx_ref).max(axis=1) > atol * scale
    assert miss.sum() <= FLIP_SHARE * dx.shape[0], (
        f"dx: {int(miss.sum())} of {dx.shape[0]} rows beyond {atol} of its "
        "largest magnitude")
    return np.where(miss[:, None], 0.0, g).astype(np.float32)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a test module with one intra-op thread in PyTorch (restored after).
    Under several test workers on one machine, PyTorch's default of one
    thread per core makes each parallel region wait on threads the other
    workers hold: a cut-down CLI run that takes 5 s alone took 108 s under
    five busy processes, and 11 s with one thread (CPU runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
