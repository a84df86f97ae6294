"""SE(3) and camera parity: the port's Taylor-form exp/log, pose matrices
and camera functions against the JAX package on the same inputs.
Tolerance 1e-6 absolute: both evaluate the same f32 formulas, only the
order of a few float operations differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proudslam_tpu.geometry import camera as jcam
from proudslam_tpu.geometry import se3 as jse3
from proudslam_tpu_torch.geometry import camera as tcam
from proudslam_tpu_torch.geometry import se3 as tse3

from torch_parity import n, t

RNG = np.random.default_rng(0)
POSES = np.concatenate([RNG.uniform(-2, 2, (16, 3)),
                        RNG.uniform(-1.5, 1.5, (16, 3))], 1).astype(np.float32)
POSES[0, 3:] = 0.0                                   # identity rotation


@pytest.mark.parametrize("fn", ["exp_rotation", "matrix_from_tangent",
                                "tangent_roundtrip", "inverse_matrix"])
def test_se3_matches_jax(fn):
    if fn == "exp_rotation":
        a, b = jse3.exp_rotation(POSES[:, 3:]), tse3.exp_rotation(t(POSES[:, 3:]))
    elif fn == "matrix_from_tangent":
        a, b = jse3.matrix_from_tangent(POSES), tse3.matrix_from_tangent(t(POSES))
    elif fn == "tangent_roundtrip":
        m = np.asarray(jse3.matrix_from_tangent(POSES))
        a, b = jse3.tangent_from_matrix(m), tse3.tangent_from_matrix(t(m))
    else:
        m = np.asarray(jse3.matrix_from_tangent(POSES))
        a, b = jse3.inverse_matrix(m), tse3.inverse_matrix(t(m))
    np.testing.assert_allclose(n(b), n(a), atol=1e-5)


def test_exp_gradient_finite_at_zero():
    w = torch.zeros(3, requires_grad=True)
    tse3.exp_rotation(w).sum().backward()
    assert torch.isfinite(w.grad).all()
    g = jax.grad(lambda v: jnp.sum(jse3.exp_rotation(v)))(jnp.zeros(3))
    np.testing.assert_allclose(n(w.grad), n(g), atol=1e-6)


def test_camera_matches_jax():
    K = (50.0, 48.0, 31.5, 23.5)
    a = jcam.pixel_ray_directions(64, 48, *K)
    b = tcam.pixel_ray_directions(64, 48, *K, device="cpu")
    np.testing.assert_allclose(n(b), n(a), atol=1e-6)
    depth = RNG.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    pts_a = jcam.backproject(a, depth).reshape(-1, 3)
    pts_b = tcam.backproject(b, t(depth)).reshape(-1, 3)
    R = np.asarray(jse3.exp_rotation(POSES[3, 3:]))
    wa = jcam.transform_points(pts_a, R, POSES[3, :3])
    wb = tcam.transform_points(pts_b, t(R), t(POSES[3, :3]))
    np.testing.assert_allclose(n(wb), n(wa), atol=1e-5)
