"""The port's entry points (``proudslam_tpu_torch/parallel/dryrun.py``),
the counterparts of ``__graft_entry__.py``'s: ``entry`` (the render + loss
forward over a wall of 169 voxels, 256 rays) held against the JAX entry on
the same inputs, its gradient, and ``dryrun_multichip`` run on 2 and 4
gloo ranks (each form's own assertions: the engine on a (dp, mp) mesh
within 5 mm of the single-device run, the sharded, spatial and Schur BA
steps finite, the map stored over every rank).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from proudslam_tpu_torch.models.decoder import (map_state_from_numpy,
                                                params_from_jax, tree_leaves)
from proudslam_tpu_torch.parallel.dryrun import entry
from torch_parallel import Ranks
from torch_parity import t


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return {n: Ranks(tmp, n, "dryrun_job", timeout=400, n=n)
            for n in (2, 4)}


def jax_args_in_port():
    """JAX's example arguments (decoder, map, rays, noise), converted."""
    fn, (params, state, rays_o, rays_d, noise) = __graft_entry__.entry()
    return fn, (params, state, rays_o, rays_d, noise), (
        params_from_jax(params, device="cpu"),
        map_state_from_numpy(state, device="cpu"), t(rays_o), t(rays_d),
        t(noise))


def test_entry_compiles_and_runs():
    fn, args = entry(device="cpu")
    assert np.isfinite(float(fn(*args)))
    # on the JAX entry's own inputs, the JAX entry's loss
    jfn, jargs, targs = jax_args_in_port()
    np.testing.assert_allclose(float(fn(*targs)),
                               float(jax.jit(jfn)(*jargs)), rtol=1e-4)


def test_entry_is_differentiable():
    fn, args = entry(device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(args[0])]
    grads = torch.autograd.grad(fn(*args), leaves)
    total = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(total) and total > 0


@pytest.mark.parametrize("n", [2, 4])
def test_graft_dryrun_multichip(dryruns, n):
    assert dryruns[n].wait() == [n] * n
