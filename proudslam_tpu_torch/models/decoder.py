"""SDF + color MLP decoder, and the bridge to the JAX package's layouts.

Port of ``proudslam_tpu/models/decoder.py``: the input embedders
(identity, NeRF, Gaussian Fourier), the MLP trunk with optional skips, the
SDF head and the color head on [sdf feature, embedded input]. Parameters
are a plain dict of dicts with the JAX layout — ``w`` is (fan_in,
fan_out), ``b`` is (fan_out,) — so the bridge is a dtype/device conversion
and the kernels' ``pack_params`` reads the same structure on both sides:

  {"layers": [{"w","b"}, ...], "sdf_out": {...}, "color0": {...},
   "color1": {...}}  (+ "gaussian_B": (in_dim, 93) with the Gaussian
  embedder: a leaf like any other, so the mapper's Adam trains it, as the
  JAX package's does)
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from proudslam_tpu_torch.config import DecoderSettings

Params = Dict[str, Any]

GAUSSIAN_SIZE = 93  # the reference's default mapping size (``nrgbd.py:16``)


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int, device):
    """Kaiming-uniform like torch.nn.Linear's default."""
    bound = 1.0 / math.sqrt(fan_in)
    u = lambda *shape: (torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
                        * (2 * bound) - bound).to(device)
    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def embedded_size(settings: DecoderSettings) -> int:
    if settings.embedder == "none":
        return settings.in_dim
    if settings.embedder == "nerf":
        # include_input + sin/cos per frequency
        return settings.in_dim * (2 * settings.multires + 1)
    if settings.embedder == "gaussian":
        return GAUSSIAN_SIZE
    raise ValueError(f"unknown embedder {settings.embedder!r}")


def embed_input(settings: DecoderSettings, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) -> (N, embedded_size) by the settings' embedder."""
    if settings.embedder == "none":
        return x
    if settings.embedder == "nerf":
        freqs = 2.0 ** np.linspace(0.0, settings.multires - 1,
                                   settings.multires, dtype=np.float32)
        outs = [x]
        for f in freqs.tolist():
            outs.append(torch.sin(x * f))
            outs.append(torch.cos(x * f))
        return torch.cat(outs, dim=-1)
    if settings.embedder == "gaussian":
        # true f32 whatever matmul_dtype says (TF32 stays off, see the
        # package's __init__): at |B| ~ 25 TF32's rounding would move the
        # sine's argument by ~0.03
        return torch.sin(x @ params["gaussian_B"])
    raise ValueError(f"unknown embedder {settings.embedder!r}")


def init_decoder(gen: torch.Generator, settings: DecoderSettings,
                 device) -> Params:
    emb = embedded_size(settings)
    layers = []
    in_dim = emb
    for i in range(settings.depth):
        layers.append(_linear_init(gen, in_dim, settings.width, device))
        in_dim = settings.width + emb if i in settings.skips else settings.width
    params = {
        "layers": layers,
        "sdf_out": _linear_init(gen, settings.width, 1 + settings.sdf_dim,
                                device),
        "color0": _linear_init(gen, settings.sdf_dim + emb, settings.width,
                               device),
        "color1": _linear_init(gen, settings.width, 3, device),
    }
    if settings.embedder == "gaussian":
        params["gaussian_B"] = 25.0 * torch.randn(
            (settings.in_dim, GAUSSIAN_SIZE), generator=gen,
            device=gen.device).to(device)
    return params


def _linear(p, x, dtype):
    """x @ w + b with operands cast to ``dtype`` and an f32 result.

    bf16 operands are rounded to nearest-even and multiplied exactly in
    f32, which is what a bf16 x bf16 -> f32 matmul computes."""
    return (x.to(dtype).float() @ p["w"].to(dtype).float()) + p["b"]


def decoder_values(params: Params, settings: DecoderSettings,
                   x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) features -> (N, 4) [r, g, b, sdf]."""
    dt = torch.bfloat16 if settings.matmul_dtype == "bf16" else torch.float32
    xe = embed_input(settings, params, x)
    h = xe
    for i, layer in enumerate(params["layers"]):
        h = torch.relu(_linear(layer, h, dt))
        if i in settings.skips:
            h = torch.cat([xe, h], dim=-1)
    sdf_out = _linear(params["sdf_out"], h, dt)
    hc = torch.cat([sdf_out[:, 1:], xe], dim=-1)
    rgb = torch.sigmoid(_linear(params["color1"], torch.relu(
        _linear(params["color0"], hc, dt)), dt))
    return torch.cat([rgb, sdf_out[:, :1]], dim=-1)


# ---------------------------------------------------------------------------
# bridge to the JAX package (numpy pytrees / numpy map arrays)
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree: Params, device="cuda") -> Params:
    """JAX decoder params (arrays convertible by ``np.asarray``) -> port."""
    return _tree_map(lambda a: torch.as_tensor(
        np.array(a, dtype=np.float32), device=device), tree)


def params_to_numpy(params: Params) -> Params:
    """Port decoder params -> numpy pytree in the JAX layout."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a params pytree in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A pytree shaped like ``tree`` holding ``leaves`` (inverse of
    :func:`tree_leaves`)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            vals = {k: rec(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return next(it)
    return rec(tree)


_MAP_FIELDS = ("cell_keys", "cell_ids", "cell_vslot", "num_cells",
               "voxel_keys", "voxel_vertex_ids", "num_voxels", "embeddings",
               "inv_map")


def map_state_from_numpy(arrays, device="cuda"):
    """A JAX ``MapState`` (or any object with its fields) -> port MapState."""
    from proudslam_tpu_torch.ops.voxel_hash import MapState

    out = {}
    for name in _MAP_FIELDS:
        a = np.asarray(getattr(arrays, name))
        out[name] = (int(a) if a.ndim == 0
                     else torch.as_tensor(np.array(a), device=device))
    return MapState(**out)


def map_state_to_numpy(state) -> dict:
    """Port MapState -> dict of numpy arrays under the JAX field names."""
    return {name: (np.int32(v) if isinstance(v, int)
                   else v.detach().cpu().numpy())
            for name, v in state._asdict().items()}


def point_store_from_numpy(arrays, device="cuda"):
    """A JAX ``VoxelPointStore`` (or any object with its fields) -> port."""
    from proudslam_tpu_torch.render.pcd_features import VoxelPointStore

    return VoxelPointStore(*[
        torch.as_tensor(np.array(getattr(arrays, name)), device=device)
        for name in VoxelPointStore._fields])


def point_store_to_numpy(store) -> dict:
    """Port VoxelPointStore -> dict of numpy arrays under its field names."""
    return {name: v.detach().cpu().numpy()
            for name, v in store._asdict().items()}
