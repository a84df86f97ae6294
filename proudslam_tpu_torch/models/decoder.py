"""SDF + color MLP decoder, and the bridge to the JAX package's layouts.

Port of ``proudslam_tpu/models/decoder.py`` for the default architecture
(identity embedder). Parameters are a plain dict of dicts with the JAX
layout — ``w`` is (fan_in, fan_out), ``b`` is (fan_out,) — so the bridge
is a dtype/device conversion and the kernels' ``pack_params`` reads the
same structure on both sides:

  {"layers": [{"w","b"}, ...], "sdf_out": {...}, "color0": {...},
   "color1": {...}}
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from proudslam_tpu_torch.config import DecoderSettings

Params = Dict[str, Any]


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int, device):
    """Kaiming-uniform like torch.nn.Linear's default."""
    bound = 1.0 / math.sqrt(fan_in)
    u = lambda *shape: (torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
                        * (2 * bound) - bound).to(device)
    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def init_decoder(gen: torch.Generator, settings: DecoderSettings,
                 device) -> Params:
    if settings.embedder != "none":
        raise NotImplementedError(
            "the port implements the identity embedder only")
    emb = settings.in_dim
    layers = []
    in_dim = emb
    for i in range(settings.depth):
        layers.append(_linear_init(gen, in_dim, settings.width, device))
        in_dim = settings.width + emb if i in settings.skips else settings.width
    return {
        "layers": layers,
        "sdf_out": _linear_init(gen, settings.width, 1 + settings.sdf_dim,
                                device),
        "color0": _linear_init(gen, settings.sdf_dim + emb, settings.width,
                               device),
        "color1": _linear_init(gen, settings.width, 3, device),
    }


def _linear(p, x, dtype):
    """x @ w + b with operands cast to ``dtype`` and an f32 result.

    bf16 operands are rounded to nearest-even and multiplied exactly in
    f32, which is what a bf16 x bf16 -> f32 matmul computes."""
    return (x.to(dtype).float() @ p["w"].to(dtype).float()) + p["b"]


def decoder_values(params: Params, settings: DecoderSettings,
                   x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) features -> (N, 4) [r, g, b, sdf]."""
    dt = torch.bfloat16 if settings.matmul_dtype == "bf16" else torch.float32
    h = x
    for i, layer in enumerate(params["layers"]):
        h = torch.relu(_linear(layer, h, dt))
        if i in settings.skips:
            h = torch.cat([x, h], dim=-1)
    sdf_out = _linear(params["sdf_out"], h, dt)
    hc = torch.cat([sdf_out[:, 1:], x], dim=-1)
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


def params_from_jax(tree: Params, device="cpu") -> Params:
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


def map_state_from_numpy(arrays, device="cpu"):
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
