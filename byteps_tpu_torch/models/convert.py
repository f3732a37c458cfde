"""Convert between the JAX package's parameter layout and the port's
state dict.

The JAX package keeps a flat dict of numpy/JAX arrays; layer parameters
are stacked with leading dims ``(pp, layers_per_stage)``.  The port keeps
one module per layer: ``layers.<i>.<name>``, with the global layer index
``i = stage * layers_per_stage + j``.  Values are copied exactly.

On a mesh each rank holds its shards (``models.transformer``: blocks over
tp, and the experts of an expert layer over sp):
:func:`shard_params_from_jax` cuts a rank's state dict out of the global
arrays, the slices the reference's ``shard_params`` places on the
matching device, and :func:`params_to_jax` with a mesh gathers the shards
back into the global layout on every rank.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import Mesh
from byteps_tpu_torch.models.transformer import (
    TransformerConfig,
    is_layer_param,
    local_spec,
    param_shapes,
    validate_mesh,
)


def _check_names(np_params: Mapping[str, np.ndarray], shapes: Mapping) -> None:
    if set(np_params) != set(shapes):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(shapes) - set(np_params))}, "
            f"unexpected {sorted(set(np_params) - set(shapes))}"
        )


def params_from_jax(
    np_params: Mapping[str, np.ndarray], cfg: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """JAX-layout arrays → the port's state dict (CPU float32 tensors)."""
    shapes = param_shapes(cfg)
    _check_names(np_params, shapes)
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_params[name], dtype=np.float32)
        if is_layer_param(name):
            arr = arr.reshape((cfg.n_layers,) + shape)
            for i in range(cfg.n_layers):
                sd[f"layers.{i}.{name}"] = torch.from_numpy(arr[i].copy())
        else:
            sd[name] = torch.from_numpy(arr.reshape(shape).copy())
    return sd


def _block(arr: np.ndarray, spec, mesh: Mesh) -> np.ndarray:
    """This rank's block of ``arr`` along each dim ``spec`` shards over a
    mesh axis."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            n, i = arr.shape[dim] // mesh.axis_size(ax), mesh.axis_index(ax)
            arr = np.take(arr, range(i * n, (i + 1) * n), axis=dim)
    return np.ascontiguousarray(arr)


def shard_params_from_jax(
    np_params: Mapping[str, np.ndarray], cfg: TransformerConfig, mesh: Mesh
) -> Dict[str, torch.Tensor]:
    """This rank's state dict on ``mesh``: its pp stage's layers (global
    indices) and its blocks of every parameter sharded over tp or sp."""
    validate_mesh(cfg, mesh)
    shapes = param_shapes(cfg)
    _check_names(np_params, shapes)
    pp, stage = mesh.axis_size("pp"), mesh.axis_index("pp")
    lps = cfg.n_layers // pp
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_params[name], dtype=np.float32)
        spec = local_spec(cfg, name)
        if is_layer_param(name):
            arr = arr.reshape((cfg.n_layers,) + shape)
            for j in range(lps):
                i = stage * lps + j
                sd[f"layers.{i}.{name}"] = torch.from_numpy(_block(arr[i], spec, mesh))
        else:
            sd[name] = torch.from_numpy(_block(arr.reshape(shape), spec, mesh))
    return sd


def params_to_jax(
    state_dict: Mapping[str, torch.Tensor], cfg: TransformerConfig, pp_size: int = 1,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """The port's state dict → JAX-layout float32 numpy arrays.  With a
    ``mesh``, ``state_dict`` is this rank's shards: every rank of the mesh
    calls this, and each gets the gathered global arrays (stacked over
    ``pp_size`` stages)."""
    if cfg.n_layers % pp_size:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp_size}")
    lps = cfg.n_layers // pp_size

    def host(t: torch.Tensor) -> np.ndarray:  # a copy, never a view of a live parameter
        return t.detach().to("cpu", torch.float32).numpy().copy()

    def whole(t: torch.Tensor, name: str) -> torch.Tensor:
        if mesh is None:
            return t
        for dim, ax in enumerate(local_spec(cfg, name)):
            if ax is not None:
                t = collectives.all_gather_axis(t.detach().contiguous(), ax, dim, mesh)
        return t

    out: Dict[str, np.ndarray] = {}
    for name, shape in param_shapes(cfg).items():
        if not is_layer_param(name):
            out[name] = host(whole(state_dict[name], name))
            continue
        mpp = mesh.axis_size("pp") if mesh is not None else 1
        first = mesh.axis_index("pp") * (cfg.n_layers // mpp) if mesh is not None else 0
        stacked = collectives.stack_stages(
            [whole(state_dict[f"layers.{first + j}.{name}"], name)
             for j in range(cfg.n_layers // mpp)], mesh)
        out[name] = host(stacked).reshape((pp_size, lps) + shape)
    return out


# --- the conv models (models/resnet.py, models/vgg.py) -----------------------
#
# flax's tree {"params": {...}, "batch_stats": {...}} and the port's state
# dict share their names (models.resnet): a path joined by "." is the
# module, and the leaves map kernel → weight (HWIO → OIHW, a Dense's
# (in, out) → (out, in)), bias, scale, and the running mean and var.


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _to_torch_leaf(name: str, arr: np.ndarray) -> tuple:
    mod, _, leaf = name.rpartition(".")
    if leaf != "kernel":
        return name, arr
    if arr.ndim == 4:
        return f"{mod}.weight", arr.transpose(3, 2, 0, 1)
    return f"{mod}.weight", arr.T


def conv_params_from_jax(variables: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A flax conv model's variables (``params`` and ``batch_stats``) as
    ``model``'s state dict (CPU float32 tensors).  A name missing on either
    side raises."""
    flat = {**_flat(variables["params"]), **_flat(variables.get("batch_stats", {}))}
    sd = {}
    for name, arr in flat.items():
        key, arr = _to_torch_leaf(name, arr)
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    _check_names(sd, model.state_dict())
    return sd


def conv_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                       model: torch.nn.Module) -> Dict[str, Dict]:
    """The inverse of :func:`conv_params_from_jax`: ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of float32 numpy arrays."""
    _check_names(state_dict, model.state_dict())
    stats = {n for n, _ in model.named_buffers()}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight":
            leaf, arr = "kernel", (arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T.copy())
        node = out["batch_stats" if key in stats else "params"]
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
