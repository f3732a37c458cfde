"""Convert between the JAX package's parameter layout and the port's
state dict.

The JAX package keeps a flat dict of numpy/JAX arrays; layer parameters
are stacked with leading dims ``(pp, layers_per_stage)``.  The port keeps
one module per layer: ``layers.<i>.<name>``, with the global layer index
``i = stage * layers_per_stage + j``.  Values are copied exactly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from byteps_tpu_torch.models.transformer import (
    TransformerConfig,
    is_layer_param,
    param_shapes,
)


def params_from_jax(
    np_params: Mapping[str, np.ndarray], cfg: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """JAX-layout arrays → the port's state dict (CPU float32 tensors)."""
    shapes = param_shapes(cfg)
    if set(np_params) != set(shapes):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(shapes) - set(np_params))}, "
            f"unexpected {sorted(set(np_params) - set(shapes))}"
        )
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


def params_to_jax(
    state_dict: Mapping[str, torch.Tensor], cfg: TransformerConfig, pp_size: int = 1
) -> Dict[str, np.ndarray]:
    """The port's state dict → JAX-layout float32 numpy arrays."""
    if cfg.n_layers % pp_size:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp_size}")
    lps = cfg.n_layers // pp_size

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy()

    out: Dict[str, np.ndarray] = {}
    for name, shape in param_shapes(cfg).items():
        if is_layer_param(name):
            stacked = np.stack(
                [host(state_dict[f"layers.{i}.{name}"]) for i in range(cfg.n_layers)]
            )
            out[name] = stacked.reshape((pp_size, lps) + shape)
        else:
            out[name] = host(state_dict[name])
    return out
