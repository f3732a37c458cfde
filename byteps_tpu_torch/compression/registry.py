"""Codec factory from declare kwargs (CompressorRegistry::Create,
compressor_registry.cc:39-56), with the same keys as
``byteps_tpu.compression.registry``:

    byteps_compressor_type           onebit | topk | randomk | dithering
    byteps_compressor_onebit_scaling "True"/"False"
    byteps_compressor_k              int (count, or ratio if < 1)
    byteps_ef_type                   vanilla
    byteps_momentum_type             nesterov
    byteps_momentum_mu               float
    byteps_seed                      int
    byteps_dithering_partition       0 (linear) | 1 (natural)
    byteps_dithering_normalize       0 (max) | 1 (l2)

The chain is momentum -> error feedback -> codec; a server's chain skips
momentum (``server=True``).
"""

from __future__ import annotations

from typing import Dict, Optional

from byteps_tpu_torch.compression.base import Compressor
from byteps_tpu_torch.compression.error_feedback import VanillaErrorFeedback
from byteps_tpu_torch.compression.impl import (
    DitheringCompressor,
    OneBitCompressor,
    RandomKCompressor,
    TopKCompressor,
)
from byteps_tpu_torch.compression.momentum import NesterovMomentum


def _parse_k(kwargs: Dict[str, str], size: int) -> int:
    val = float(kwargs.get("byteps_compressor_k", "1"))
    if 0 < val < 1:  # ratio semantics (topk.cc:30-36)
        return max(1, int(val * size))
    return max(1, int(val))


def translate_compression_params(params: Optional[Dict]) -> Dict[str, str]:
    """User-facing ``compression_params`` -> byteps_* declare kwargs, the
    translation of the reference's DistributedTrainer
    (mxnet/__init__.py:236-290): {"compressor": "onebit", "scaling": True,
    "ef": "vanilla", "momentum": "nesterov", "k": 0.01, "seed": 42,
    "partition": "natural", "normalize": "l2", "momentum_mu": 0.9}."""
    out: Dict[str, str] = {}
    if not params:
        return out
    if params.get("compressor"):
        out["byteps_compressor_type"] = str(params["compressor"])
    if params.get("ef"):
        out["byteps_ef_type"] = str(params["ef"])
    if params.get("momentum"):
        out["byteps_momentum_type"] = str(params["momentum"])
    if "k" in params:
        out["byteps_compressor_k"] = str(params["k"])
    if "scaling" in params:
        out["byteps_compressor_onebit_scaling"] = str(params["scaling"])
    if "seed" in params:
        out["byteps_seed"] = str(params["seed"])
    if params.get("partition"):
        out["byteps_dithering_partition"] = (
            "1" if params["partition"] in ("natural", 1, "1") else "0"
        )
    if params.get("normalize"):
        out["byteps_dithering_normalize"] = (
            "1" if params["normalize"] in ("l2", 1, "1") else "0"
        )
    if "momentum_mu" in params:
        out["byteps_momentum_mu"] = str(params["momentum_mu"])
    return out


def parse_codec_config(kwargs: Dict[str, str], size: int) -> Optional[Dict]:
    """Normalize a declared tensor's compression kwargs; None when no
    codec is configured.  The one parser of the byteps_* keys, shared by
    :func:`create_compressor` and ``core.device_codec.device_codec_for``."""
    kwargs = {str(k): str(v) for k, v in kwargs.items()}
    ctype = kwargs.get("byteps_compressor_type") or kwargs.get("compressor")
    if not ctype:
        return None
    return {
        "ctype": ctype,
        "seed": int(float(kwargs.get("byteps_seed", kwargs.get("seed", "0")))),
        "k": _parse_k(kwargs, size),
        "scaling": kwargs.get(
            "byteps_compressor_onebit_scaling", kwargs.get("scaling", "False")
        ).lower() in ("true", "1"),
        "natural": kwargs.get("byteps_dithering_partition", "0")
        in ("1", "natural"),
        "l2": kwargs.get("byteps_dithering_normalize", "0") in ("1", "l2"),
        "ef": kwargs.get("byteps_ef_type") or kwargs.get("ef") or "",
        "momentum": kwargs.get("byteps_momentum_type")
        or kwargs.get("momentum") or "",
        "momentum_mu": float(kwargs.get("byteps_momentum_mu", "0.9")),
    }


def check_supported(cfg: Dict) -> None:
    """Raise ValueError for a parsed config that names an unknown codec,
    error feedback or momentum."""
    if cfg["ctype"] not in ("onebit", "topk", "randomk", "dithering"):
        raise ValueError(f"unknown compressor type {cfg['ctype']!r}")
    if cfg["ef"] not in ("", "vanilla"):
        raise ValueError(f"unknown error-feedback type {cfg['ef']!r}")
    if cfg["momentum"] not in ("", "nesterov"):
        raise ValueError(f"unknown momentum type {cfg['momentum']!r}")


def create_compressor(
    kwargs: Dict[str, str], size: int, server: bool = False
) -> Optional[Compressor]:
    """The codec chain for a declared tensor; None when none is
    configured.  Servers skip momentum (compressor_registry.cc:44)."""
    cfg = parse_codec_config(kwargs, size)
    if cfg is None:
        return None
    check_supported(cfg)
    ctype = cfg["ctype"]
    if ctype == "onebit":
        codec: Compressor = OneBitCompressor(size, scaling=cfg["scaling"])
    elif ctype == "topk":
        codec = TopKCompressor(size, cfg["k"])
    elif ctype == "randomk":
        codec = RandomKCompressor(size, cfg["k"], seed=cfg["seed"])
    else:
        codec = DitheringCompressor(
            size, k=cfg["k"], partition="natural" if cfg["natural"] else "linear",
            normalize="l2" if cfg["l2"] else "max", seed=cfg["seed"],
        )
    if cfg["ef"]:
        codec = VanillaErrorFeedback(codec)
    if cfg["momentum"] and not server:
        codec = NesterovMomentum(codec, mu=cfg["momentum_mu"])
    return codec


def apply_lr_to_chain(codec: Optional[Compressor], lr: float) -> None:
    """Feed the learning rate to every error-feedback stage of a chain."""
    while codec is not None:
        setter = getattr(codec, "set_lr", None)
        if setter is not None:
            setter(lr)
        codec = getattr(codec, "inner", None)
