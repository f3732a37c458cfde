"""Checkpoint and resume (``byteps_tpu.checkpoint`` in torch idiom).

As in the reference, the framework keeps the state and this module adds
the BytePS-style wrappers around it:

- :func:`save` / :func:`restore` write and read torch state: a model's or
  an optimizer's ``state_dict``, or any nested dict of tensors, through
  ``torch.save`` / ``torch.load`` (tensors only, ``weights_only``).  The
  reference stores orbax checkpoints; that format is not reproduced here,
  so a checkpoint of one package is not read by the other.
- :func:`restore_and_broadcast`: only the root worker reads; every other
  worker starts from zeros and receives the values through
  ``broadcast_parameters`` (the zero-then-push_pull broadcast).
- :func:`broadcast_optimizer_state` is the API's own
  (``byteps_tpu_torch.api``), re-exported.
- :func:`write_shard` / :func:`read_shard`: byte shards in the wire's
  lossless container with a CRC32C trailer, written with ``fsync`` and an
  atomic rename, byte for byte the reference's files.  A short, truncated
  or bit-flipped shard fails closed (``LosslessError``, a ValueError).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional

import torch

from byteps_tpu_torch.api import broadcast_optimizer_state, broadcast_parameters, rank
from byteps_tpu_torch.comm.transport import crc32c
from byteps_tpu_torch.compression.lossless import LosslessError, compress_frame, decompress_frame

__all__ = ["save", "restore", "write_shard", "read_shard", "restore_and_broadcast",
           "broadcast_optimizer_state"]


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree: Any, force: bool = True) -> None:
    """Save ``tree`` (a state dict, or a nested dict of tensors) to
    ``path``.  An existing file is replaced only with ``force``."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (pass force=True to replace it)")
    _atomic_write(path, lambda f: torch.save(tree, f))


def _like(value: Any, template: Any) -> Any:
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != template.shape:
            raise ValueError(f"restored {getattr(value, 'shape', type(value))} where the "
                             f"template has {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if set(value) != set(template):
            raise ValueError(f"restored keys {sorted(map(str, value))} differ from the "
                             f"template's {sorted(map(str, template))}")
        return {k: _like(value[k], t) for k, t in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, t) for v, t in zip(value, template))
    return value


def restore(path: str, template: Optional[Any] = None) -> Any:
    """Read a :func:`save` file onto the CPU; with ``template`` (the same
    structure) each tensor takes the template's device and dtype."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return tree if template is None else _like(tree, template)


def write_shard(path: str, data: bytes) -> int:
    """Write one byte shard: the lossless container of ``data``, then the
    CRC32C of the container (4 bytes, big-endian); ``fsync``, then an
    atomic rename, so that a crash never leaves a torn shard.  Returns the
    bytes written."""
    blob = compress_frame(bytes(data))
    blob += struct.pack("!I", crc32c(blob))
    _atomic_write(path, lambda f: f.write(blob))
    return len(blob)


def read_shard(path: str) -> bytes:
    """Read a :func:`write_shard` file, failing closed: a file shorter than
    its trailer, a CRC mismatch or a corrupt container raises
    ``LosslessError``."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 4:
        raise LosslessError("shard file shorter than its CRC trailer")
    body, (want,) = blob[:-4], struct.unpack("!I", blob[-4:])
    if crc32c(body) != want:
        raise LosslessError("shard CRC32C mismatch")
    return decompress_frame(body)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Each tensor under the reference's name for its path (``['a']/['b']``,
    as jax's key paths print), in jax's order (sorted keys): the workers of
    a broadcast declare the same names in the same order, so the same keys."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sorted(tree.items()):
        name = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        elif isinstance(v, torch.Tensor):
            out[name] = v
        else:
            raise TypeError(f"restore_and_broadcast: {name} is a {type(v).__name__}, "
                            f"not a tensor")
    return out


def _zeros(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def restore_and_broadcast(path: str, template: Dict[str, Any], root_rank: int = 0) -> Dict[str, Any]:
    """Multi-worker restore of a nested dict of tensors: worker
    ``root_rank`` reads ``path`` into ``template``'s devices and dtypes,
    every other worker starts from zeros of the template and receives the
    values through ``broadcast_parameters``, under the reference's names
    (a worker of either package may take part).  Every worker passes a
    template of the same structure."""
    tree = restore(path, template) if rank() == root_rank else _zeros(template)
    broadcast_parameters(_flatten(tree), root_rank=root_rank)
    return tree
