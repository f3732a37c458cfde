"""Intra-host collectives over the host's process group: the NCCL layer.

The reference BytePS reduces inside the machine with ncclReduceScatter +
ncclAllGather (core_loops.cc:190-317); ``byteps_tpu`` does it with
``lax.psum_scatter`` + ``lax.all_gather`` over a mesh axis
(``byteps_tpu/comm/collectives.py``).  The port calls ``torch.distributed``
on the host's group (``comm.mesh``): NCCL for CUDA tensors, gloo for CPU
tensors.  Each process's tensor stands for the reference's per-member
value, and every function returns a new tensor, as the reference's do.

- :func:`push_pull`: all-reduce, ``"psum"`` (one all-reduce) or
  ``"scatter_gather"`` (flatten, pad to a multiple of the group size,
  reduce-scatter, all-gather, unpad);
- :func:`reduce_scatter` (each member keeps 1/N of the sum along dim 0),
  :func:`all_gather` (along dim 0) and :func:`broadcast`;
- :func:`push_pull_tree`: a list or dict of tensors reduced as one
  flattened bucket, the counterpart of ``jit_push_pull_tree``.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.mesh import Mesh, require_mesh


def _group(x: torch.Tensor, mesh: Optional[Mesh]) -> Mesh:
    """The mesh to reduce ``x`` over; a tensor on another kind of device
    than the group's backend serves raises (no CUDA tensor through gloo)."""
    mesh = mesh or require_mesh()
    want = "cuda" if mesh.backend == "nccl" else "cpu"
    if x.device.type != want:
        raise ValueError(f"a {x.device.type} tensor on the host's {mesh.backend} group "
                         f"(bound to {mesh.device}): move it to the group's device")
    return mesh


def push_pull(
    x: torch.Tensor,
    average: bool = True,
    mode: str = "psum",
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """The sum of ``x`` over the host's group, divided by its size when
    ``average``.  ``mode="scatter_gather"`` runs the reference's two-phase
    form: reduce-scatter, then all-gather."""
    mesh = _group(x, mesh)
    n = mesh.size
    if mode == "scatter_gather":
        flat = x.detach().reshape(-1)
        pad = (-flat.numel()) % n
        padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.contiguous()
        scat = padded.new_empty(padded.numel() // n)
        dist.reduce_scatter_tensor(scat, padded, group=mesh.group)
        red = torch.empty_like(padded)
        dist.all_gather_into_tensor(red, scat, group=mesh.group)
        red = red[: flat.numel()].reshape(x.shape)
    elif mode == "psum":
        red = x.detach().clone()
        dist.all_reduce(red, group=mesh.group)
    else:
        raise ValueError(f"push_pull mode {mode!r}: 'psum' or 'scatter_gather'")
    return red / n if average else red


def reduce_scatter(x: torch.Tensor, average: bool = True,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Each member keeps its 1/N slice along dim 0 of the summed tensor
    (the reference's REDUCE stage before PUSH, core_loops.cc:232-253).
    Dim 0 must divide by the group size."""
    mesh = _group(x, mesh)
    n = mesh.size
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does not divide "
                         f"by the group's {n} members")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.detach().contiguous(), group=mesh.group)
    return out / n if average else out


def all_gather(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along dim 0, in rank order (the
    BROADCAST stage, core_loops.cc:254-268)."""
    mesh = _group(x, mesh)
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=mesh.group)
    return out


def broadcast(x: torch.Tensor, root: int = 0, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``root``'s ``x`` on every member (the primitive under
    broadcast_parameters, torch/__init__.py:268-299)."""
    mesh = _group(x, mesh)
    out = x.detach().clone()
    dist.broadcast(out, src=root, group=mesh.group)
    return out


def push_pull_tree(grads: Any, average: bool = True, mesh: Optional[Mesh] = None) -> Any:
    """push_pull of every tensor of a list, tuple or dict, as one flattened
    bucket: one all-reduce in the tensors' promoted dtype, split back into
    the container, each tensor in its own shape and dtype."""
    is_dict = isinstance(grads, dict)
    items = list(grads.values()) if is_dict else list(grads)
    if not items:
        return grads
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in items))
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in items])
    red = push_pull(flat, average=average, mesh=mesh)
    out, off = [], 0
    for t in items:
        out.append(red[off: off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return dict(zip(grads.keys(), out)) if is_dict else type(grads)(out)
