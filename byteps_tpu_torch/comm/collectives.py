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

The axis collectives run over one named axis of the mesh (the subgroup of
this rank's line, ``Mesh.axis_group``) and are differentiable, as the
reference's ``lax`` collectives under ``shard_map`` are:

- :func:`psum` sums over the axis forward and passes the gradient through
  (Megatron's "g", the row-parallel combine); :func:`psum_grad` is the
  identity forward and sums the gradient (Megatron's "f", where an
  activation replicated over tp meets a tp-sharded weight);
- :func:`ppermute` sends point to point along ``perm``, its backward along
  the inverse permutation; :func:`send_next` / :func:`recv_prev` are the
  one-sided halves a pipeline stage posts;
- :func:`all_to_all` (tiled), its backward the inverse all-to-all;
- :func:`all_gather_axis` concatenates the axis's shards along a dim.

Paired sends and receives are posted together (``batch_isend_irecv``),
so no rank blocks on a send its peer has not matched.  An axis of size 1
is the identity, with no autograd node.

Under the staged transport (``Mesh.staged``) each collective copies its
CUDA tensors to pinned host buffers, runs gloo on them and copies the
result back.  The copy to the host waits for the current stream first,
so a collective never reads a tensor its producer kernel is still
writing; the copy back is ordered on the current stream before the
kernels that read it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.mesh import Mesh, require_mesh
from byteps_tpu_torch.common.types import divide


def _group(x: torch.Tensor, mesh: Optional[Mesh]) -> Mesh:
    """The mesh to reduce ``x`` over; a tensor on another kind of device
    than the group's backend serves raises (no CUDA tensor through gloo)."""
    mesh = mesh or require_mesh()
    want = "cuda" if mesh.transport in ("nccl", "staged") else "cpu"
    if x.device.type != want:
        raise ValueError(f"a {x.device.type} tensor on the host's {mesh.backend} group "
                         f"(bound to {mesh.device}): move it to the group's device")
    return mesh


def _wire(x: torch.Tensor, mesh: Mesh, copy: bool = True) -> torch.Tensor:
    """The buffer a collective runs on: ``x`` contiguous (a copy with
    ``copy``, for a collective that writes its buffer), in pinned host
    memory under the staged transport (taken once the current stream has
    produced ``x``)."""
    if not mesh.staged:
        return x.detach().clone() if copy else x.detach().contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def _empty(shape, like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A receive buffer of ``shape`` for the collective's result."""
    if not mesh.staged:
        return like.new_empty(shape)
    return torch.empty(shape, dtype=like.dtype, pin_memory=True)


def _land(buf: torch.Tensor, mesh: Mesh, device: torch.device) -> torch.Tensor:
    """A collective's result on ``device`` (a copy on the current stream
    under the staged transport)."""
    return buf.to(device, non_blocking=True) if mesh.staged else buf


def push_pull(
    x: torch.Tensor,
    average: bool = True,
    mode: str = "psum",
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """The sum of ``x`` over the host's group, divided by its size when
    ``average``.  ``mode="scatter_gather"`` runs the reference's two-phase
    form: reduce-scatter, then all-gather.  A process alone, with no
    process group (a ``Mesh(0, 1, ...)`` before any
    ``init_process_group``), gets a copy of ``x``."""
    mesh = _group(x, mesh)
    n = mesh.size
    if n == 1 and not dist.is_initialized():  # no group to reduce over
        return x.detach().clone()
    if mode == "scatter_gather":
        flat = _wire(x, mesh, copy=False).reshape(-1)
        pad = (-flat.numel()) % n
        padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        scat = padded.new_empty(padded.numel() // n)
        dist.reduce_scatter_tensor(scat, padded, group=mesh.group)
        red = torch.empty_like(padded)
        dist.all_gather_into_tensor(red, scat, group=mesh.group)
        red = _land(red[: flat.numel()].reshape(x.shape), mesh, x.device)
    elif mode == "psum":
        red = _wire(x, mesh)
        dist.all_reduce(red, group=mesh.group)
        red = _land(red, mesh, x.device)
    else:
        raise ValueError(f"push_pull mode {mode!r}: 'psum' or 'scatter_gather'")
    return divide(red, n) if average else red


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
    out = _empty((x.shape[0] // n, *x.shape[1:]), x, mesh)
    dist.reduce_scatter_tensor(out, _wire(x, mesh, copy=False), group=mesh.group)
    out = _land(out, mesh, x.device)
    return divide(out, n) if average else out


def all_gather(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every member's ``x`` concatenated along dim 0, in rank order (the
    BROADCAST stage, core_loops.cc:254-268)."""
    mesh = _group(x, mesh)
    out = _empty((mesh.size * x.shape[0], *x.shape[1:]), x, mesh)
    dist.all_gather_into_tensor(out, _wire(x, mesh, copy=False), group=mesh.group)
    return _land(out, mesh, x.device)


def broadcast(x: torch.Tensor, root: int = 0, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``root``'s ``x`` on every member (the primitive under
    broadcast_parameters, torch/__init__.py:268-299)."""
    mesh = _group(x, mesh)
    out = _wire(x, mesh)
    dist.broadcast(out, src=root, group=mesh.group)
    return _land(out, mesh, x.device)


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


# --- axis collectives -----------------------------------------------------


def _axis(axis: str, mesh: Optional[Mesh]) -> Tuple[Mesh, int]:
    mesh = mesh or require_mesh()
    return mesh, mesh.axis_size(axis)


def all_reduce_axis(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of this rank's ``axis`` line (no
    autograd); ``x`` itself on an axis of size 1."""
    mesh, n = _axis(axis, mesh)
    if n == 1:
        return x
    _group(x, mesh)
    red = _wire(x, mesh)
    dist.all_reduce(red, group=mesh.axis_group(axis))
    return _land(red, mesh, x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce_axis(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axis(g.contiguous(), ctx.axis, ctx.mesh), None, None


def psum(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over ``axis``; the gradient passes through unchanged (each rank
    holds the whole sum, so its cotangent is already the sum's)."""
    mesh, n = _axis(axis, mesh)
    return x if n == 1 else _Psum.apply(x, axis, mesh)


def psum_grad(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The identity; the gradient is summed over ``axis`` (each rank's
    cotangent covers only its shard of what consumed ``x``)."""
    mesh, n = _axis(axis, mesh)
    return x if n == 1 else _PsumGrad.apply(x, axis, mesh)


def _exchange(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """Post every send and receive (global peer ranks) at once, then wait."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
              mesh: Mesh) -> torch.Tensor:
    ranks, me = mesh.axis_ranks(axis), mesh.axis_index(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    sends = [(_wire(x, mesh, copy=False), ranks[d]) for d in dst]
    if not src:
        for t, peer in sends:
            _exchange([(t, peer)], [], mesh.axis_group(axis))
        return torch.zeros_like(x)
    buf = _empty(x.shape, x, mesh)
    _exchange(sends, [(buf, ranks[src[0]])], mesh.axis_group(axis))
    return _land(buf, mesh, x.device)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _ppermute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g.contiguous(), ctx.axis, inverse, ctx.mesh), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.ppermute``: the rank at axis index ``s`` sends ``x`` to ``d``
    for each ``(s, d)`` of ``perm``; a rank no one sends to gets zeros.
    Every rank of the axis posts its sends and its receive together."""
    mesh, n = _axis(axis, mesh)
    if n == 1:
        return x
    return _Ppermute.apply(x, axis, [tuple(p) for p in perm], mesh)


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, mesh):
        ctx.axis, ctx.mesh, ctx.shape = axis, mesh, y.shape
        ctx.next = mesh.axis_ranks(axis)[mesh.axis_index(axis) + 1]
        _exchange([(_wire(y, mesh, copy=False), ctx.next)], [], mesh.axis_group(axis))
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        buf = _empty(ctx.shape, g, ctx.mesh)
        _exchange([], [(buf, ctx.next)], ctx.mesh.axis_group(ctx.axis))
        return _land(buf, ctx.mesh, g.device), None, None


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, like, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        ctx.prev = mesh.axis_ranks(axis)[mesh.axis_index(axis) - 1]
        buf = _empty(like.shape, like, mesh)
        _exchange([], [(buf, ctx.prev)], mesh.axis_group(axis))
        return _land(buf, mesh, like.device)

    @staticmethod
    def backward(ctx, g):
        _exchange([(_wire(g, ctx.mesh, copy=False), ctx.prev)], [],
                  ctx.mesh.axis_group(ctx.axis))
        return None, None, None, None


def send_next(y: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Send ``y`` to the next rank of ``axis`` (a pipeline stage's output).
    Returns a zero scalar to add to the loss: its backward receives the
    next rank's cotangent of ``y``."""
    mesh = mesh or require_mesh()
    return _SendNext.apply(y, axis, mesh)


def recv_prev(like: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Receive a tensor shaped as ``like`` from the previous rank of
    ``axis``; its backward sends the cotangent back."""
    mesh = mesh or require_mesh()
    anchor = torch.zeros((), device=like.device, requires_grad=True)
    return _RecvPrev.apply(anchor, like, axis, mesh)


def _all_to_all(x: torch.Tensor, axis: str, split: int, concat: int,
                mesh: Mesh) -> torch.Tensor:
    n = mesh.axis_size(axis)
    chunks = torch.stack(x.chunk(n, dim=split))  # (n, ...): chunk j goes to rank j
    got = _empty(chunks.shape, chunks, mesh)
    dist.all_to_all_single(got, _wire(chunks, mesh, copy=False), group=mesh.axis_group(axis))
    got = _land(got, mesh, x.device)
    return torch.cat(got.unbind(0), dim=concat)  # rank i's chunk i-th along concat


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat, mesh):
        ctx.args = (axis, split, concat, mesh)
        return _all_to_all(x, axis, split, concat, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, split, concat, mesh = ctx.args
        return _all_to_all(g, axis, concat, split, mesh), None, None, None, None


def all_to_all(x: torch.Tensor, axis: str, split: int, concat: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` split in axis-size chunks
    along ``split``, chunk j sent to the axis's rank j, the chunks
    received concatenated along ``concat`` in rank order."""
    mesh, n = _axis(axis, mesh)
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} does not divide by "
                         f"the {axis} axis's {n} ranks")
    return _AllToAll.apply(x, axis, split, concat, mesh)


def all_gather_axis(x: torch.Tensor, axis: str, dim: int = 0,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The shards of the ranks of ``axis``, concatenated along ``dim`` in
    axis order (no autograd)."""
    mesh, n = _axis(axis, mesh)
    if n == 1:
        return x
    _group(x, mesh)
    src = _wire(x, mesh, copy=False)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.axis_group(axis))
    return _land(torch.cat(parts, dim=dim), mesh, x.device)


def stack_stages(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> torch.Tensor:
    """A pipeline stage's per-layer tensors stacked, and the stages' stacks
    gathered over pp: ``(pp, layers a stage, ...)``, stage i's at row i, on
    every rank (no autograd): the reference's stacked layer layout."""
    mine = torch.stack([t.detach() for t in tensors]).contiguous()
    pp = mesh.axis_size("pp") if mesh is not None else 1
    out = mine if pp == 1 else all_gather_axis(mine, "pp", 0, mesh)
    return out.reshape((pp,) + tuple(mine.shape))


def sync_grads(params: Mapping[str, torch.Tensor], axes_of: Mapping[str, Sequence[str]],
               mesh: Mesh) -> None:
    """Sum each parameter's gradient over the axes ``axes_of`` lists for
    it, tp left out and axes of size 1 skipped: one flattened all-reduce
    per set of axes and axis.  A missing gradient counts as zeros."""
    buckets: Dict[Tuple[str, ...], list] = {}
    for name, p in params.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        axes = tuple(ax for ax in axes_of[name] if ax != "tp" and mesh.axis_size(ax) > 1)
        if axes:
            buckets.setdefault(axes, []).append(p)
    for axes, group in buckets.items():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        for ax in axes:
            flat = all_reduce_axis(flat, ax, mesh)
        off = 0
        for p in group:
            p.grad.copy_(flat[off: off + p.numel()].view_as(p.grad))
            off += p.numel()
