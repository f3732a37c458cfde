"""Expert parallelism: top-k routed mixture-of-experts with all-to-all
dispatch (the port of ``byteps_tpu/parallel/moe.py``).

The same function as the reference's: top-1 (Switch) or top-2 (GShard,
gates renormalized) routing, per-expert queues of ``capacity`` slots where
the tokens of a later choice queue after every assignment of an earlier
one, overflow dropped, and the experts sharded over a mesh axis (``sp`` in
the training mesh), tokens travelling to their expert's rank through a
tiled all-to-all and back.

The reference builds dense (T, E, C) one-hot dispatch and combine tensors
and contracts them with einsums, which XLA wants for static shapes.  Here
dispatch and combine work by index: every kept (token, choice) pair has
one slot ``e * C + c`` of the (E, C, D) expert input, scattered in and
gathered back, O(T·k) memory instead of O(T·E·C).  The routing is the
reference's bit for bit: the same argmax (the first maximum), the same
float32 queue positions and the same drops.

:func:`count_drops` collects the number of dropped assignments of each
call made inside it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F

from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import Mesh

_drops: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops() -> Iterator[List[torch.Tensor]]:
    """Within the block every :func:`moe_mlp` call appends the number of
    its (token, choice) assignments that overflowed their expert's queue,
    a 0-d tensor on the tokens' device, to the list it yields."""
    global _drops
    prev, _drops = _drops, []
    try:
        yield _drops
    finally:
        _drops = prev


def capacity_of(capacity_factor: float, top_k: int, t: int, e_total: int) -> int:
    """Slots per expert: scaled by k (each token takes k queues), never
    beyond t (a token picks an expert at most once)."""
    return max(1, min(int(capacity_factor * top_k * t / e_total), t))


def route(gates: torch.Tensor, top_k: int, capacity: int):
    """The reference's routing of (T, E) gates: for each choice i, the
    (T,) expert, queue position and gate weight (in the gates' dtype),
    and whether the assignment fits (position < capacity).  Positions
    are float32 cumsums, as the reference's: a bf16 cumsum is only exact
    to 256."""
    e_total = gates.shape[-1]
    experts, gate_vals = [], []
    remaining = gates
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        oh = F.one_hot(idx, e_total).to(gates.dtype)
        experts.append(idx)
        gate_vals.append(gates.gather(-1, idx[:, None])[:, 0])
        remaining = remaining * (1.0 - oh)
    if top_k > 1:
        denom = sum(gate_vals) + 1e-9  # GShard: the k gates sum to 1
        weights = [gv / denom for gv in gate_vals]
    else:
        weights = gate_vals
    slots, keeps = [], []
    prev_counts = torch.zeros(e_total, dtype=torch.float32, device=gates.device)
    for idx in experts:
        oh = F.one_hot(idx, e_total).float()
        pos = (torch.cumsum(oh, dim=0) - 1.0) * oh + prev_counts[None, :] * oh
        slot = pos.sum(-1)
        slots.append(slot.long())
        keeps.append(slot < capacity)
        prev_counts = prev_counts + oh.sum(0)
    return experts, slots, weights, keeps


def moe_mlp(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    axis_name: Optional[str],
    axis_size: int,
    capacity_factor: float = 2.0,
    top_k: int = 1,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Top-k routed expert MLP (k=1 Switch, k=2 GShard).

    x: (T, D) local tokens; router_w: (D, E) global router; w1 (E_local,
    D, F), b1 (E_local, F), w2 (E_local, F, D), b2 (E_local, D), where E =
    axis_size * E_local and expert e lives on rank e // E_local of
    ``axis_name``.  Returns (T, D)."""
    t, d = x.shape
    e_local = w1.shape[0]
    e_total = e_local * max(1, axis_size)
    top_k = max(1, min(top_k, e_total))
    gates = torch.softmax(x @ router_w, dim=-1)
    capacity = capacity_of(capacity_factor, top_k, t, e_total)
    experts, slots, weights, keeps = route(gates, top_k, capacity)

    tok = torch.arange(t, device=x.device).repeat(top_k)
    flat = torch.cat([e * capacity + s for e, s in zip(experts, slots)])
    keep = torch.cat(keeps)
    # combine weights in x's dtype, as the reference casts them
    wv = torch.cat(weights).to(x.dtype)
    tok, flat, wv = tok[keep], flat[keep], wv[keep]
    if _drops is not None:
        _drops.append(top_k * t - keep.sum())

    # each kept assignment owns one slot of the (E, C, D) expert input
    expert_in = x.new_zeros(e_total * capacity, d).index_copy(0, flat, x[tok])
    expert_in = expert_in.view(e_total, capacity, d)
    if axis_name is not None and axis_size > 1:
        # (E, C, D) -> (E_local, n·C, D): our experts' slots from every rank
        expert_in = collectives.all_to_all(expert_in, axis_name, 0, 1, mesh)
    h = F.gelu(torch.bmm(expert_in, w1) + b1[:, None, :], approximate="tanh")
    out = torch.bmm(h, w2) + b2[:, None, :]
    if axis_name is not None and axis_size > 1:
        out = collectives.all_to_all(out, axis_name, 1, 0, mesh)  # the inverse route
    out = out.reshape(e_total * capacity, d)
    # each token's gate-weighted expert outputs back at its row
    return x.new_zeros(t, d).index_add(0, tok, out[flat] * wv[:, None])


def moe_aux_loss(x: torch.Tensor, router_w: torch.Tensor, axis_size: int,
                 e_local: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch): E · mean(mean(gates) ·
    mean(top-1 mask))."""
    e_total = e_local * max(1, axis_size)
    gates = torch.softmax(x @ router_w, dim=-1)
    mask = F.one_hot(torch.argmax(gates, dim=-1), e_total).to(x.dtype)
    return e_total * torch.mean(gates.mean(0) * mask.mean(0))
