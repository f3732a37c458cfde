"""Dense attention on one device: the ``axis_size == 1`` branch of
``byteps_tpu.parallel.ring_attention``, which the transformer takes when
``use_flash`` is off.  Sequence parallelism (axis size > 1) is a later
slice of the port and raises."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = None,
    axis_size: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q/k/v: (B, H, S, dh) → (B, H, S, dh)."""
    if axis_size != 1 and axis_name is not None:
        raise NotImplementedError(
            "sequence parallelism (axis_size > 1) is a later slice of the "
            "port, ROADMAP.md Queue 1 item 9"
        )
    s_local = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q = q * scale
    idx = torch.arange(s_local, device=q.device)
    if causal:
        bias = torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_INF)
    else:
        bias = torch.zeros((s_local, s_local), device=q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias.to(q.dtype)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v) / l
