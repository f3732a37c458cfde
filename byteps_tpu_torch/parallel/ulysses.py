"""All-to-all sequence parallelism, DeepSpeed-Ulysses style (the port of
``byteps_tpu/parallel/ulysses.py``).

Where the ring rotates key/value blocks, Ulysses re-shards once a call:

    (B, H, S/a, dh)  --all_to_all-->  (B, H/a, S, dh)
        heads sharded, the sequence gathered: each rank runs full-sequence
        flash attention on its heads (K1 forward, K2/K3 backward on the
        card), causal masking included, with no cross-block merge
    (B, H/a, S, dh)  --all_to_all-->  (B, H, S/a, dh)

Two all-to-alls of the activation a call (q, k and v stacked into one),
differentiable: their backward is the inverse all-to-all.  The local
heads must divide by the axis size.
"""

from __future__ import annotations

from typing import Optional

import torch

from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.ops.flash_attention import flash_attention


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = "sp",
    axis_size: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """q/k/v: (B, H_local, S_local, dh) with the sequence sharded over
    ``axis_name`` → the same layout."""
    if axis_size == 1 or axis_name is None:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    h_local = q.shape[1]
    if h_local % axis_size:
        raise ValueError(
            f"ulysses needs heads ({h_local}) divisible by the sp axis "
            f"({axis_size}); use ring attention for this shape"
        )
    # (3, B, H, S/a, dh): heads split, sequence gathered
    qkv = collectives.all_to_all(torch.stack((q, k, v)), axis_name, split=2, concat=3,
                                 mesh=mesh)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
    return collectives.all_to_all(out, axis_name, split=2, concat=1, mesh=mesh)
