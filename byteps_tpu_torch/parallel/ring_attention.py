"""Ring attention: sequence parallelism over the mesh's sp axis (the port
of ``byteps_tpu/parallel/ring_attention.py``).

The sequence is sharded into contiguous blocks along the axis; queries
stay local while the key/value blocks rotate around the ring, one
``ppermute`` a hop (k and v stacked, so a hop is one exchange), and each
hop's attention merges into the running result exactly.  A causal ring
picks each hop's work by ring distance: a block from upstream is fully
visible, the rank's own block takes the diagonal mask, and a block from
downstream is skipped (it still rotates on).

- :func:`ring_attention` computes each hop densely, (m, l, o) online
  softmax state as the reference's;
- :func:`ring_flash_attention` runs each hop through the port's flash
  attention (K1 forward and K2/K3 backward on the card, the plain versions
  on the CPU) and merges (o, lse) by the logsumexp rule; the lse
  cotangent folds into Δ in the flash backward.

Both are differentiable through autograd: the ``ppermute``'s backward is
the reverse ring, which carries dK and dV back to their owners.  Every
rank of the ring posts the same exchanges in the same order, forward and
backward, whatever it skips: a skipped block still takes a zero
cotangent, so its rotation's backward runs on every rank (a checkpointed
layer recomputes all of its forward for the same reason,
``models.transformer``).  With ``axis_size == 1`` (or no axis) they are single-device
attention.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_attend(q, k, v, bias):
    """One block pair: (row max, exp sums, weighted v)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhqk,bhkd->bhqd", p, v)


class _Skipped(torch.autograd.Function):
    """``acc`` unchanged, with a zero cotangent for the skipped block
    ``kv``: a causal rank that skips a hop still runs the backward of the
    rotation that brought the block, as every other rank of the ring does."""

    @staticmethod
    def forward(ctx, acc, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring(axis_name: str, axis_size: int, mesh):
    from byteps_tpu_torch.comm import collectives
    from byteps_tpu_torch.comm.mesh import require_mesh

    mesh = mesh or require_mesh()
    if mesh.axis_size(axis_name) != axis_size:
        raise ValueError(f"axis_size {axis_size} but the mesh's {axis_name} axis has "
                         f"{mesh.axis_size(axis_name)} ranks")
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]

    def rotate(kv):
        return collectives.ppermute(kv, axis_name, perm, mesh)

    return mesh.axis_index(axis_name), rotate


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = "sp",
    axis_size: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """q/k/v: (B, H, S_local, dh), the local sequence block → (B, H,
    S_local, dh)."""
    s_local = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q = q * scale
    idx = torch.arange(s_local, device=q.device)
    diag_bias = torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_INF)
    if axis_size == 1 or axis_name is None:
        if causal:
            bias = diag_bias
        else:
            bias = torch.zeros((s_local, s_local), device=q.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias.to(q.dtype)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1, keepdim=True)
        return torch.einsum("bhqk,bhkd->bhqd", p, v) / l

    me, rotate = _ring(axis_name, axis_size, mesh)
    zero_bias = torch.zeros((s_local, s_local), device=q.device)
    m_acc = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l_acc = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for t in range(axis_size):
        src = (me - t) % axis_size  # the block held now started t hops upstream
        if not causal or src <= me:
            bias = (diag_bias if src == me else zero_bias) if causal else zero_bias
            m_t, l_t, pv_t = _block_attend(q, kv[0], kv[1], bias)
            m_new = torch.maximum(m_acc, m_t)
            a, b = torch.exp(m_acc - m_new), torch.exp(m_t - m_new)
            l_acc = l_acc * a + l_t * b
            o_acc = o_acc * a[..., None] + pv_t * b[..., None]
            m_acc = m_new
        elif kv.requires_grad:
            o_acc = _Skipped.apply(o_acc, kv)
        if t < axis_size - 1:
            kv = rotate(kv)
    l_acc = torch.where(l_acc == 0, torch.ones_like(l_acc), l_acc)
    return (o_acc / l_acc[..., None]).to(q.dtype)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: Optional[str] = "sp",
    axis_size: int = 1,
    causal: bool = True,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """Ring attention whose hops are flash attention: O(block) memory a
    hop instead of the (S_local, S_local) score matrix.  q/k/v: (B, H,
    S_local, dh) → (B, H, S_local, dh)."""
    from byteps_tpu_torch.ops.flash_attention import flash_attention_lse

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if axis_size == 1 or axis_name is None:
        return flash_attention_lse(q, k, v, causal=causal, scale=scale)[0]

    me, rotate = _ring(axis_name, axis_size, mesh)
    L_acc = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for t in range(axis_size):
        src = (me - t) % axis_size
        if not causal or src <= me:
            # the own block takes the diagonal mask, an upstream one is full
            o_t, lse_t = flash_attention_lse(q, kv[0], kv[1], causal=causal and src == me,
                                             scale=scale)
            L_new = torch.logaddexp(L_acc, lse_t)
            o_acc = (o_acc * torch.exp(L_acc - L_new)[..., None]
                     + o_t.float() * torch.exp(lse_t - L_new)[..., None])
            L_acc = L_new
        elif kv.requires_grad:
            o_acc = _Skipped.apply(o_acc, kv)
        if t < axis_size - 1:
            kv = rotate(kv)
    return o_acc.to(q.dtype)
