"""Flash attention: hand-written CUDA kernels for Hopper, with their plain
PyTorch versions beside them.

Three kernels in ``csrc/flash_attention.cu`` replace the Pallas kernels of
``byteps_tpu/ops/flash_attention.py``:

- ``flash_fwd`` replaces ``_fwd_kernel_factory``: blocked online-softmax
  attention that returns O and the per-row logsumexp (lse);
- ``flash_bwd_dq`` replaces ``_bwd_dq_kernel_factory``: recomputes
  P = exp(QKᵀ·scale − lse) block by block and accumulates dQ;
- ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel_factory``: the same P,
  accumulated into dK and dV over the query blocks.

bf16 inputs (the training path) run their products on the tensor cores
with f32 accumulators.  For dh = 64, the head dim of the models the port
supports, all three kernels are built for Hopper: ``wgmma`` fed by TMA
copies under mbarriers.  The forward and dK/dV have a producer warpgroup
and two consumer warpgroups on a persistent grid; dQ has two warpgroups
and a ring of K/V tiles that one thread fills, two blocks an SM.  The
forward keeps its scores, probabilities and output in registers; dQ keeps
S, dP and dS in registers, dS as the A operand of dQ += dS·K; dK/dV
computes the scores transposed, so that Pᵀ and dSᵀ stay in registers as
the A operand of dV += Pᵀ·dO and dK += dSᵀ·Q.  For dh = 32 and 128 the
three use WMMA tiles.  f32 inputs
run all three on the f32 FMA units, which hold the f32 tolerance that
TF32 or bf16 tiles would not.  What bounds each on the H100, and what the
design does about it, is noted at the top of the CUDA source; no S×S
intermediate reaches device memory.

Dispatch is by where the tensors lie: a CPU tensor takes the plain version
(one (S, S) score matrix, :func:`_dense_reference_lse`, and the matching
dense backward); a CUDA tensor launches the kernel or raises.  There is no
fallback from one to the other.  Δ = rowsum(dO∘O) − dlse is computed with
torch ops outside the kernels, as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from byteps_tpu_torch.ops._build import load_library

NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launches`; each wrapper adds
#: one where it launches its kernel and nowhere else
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _dense_reference_lse(q, k, v, causal: bool, scale: float):
    """Dense (out, lse) from ONE (S, S) score matrix."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-1], s.device), NEG_INF)
    s32 = s.float()
    lse = torch.logsumexp(s32, dim=-1)
    p = torch.exp(s32 - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v), lse


def _plain_probs_and_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P = exp(QKᵀ·scale − lse) (masked) and dS = P∘(dO·Vᵀ − Δ), in f32."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(p.shape[-1], p.device), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    return p, p * (dp - delta[..., None])


def _plain_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """What the dQ kernel computes, densely and in f32."""
    _, ds = _plain_probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(q.dtype)


def _plain_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """What the dK/dV kernel computes, densely and in f32."""
    p, ds = _plain_probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = load_library("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bps_flash_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
        lib.bps_flash_bwd_dq.argtypes = [p] * 7 + [i] * 5 + [f, p]
        lib.bps_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + [f, p]
        for fn in (lib.bps_flash_fwd, lib.bps_flash_bwd_dq, lib.bps_flash_bwd_dkv):
            fn.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_kernel_inputs(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Validate (B, H, S, dh) inputs for the kernels; return them
    contiguous.  Raises on anything the kernels do not take."""
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(
            f"flash attention kernels need CUDA tensors, got {q.device}"
        )
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, S, dh) tensors, got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds 65535")
    for x in xs[1:]:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"q/k/v/dO must agree: {tuple(x.shape)} {x.dtype} {x.device} "
                f"vs {tuple(q.shape)} {q.dtype} {q.device}"
            )
    # the kernels load 16 bytes a thread: a view that starts off that
    # alignment is copied
    return tuple(_aligned(x.contiguous()) for x in xs)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Forward kernel wrapper: (O, lse), lse (B, H, S) float32."""
    if q.device.type == "cpu":
        return _dense_reference_lse(q, k, v, causal, scale)
    q, k, v = _check_kernel_inputs(q, k, v)
    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.bps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, s, dh, _DTYPE_CODES[q.dtype], int(causal), scale, _stream(),
        )
    _raise_on(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def _row_stats(q, lse, delta):
    b, h, s, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, s) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be ({b}, {h}, {s}) float32 on {q.device}")
    # the dK/dV kernel reads them through TMA maps, whose base must be
    # 16-byte aligned
    return _aligned(lse.contiguous()), _aligned(delta.contiguous())


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel wrapper; ``delta`` is Δ = rowsum(dO∘O) − dlse."""
    if q.device.type == "cpu":
        return _plain_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do = _check_kernel_inputs(q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    b, h, s, dh = q.shape
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.bps_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b * h, s, dh, _DTYPE_CODES[q.dtype], int(causal), scale, _stream(),
        )
    _raise_on(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel wrapper; ``delta`` is Δ = rowsum(dO∘O) − dlse."""
    if q.device.type == "cpu":
        return _plain_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do = _check_kernel_inputs(q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    b, h, s, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.bps_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, s, dh, _DTYPE_CODES[q.dtype], int(causal), scale, _stream(),
        )
    _raise_on(err, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # an lse cotangent folds exactly into Δ: dS = P∘(dP − Δ + dlse),
        # so the kernels run unchanged on Δ' = Δ − dlse
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the per-row logsumexp
    ``(B, H, S)`` in float32.  Differentiable in (q, k, v), including
    through the lse output."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q/k/v: (B, H, S, dh) → (B, H, S, dh)."""
    return flash_attention_lse(q, k, v, causal, scale)[0]
