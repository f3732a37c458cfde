"""Flagship transformer family (BERT-large, GPT-2 medium) on one device.

The port of ``byteps_tpu.models.transformer`` for dp = pp = sp = tp = 1:
the same configs, the same numpy parameter draws (:func:`init_params`),
the same layer math and the same loss, as an ``nn.Module`` plus a train
step function.  Parameters live in float32; activations are cast to
``compute_dtype`` where the JAX code casts them (``.astype(cdt)``), so the
residual stream runs in compute dtype after the embedding.  With
``use_flash`` the attention is the port's flash attention (CUDA kernels on
the card); otherwise the dense single-device attention.

Model parallelism (pp/sp/tp/ep), mixture-of-experts layers and the
generation helpers are later slices of the port and raise here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from byteps_tpu_torch.ops.flash_attention import flash_attention
from byteps_tpu_torch.parallel.ring_attention import ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    n_heads: int = 16
    # grouped-query attention: K/V heads (None = n_heads, classic MHA)
    n_kv_heads: Optional[int] = None
    d_head: int = 64
    d_ff: int = 4096
    n_layers: int = 24
    max_seq: int = 512
    causal: bool = False  # BERT-style bidirectional by default
    moe: bool = False
    compute_dtype: torch.dtype = torch.float32
    # recompute each layer in the backward pass (activation checkpointing)
    remat: bool = True
    # attention through the flash-attention kernels instead of the dense
    # (S, S) score matrix
    use_flash: bool = False
    attn_bias: bool = False
    pos_emb: str = "learned"  # "learned" absolute table or "rope"
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.n_kv_heads} (query heads share KV groups evenly)"
            )
        if self.pos_emb not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_emb {self.pos_emb!r}; expected 'learned' or 'rope'"
            )
        if self.pos_emb == "rope" and self.d_head % 2:
            raise ValueError(f"rope needs an even d_head, got {self.d_head}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def bert_large(**kw) -> TransformerConfig:
    """BERT-large: 24 layers, d_model 1024, 16 heads, d_ff 4096."""
    return TransformerConfig(
        vocab_size=30528, d_model=1024, n_heads=16, d_head=64, d_ff=4096,
        n_layers=24, causal=False, **kw,
    )


def gpt2_medium(**kw) -> TransformerConfig:
    """GPT-2 medium: 24 layers, d_model 1024, causal."""
    return TransformerConfig(
        vocab_size=50257, d_model=1024, n_heads=16, d_head=64, d_ff=4096,
        n_layers=24, causal=True, **kw,
    )


def tiny_test(**kw) -> TransformerConfig:
    kw.setdefault("vocab_size", 64)
    kw.setdefault("d_model", 16)
    kw.setdefault("n_heads", 4)
    kw.setdefault("d_head", 4)
    kw.setdefault("d_ff", 32)
    kw.setdefault("n_layers", 4)
    kw.setdefault("max_seq", 16)
    return TransformerConfig(**kw)


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            "mixture-of-experts layers are a later slice of the port "
            "(ROADMAP.md Queue 1 item 9)"
        )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """name → per-layer (or global) shape, in the JAX package's order: the
    order :func:`init_params` draws in."""
    _require_dense(cfg)
    D, H, dh, F_, KV = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff, cfg.kv_heads
    shapes: Dict[str, Tuple[int, ...]] = {"embed": (cfg.vocab_size, D)}
    if cfg.pos_emb == "learned":
        shapes["pos"] = (cfg.max_seq, D)
    shapes.update({
        "ln_f_s": (D,), "ln_f_b": (D,), "head": (D, cfg.vocab_size),
        "ln1_s": (D,), "ln1_b": (D,), "ln2_s": (D,), "ln2_b": (D,),
        "wq": (D, H, dh), "wk": (D, KV, dh), "wv": (D, KV, dh), "wo": (H, dh, D),
    })
    if cfg.attn_bias:
        shapes.update({"wq_b": (H, dh), "wk_b": (KV, dh), "wv_b": (KV, dh), "wo_b": (D,)})
    shapes.update({"w1": (D, F_), "b1": (F_,), "w2": (F_, D), "b2": (D,)})
    return shapes


_LAYER_PARAMS_PREFIXES = ("ln1_", "ln2_", "wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2")


def is_layer_param(name: str) -> bool:
    return name.startswith(_LAYER_PARAMS_PREFIXES)


def init_params(
    cfg: TransformerConfig, seed: int = 0, pp_size: int = 1
) -> Dict[str, np.ndarray]:
    """Host-side init (numpy, float32), draw for draw the JAX package's:
    layer params get leading dims (pp, layers_per_stage)."""
    if cfg.n_layers % pp_size:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp_size}")
    lps = cfg.n_layers // pp_size
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for name, shape in param_shapes(cfg).items():
        full = (pp_size, lps) + shape if is_layer_param(name) else shape
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 0.02 if name in ("embed", "pos") else 1.0 / math.sqrt(fan_in)
        if name.endswith("_s"):  # layernorm scales
            arr = np.ones(full, dtype=np.float32)
        elif name.endswith("_b") or name.startswith("b"):
            arr = np.zeros(full, dtype=np.float32)
        else:
            arr = rng.normal(0.0, std, size=full).astype(np.float32)
        params[name] = arr
    return params


# ---------------------------------------------------------------------------
# layer math
# ---------------------------------------------------------------------------


def _ln(x, s, b, eps: float = 1e-5):
    """Layer norm with the population variance, as the JAX package's."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _rope(x, positions, theta: float):
    """Rotary position embedding (rotate-half convention) at absolute
    ``positions``; x: (B, H, S, dh)."""
    half = x.shape[-1] // 2
    freqs = torch.tensor(theta, dtype=torch.float32, device=x.device) ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, None], torch.sin(ang)[None, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _qkv_proj(cfg: TransformerConfig, h, lp, positions=None):
    cdt = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bhsk", h, lp.wq.to(cdt))
    k = torch.einsum("bsd,dhk->bhsk", h, lp.wk.to(cdt))
    v = torch.einsum("bsd,dhk->bhsk", h, lp.wv.to(cdt))
    if cfg.attn_bias:
        q = q + lp.wq_b.to(cdt)[None, :, None, :]
        k = k + lp.wk_b.to(cdt)[None, :, None, :]
        v = v + lp.wv_b.to(cdt)[None, :, None, :]
    if cfg.pos_emb == "rope":
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, v, n_q_heads: int):
    """Expand grouped K/V heads to the query head count (GQA)."""
    rep = n_q_heads // k.shape[1]
    if rep == 1:
        return k, v
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def _attn_out(cfg: TransformerConfig, attn, lp, x):
    cdt = cfg.compute_dtype
    o = torch.einsum("bhsk,hkd->bsd", attn, lp.wo.to(cdt))
    if cfg.attn_bias:
        o = o + lp.wo_b.to(cdt)
    return x + o.to(x.dtype)


def _dense_mlp(cfg: TransformerConfig, x, lp):
    cdt = cfg.compute_dtype
    g = _ln(x, lp.ln2_s, lp.ln2_b).to(cdt)
    hmid = F.gelu(
        torch.einsum("bsd,df->bsf", g, lp.w1.to(cdt)) + lp.b1.to(cdt),
        approximate="tanh",  # jax.nn.gelu's default
    )
    y = torch.einsum("bsf,fd->bsd", hmid, lp.w2.to(cdt)) + lp.b2.to(cdt)
    return x + y.to(x.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            if is_layer_param(name):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(shape, device=device))
                )

    def forward(self, x):
        cfg = self.cfg
        h = _ln(x, self.ln1_s, self.ln1_b).to(cfg.compute_dtype)
        positions = (
            torch.arange(x.shape[1], device=x.device) if cfg.pos_emb == "rope" else None
        )
        q, k, v = _qkv_proj(cfg, h, self, positions)
        k, v = _repeat_kv(k, v, q.shape[1])
        if cfg.use_flash:
            attn = flash_attention(q, k, v, causal=cfg.causal)
        else:
            attn = ring_attention(q, k, v, axis_name=None, causal=cfg.causal)
        x = _attn_out(cfg, attn, self, x)
        return _dense_mlp(cfg, x, self)


def validate_mesh(axis_sizes: Optional[Mapping[str, int]]) -> None:
    """Data parallelism (dp) lives outside the model: each process of the
    host's group holds all of it (``comm.mesh``, ``parallel.hybrid``).  The
    port runs pp = sp = tp = 1; any larger model axis raises."""
    for axis, n in (axis_sizes or {}).items():
        if n != 1 and axis != "dp":
            raise NotImplementedError(
                f"mesh axis {axis}={n}: model parallelism is a later slice "
                "of the port (ROADMAP.md Queue 1 item 9)"
            )


def _default_device() -> torch.device:
    from byteps_tpu_torch.core.state import get_state

    st = get_state()
    return st.device if st.initialized else torch.device("cuda")


class Transformer(nn.Module):
    """The model on one device.  Parameters are allocated, not drawn:
    load them with ``model.load_state_dict(params_from_jax(init_params(cfg,
    seed), cfg))``.  ``device`` defaults to the one ``init()`` bound, else
    CUDA."""

    def __init__(
        self,
        cfg: TransformerConfig,
        device: Union[str, torch.device, None] = None,
        axis_sizes: Optional[Mapping[str, int]] = None,
    ) -> None:
        super().__init__()
        validate_mesh(axis_sizes)
        device = torch.device(device) if device is not None else _default_device()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            if not is_layer_param(name):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(shape, device=device))
                )
        self.layers = nn.ModuleList(
            TransformerLayer(cfg, device) for _ in range(cfg.n_layers)
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int → logits (B, S, V) in compute dtype."""
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.pos_emb == "learned":
            x = x + self.pos[: tokens.shape[1]]
        x = x.to(cfg.compute_dtype)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        h = _ln(x, self.ln_f_s, self.ln_f_b).to(cfg.compute_dtype)
        return torch.einsum("bsd,dv->bsv", h, self.head.to(cfg.compute_dtype))

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return token_loss(self(tokens), targets)


def token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32.  Every position with a target
    below 0 is ignored (masked-LM and padding)."""
    valid = (targets >= 0).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    return ((logz - gold) * valid).sum() / valid.sum()


def build_train_step(
    model: Transformer, optimizer: torch.optim.Optimizer
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One train step: ``step(tokens, targets) → loss`` (detached)."""

    def step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(tokens, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def build_generate(cfg: TransformerConfig, *args, **kwargs):
    raise NotImplementedError(
        "generation is a later slice of the port (ROADMAP.md Queue 1 item 9)"
    )


build_generate_cached = build_generate
