"""Flagship transformer family (BERT-large, GPT-2 medium), over one device
or a (dp, pp, sp, tp) mesh.

The port of ``byteps_tpu.models.transformer``: the same configs, the same
numpy parameter draws (:func:`init_params`), the same layer math and the
same loss, as an ``nn.Module`` plus a train step function.  Parameters
live in float32; activations are cast to ``compute_dtype`` where the JAX
code casts them (``.astype(cdt)``), so the residual stream runs in compute
dtype after the embedding.  With ``use_flash`` the attention is the port's
flash attention (CUDA kernels on the card); otherwise the dense attention.

Over a mesh (``comm.mesh.Mesh``, e.g. ``parallel.mesh_utils.
make_training_mesh``) each rank's module holds only its shards, as the
reference's ``shard_map`` hands each device its blocks (:func:`param_specs`):

- tp: Megatron tensor parallelism.  wq/wk/wv (and their biases) are
  sharded on heads, w1/b1 on columns, wo/w2 on rows; an activation
  replicated over tp meets the sharded weights through
  ``collectives.psum_grad`` ("f") and the row-parallel products are
  summed by ``collectives.psum`` ("g");
- sp: the sequence is sharded; attention is the ring (dense, or flash
  hops with ``use_flash``) or Ulysses (``seq_parallel_impl``), learned
  positions are offset by the sp index and rope uses absolute positions;
- pp: the layers are split into stages; GPipe over ``microbatches``
  (default pp), each stage sending its activations on to the next
  (``collectives.send_next`` / ``recv_prev``), with no bubble ticks;
- dp: the batch is sharded;
- experts (``moe``): a layer's MLP is ``parallel.moe.moe_mlp``, its
  experts sharded over sp (each sp rank holds ``n_experts / sp``) and the
  tokens routed to them by a tiled all-to-all over sp; the router is
  replicated.  The load-balancing term of each layer and microbatch is
  summed over the mesh (pp, dp and sp, as the reference's) and added
  times ``moe_aux_coef``.

The loss is the reference's ``_local_loss``: targets below 0 ignored, the
last stage's sum and count summed over pp, dp and sp.  After backward the
train step sums each gradient over dp, sp and pp as
:func:`grad_sync_axes` lists them: the reference's VMA-checked AD does
that implicitly.  tp is left to the f/g pair (each tp rank already holds
the whole gradient of what it replicates).  With every axis at 1 no
collective runs and the model is the one-device model.

Generation: :func:`build_generate` recomputes the forward on the fixed
``max_seq`` window for every new token; :func:`build_generate_cached`
keeps each layer's K/V (kv heads only) and decodes a token at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import Mesh, as_axis_sizes
from byteps_tpu_torch.ops.flash_attention import flash_attention
from byteps_tpu_torch.parallel.moe import moe_aux_loss, moe_mlp
from byteps_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from byteps_tpu_torch.parallel.ulysses import ulysses_attention


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
    n_experts: int = 8
    # experts per token: 2 = GShard (gates renormalized), 1 = Switch
    moe_top_k: int = 2
    capacity_factor: float = 2.0
    # the capacity factor of generation's prefill; None = no drops (cf =
    # n_experts, capacity = the token count), so a prompt's output does not
    # depend on the mesh
    prefill_capacity_factor: Optional[float] = None
    moe_aux_coef: float = 0.01
    compute_dtype: torch.dtype = torch.float32
    microbatches: int = 0  # GPipe microbatches; 0 = the pipeline's stage count
    # recompute each layer in the backward pass (activation checkpointing)
    remat: bool = True
    # attention through the flash-attention kernels instead of the dense
    # (S, S) score matrix; at sp > 1, flash hops in the ring
    use_flash: bool = False
    # sequence parallelism at sp > 1: "ring" (any head count) or "ulysses"
    # (all-to-all; the tp-local heads must divide by sp)
    seq_parallel_impl: str = "ring"
    attn_bias: bool = False
    pos_emb: str = "learned"  # "learned" absolute table or "rope"
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.seq_parallel_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown seq_parallel_impl {self.seq_parallel_impl!r}; "
                "expected 'ring' or 'ulysses'"
            )
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


# ---------------------------------------------------------------------------
# parameters: the reference's layout table
# ---------------------------------------------------------------------------

#: every axis of the mesh: the gradient of a parameter used whole on every
#: rank is summed over all of them (tp by the f/g pair, the rest after backward)
_ALL = ("dp", "pp", "sp", "tp")


def _layouts(cfg: TransformerConfig) -> Dict[str, Tuple[Tuple[int, ...], Tuple, Tuple[str, ...]]]:
    """name → (per-layer or global shape, partition spec of the stacked
    global array, gradient-sync axes), the reference's table: a spec is a
    tuple of mesh axis names or None per dimension (trailing ones left
    out), layer parameters stacked with leading dims (pp, layers_per_stage)."""
    D, H, dh, F_, KV = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff, cfg.kv_heads
    table = {"embed": ((cfg.vocab_size, D), (), _ALL)}
    if cfg.pos_emb == "learned":
        table["pos"] = ((cfg.max_seq, D), (), _ALL)
    table.update({
        "ln_f_s": ((D,), (), _ALL),
        "ln_f_b": ((D,), (), _ALL),
        "head": ((D, cfg.vocab_size), (), _ALL),
        "ln1_s": ((D,), ("pp",), ("dp", "sp", "tp")),
        "ln1_b": ((D,), ("pp",), ("dp", "sp", "tp")),
        "ln2_s": ((D,), ("pp",), ("dp", "sp", "tp")),
        "ln2_b": ((D,), ("pp",), ("dp", "sp", "tp")),
        "wq": ((D, H, dh), ("pp", None, None, "tp", None), ("dp", "sp")),
        "wk": ((D, KV, dh), ("pp", None, None, "tp", None), ("dp", "sp")),
        "wv": ((D, KV, dh), ("pp", None, None, "tp", None), ("dp", "sp")),
        "wo": ((H, dh, D), ("pp", None, "tp", None, None), ("dp", "sp")),
    })
    if cfg.attn_bias:
        table.update({
            "wq_b": ((H, dh), ("pp", None, "tp", None), ("dp", "sp")),
            "wk_b": ((KV, dh), ("pp", None, "tp", None), ("dp", "sp")),
            "wv_b": ((KV, dh), ("pp", None, "tp", None), ("dp", "sp")),
            # added after the tp psum, like b2
            "wo_b": ((D,), ("pp",), ("dp", "sp", "tp")),
        })
    if cfg.moe:
        # the experts are sharded over sp; each tp rank routes the same
        # (tp-replicated) tokens, so their gradients sum over dp only
        E = cfg.n_experts
        table.update({
            "router": ((D, E), ("pp",), ("dp", "sp", "tp")),
            "ew1": ((E, D, F_), ("pp", None, "sp", None, None), ("dp", "tp")),
            "eb1": ((E, F_), ("pp", None, "sp", None), ("dp", "tp")),
            "ew2": ((E, F_, D), ("pp", None, "sp", None, None), ("dp", "tp")),
            "eb2": ((E, D), ("pp", None, "sp", None), ("dp", "tp")),
        })
    else:
        table.update({
            "w1": ((D, F_), ("pp", None, None, "tp"), ("dp", "sp")),
            "b1": ((F_,), ("pp", None, "tp"), ("dp", "sp")),
            "w2": ((F_, D), ("pp", None, "tp", None), ("dp", "sp")),
            "b2": ((D,), ("pp",), ("dp", "sp", "tp")),
        })
    return table


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """name → per-layer (or global) shape, in the JAX package's order: the
    order :func:`init_params` draws in."""
    return {k: shape for k, (shape, _, _) in _layouts(cfg).items()}


def param_specs(cfg: TransformerConfig) -> Dict[str, Tuple]:
    """name → the partition spec of the global (stacked) array."""
    return {k: spec for k, (_, spec, _) in _layouts(cfg).items()}


def grad_sync_axes(cfg: TransformerConfig) -> Dict[str, Tuple[str, ...]]:
    """name → the axes its gradient is summed over (tp by the f/g pair)."""
    return {k: axes for k, (_, _, axes) in _layouts(cfg).items()}


_LAYER_PARAMS_PREFIXES = ("ln1_", "ln2_", "wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2",
                          "router", "ew1", "eb1", "ew2", "eb2")


def is_layer_param(name: str) -> bool:
    return name.startswith(_LAYER_PARAMS_PREFIXES)


def local_spec(cfg: TransformerConfig, name: str) -> Tuple:
    """The partition of one layer's (or a global) parameter over the mesh,
    one entry per dimension of :func:`param_shapes`' shape: the stacked
    spec without its (pp, layers_per_stage) dims."""
    shape, spec, _ = _layouts(cfg)[name]
    if is_layer_param(name):
        spec = spec[2:]
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def local_shapes(cfg: TransformerConfig, tp: int = 1, sp: int = 1) -> Dict[str, Tuple[int, ...]]:
    """name → the shape a rank of a mesh with ``tp`` tensor-parallel and
    ``sp`` sequence-parallel ranks holds."""
    sizes = {"tp": tp, "sp": sp}
    return {name: tuple(n // sizes[ax] if ax else n
                        for n, ax in zip(shape, local_spec(cfg, name)))
            for name, shape in param_shapes(cfg).items()}


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
        elif name.endswith("_b") or name.startswith("b") or name.startswith("eb"):
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


def _f(x, mesh: Optional[Mesh]):
    """Megatron's f: an activation replicated over tp meets tp-sharded
    weights (the identity without a tp axis)."""
    return x if mesh is None else collectives.psum_grad(x, "tp", mesh)


def _g(x, mesh: Optional[Mesh]):
    """Megatron's g: the row-parallel combine over tp."""
    return x if mesh is None else collectives.psum(x, "tp", mesh)


def _attn_out(cfg: TransformerConfig, attn, lp, x, mesh: Optional[Mesh] = None):
    cdt = cfg.compute_dtype
    o = torch.einsum("bhsk,hkd->bsd", attn, lp.wo.to(cdt))
    o = _g(o, mesh)
    if cfg.attn_bias:
        o = o + lp.wo_b.to(cdt)
    return x + o.to(x.dtype)


def _dense_mlp(cfg: TransformerConfig, x, lp, mesh: Optional[Mesh] = None):
    cdt = cfg.compute_dtype
    g = _f(_ln(x, lp.ln2_s, lp.ln2_b).to(cdt), mesh)
    hmid = F.gelu(
        torch.einsum("bsd,df->bsf", g, lp.w1.to(cdt)) + lp.b1.to(cdt),
        approximate="tanh",  # jax.nn.gelu's default
    )
    y = _g(torch.einsum("bsf,fd->bsd", hmid, lp.w2.to(cdt)), mesh)
    y = y + lp.b2.to(cdt)
    return x + y.to(x.dtype)


def _moe_block(cfg: TransformerConfig, x, lp, mesh: Optional[Mesh], capacity_factor: float):
    """ln2 → routed expert MLP → residual; returns (new residual stream,
    the router's input g, which the aux loss takes).  The tokens are
    replicated over tp and route the same on every tp rank: no f/g pair."""
    cdt = cfg.compute_dtype
    sp = mesh.axis_size("sp") if mesh is not None else 1
    g = _ln(x, lp.ln2_s, lp.ln2_b).to(cdt)
    b, s, d = g.shape
    y = moe_mlp(
        g.reshape(b * s, d), lp.router.to(cdt), lp.ew1.to(cdt), lp.eb1.to(cdt),
        lp.ew2.to(cdt), lp.eb2.to(cdt), axis_name="sp" if sp > 1 else None, axis_size=sp,
        capacity_factor=capacity_factor, top_k=cfg.moe_top_k, mesh=mesh,
    ).reshape(b, s, d)
    return x + y.to(x.dtype), g


def _attention(cfg: TransformerConfig, q, k, v, mesh: Optional[Mesh]):
    """The reference's choice in ``layer_fn``."""
    sp = mesh.axis_size("sp") if mesh is not None else 1
    if sp == 1 and cfg.use_flash:
        return flash_attention(q, k, v, causal=cfg.causal)
    if sp > 1 and cfg.seq_parallel_impl == "ulysses":
        return ulysses_attention(q, k, v, "sp", sp, causal=cfg.causal, mesh=mesh)
    if sp > 1 and cfg.use_flash:
        return ring_flash_attention(q, k, v, "sp", sp, causal=cfg.causal, mesh=mesh)
    return ring_attention(q, k, v, axis_name="sp" if sp > 1 else None, axis_size=sp,
                          causal=cfg.causal, mesh=mesh)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 mesh: Optional[Mesh] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        sizes = {ax: mesh.axis_size(ax) if mesh is not None else 1 for ax in ("tp", "sp")}
        for name, shape in local_shapes(cfg, **sizes).items():
            if is_layer_param(name):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(shape, device=device))
                )

    def forward(self, x):
        """(B, S, D) → (the layer's output, its load-balancing term: a
        compute-dtype scalar with ``moe``, else None)."""
        cfg, mesh = self.cfg, self.mesh
        h = _f(_ln(x, self.ln1_s, self.ln1_b).to(cfg.compute_dtype), mesh)
        positions = None
        if cfg.pos_emb == "rope":
            off = mesh.axis_index("sp") * x.shape[1] if mesh is not None else 0
            positions = off + torch.arange(x.shape[1], device=x.device)
        q, k, v = _qkv_proj(cfg, h, self, positions)
        k, v = _repeat_kv(k, v, q.shape[1])
        attn = _attention(cfg, q, k, v, mesh)
        x = _attn_out(cfg, attn, self, x, mesh)
        if not cfg.moe:
            return _dense_mlp(cfg, x, self, mesh), None
        x, g = _moe_block(cfg, x, self, mesh, cfg.capacity_factor)
        sp = mesh.axis_size("sp") if mesh is not None else 1
        aux = moe_aux_loss(g.reshape(-1, g.shape[-1]), self.router.to(cfg.compute_dtype), sp,
                           self.ew1.shape[0])
        return x, aux


def validate_mesh(cfg: TransformerConfig, mesh: Union[Mesh, Mapping[str, int], None]) -> None:
    """Config × mesh checks, the reference's messages: wq is tp-sharded on
    the query heads, wk/wv on the KV heads, w1 on d_ff; the layers split
    into pp stages; the experts split over sp.  ``mesh`` may be a mapping of axis sizes."""
    sizes = as_axis_sizes(mesh)
    tp, pp = sizes.get("tp", 1), sizes.get("pp", 1)
    if cfg.n_heads % tp:
        raise ValueError(
            f"n_heads {cfg.n_heads} not divisible by tp={tp}: wq is "
            "tp-sharded on the head dim"
        )
    if cfg.kv_heads % tp:
        raise ValueError(
            f"n_kv_heads {cfg.kv_heads} not divisible by tp={tp}: wk/wv "
            "are tp-sharded on the KV-head dim — use more KV heads or a "
            "smaller tp axis (GQA groups cannot span tp shards)"
        )
    if not cfg.moe and cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tp={tp}: w1 is tp-sharded "
                         "on its columns")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp}")
    sp = sizes.get("sp", 1)
    if cfg.moe and cfg.n_experts % sp:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by sp={sp}: the experts "
                         "are sharded over the sp axis")


def _default_device() -> torch.device:
    from byteps_tpu_torch.core.state import get_state

    st = get_state()
    return st.device if st.initialized else torch.device("cuda")


class _StageLayers(nn.ModuleList):
    """A later pipeline stage's layers, named by their global index (the
    state dict's ``layers.<i>`` is the model's layer i on every stage)."""

    def __init__(self, layers, offset: int) -> None:
        super().__init__()
        for j, layer in enumerate(layers):
            self.add_module(str(offset + j), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class Transformer(nn.Module):
    """The model, or with ``mesh`` this rank's shards of it.  Parameters
    are allocated, not drawn: load them with ``model.load_state_dict(
    params_from_jax(init_params(cfg, seed), cfg))`` (on a mesh,
    ``shard_params_from_jax``).  ``device`` defaults to the one ``init()``
    bound, else CUDA."""

    def __init__(
        self,
        cfg: TransformerConfig,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        super().__init__()
        validate_mesh(cfg, mesh)
        device = torch.device(device) if device is not None else _default_device()
        self.cfg = cfg
        # a mesh of one rank runs no collective: the one-device model
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        for name, shape in local_shapes(cfg, self.axis_size("tp"), self.axis_size("sp")).items():
            if not is_layer_param(name):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(shape, device=device))
                )
        lps = cfg.n_layers // self.axis_size("pp")
        offset = self.axis_index("pp") * lps
        layers = [TransformerLayer(cfg, device, self.mesh) for _ in range(lps)]
        self.layers = nn.ModuleList(layers) if offset == 0 else _StageLayers(layers, offset)

    def axis_size(self, axis: str) -> int:
        return self.mesh.axis_size(axis) if self.mesh is not None else 1

    def axis_index(self, axis: str) -> int:
        return self.mesh.axis_index(axis) if self.mesh is not None else 0

    @property
    def is_last_stage(self) -> bool:
        return self.axis_index("pp") == self.axis_size("pp") - 1

    def _stage(self, x):
        """This stage's layers on x: (output, the sum of their load-balancing
        terms, None without ``moe``)."""
        aux = None
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                if self.mesh is None:
                    x, a = checkpoint(layer, x, use_reentrant=False)
                else:
                    # recompute the whole layer, every collective in it: a
                    # recompute that stops once it has what this rank saved
                    # skips the exchanges a causal ring's skipped hops feed,
                    # and its peers would wait for them
                    with set_checkpoint_early_stop(False):
                        x, a = checkpoint(layer, x, use_reentrant=False)
            else:
                x, a = layer(x)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _embed(self, tokens):
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.pos_emb == "learned":
            off = self.axis_index("sp") * tokens.shape[1]
            x = x + self.pos[off: off + tokens.shape[1]]
        return x.to(cfg.compute_dtype)

    def _pipeline(self, tokens):
        """GPipe: (the last stage's final activations or None, the zero
        scalar whose backward receives the next stage's cotangents, the
        stage's load-balancing terms summed over its layers and the
        microbatches, None without ``moe``)."""
        cfg, mesh = self.cfg, self.mesh
        pp, stage = self.axis_size("pp"), self.axis_index("pp")
        b, s = tokens.shape
        m = cfg.microbatches or pp
        if b % m:
            raise ValueError(f"local batch {b} not divisible by {m} microbatches")
        if pp == 1 and not (cfg.moe and m > 1):
            y, aux = self._stage(self._embed(tokens))
            return y, None, aux
        xs = self._embed(tokens).chunk(m) if stage == 0 else None
        like = torch.empty((b // m, s, cfg.d_model), dtype=cfg.compute_dtype,
                           device=tokens.device)
        outs, sent, aux = [], [], None
        for i in range(m):
            # an expert layer routes each microbatch alone, as the reference
            # does: the capacity and the queue order depend on the token set
            x = xs[i] if stage == 0 else collectives.recv_prev(like, "pp", mesh)
            y, a = self._stage(x)
            if a is not None:
                aux = a if aux is None else aux + a
            if stage < pp - 1:
                sent.append(collectives.send_next(y, "pp", mesh))
            else:
                outs.append(y)
        return (torch.cat(outs) if outs else None), (sum(sent) if sent else None), aux

    def _logits(self, x):
        cfg = self.cfg
        h = _ln(x, self.ln_f_s, self.ln_f_b).to(cfg.compute_dtype)
        return torch.einsum("bsd,dv->bsv", h, self.head.to(cfg.compute_dtype))

    def forward(self, tokens: torch.Tensor, targets: Optional[torch.Tensor] = None,
                over: Tuple[str, ...] = ("pp", "dp", "sp")) -> Optional[torch.Tensor]:
        """tokens (B, S) int (this rank's block on a mesh) → logits (B, S,
        V) in compute dtype; None on a pipeline stage other than the last.
        With ``targets``, :meth:`loss` instead: both run through the
        module's call, so its forward pre-hooks (``CrossBarrier``'s wait
        for the updates of the embedding and the head) fire first."""
        x, sent, aux = self._pipeline(tokens)
        if targets is None:
            return self._logits(x) if x is not None else None
        if self.mesh is None:
            loss = token_loss(self._logits(x), targets)
        else:
            if x is not None:
                local = torch.stack(_token_loss_terms(self._logits(x), targets))
            else:
                local = torch.zeros(2, device=tokens.device)
            for ax in over:
                local = collectives.psum(local, ax, self.mesh)
            loss = local[0] / local[1]
        if aux is not None:
            if self.mesh is not None:
                for ax in over:
                    aux = collectives.psum(aux, ax, self.mesh)
            loss = loss + self.cfg.moe_aux_coef * aux.float()
        return loss if sent is None else loss + sent

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             over: Tuple[str, ...] = ("pp", "dp", "sp")) -> torch.Tensor:
        """The mean token loss over the batch blocks of the axes ``over``
        (default: the whole global batch; ``("pp", "sp")`` is one dp
        replica's, what ``HybridDataParallel`` averages over dp).  With
        ``moe``, plus ``moe_aux_coef`` times the load-balancing terms of
        every layer and microbatch summed over ``over`` (a sum, as the
        reference's, not a mean)."""
        return self(tokens, targets, over)

    def param_specs(self) -> Dict[str, Tuple]:
        """Parameter name → its partition over the mesh, one entry per dim."""
        return {name: local_spec(self.cfg, name.rsplit(".", 1)[-1])
                for name, _ in self.named_parameters()}

    def grad_sync_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Parameter name → :func:`grad_sync_axes`' entry for it."""
        table = grad_sync_axes(self.cfg)
        return {name: table[name.rsplit(".", 1)[-1]] for name, _ in self.named_parameters()}

    def stacked_keys(self) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
        """The reference's parameter tree as ``HybridDataParallel`` pushes
        it: for each entry of :func:`param_shapes`, in sorted order (the
        order of the reference's tree leaves), (its name, its global shape,
        the names of this rank's parameters that fill it).  A layer
        parameter is one array stacked ``(pp, layers a stage) + shape``,
        filled by this stage's layers in order (``params_to_jax``'s
        layout); a global one is itself."""
        cfg, shapes = self.cfg, param_shapes(self.cfg)
        pp = self.axis_size("pp")
        lps = cfg.n_layers // pp
        first = self.axis_index("pp") * lps
        return [(name, (pp, lps) + shapes[name],
                 [f"layers.{first + j}.{name}" for j in range(lps)])
                if is_layer_param(name) else (name, shapes[name], [name])
                for name in sorted(shapes)]

    def sync_grads(self) -> None:
        """Sum each gradient over the axes :func:`grad_sync_axes` lists
        for it, tp left out (the f/g pair's), one flattened all-reduce per
        set of axes and axis.  A parameter this stage did not use (the
        embedding past stage 0, the head before the last) adds zeros."""
        if self.mesh is not None:
            collectives.sync_grads(dict(self.named_parameters()), self.grad_sync_axes(),
                                   self.mesh)


def _token_loss_terms(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of the token cross-entropies, count of the targets ≥ 0), f32."""
    valid = (targets >= 0).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32.  Every position with a target
    below 0 is ignored (masked-LM and padding)."""
    total, count = _token_loss_terms(logits, targets)
    return total / count


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of a global (B, S) batch: rows over dp, the
    sequence over sp (the reference's ``P("dp", "sp")``)."""
    if mesh is None:
        return x
    dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")
    b, s = x.shape[0] // dp, x.shape[1] // sp
    i, j = mesh.axis_index("dp"), mesh.axis_index("sp")
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def build_forward(model: Transformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """``forward(tokens) → logits`` without autograd, the last pipeline
    stage's logits on every rank."""

    def forward(tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            logits = model(tokens)
            if model.axis_size("pp") == 1:
                return logits
            if logits is None:
                cfg = model.cfg
                logits = torch.zeros((*tokens.shape, cfg.vocab_size), dtype=cfg.compute_dtype,
                                     device=tokens.device)
            return collectives.all_reduce_axis(logits, "pp", model.mesh)

    return forward


def build_train_step(
    model: Transformer, optimizer: torch.optim.Optimizer
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One train step: ``step(tokens, targets) → loss`` (detached), on this
    rank's shards with this rank's block of the batch."""

    def step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(tokens, targets)
        loss.backward()
        model.sync_grads()
        optimizer.step()
        return loss.detach()

    return step


def _check_prompt(model: Transformer, prompt, n_new: int) -> np.ndarray:
    """The reference's argument checks; the prompt as int64 numpy."""
    prompt = np.asarray(prompt).astype(np.int64)
    b, s0 = prompt.shape
    if s0 + n_new > model.cfg.max_seq:
        raise ValueError(f"{s0}+{n_new} exceeds max_seq {model.cfg.max_seq}")
    dp = model.axis_size("dp")
    if b % dp:
        raise ValueError(f"batch {b} not divisible by dp={dp}")
    return prompt


def _require_causal(model: Transformer) -> None:
    if not model.cfg.causal:
        raise ValueError("generation requires a causal config")


def _all_rows(model: Transformer, rows: torch.Tensor) -> torch.Tensor:
    """This dp shard's rows → the global batch's, in the input's order."""
    if model.mesh is None:
        return rows
    return collectives.all_gather_axis(rows.contiguous(), "dp", 0, model.mesh)


def build_generate(model: Transformer) -> Callable[..., np.ndarray]:
    """Greedy decoding by recompute: ``generate(prompt, n_new) → (B,
    s0+n_new)`` int64 numpy, the same on every rank.  Each new token runs
    the forward on the fixed ``max_seq`` window (causal masking makes the
    right padding inert), the whole (B, max_seq) buffer sharded over dp and
    sp as the training batch is.  Every rank of the mesh calls it with the
    whole prompt.  Requires a causal config."""
    _require_causal(model)
    cfg, mesh = model.cfg, model.mesh

    def predictions(buf: torch.Tensor) -> torch.Tensor:
        """(B, max_seq): the argmax of the logits at every position."""
        logits = model(shard_batch(buf, mesh))
        if mesh is None:
            return logits.argmax(-1)
        pred = (logits.argmax(-1) if logits is not None else
                torch.zeros(shard_batch(buf, mesh).shape, dtype=torch.long, device=buf.device))
        pred = collectives.all_reduce_axis(pred, "pp", mesh)  # the last stage's
        pred = collectives.all_gather_axis(pred.contiguous(), "sp", 1, mesh)
        return _all_rows(model, pred)

    def generate(prompt, n_new: int) -> np.ndarray:
        prompt = _check_prompt(model, prompt, n_new)
        b, s0 = prompt.shape
        buf = torch.zeros((b, cfg.max_seq), dtype=torch.long, device=model.embed.device)
        buf[:, :s0] = torch.as_tensor(prompt)
        with torch.no_grad():
            for i in range(s0, s0 + n_new):
                buf[:, i] = predictions(buf)[:, i - 1]
        return buf[:, :s0 + n_new].cpu().numpy()

    return generate


def _sample_seed(seed: int, shard: int, step: int) -> int:
    """The seed of a sampled step's generator: one stream per seed, dp
    shard and step."""
    return ((int(seed) * 1_000_003 + shard) * 1_000_003 + step) % (1 << 63)


def build_generate_cached(model: Transformer) -> Callable[..., np.ndarray]:
    """KV-cached decoding: ``generate(prompt, n_new, temperature=0.0,
    top_k=0, seed=0) → (B, s0+n_new)`` int64 numpy on every rank, for
    equal-length prompts.  Every rank of the mesh calls it with the whole
    prompt and decodes its dp shard's rows.

    Prefill writes the prompt's K/V in one batched pass; each later step
    embeds one token, attends over the cache (masked to the positions
    written so far, plain torch ops as the reference's einsums), appends
    its K/V and picks the next token.  The caches hold kv heads only (the
    GQA memory win), tp-local heads on a tp mesh, this stage's layers on a
    pp mesh.  pp runs as turns: the stage whose turn it is runs its layers
    and sends the activations on, and the last stage's output goes to all.
    sp keeps the tokens replicated; expert layers dispatch them over sp.
    Expert layers run at no-drop capacity (cf = n_experts) unless
    ``prefill_capacity_factor`` bounds the prefill.

    ``temperature == 0`` decodes greedily; above 0 it samples, truncated
    to the ``top_k`` most likely tokens when ``top_k > 0``, from a
    ``torch.Generator`` seeded per ``seed``, dp shard and step: the same
    tokens for the same seed on the same device, not the reference's
    threefry draws.  Requires a causal config."""
    _require_causal(model)
    cfg, mesh = model.cfg, model.mesh
    cdt, s_max = cfg.compute_dtype, cfg.max_seq
    pp, stage = model.axis_size("pp"), model.axis_index("pp")

    def cached_layer(lp, x, kc, vc, offset: int, cf: float):
        """x (B, s, D) at positions [offset, offset+s); kc, vc (B, KV, S_max,
        dh) updated in place."""
        s = x.shape[1]
        h = _ln(x, lp.ln1_s, lp.ln1_b).to(cdt)
        positions = offset + torch.arange(s, device=x.device)
        q, k, v = _qkv_proj(cfg, h, lp, positions)
        kc[:, :, offset:offset + s] = k.to(kc.dtype)
        vc[:, :, offset:offset + s] = v.to(vc.dtype)
        b, hq, hkv = q.shape[0], q.shape[1], kc.shape[1]
        qg = q.reshape(b, hkv, hq // hkv, s, cfg.d_head)
        scores = torch.einsum("bgrsk,bgtk->bgrst", qg, kc.to(cdt))
        scores = scores / torch.tensor(math.sqrt(cfg.d_head), dtype=cdt, device=x.device)
        # query i (position offset+i) sees the cache up to offset+i
        mask = (torch.arange(s_max, device=x.device)[None, :] <= positions[:, None])
        scores = scores.masked_fill(~mask, -1e30)
        attn = torch.softmax(scores.float(), dim=-1).to(cdt)
        ctx = torch.einsum("bgrst,bgtk->bgrsk", attn, vc.to(cdt)).reshape(b, hq, s, cfg.d_head)
        x = _attn_out(cfg, ctx, lp, x, mesh)
        if cfg.moe:
            return _moe_block(cfg, x, lp, mesh, cf)[0]
        return _dense_mlp(cfg, x, lp, mesh)

    def full_stack(x, caches, offset: int, cf: float):
        for turn in range(pp):
            if stage == turn:
                for lp, (kc, vc) in zip(model.layers, caches):
                    x = cached_layer(lp, x, kc, vc, offset, cf)
            if turn < pp - 1:
                got = collectives.ppermute(x, "pp", [(turn, turn + 1)], mesh)
                if stage == turn + 1:
                    x = got
        if pp > 1:  # the last stage's output on every stage
            x = collectives.all_reduce_axis(x if stage == pp - 1 else torch.zeros_like(x),
                                            "pp", mesh)
        return x

    def embed(tokens, positions):
        x = model.embed[tokens]
        if cfg.pos_emb == "learned":
            x = x + model.pos[positions]
        return x.to(cdt)

    def generate(prompt, n_new: int, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0) -> np.ndarray:
        prompt = _check_prompt(model, prompt, n_new)
        if top_k > cfg.vocab_size:
            raise ValueError(f"top_k={top_k} exceeds vocab_size {cfg.vocab_size}")
        b, s0 = prompt.shape
        dp, shard = model.axis_size("dp"), model.axis_index("dp")
        dev = model.embed.device
        rows = b // dp
        tokens = torch.as_tensor(prompt[shard * rows:(shard + 1) * rows], device=dev)
        kv_local, dh = model.layers[0].wk.shape[1], cfg.d_head
        caches = [(torch.zeros((rows, kv_local, s_max, dh), dtype=cdt, device=dev),
                   torch.zeros((rows, kv_local, s_max, dh), dtype=cdt, device=dev))
                  for _ in model.layers]
        generate.cache_shapes = [tuple(kc.shape) for kc, _ in caches]
        sampling = temperature > 0.0

        def pick(logits, step: int):
            if not sampling:
                return logits.argmax(-1)
            scaled = logits.float() / torch.tensor(max(float(temperature), 1e-9),
                                                   device=logits.device)
            if top_k > 0:
                kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
                scaled = torch.where(scaled >= kth, scaled, torch.full_like(scaled, -1e30))
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_sample_seed(seed, shard, step))
            u = torch.rand(scaled.shape, generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            return (scaled + gumbel).argmax(-1)  # Gumbel-max: a categorical draw

        prefill_cf = (float(cfg.n_experts) if cfg.prefill_capacity_factor is None
                      else cfg.prefill_capacity_factor)
        with torch.no_grad():
            x = full_stack(embed(tokens, torch.arange(s0, device=dev)), caches, 0, prefill_cf)
            out = [pick(model._logits(x)[:, -1], 0)]
            for j in range(1, n_new):  # consume token j at position s0+j-1
                pos = s0 + j - 1
                x = embed(out[-1][:, None], torch.tensor([pos], device=dev))
                x = full_stack(x, caches, pos, float(cfg.n_experts))
                out.append(pick(model._logits(x)[:, -1], j))
            new = _all_rows(model, torch.stack(out, dim=1)) if n_new else \
                torch.zeros((b, 0), dtype=torch.long, device=dev)
        return np.concatenate([prompt, new.cpu().numpy()], axis=1)

    return generate
