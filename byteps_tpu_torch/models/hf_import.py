"""HuggingFace GPT-2 checkpoint import for the flagship transformer.

The port of ``byteps_tpu.models.hf_import``: a GPT-2 model's weights
become the JAX package's flat parameter layout (layer parameters stacked
with leading dims ``(pp, layers_per_stage)``), which the port loads with
``models.convert.params_from_jax`` (one process) or
``shard_params_from_jax`` (a rank of a mesh).

``transformers`` is not needed: ``hf_model`` is any object with a
``config`` (``vocab_size``, ``n_embd``, ``n_head``, ``n_layer``,
``n_positions``, ``n_inner``) and a ``state_dict()`` of tensors under HF's
GPT-2 key names.  HF's ``Conv1D`` stores its weight as (in, out) and
computes ``x @ W + b``, the layout of the port's ``wq``/``w1``/...; the
LM head is a copy of the token embedding's transpose, untied after the
import.  Keys the state dict may also hold (``lm_head.weight``, the
attention's ``bias`` and ``masked_bias`` buffers) are not read.

The port's layer norm (eps 1e-5) and tanh GELU are GPT-2's
``layer_norm_epsilon`` and ``gelu_new``; a config that states another
epsilon or activation is refused, where the reference would import it
and compute something else.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from byteps_tpu_torch.models.transformer import TransformerConfig

#: what the port's layer math computes (``transformer._ln``, ``_dense_mlp``)
_LN_EPS, _ACTIVATION = 1e-5, "gelu_new"


def config_from_gpt2(hf_config) -> TransformerConfig:
    eps = getattr(hf_config, "layer_norm_epsilon", _LN_EPS)
    act = getattr(hf_config, "activation_function", _ACTIVATION)
    if eps != _LN_EPS or act != _ACTIVATION:
        raise ValueError(f"layer_norm_epsilon {eps} and activation_function {act!r}: the "
                         f"model computes {_LN_EPS} and {_ACTIVATION!r}")
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_heads=hf_config.n_head,
        d_head=hf_config.n_embd // hf_config.n_head,
        d_ff=hf_config.n_inner or 4 * hf_config.n_embd,
        n_layers=hf_config.n_layer,
        max_seq=hf_config.n_positions,
        causal=True,
        attn_bias=True,
        remat=False,
    )


def load_gpt2_weights(hf_model, pp_size: int = 1) -> Tuple[TransformerConfig,
                                                            Dict[str, np.ndarray]]:
    """GPT-2 model → (config, float32 numpy params in the JAX package's
    layout), layer params stacked with leading dims (pp, layers_per_stage)."""
    cfg = config_from_gpt2(hf_model.config)
    D, H, dh, L = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.n_layers
    if L % pp_size:
        raise ValueError(f"n_layers {L} not divisible by pp {pp_size}")
    sd = {k: v.detach().cpu().numpy() for k, v in hf_model.state_dict().items()}

    def stack(fn) -> np.ndarray:
        arr = np.stack([fn(i) for i in range(L)]).astype(np.float32)  # (L, ...)
        return arr.reshape((pp_size, L // pp_size) + arr.shape[1:])

    def layer(i: int, name: str) -> np.ndarray:
        return sd[f"transformer.h.{i}.{name}"]

    wte = sd["transformer.wte.weight"]
    params: Dict[str, np.ndarray] = {
        "embed": wte.astype(np.float32),
        "pos": sd["transformer.wpe.weight"].astype(np.float32),
        "ln_f_s": sd["transformer.ln_f.weight"].astype(np.float32),
        "ln_f_b": sd["transformer.ln_f.bias"].astype(np.float32),
        # GPT-2 ties the LM head to the token embedding
        "head": wte.T.astype(np.float32),
        "ln1_s": stack(lambda i: layer(i, "ln_1.weight")),
        "ln1_b": stack(lambda i: layer(i, "ln_1.bias")),
        "ln2_s": stack(lambda i: layer(i, "ln_2.weight")),
        "ln2_b": stack(lambda i: layer(i, "ln_2.bias")),
    }
    # c_attn: weight (D, 3D), bias (3D,); thirds q, k, v, each split by head
    for which, name in enumerate(("wq", "wk", "wv")):
        params[name] = stack(lambda i: np.split(layer(i, "attn.c_attn.weight"), 3,
                                                axis=1)[which].reshape(D, H, dh))
    for which, name in enumerate(("wq_b", "wk_b", "wv_b")):
        params[name] = stack(lambda i: np.split(layer(i, "attn.c_attn.bias"),
                                                3)[which].reshape(H, dh))
    params["wo"] = stack(lambda i: layer(i, "attn.c_proj.weight").reshape(H, dh, D))
    params["wo_b"] = stack(lambda i: layer(i, "attn.c_proj.bias"))
    params["w1"] = stack(lambda i: layer(i, "mlp.c_fc.weight"))
    params["b1"] = stack(lambda i: layer(i, "mlp.c_fc.bias"))
    params["w2"] = stack(lambda i: layer(i, "mlp.c_proj.weight"))
    params["b2"] = stack(lambda i: layer(i, "mlp.c_proj.bias"))
    return cfg, params
