"""Entry points of the port: one card's forward, and a dry run of the
training meshes (the counterpart of the repository's ``__graft_entry__``).

- :func:`entry` → ``(fn, example_args)``: BERT-large's forward at max_seq
  128 on a batch of 8, bf16, on the card.
- :func:`dryrun_multichip` ``(n)``: on every rank of the host's group of n
  ranks, for each of two factorizations of n (dp first, then pp-heavy and
  sp-heavy: 4 → {dp:2, pp:2} and {dp:2, sp:2}; 8 → {dp:2, pp:2, tp:2}
  and {dp:2, sp:2, tp:2}), one full train step of a small mixture-of-
  experts model (GQA, causal, 2·sp experts over sp, 2·pp microbatches,
  f32, AdamW) and a KV-cached decode of 2·dp prompts; returns (and rank 0
  prints) a summary line a mesh.

    python -m byteps_tpu_torch.dryrun [N]

starts N ranks under the port's launcher and runs :func:`dryrun_multichip`
in each: NCCL ranks when the host has N GPUs, staged ranks on one card
when it has fewer, gloo ranks on the CPU without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from byteps_tpu_torch.comm.mesh import AXES


def entry(device: Optional[str] = None):
    """BERT-large's forward (max_seq 128, bf16, ``init_params(seed=0)``)
    on ``device`` (default: the card) and a batch of 8 sequences of numpy
    seed 0: ``(fn, (tokens,))`` with ``fn(tokens) → logits (8, 128, V)``."""
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import (Transformer, bert_large, build_forward,
                                                     init_params)

    cfg = bert_large(max_seq=128, compute_dtype=torch.bfloat16)
    model = Transformer(cfg, device=device or "cuda")
    model.load_state_dict(params_from_jax(init_params(cfg, seed=0), cfg))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, cfg.max_seq)),
                             device=model.embed.device)
    return build_forward(model), (tokens,)


def mesh_configs(n_devices: int) -> List[Dict[str, int]]:
    """The two factorizations of ``n_devices``, dp first: pp-heavy, then
    sp-heavy (one when they coincide)."""
    from byteps_tpu_torch.parallel.mesh_utils import factorize_mesh

    configs: List[Dict[str, int]] = []
    for want in (("dp", "pp", "tp", "sp"), ("dp", "sp", "tp", "pp")):
        sizes = factorize_mesh(n_devices, want=want)
        for ax in AXES:
            sizes.setdefault(ax, 1)
        if sizes not in configs:
            configs.append(sizes)
    return configs


def dryrun_config(sizes: Dict[str, int]):
    """The dry run's model on a mesh of ``sizes``: d_model 32, 4 heads of
    8 over 2 kv heads, d_ff 64, 2 layers a stage, max_seq 8 a sequence
    rank, 2 experts a sequence rank, 2 microbatches a stage, causal, f32."""
    from byteps_tpu_torch.models.transformer import TransformerConfig

    pp, sp = sizes.get("pp", 1), max(sizes.get("sp", 1), 1)
    return TransformerConfig(
        vocab_size=128, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        n_layers=2 * pp, max_seq=8 * sp, causal=True, moe=True, n_experts=2 * sp,
        compute_dtype=torch.float32, microbatches=2 * pp,
    )


def dryrun_data(cfg, dp: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens, targets, prompt) of a mesh with ``dp`` replicas: 2·dp·
    microbatches sequences, their next tokens (wrapping), and 2·dp prompts
    of 3 tokens, drawn from one numpy seed-0 stream in that order."""
    rng = np.random.default_rng(0)
    batch = 2 * dp * cfg.microbatches
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, cfg.max_seq)).astype(np.int64)
    targets = np.roll(tokens, -1, axis=1)
    prompt = rng.integers(0, cfg.vocab_size, size=(2 * dp, 3)).astype(np.int64)
    return tokens, targets, prompt


def dryrun_one_mesh(sizes: Dict[str, int]) -> Tuple[str, dict]:
    """One train step (AdamW, lr 1e-3, weight decay 1e-4: optax.adamw's)
    and a cached decode of 4 new tokens on the mesh of ``sizes`` over the
    host's group.  Raises unless the loss is finite and the decode keeps
    the prompt and stays in the vocabulary.  Returns (the summary line,
    {"loss", "tokens"})."""
    from byteps_tpu_torch.models.convert import shard_params_from_jax
    from byteps_tpu_torch.models.transformer import (Transformer, build_generate_cached,
                                                     build_train_step, init_params,
                                                     shard_batch)
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    mesh = make_training_mesh(axis_sizes=sizes)
    dp, pp = mesh.axis_size("dp"), mesh.axis_size("pp")
    cfg = dryrun_config(sizes)
    model = Transformer(cfg, device=mesh.device, mesh=mesh)
    model.load_state_dict(shard_params_from_jax(init_params(cfg, seed=0, pp_size=pp), cfg,
                                                mesh))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    tokens, targets, prompt = dryrun_data(cfg, dp)
    tok, tgt = (shard_batch(torch.as_tensor(a), mesh).to(mesh.device)
                for a in (tokens, targets))
    loss = float(build_train_step(model, opt)(tok, tgt))
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun loss not finite: {loss}")
    toks = build_generate_cached(model)(prompt, 4)
    if toks.shape != (2 * dp, 3 + 4):
        raise RuntimeError(f"decode shape {toks.shape}")
    if not (np.array_equal(toks[:, :3], prompt) and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise RuntimeError(f"decode lost its prompt or left the vocabulary: {toks}")
    line = (f"mesh={dict(mesh.shape)} layers={cfg.n_layers} experts={cfg.n_experts} "
            f"seq={cfg.max_seq} microbatches={cfg.microbatches} loss={loss:.4f} "
            f"decode_rows={toks.shape[0]}")
    return line, {"loss": loss, "tokens": toks}


def dryrun_multichip(n_devices: int) -> List[str]:
    """Run :func:`dryrun_one_mesh` on each of :func:`mesh_configs`, on
    every rank of the host's group (``init()`` under the launcher; the
    group's size must be ``n_devices``).  Rank 0 prints "dryrun_multichip
    OK: <line>" a mesh; every rank returns the lines."""
    from byteps_tpu_torch.comm.mesh import require_mesh

    base = require_mesh()
    if base.size != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a group of {base.size} ranks")
    lines = [dryrun_one_mesh(sizes)[0] for sizes in mesh_configs(n_devices)]
    if base.rank == 0:
        for line in lines:
            print(f"dryrun_multichip OK: {line}", flush=True)
    return lines


def _rank_main(n: int, device: str) -> None:
    import byteps_tpu_torch as bps

    bps.init(device=device or None)
    try:
        dryrun_multichip(n)
    finally:
        bps.shutdown()


def main(argv: List[str]) -> int:
    """``dryrun N`` starts N ranks under the launcher; ``dryrun N --rank
    DEVICE`` is one of them ("" binds cuda:<local rank>)."""
    n = int(argv[0]) if argv else 8
    if argv[1:2] == ["--rank"]:
        _rank_main(n, argv[2] if len(argv) > 2 else "")
        return 0
    env = {**os.environ, "BYTEPS_LOCAL_SIZE": str(n), "DMLC_ROLE": "worker",
           "DMLC_NUM_WORKER": "1", "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": "0"}
    env.pop("BYTEPS_FORCE_DISTRIBUTED", None)
    if not torch.cuda.is_available():
        device = "cpu"
    elif torch.cuda.device_count() >= n:
        device = ""  # a GPU a rank, NCCL
    else:
        device, env["BYTEPS_MESH_TRANSPORT"] = "cuda:0", "staged"
    return subprocess.call([sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                            sys.executable, "-m", "byteps_tpu_torch.dryrun", str(n), "--rank",
                            device], env=env)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
