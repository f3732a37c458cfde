"""BERT/GPT training with 4-D parallelism, dp x pp x sp x tp, and expert
parallelism on the sp axis with ``--moe`` (``examples/bert_4d_parallel.py``
of the JAX package).  The mesh is the host's group of processes, one a
card (or several on one card over the staged transport):

    DMLC_ROLE=worker DMLC_NUM_WORKER=1 DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000 \\
        BYTEPS_LOCAL_SIZE=4 BYTEPS_MESH_TRANSPORT=staged \\
        python -m byteps_tpu_torch.launcher.launch -- \\
        python -m byteps_tpu_torch.examples.bert_4d_parallel --dp 1 --pp 2 --sp 2 --tp 1
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from byteps_tpu_torch.examples._common import add_device_flag, say


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--moe", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.models.convert import params_from_jax, shard_params_from_jax
    from byteps_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, build_train_step, init_params, shard_batch,
    )
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device=args.device)
    n = args.dp * args.pp * args.sp * args.tp
    group = get_global_mesh()
    if (group.size if group else 1) != n:
        raise SystemExit(
            f"need {n} processes for the mesh; have {group.size if group else 1} (run "
            f"under python -m byteps_tpu_torch.launcher.launch with BYTEPS_LOCAL_SIZE={n})")
    axes = {"dp": args.dp, "pp": args.pp, "sp": args.sp, "tp": args.tp}
    mesh = make_training_mesh(n, axes) if group is not None else None
    cfg = TransformerConfig(
        vocab_size=1024, d_model=args.d_model, n_heads=4,
        d_head=args.d_model // 4, d_ff=args.d_model * 4,
        n_layers=args.layers, max_seq=args.seq, causal=True,
        moe=args.moe, n_experts=2 * args.sp,
    )
    say(f"mesh {mesh.shape if mesh else axes}  layers={cfg.n_layers} moe={cfg.moe}")
    params = init_params(cfg, pp_size=args.pp)
    model = Transformer(cfg, device=bps.device(), mesh=mesh)
    model.load_state_dict(params_from_jax(params, cfg) if mesh is None
                          else shard_params_from_jax(params, cfg, mesh))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    step = build_train_step(model, opt)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(args.batch, args.seq)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    tokens, targets = (shard_batch(torch.from_numpy(a).long().to(bps.device()),
                                   model.mesh) for a in (tokens, targets))
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = step(tokens, targets)
        say(f"step {i} loss {float(loss):.4f}")
    say(f"{args.batch * args.steps / (time.perf_counter() - t0):.1f} samples/s")
    bps.shutdown()


if __name__ == "__main__":
    main()
