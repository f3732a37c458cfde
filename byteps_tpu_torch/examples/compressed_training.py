"""Gradient compression example: train with onebit, topk, randomk or
dithering, with error feedback and momentum, through the PS path
(``examples/compressed_training.py`` of the JAX package), on
:class:`~byteps_tpu_torch.cross_barrier.CrossBarrierOptimizer`.  The codec
is set through ``declare_tensor``'s kwargs.

Needs a scheduler and servers (``python -m byteps_tpu_torch.server``; see
README.md) and DMLC_* set, or BYTEPS_FORCE_DISTRIBUTED=1 with one worker:

    python -m byteps_tpu_torch.examples.compressed_training --compressor onebit --ef vanilla
"""

from __future__ import annotations

import argparse

import numpy as np

from byteps_tpu_torch.examples._common import add_device_flag


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compressor", default="onebit",
                    choices=["onebit", "topk", "randomk", "dithering"])
    ap.add_argument("--k", default="0.1")
    ap.add_argument("--ef", default="", choices=["", "vanilla"])
    ap.add_argument("--momentum", default="", choices=["", "nesterov"])
    ap.add_argument("--steps", type=int, default=50)
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.cross_barrier import CrossBarrierOptimizer

    bps.init(device=args.device)
    rng = np.random.default_rng(0)
    # least squares: params w fit y = X w*
    n, d = 512, 64
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    y = X @ w_true
    X, y = torch.from_numpy(X).to(bps.device()), torch.from_numpy(y).to(bps.device())

    kwargs = {"byteps_compressor_type": args.compressor, "byteps_compressor_k": args.k}
    if args.ef:
        kwargs["byteps_ef_type"] = args.ef
    if args.momentum:
        kwargs["byteps_momentum_type"] = args.momentum
    bps.declare_tensor("Gradient.w", **kwargs)

    opt = CrossBarrierOptimizer({"w": np.zeros(d, np.float32)}, "sgd", lr=0.01)
    for step in range(args.steps):
        w = opt.params["w"]
        grad = X.T @ (X @ w - y) / n
        opt.backward({"w": grad})
        opt.step()
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(torch.mean((X @ opt.params["w"] - y) ** 2))
            print(f"step {step:3d} loss {loss:.5f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
