"""Asynchronous training through the parameter-store mode
(``examples/async_training.py`` of the JAX package; BYTEPS_ENABLE_ASYNC).

In async mode the servers hold the parameters: each worker pushes its
weight delta after some local steps and pulls the current global
parameters, with no barrier between workers (stale-gradient SGD).

Run against an async fleet (BYTEPS_ENABLE_ASYNC=1 on the workers and the
servers; README.md has the commands).
"""

from __future__ import annotations

import argparse

import numpy as np

from byteps_tpu_torch.examples._common import add_device_flag


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps

    bps.init(device=args.device)
    if not bps.get_config().enable_async:
        raise SystemExit("set BYTEPS_ENABLE_ASYNC=1 on workers and servers")

    rng = np.random.default_rng(bps.rank())
    n, d = 256, 32
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.ones(d, dtype=np.float32)
    y = X @ w_true
    X, y = torch.from_numpy(X).to(bps.device()), torch.from_numpy(y).to(bps.device())

    # the PS store accumulates deltas; the initial pull seeds local weights
    bps.declare_tensor("AsyncParam.w")
    w = bps.push_pull(torch.zeros(d, device=bps.device()), name="AsyncParam.w",
                      average=False)
    for r in range(args.rounds):
        w_before = w.clone()
        for _ in range(args.local_steps):  # local SGD, no communication
            g = X.T @ (X @ w - y) / n
            w = w - args.lr * g
        # push the delta; pull the global parameter state (the sum of every
        # worker's deltas so far)
        w = bps.push_pull(w - w_before, name="AsyncParam.w", average=False)
        if r % 5 == 0 or r == args.rounds - 1:
            loss = float(torch.mean((X @ w - y) ** 2))
            print(f"round {r:3d} loss {loss:.5f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
