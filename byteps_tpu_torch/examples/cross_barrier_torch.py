"""Cross-barrier training: no per-step gradient barrier
(``examples/cross_barrier_torch.py`` of the JAX package, the reference's
``benchmark_cross_barrier_byteps.py`` pattern).  Backward hooks start one
async push_pull per parameter (front layers first) and the next forward's
module pre-hooks wait only for that module's own parameters, so step N+1's
front layers compute while step N's back-layer gradients are on the wire.

One process (the PS hop is the identity):

    python -m byteps_tpu_torch.examples.cross_barrier_torch --steps 30

As a PS worker: set DMLC_* and run it unchanged.
"""

from __future__ import annotations

import argparse
import time

from byteps_tpu_torch.examples._common import add_device_flag


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--opt", default="sgd", choices=["sgd", "adam", "rmsprop"])
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.cross_barrier import CrossBarrier

    bps.init(device=args.device)
    torch.manual_seed(0)
    layers = []
    for _ in range(args.depth):
        layers += [torch.nn.Linear(args.width, args.width), torch.nn.ReLU()]
    layers.append(torch.nn.Linear(args.width, 10))
    model = torch.nn.Sequential(*layers).to(bps.device())
    opt = CrossBarrier(model, args.opt, lr=0.05)

    g = torch.Generator().manual_seed(1)
    x = torch.randn(args.batch, args.width, generator=g).to(bps.device())
    y = (0.1 * torch.randn(args.batch, 10, generator=g)).to(bps.device())

    t0 = time.perf_counter()
    # the canonical loop: no optimizer.step(), no zero_grad: the next
    # forward's pre-hooks wait and apply per module, and CrossBarrier
    # zeroes each gradient as it consumes it
    for step in range(args.steps):
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[rank {bps.rank()}] step {step:3d} "
                  f"loss {float(loss.detach()):.6f}")
    opt.step()  # final barrier before leaving the loop
    dt = (time.perf_counter() - t0) / args.steps
    print(f"[rank {bps.rank()}] {dt * 1e3:.2f} ms/step, "
          f"{opt.outstanding()} handles outstanding (must be 0)")
    bps.shutdown()


if __name__ == "__main__":
    main()
