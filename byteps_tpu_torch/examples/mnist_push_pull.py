"""Minimum end-to-end example: MNIST-style training with push_pull
(``examples/mnist_push_pull.py`` of the JAX package: init ->
broadcast_parameters -> the data-parallel step, SGD).

Runs on one card, in a launcher's local group (each process takes its rows
of the batch), or as a PS worker when DMLC_* is set:

    python -m byteps_tpu_torch.examples.mnist_push_pull [--steps 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from byteps_tpu_torch.examples._common import add_device_flag, host_mesh


def synthetic_mnist(n=512, seed=0, device="cpu"):
    """(x (n, 784) float32, y (n,) int64 labels), the reference's draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    w = rng.normal(size=(784, 10)).astype(np.float32)
    y = np.argmax(x @ w + 0.5 * rng.normal(size=(n, 10)), axis=1).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).long().to(device)


class MLP(torch.nn.Module):
    """784 -> 128 (ReLU) -> 10, its weights from ``default_rng(1)``."""

    def __init__(self, device) -> None:
        super().__init__()
        rng = np.random.default_rng(1)
        w1 = rng.normal(0, 0.05, (784, 128)).astype(np.float32)
        w2 = rng.normal(0, 0.05, (128, 10)).astype(np.float32)
        for name, value in (("w1", w1), ("b1", np.zeros(128, np.float32)),
                            ("w2", w2), ("b2", np.zeros(10, np.float32))):
            self.register_parameter(name, torch.nn.Parameter(torch.from_numpy(value).to(device)))


def loss_fn(model, batch):
    x, y = batch
    h = torch.relu(x @ model.w1 + model.b1)
    logits = h @ model.w2 + model.b2
    return torch.nn.functional.cross_entropy(logits, y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.1)
    add_device_flag(ap)
    args = ap.parse_args()

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.optim import build_data_parallel_step

    bps.init(device=args.device)
    mesh = host_mesh()
    print(f"rank {bps.rank()}/{bps.size()} devices={mesh.size}")

    model = MLP(bps.device())
    # cross-worker sync of the initial params (broadcast_parameters parity)
    bps.broadcast_parameters(model.state_dict(), root_rank=0)

    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    step = build_data_parallel_step(loss_fn, model, opt, mesh=mesh)
    x, y = synthetic_mnist(device=bps.device())
    rows = slice(mesh.rank * len(x) // mesh.size, (mesh.rank + 1) * len(x) // mesh.size)
    batch = (x[rows], y[rows])
    for i in range(args.steps):
        loss = step(batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f}")
    bps.shutdown()


if __name__ == "__main__":
    main()
