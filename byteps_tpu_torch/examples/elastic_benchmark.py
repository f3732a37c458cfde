"""Elastic suspend and resume (``examples/elastic_benchmark.py`` of the
JAX package; the reference's ``elastic_benchmark_byteps.py``): trains,
suspends mid-run, resumes with a topology that may be rewritten, and
checks that the declared keys stay the same across generations.

    python -m byteps_tpu_torch.examples.elastic_benchmark
"""

from __future__ import annotations

import argparse

from byteps_tpu_torch.examples._common import add_device_flag


def main():
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps

    bps.init(device=args.device)
    dev = bps.device()
    print(f"gen 0: rank {bps.rank()}/{bps.size()}")
    names = [f"Gradient.layer{i}" for i in range(8)]
    keys0 = {n: bps.declare_tensor(n) for n in names}
    for step in range(5):
        for n in names:
            bps.push_pull(torch.full((64,), float(step), device=dev), name=n)
    print("gen 0: 5 steps done")

    bps.suspend()
    print("suspended")

    # a real elastic event would change num_workers / global_rank here
    bps.resume(num_workers=bps.size())
    print(f"gen 1: rank {bps.rank()}/{bps.size()}")
    keys1 = {n: bps.declare_tensor(n) for n in names}
    if keys0 != keys1:
        raise AssertionError(f"key assignment must be stable across generations: "
                             f"{keys0} then {keys1}")
    for n in names:
        bps.push_pull(torch.ones(64, device=dev), name=n)
    print("gen 1: keys stable, traffic OK")
    bps.shutdown()


if __name__ == "__main__":
    main()
