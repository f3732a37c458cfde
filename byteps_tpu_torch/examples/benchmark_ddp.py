"""Synthetic throughput benchmark, img/s or samples/s
(``examples/benchmark_ddp.py`` of the JAX package; the reference's
``benchmark_byteps.py``): ResNet-50 or VGG-16 in bf16 on the
batch-statistics data-parallel step with SGD momentum 0.9, or BERT-large
at seq 128 (bf16, dense attention, remat) with AdamW 1e-4.  Three warm-up
steps, then a timed window that ends in a device sync.

    python -m byteps_tpu_torch.examples.benchmark_ddp --model resnet50 --batch 64
    python -m byteps_tpu_torch.examples.benchmark_ddp --model vgg16
    python -m byteps_tpu_torch.examples.benchmark_ddp --model bert_large --batch 32

Under the launcher the host's group is data-parallel: each process takes
its rows of the batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from byteps_tpu_torch.examples._common import add_device_flag, host_mesh

WARMUP_STEPS = 3


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's rows of a batch (all of it with one process)."""
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _ce(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def conv_step(model_name: str, batch: int, hw: int = 224, state_dict=None):
    """The conv benchmark's step on the bound device: (step, this process's
    batch), the model's weights drawn (seed 0) unless ``state_dict`` is
    given, the images and labels from ``default_rng(0)``."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.resnet import ResNet50
    from byteps_tpu_torch.models.vgg import VGG16
    from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step

    dev = bps.device()
    model = (ResNet50(dtype=torch.bfloat16, seed=0) if model_name == "resnet50"
             else VGG16(dtype=torch.bfloat16, image=hw, seed=0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 1000, size=(batch,)).astype(np.int32)
    mesh = host_mesh()
    data = (_rows(torch.from_numpy(x).to(dev), mesh),
            _rows(torch.from_numpy(y).long().to(dev), mesh))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = build_batchnorm_data_parallel_step(_ce, model, opt, mesh=mesh)
    return step, data


def bert_step(batch: int, n_layers: int = 24):
    """The BERT benchmark's step on the bound device: (step, tokens,
    targets), BERT-large at seq 128 (bf16, dense attention, remat) cut to
    ``n_layers``, its weights ``init_params(cfg, seed=0)``, the tokens from
    ``default_rng(0)``; data-parallel over the host's group."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.models.convert import params_from_jax, shard_params_from_jax
    from byteps_tpu_torch.models.transformer import (
        Transformer, bert_large, build_train_step, init_params, shard_batch,
    )
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    cfg = dataclasses.replace(bert_large(max_seq=128, compute_dtype=torch.bfloat16),
                              n_layers=n_layers)
    dev = bps.device()
    mesh = None
    if get_global_mesh() is not None:  # data-parallel over the host's group
        n = get_global_mesh().size
        mesh = make_training_mesh(n, {"dp": n, "pp": 1, "sp": 1, "tp": 1})
    params = init_params(cfg, seed=0)
    model = Transformer(cfg, device=dev, mesh=mesh)
    model.load_state_dict(params_from_jax(params, cfg) if mesh is None
                          else shard_params_from_jax(params, cfg, mesh))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = build_train_step(model, opt)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, 128)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    tokens, targets = (shard_batch(torch.from_numpy(a).long().to(dev), mesh)
                       for a in (tokens, targets))
    return step, tokens, targets


def _timed(step, args: tuple, batch: int, steps: int) -> tuple:
    """WARMUP_STEPS steps, then ``steps`` timed ones ending in a device
    sync: (samples a second, the last loss)."""
    for _ in range(WARMUP_STEPS):
        loss = step(*args)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(*args)
    final = float(loss)  # waits for the device: the window ends here
    return batch * steps / (time.perf_counter() - t0), final


def bench_conv(model_name: str, batch: int, steps: int, hw: int = 224) -> tuple:
    """(img/s, the last loss) of the conv benchmark."""
    step, data = conv_step(model_name, batch, hw)
    return _timed(step, (data,), batch, steps)


def bench_bert(batch: int, steps: int) -> tuple:
    """(samples/s, the last loss) of the BERT benchmark."""
    step, tokens, targets = bert_step(batch)
    return _timed(step, (tokens, targets), batch, steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50",
                    choices=["resnet50", "vgg16", "bert_large"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    add_device_flag(ap)
    args = ap.parse_args()

    import byteps_tpu_torch as bps

    bps.init(device=args.device)
    cuda = bps.device().type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if args.model == "bert_large":
        rate, loss = bench_bert(args.batch, args.steps)
    else:
        rate, loss = bench_conv(args.model, args.batch, args.steps)
    unit = "samples/s" if args.model == "bert_large" else "img/s"
    print(f"{args.model}: {rate:.1f} {unit} "
          f"(batch {args.batch}, rank {bps.rank()}/{bps.size()})")
    peak = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda else "not measured"
    print(f"{args.model}: {args.batch / rate * 1e3:.2f} ms a step, final loss {loss:.4f}, "
          f"peak device memory {peak}")
    bps.shutdown()


if __name__ == "__main__":
    main()
