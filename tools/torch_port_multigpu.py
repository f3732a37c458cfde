#!/usr/bin/env python3
"""The port's host-level group over NCCL on every GPU of one host.

    python3 tools/torch_port_multigpu.py

Run from the repository root on a host with two or more GPUs.  It starts
`python -m byteps_tpu_torch.launcher.launch` (one process per GPU, the count
discovered by the launcher), which runs this file with `--rank DIR` in each
process.  Each process calls init(), which brings up the host's group over
NCCL on cuda:<local rank>, and then:

  1. the collectives on every rank's seeded input against numpy's sums (f32
     within rtol 1e-6 + atol 1e-6; all_gather and broadcast bitwise), the
     host-level push_pull against the plain average, and the int8 ring: its
     replicas bitwise equal, zero input exact, within the reference test's rms
     bound (0.03) of the dense sum;
  2. build_data_parallel_step and build_zero1_step (SGD, lr 3e-4, 3 steps) on
     2 layers at BERT-large's widths in f32, each rank on its share of 8
     sequences: the replicas bitwise equal, and within atol 1e-5 + rtol 1e-4
     of one process on all 8 (local rank 0 runs it on its GPU afterwards);
  3. times, with CUDA events, an all-reduce over the group of BERT-large's
     float32 gradient (365,258,752 elements, 1,461,035,008 bytes) and the int8
     ring on the same tensor (median of 5 after 2 warm-up calls).

The parent prints the card's name and power limit, each rank's results and
one JSON line, and exits non-zero if a check failed.  Nothing here measures
the PS plane: the group is one host's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_ELEMENTS = 365_258_752  # BERT-large's parameters
LAYERS, BATCH, STEPS, LR = 2, 8, 3, 3e-4
ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed: int, n: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


def _events_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rank_main(out_dir: str) -> None:
    import torch

    sys.path.insert(0, REPO)
    import byteps_tpu_torch as bps
    import chip_smoke as cs
    from byteps_tpu_torch.comm import collectives as C
    from byteps_tpu_torch.comm.mesh import require_mesh
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops.quantized_allreduce import quantized_psum
    from byteps_tpu_torch.optim import build_data_parallel_step, build_zero1_step

    torch.backends.cuda.matmul.allow_tf32 = False
    bps.init()
    mesh = require_mesh()
    r, n, dev = mesh.rank, mesh.size, bps.device()
    out = {"rank": r, "size": n, "device": str(dev), "backend": mesh.backend,
           "name": torch.cuda.get_device_name(dev), "errors": {}, "failed": []}

    def mine(seed, shape):
        return torch.from_numpy(_inputs(seed, n, shape)[r]).to(dev)

    def check(name, got, want, exact=False):
        got = got.detach().cpu().numpy()
        err = float(np.abs(got - want).max()) if got.size else 0.0
        out["errors"][name] = err
        ok = (np.array_equal(got, want) if exact
              else np.allclose(got, want, rtol=1e-6, atol=1e-6))
        if not ok:
            out["failed"].append(f"{name}: max abs err {err:.3e}")

    for i, shape in enumerate([(7,), (3, 5)]):
        xs = _inputs(10 + i, n, shape)
        x = mine(10 + i, shape)
        for mode in ("psum", "scatter_gather"):
            check(f"push_pull {shape} {mode} average", C.push_pull(x, mode=mode), xs.mean(0))
            check(f"push_pull {shape} {mode} sum", C.push_pull(x, average=False, mode=mode),
                  xs.sum(0))
    xs = _inputs(20, n, (3 * n, 2))
    check("reduce_scatter", C.reduce_scatter(mine(20, (3 * n, 2))),
          xs.mean(0)[3 * r:3 * r + 3])
    check("all_gather", C.all_gather(mine(21, (3, 2))),
          _inputs(21, n, (3, 2)).reshape(3 * n, 2), exact=True)
    check("broadcast", C.broadcast(mine(22, (6,)), root=n - 1), _inputs(22, n, (6,))[n - 1],
          exact=True)
    tree = C.push_pull_tree({"a": mine(23, (5,)), "b": mine(24, (2, 3))})
    check("push_pull_tree a", tree["a"], _inputs(23, n, (5,)).mean(0))
    check("push_pull_tree b", tree["b"], _inputs(24, n, (2, 3)).mean(0))
    check("host-level push_pull", bps.push_pull(mine(40, (11,)), name="host.level"),
          _inputs(40, n, (11,)).mean(0))

    ring = quantized_psum(mine(30, (5000,)), axis_size=n)
    replicas = C.all_gather(ring[None])
    if not all(torch.equal(replicas[i], replicas[0]) for i in range(n)):
        out["failed"].append("int8 ring: the replicas differ")
    dense = _inputs(30, n, (5000,)).sum(0)
    rms = float(np.sqrt(((ring.cpu().numpy() - dense) ** 2).mean() / (dense ** 2).mean()))
    out["errors"]["int8 ring rms"] = rms
    if not rms < 0.03:
        out["failed"].append(f"int8 ring: rms {rms:.3e} from the dense sum")
    if not bool((quantized_psum(torch.zeros(512, device=dev)) == 0).all()):
        out["failed"].append("int8 ring: zero input not exact")

    # the step builders against one process on the whole batch
    per = BATCH // n
    rows = slice(r * per, (r + 1) * per)

    def model():
        _, m, tok, tgt = cs._bert(LAYERS, batch=BATCH, compute_dtype=torch.float32,
                                  remat=False)
        return m, tok, tgt

    def loss_fn(m, batch):
        return m.loss(*batch)

    results = {}
    m, tok, tgt = model()
    step = build_data_parallel_step(loss_fn, m, torch.optim.SGD(m.parameters(), lr=LR))
    for _ in range(STEPS):
        step((tok[rows], tgt[rows]))
    results["build_data_parallel_step"] = m
    m, _, _ = model()
    init_fn, step = build_zero1_step(loss_fn, m, lambda ps: torch.optim.SGD(ps, lr=LR))
    init_fn()
    for _ in range(STEPS):
        step((tok[rows], tgt[rows]))
    results["build_zero1_step"] = m
    for name, m in results.items():
        digest = torch.frombuffer(bytearray.fromhex(cs._param_digest(m)), dtype=torch.uint8)
        every = C.all_gather(digest.to(dev)[None])
        if not all(torch.equal(every[i], every[0]) for i in range(n)):
            out["failed"].append(f"{name}: the replicas differ")
    if r == 0:
        ref, _, _ = model()
        ref_step = build_train_step(ref, torch.optim.SGD(ref.parameters(), lr=LR))
        for _ in range(STEPS):
            ref_step(tok, tgt)
        with torch.no_grad():
            for name, m in results.items():
                worst = max(float(((a - b).abs() - RTOL * b.abs()).max())
                            for a, b in zip(m.parameters(), ref.parameters()))
                out["errors"][f"{name} vs one process"] = worst
                if not worst <= ATOL:
                    out["failed"].append(f"{name}: {worst:.3e} beyond atol {ATOL} + rtol "
                                         f"{RTOL} of one process on the whole batch")
        del ref, ref_step
    del results, m, step
    torch.cuda.empty_cache()

    # the gradient's all-reduce over NVLink, dense and on the int8 ring
    g = torch.randn(GRAD_ELEMENTS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(r))
    out["allreduce_ms"] = _events_ms(lambda: C.push_pull(g, average=False))
    out["int8_ring_ms"] = _events_ms(lambda: quantized_psum(g))
    bps.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)


def main() -> int:
    import tempfile

    import torch

    if torch.cuda.device_count() < 2:
        print("torch_port_multigpu: needs two or more GPUs", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        env = {**os.environ, "DMLC_ROLE": "worker", "PYTHONPATH": REPO}
        rc = subprocess.call(
            [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--", sys.executable,
             os.path.abspath(__file__), "--rank", out_dir], cwd=REPO, env=env, timeout=900)
        ranks = []
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                ranks.append(json.load(f))
    n = torch.cuda.device_count()
    nbytes = 4 * GRAD_ELEMENTS
    failed = [f"rank {x['rank']}: {msg}" for x in ranks for msg in x["failed"]]
    if rc != 0 or len(ranks) != n:
        failed.append(f"the launcher exited {rc} with {len(ranks)} of {n} ranks' results")
    for x in ranks:
        bus = nbytes / (x["allreduce_ms"] / 1e3) * 2 * (n - 1) / n / 1e9
        print(f"rank {x['rank']} of {x['size']} on {x['device']} ({x['name']}, {x['backend']}): "
              f"all-reduce of {nbytes} bytes {x['allreduce_ms']:.3f} ms (bus {bus:.1f} GB/s), "
              f"int8 ring {x['int8_ring_ms']:.3f} ms; max errors "
              + ", ".join(f"{k} {v:.3e}" for k, v in x["errors"].items()), flush=True)
    print(json.dumps({"card": card, "gpus": n, "ranks": ranks, "failed": failed}), flush=True)
    if failed:
        print("torch_port_multigpu: FAIL: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    else:
        raise SystemExit(main())
