#!/usr/bin/env python3
"""How many of a window's hand-kernel launches the profiler's device trace
holds, window after window, on one GPU.

    python3 tools/torch_port_profiler_probe.py [--windows N] [--batch B]

Builds BERT-large at 2 layers (seq 512, bf16, remat, flash attention,
batch 32, the weights of ``init_params(seed=0)``) and opens N profiler
windows of each kind, in turns, in one process.  Each window holds one
forward and backward (4 K1, 2 K2 and 2 K3 launches) while a second host
thread launches small kernels on a side stream, as the engine's codec
does beside a step.  The kinds:

- ``bare``: ``torch.profiler.profile`` with ``start()`` just before the
  step and ``stop()`` after a device wait;
- ``trace``: ``byteps_tpu_torch.profiler.trace``.

For each window it compares the K1-K3 events in ``key_averages()`` with
the launches the wrappers counted, and prints one JSON line per kind: the
windows, those whose device trace held fewer, and the first K1's start
after the window's first host event (ms, the median and the largest).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _device_counts(prof) -> tuple:
    """The K1-K3 events of a window, and the first K1's start (ms) after
    its first host event."""
    from torch.autograd import DeviceType

    counts = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        for name in KERNELS:
            if name in e.key:
                counts[name] += e.count
    events = prof.events()
    host0 = min(e.time_range.start for e in events if e.device_type != DeviceType.CUDA)
    k1 = [e.time_range.start for e in events
          if e.device_type == DeviceType.CUDA and "flash_fwd" in e.name]
    return counts, (min(k1) - host0) / 1e3 if k1 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch

    from byteps_tpu_torch import profiler
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import Transformer, bert_large, init_params
    from byteps_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_port_profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cfg = dataclasses.replace(bert_large(max_seq=512, compute_dtype=torch.bfloat16, remat=True,
                                         use_flash=True), n_layers=2)
    model = Transformer(cfg, device="cuda")
    model.load_state_dict(params_from_jax(init_params(cfg, seed=0), cfg))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(args.batch, 512))
    tok = torch.as_tensor(tokens, device="cuda").long()
    tgt = torch.as_tensor(np.roll(tokens, -1, axis=1), device="cuda").long()

    def step() -> None:
        model.zero_grad(set_to_none=True)
        model.loss(tok, tgt).backward()

    step()
    torch.cuda.synchronize()

    stop = threading.Event()

    def side() -> None:
        stream = torch.cuda.Stream()
        x = torch.zeros(1 << 20, device="cuda")
        with torch.cuda.stream(stream):
            while not stop.is_set():
                x.mul_(0.5).add_(1.0)
                stream.synchronize()

    work = tempfile.mkdtemp(prefix="bps-prof-probe-")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    results = {kind: {"windows": 0, "short": [], "k1_ms": []} for kind in ("bare", "trace")}
    thread = threading.Thread(target=side, daemon=True)
    thread.start()
    try:
        for i in range(args.windows):
            for kind, res in results.items():
                fa.reset_launches()
                torch.cuda.synchronize()
                if kind == "bare":
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                    step()
                    torch.cuda.synchronize()
                    prof.stop()
                else:
                    with profiler.trace(os.path.join(work, str(i)), host_tracing=False) as prof:
                        step()
                counted = {k: fa.launches[k] for k in KERNELS}
                device, k1_ms = _device_counts(prof)
                res["windows"] += 1
                if device != counted:
                    res["short"].append({"window": i, "device": device, "counted": counted})
                if k1_ms is not None:
                    res["k1_ms"].append(k1_ms)
            shutil.rmtree(os.path.join(work, str(i)), ignore_errors=True)
    finally:
        stop.set()
        thread.join()
        shutil.rmtree(work, ignore_errors=True)
    print(card.strip(), flush=True)
    for kind, res in results.items():
        ms = res.pop("k1_ms")
        print(json.dumps({"kind": kind, **res, "short_windows": len(res["short"]),
                          "first_k1_ms_median": statistics.median(ms) if ms else None,
                          "first_k1_ms_max": max(ms) if ms else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
