#!/usr/bin/env python3
"""Smoke test of byteps_tpu_torch on one NVIDIA GPU (built for the H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from byteps_tpu_torch/ops/csrc, one compiler process per
     source, all started together: flash attention (K1-K3) and the onebit packer
     (K4) with nvcc, the wire checksum with the host C compiler, and the native
     lanes and host codecs (byteps_tpu_torch/native/csrc) with g++; print what
     ptxas says of registers, spills and wgmma, and fail if it serialized wgmma;
  3. hold each flash kernel against its plain PyTorch version on the card
     (BERT-large's attention shape in bf16 and f32, a causal case, a ragged S,
     each head dim, and for the bf16 dh=64 kernels S at and around their tile
     edges: K1's and K2's 128 query rows and 64-key tiles, K3's 128 keys and
     64-row query tiles; causal and not; two launches of K1, K2 and K3 bitwise
     equal), and time kernel, plain version and the library call (K1 in turns
     with SDPA's forward, K2 and K3 each in turns with SDPA's whole backward);
  4. hold K4 against its plain version on the card (words bitwise, scale within
     rtol 1e-6 and bitwise the same across launches) for n from 1 to 1,024,000,
     n = 1, 2, 3 (mod 4) near a full partition, and views starting 4, 8 and 12
     bytes past a 16-byte boundary, on inputs with +-0.0, +-inf, NaNs of both
     signs and denormals; two inputs packed at the same time on two streams,
     each bitwise its own sequential launch; time it at one full partition
     (1,024,000 elements): its device time with L2 cold (median of 20, CUDA
     events around the launch alone, cross-checked with torch.profiler) and
     the wrapper's back-to-back call time;
  5. F1: common.types.divide and the engine's average over 3 workers equal the
     CPU's division bitwise on the card (over 3, 6 and 7; float32 and bfloat16);
     agreement of a 2-layer BERT-large-width model on the card (kernels) with the
     same model on the CPU (plain versions) in f32, and in bf16 no further from f32
     than dense attention;
  6. the main path: BERT-large (seq 512, bf16, remat, flash attention) trained for a
     few steps through init -> broadcast_parameters -> DistributedOptimizer(AdamW),
     with the kernels' launch counts read around it; before it, at full depth on
     the same weights and tokens, the kernels' bf16 logits no further from f32
     than dense bf16 attention's;
  7. the distributed path: the same model on one worker whose gradients go
     through a scheduler and two PS servers, each a `python -m
     byteps_tpu_torch.server` process, with 1-bit compression (scaling) of every
     float32 gradient of at least 64 KiB packed on the card by K4; launches,
     device-to-host and wire bytes are read around it and checked against the
     engine's partition table, and every round of one onebit partition against
     a CPU replay of the servers' codec; the step is split (forward and
     backward, the wait for pulls, AdamW; forward and backward with the engine
     idle; the engine alone) and, by the engine's stage timers, by stage
     (stage_dwell_seconds), with the worker's round trips and the servers'
     sum and publish histograms (from their stop reports);
     then the same on the native lanes: the servers' data plane in C++
     (BYTEPS_SERVER_NATIVE=1) and the worker's client lanes
     (BYTEPS_NATIVE_CLIENT=1), 2 timed steps, the first step's loss bitwise
     the Python lanes', and each half alone for 1 at 2 layers, its first
     loss bitwise the same model's forward without the PS;
  8. the compressed chain: the same model at full depth through a scheduler and
     two server processes with BytePS's documented compression config (onebit,
     error feedback, Nesterov momentum, scaling) and its lr set before the first
     step; error-feedback chains take the host lane, so the whole raw gradient
     crosses device to host while the wire carries the bare-onebit run's bytes;
     each server reports the lr it applied, and the first compressed payload is
     bitwise a CPU replay of the chain;
  9. the device topk and dithering lanes (2 layers at BERT-large's widths, so the
     partitions stay full size): only their payloads cross device to host; on
     the card, topk on tied magnitudes bitwise its CPU plain version and the
     host codec, dithering decoded bitwise by the host codec and unbiased; each
     timed at one full partition beside its bytes bound;
 10. randomk with error feedback on the host lane (2 layers), its first payload
     bitwise a CPU replay;
 11. DistributedDataParallel and CrossBarrier (2 layers, f32): DDP + AdamW
     bitwise DistributedOptimizer + AdamW, CrossBarrier(adam) within 1e-6 of
     torch.optim.Adam, and two backward passes in a row pushing the accumulated
     gradient, not zeros;
 12. the hybrid path: a scheduler, two servers and two hosts, each `python -m
     byteps_tpu_torch.launcher.launch` at BYTEPS_LOCAL_SIZE=1 on this card
     (DMLC_NUM_WORKER=2, each host a one-rank NCCL group: NCCL takes one rank
     of a group per GPU), each host running `chip_smoke.py --hybrid-host`,
     whose init() brings the group up from the launcher's rendezvous: the
     one-rank collectives bitwise their inputs; 2 layers in f32 through
     HybridDataParallel (SGD, 4 sequences a host), the hosts bitwise equal to
     each other and to one process averaging the two halves' gradients, and
     within atol 1e-5 + rtol 1e-4 of one process on the combined batch;
     BERT-large at 2 layers (widths kept), 16 sequences a host, through
     DistributedOptimizer(AdamW) with bare onebit: the global batch's loss
     falling, the hosts' parameters bitwise equal, bytes against the
     partition table, K1-K4 launched, two pushes summed into every server
     round, and every round of one partition's pull bitwise a CPU replay of
     the servers' decode, sum and re-sign of the two hosts' pushes;
 13. the int8 ring's quantize and dequantize on one full partition: bitwise
     their CPU run, timed with L2 cold beside their bytes bounds;
 14. the step builders (build_data_parallel_step, build_zero1_step,
     accumulate_steps=2, grad_quant_bits=8) at one rank of an NCCL group, 2
     layers, f32: within 1e-6 of DistributedOptimizer at one worker;
 15. small-tensor fusion (after phase 7; 2 layers, widths kept): BERT-large
     through one worker and two servers with bare onebit, on the Python
     lanes and on the native lanes, each unfused and fused
     (BYTEPS_FUSION_THRESHOLD=131072: every partition fits) in turns: the
     parameters bitwise the unfused run's, K4 once a compressed partition a
     step, the
     warm-up step's onebit payloads bitwise, the same bytes; fused frames
     a step, keys a frame, the stage split with FUSE's dwell, and the step
     beside the unfused one;
 16. the server-side optimizer: DistributedOptimizer(None,
     server_side=True, server_rule="adam") at 2 layers through two
     Python servers, every round of six tensors' partitions bitwise a CPU
     replay of update_rules.Adam, falling losses, no optimizer state on
     the worker; the round journal's copy of these raw f32 pushes, steps
     in turns with it on and off; against native servers the worker raises
     at its first INIT;
 17. async (2 layers, widths kept): server-wide (BYTEPS_ENABLE_ASYNC=1) on
     Python and on native servers, one worker with local AdamW pushing weight
     deltas: every
     pulled store the sum of its deltas, the parameters bitwise AdamW with
     the store's rounding done on the card and within ASYNC_ATOL of bare
     AdamW; per key at staleness bound 1 on two launcher hosts, one of
     them lagging two rounds behind in two steps: finite losses, pulls
     parked by the servers, no pull answered beyond the bound;
 18. faults (after phase 7, whose run it is held to): the distributed path on
     the Python lanes under BYTEPS_VAN=chaos:tcp, every fault kind (drop,
     delay, disconnect, truncate, corrupt, payload flip) at 0.001 a frame on
     the worker's frames and the servers' replies, the RPC deadline at 1 s:
     losses and parameters bitwise the fault-free run's, every kind fired,
     retries, revivals and the servers' dedupes counted, no step degraded;
     phase 7 also times steps in turns with the round journal on and off,
     and the journal's copy a step;
 19. the one-sided heal (2 layers, widths kept): two launcher hosts through
     two Python servers, host 1 losing every push to one server in one step
     until its single retry gives up: its client heals in place (RESYNC, the
     journaled rounds replayed), no step degrades, no init barrier runs, and
     both hosts are bitwise their fault-free runs and each other;
 20. elastic membership, phase (c) (2 layers, widths kept): a scheduler,
     two Python servers (a third waiting) and two launcher hosts with a
     probe key summed exactly at every step: both hosts; host 1 suspended
     and host 0 alone; both again, host 1's keys unchanged and its device
     and pinned memory not grown across the suspend; three servers (keys
     re-homed, the init barriers run again) and back to two (the dropped
     server exits on SHUTDOWN); the scheduler killed and restarted between
     two steps, bitwise the same steps without it, every node reconnected
     and rejoined above its last epoch with no eviction; host 1 killed and
     host 0's next step completed once it was evicted; each stage's ms,
     launches, d2h bytes and time to recover printed;
 21. online resharding, phase (d) (2 layers, widths kept): a scheduler, two
     Python servers and a third started on demand, all with
     BYTEPS_ELASTIC_RESHARD=1, one worker: 2 steps at two servers, a
     scale-up to three asked from a second thread once the step's first
     partitions were pushed, 2 steps at three, a drain back to two (the
     third server ships its keys and exits 0 by itself), 2 steps; with bare
     onebit, and with DistributedOptimizer(None, server_side=True,
     server_rule="adam") on raw f32: losses and parameters bitwise a fleet
     that never resizes, no re-init (server_generation 0), the keys the
     servers shipped each way equal to the keys whose ring owner differs
     between the two rank sets, no optimizer state on the worker; each
     wave's wall ms, keys and bytes, and the steps' ms beside the
     no-resize run's;
 22. the control plane, phase (e): adaptive compression and the autotuner
     (``train_control``);
 23. the rest of the data plane, phase (f) (after phase 15, whose unfused
     Python-lane run on tcp is its baseline; 2 layers, widths kept).
     (f1) the uds and shm vans: that run on Python servers over shm, on C++
     servers over uds with the native client, and on C++ servers over shm
     with the Python lanes: losses and parameters bitwise tcp's, K1-K4 and
     wire bytes as on tcp, no socket or ring file left, the step and the
     round trips beside tcp's; the host's machine name printed (the shm van
     refuses any but x86-64).  (f2) row-sparse push_pull and lossless
     frames: two launcher hosts of 16 sequences through two Python servers
     under BYTEPS_COMPRESSION_AUTO=1 and BYTEPS_WIRE_LOSSLESS=1, the
     embedding's gradient pushed each step dense (a topk of k = 0.5, off
     from registration, its raw pushes probed and sent as lossless
     containers) and row-sparse at the host's tokens: the rows bitwise the
     dense result's, the hosts bitwise, every dense partition probed under
     the entropy cutoff and every dense push flagged; rows, payload bytes
     and the container's bytes against raw printed;
 24. model parallelism, phase (h) (after phase (g), its fleet and ranks
     started before the fusion phase; ``train_model_parallel``):
     K1-K3 at the phase's shapes against their plain versions, then one
     launcher host of four ranks on this card over the staged transport
     (BYTEPS_MESH_TRANSPORT=staged), a scheduler and two Python servers:
     BERT-large at 4 layers on {pp:2, tp:2} (4 microbatches), GPT-2 medium
     at 2 layers on {sp:2, tp:2} (the ring of flash hops, and Ulysses),
     BERT-large at 2 layers on {dp:2, tp:2} and on {dp:2, pp:2} (one layer
     a stage, 2 microbatches) through HybridDataParallel and the servers,
     each rank holding its shards of init_params(seed=0): every run's
     losses within 2e-2 of one process of the same model on the card, one
     f32 step of the first two at 2 layers within atol 1e-6 + rtol 1e-5
     per parameter gathered, K1-K3 launched a step on every rank as its
     coordinates say, the hybrids' keys the reference's tree (a layer
     parameter stacked (pp, layers a stage, ...)) and their pulls bitwise
     the host's sum;
 25. mixture-of-experts and generation, phase (i) (on phase (h)'s host;
     ``_moe_generation``), GPT-2 medium's widths, experts at the
     reference's defaults (8, top-2, capacity factor 2.0, aux 0.01): K1-K3
     at the phase's shapes against their plain versions; (i1) 4 layers in
     one process, 2 AdamW steps on 8 sequences: losses finite and falling,
     the drops per layer and step, K1-K3 as depth and remat say, and one
     f32 step at 2 layers per parameter against the CPU's; (i2) 2 layers on
     {sp:2, tp:2}, 4 experts a rank: at no-drop capacity without the aux
     term within 2e-2 of one process (and one f32 step per parameter), at
     the defaults finite and falling; (i3) the no-drop model on {dp:2,
     sp:2} through HybridDataParallel and the servers, the experts pushed
     whole, every pull bitwise the host's sum; (i4) dense at 2 layers, 8
     prompts of 128, 64 new greedy: in f32 the builders' tokens (recompute
     on K1, and the KV cache) equal on the card and to the CPU's, bf16
     prefill logits within the model check's rule of f32 (at 24 layers:
     phase (l)'s (l4)); (i5) the f32 expert model's cached decode
     on {sp:2, tp:2} and {pp:2, tp:2} equal to one process's; (i6)
     ``byteps_tpu_torch.dryrun.dryrun_multichip(4)`` on the host's ranks;
 26. the observability plane, phase (j) (``train_observability``; 2
     layers, widths kept): one worker, a Python server and a C++ one, bare
     onebit, fusion at 131072, BYTEPS_TRACE_ON with the envelopes' window
     over the timed steps, BYTEPS_METRICS_PORT on the worker and the
     scheduler, BYTEPS_JOB_SLO_S under the step with BYTEPS_FLIGHT_UPLOAD,
     3 steps (the last under ``profiler.trace``) and one untraced: (j1) the
     first loss bitwise the same model's forward without the PS; (j2)
     tools/trace_merge.py, run as a tool over the worker's and both
     servers' trace files, counts no orphan, every worker PUSH/PULL span
     and FUSED_RPC has server children, the C++ server's tagged
     ``engine: "native"``; (j3) the profiled step's device trace holds
     K1-K4 4, 2, 2 and 99 times; (j4) both endpoints serve the round trips
     and the stage dwell, read by tools/bps_top.py --once; (j5) slo_breach
     fired, its bundle holds its files, tools/bps_doctor.py --json
     diagnoses it, its upload is in the scheduler's flight directory; (j6)
     the traced step's wall beside the untraced one's;
 27. the training kit and the conv models, phase (k) (``train_kit``):
     (k1) ResNetTiny f32, one batch-statistics step on the card within
     1e-4 of the CPU's; ResNet-50 at 224x224, 1000 classes, bf16, batch 64,
     3 SGD-momentum steps through ``build_batchnorm_data_parallel_step``,
     losses finite and falling, ms a step, samples/s and peak memory;
     ResNet-18 on two ranks of the card (staged), one step: the running
     statistics bitwise equal on both ranks and the mean of their own;
     (k2) BERT-large at 24 layers, flash, batch 32, bf16 parameters under
     master_weights(AdamW) and dynamic_loss_scale, the batches through
     ShardedDataset and prefetch_to_device, 4 steps, one forced to
     overflow (parameters, masters and AdamW's state bitwise unchanged,
     the scale halved), K1-K3 48/24/24 a step; (k3) VGG-16 at 224x224,
     bf16, two launcher hosts of 32 images, two Python servers, bare
     onebit: host 0's checkpoint and shard, host 1 from zeros through
     restore_and_broadcast (digests equal, read_shard host 0's bytes),
     BroadcastGlobalVariables, LearningRateWarmup and MetricAverage over
     disjoint shards, 2 steps on plain links, then the link shaped
     (BYTEPS_VAN_RATE_MBYTES_S, BYTEPS_VAN_DELAY_MS; the servers on a cue,
     the hosts through suspend and resume) for 3: the hosts bitwise equal
     after each step, the metric equal, K4 launched a step once a
     partition of at least 64 KiB, the shaped step at least its bytes to
     a server over the rate;
 28. GPT-2 medium from a HuggingFace checkpoint, phase (l) (``train_hf_gpt2``;
     on the card while phase (i)'s host runs): the published widths (HF's
     gpt2-medium config: 24 layers, 1024 wide, 16 heads, 1024 positions,
     vocab 50257, gelu_new, eps 1e-5), a checkpoint in HF's key names and
     layouts drawn from numpy seed 0 by a child started before fusion, nothing
     downloaded and no ``transformers``: (l1) imported by
     ``models.hf_import.load_gpt2_weights`` on a duck-typed model, every
     parameter bitwise its HF tensor; (l2) an independent plain-torch GPT-2
     forward in f32 at 24 layers on 2 sequences of 1024, the port's f32 model
     within 1e-3 of it, its bf16 logits through K1 within 1.25 times dense
     attention's distance; (l4) greedy decoding, both builders' f32 tokens at
     2 layers equal to the independent forward's, at 24 layers in bf16
     tokens a second and K1's launches; (l3) 3 AdamW steps of 8 sequences of
     1024 through init -> DistributedOptimizer, bf16 on K1-K3 with the
     attention biases: falling losses, the first within 2e-2 of the
     independent forward's f32 loss, K1-K3 24/24/24 a step;
 29. one JSON line listing the kernels, then the contract line
     {"ok": true, "device": {...}} last.

`python3 chip_smoke.py --hybrid-host <dir>` is phase 12's host,
`--async-host <dir>` phase 17's, `--heal-host <dir>` phase 19's,
`--elastic-host <dir>` phase 20's, `--control-host <dir>` phase 22's,
`--rowsparse-host <dir>` phase 23's, `--tenant-host <dir>` phase (g)'s,
`--mp-host <dir>` phase 24's, `--conv-host <dir>` phase (k1)'s and
`--vgg-host <dir>` phase (k3)'s ranks, which the launcher runs; they are
not run by hand.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import gc
import glob
import json
import math
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# main path: BERT-large at seq 512, batch 32
BATCH, SEQ, STEPS, WARMUP = 32, 512, 5, 1
N_LAYERS_FULL = 24
# distributed path: the same model, fewer timed steps (each crosses the
# servers; 2 since the observability phase (j) joined, 3 before)
DIST_STEPS, DIST_WARMUP = 2, 1
# the distributed path on the native lanes (both halves C++), and each half
# alone (6 and 3 timed steps before the self-healing plane's phases joined;
# the halves at 1 from 2 since the data plane's phase (f) joined; the whole
# at 2 from 3, the halves at NATIVE_HALF_LAYERS from 24, since the model
# parallelism's expert and generation phase (i) joined; the whole at 1 from
# 2 since the training kit's phase (k) joined)
NATIVE_STEPS, NATIVE_HALF_STEPS, NATIVE_HALF_LAYERS = 1, 1, 2


def onebit_table(layers: int) -> tuple:
    """(compressed partitions, bytes one worker moves a step) of BERT-large's
    gradient at ``layers`` under bare onebit, computed from the parameter
    shapes as the engine partitions them: one key a parameter
    (DistributedOptimizer's ``Gradient.<name>``), 4,096,000-byte partitions,
    each of a float32 tensor of at least 64 KiB compressed to a scale and
    its sign words, the rest raw (495 and 46,524,348 at 24 layers, 99 and
    11,108,748 at 2)."""
    from byteps_tpu_torch.common.partition import partition_elements
    from byteps_tpu_torch.models.transformer import bert_large, is_layer_param, param_shapes

    cfg = dataclasses.replace(bert_large(max_seq=SEQ), n_layers=layers)
    parts, nbytes = 0, 0
    for name, shape in param_shapes(cfg).items():
        n = int(np.prod(shape))
        copies = layers if is_layer_param(name) else 1
        if 4 * n < 65536:
            nbytes += copies * 4 * n
            continue
        lengths = [ln for _, ln in partition_elements(n, 4, 4_096_000)]
        parts += copies * len(lengths)
        nbytes += copies * sum(4 + 4 * ((ln + 31) // 32) for ln in lengths)
    return parts, nbytes


# sequence lengths at and around the bf16 dh=64 kernels' tiles: K1's and K2's
# 128 query rows and 64-key tiles, K3's 128 keys and 64-row query tiles
TILE_EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 200, 511)

# K4: element counts checked against the plain version (n = 1, 2, 3 mod 4 near a
# full partition among them), the counts also checked on views that start 4, 8
# and 12 bytes past a 16-byte boundary, and the timed one (a full partition at
# the default BYTEPS_PARTITION_BYTES)
ONEBIT_NS = (1, 31, 32, 33, 1023, 1025, 24576, 32768, 1_023_997, 1_023_998,
             1_023_999, 1_024_000, 1_000_003)
ONEBIT_VIEW_NS = (1, 5, 33, 1023, 8195, 1_024_000, 1_000_003)
ONEBIT_TIMED_N = 1_024_000
# K4's device time: each timed launch follows a write of this many bytes (the
# L2 holds 50 MB) and a device-side sleep of this many cycles, long enough for
# the host to enqueue the events and the launch before the device reaches them
FLUSH_BYTES, SLEEP_CYCLES = 256 << 20, 1_000_000

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the longest a phase may run (the native lanes took 141.7 s on a slow host)
PHASE_STALL_S = 400

# tolerances, |kernel - plain| <= atol + rtol * |plain|, elementwise:
#  f32: the same f32 arithmetic summed in another order over S <= 512 terms
#  bf16: the plain version runs in f32 on the same bf16 inputs; the kernel also
#        rounds P and dS to bf16 for its tensor-core products, and its output to
#        bf16 (8-bit mantissa: 2^-9 relative each)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(name: str, got, want, dtype_name: str) -> float:
    """Max abs error; fails beyond the dtype's tolerance or on non-finite values."""
    got, want = got.float(), want.float()
    atol, rtol = TOL[dtype_name]
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_abs = float(err.max())
    if worst > atol:
        fail(f"{name}: max abs err {max_abs:.3e} beyond atol {atol} + rtol {rtol}")
    return max_abs


def phase_build() -> None:
    from byteps_tpu_torch import native
    from byteps_tpu_torch.comm import transport
    from byteps_tpu_torch.ops import _build, flash_attention, onebit_device

    sources = ("flash_attention", "onebit", "crc32c")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        futs = [pool.submit(_build.build, name) for name in sources]
        # the native lanes and host codecs: g++, one process per source
        futs.append(pool.submit(native.get_lib))
        for fut in futs:
            fut.result()
    flash_attention._lib()
    onebit_device._lib()
    if transport.crc32c(b"123456789") != 0xE3069283:
        fail("the wire checksum helper gives a wrong CRC32C")
    names = (*sources, "byteps_native")
    print(f"build: {', '.join(names)} in parallel in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.1f} s" for n in names)
          + ")", flush=True)
    # registers and spills of each kernel, and any word that wgmma products
    # were serialized (an accumulator touched mid-product, or spilled)
    for name in ("flash_attention", "onebit"):
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("entry function", "Used", "spill", "wgmma", "serialized")):
                print(f"  ptxas {name}:", line.strip())
    if "serialized" in _build.build_log.get("flash_attention", ""):
        fail("ptxas serialized the wgmma products of a flash attention kernel")


def _inputs(b, h, s, dh, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, s, dh), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    dlse = torch.randn((b, h, s), generator=g, device="cuda")
    return q, k, v, do, dlse


def check_case(label, b, h, s, dh, dtype, causal, seed=0) -> dict:
    """Each wrapper against its plain version on the same inputs, then the
    autograd path (with an lse cotangent) against autograd of the dense
    reference.  Returns max abs errors per kernel."""
    import torch

    from byteps_tpu_torch.ops import flash_attention as fa

    dn = str(dtype).split(".")[-1]
    q, k, v, do, dlse = _inputs(b, h, s, dh, dtype, seed)
    scale = dh ** -0.5
    f32 = [x.float() for x in (q, k, v, do)]

    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa._dense_reference_lse(*f32[:3], causal, scale)
    err = {"flash_fwd": max(close(f"{label} O", o, o_ref, dn),
                            close(f"{label} lse", lse, lse_ref, dn))}

    delta = (do.float() * o.float()).sum(-1) - dlse
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dq_ref = fa._plain_bwd_dq(*f32, lse, delta, causal, scale)
    dk_ref, dv_ref = fa._plain_bwd_dkv(*f32, lse, delta, causal, scale)
    err["flash_bwd_dq"] = close(f"{label} dQ", dq, dq_ref, dn)
    err["flash_bwd_dkv"] = max(close(f"{label} dK", dk, dk_ref, dn),
                               close(f"{label} dV", dv, dv_ref, dn))

    # end to end through autograd, lse cotangent included
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o2, lse2 = fa.flash_attention_lse(*xs, causal=causal)
    grads = torch.autograd.grad((o2.float() * do.float()).sum() + (lse2 * dlse).sum(), xs)
    rs = [x.clone().requires_grad_() for x in f32[:3]]
    o3, lse3 = fa._dense_reference_lse(*rs, causal, scale)
    refs = torch.autograd.grad((o3 * do.float()).sum() + (lse3 * dlse).sum(), rs)
    for n, g_, r_ in zip("QKV", grads, refs):
        close(f"{label} autograd d{n}", g_, r_, dn)
    print(f"check {label}: B={b} H={h} S={s} dh={dh} {dn} causal={causal}: "
          + ", ".join(f"{n} max_abs_err {e:.2e}" for n, e in err.items()), flush=True)
    return err


def bounds_flops(b, h, s, dh, causal) -> dict:
    """Tensor-core operations each kernel's work needs (the visible pairs)."""
    bh = b * h
    pairs = s * (s + 1) // 2 if causal else s * s
    return {"flash_fwd": 4 * bh * pairs * dh, "flash_bwd_dq": 6 * bh * pairs * dh,
            "flash_bwd_dkv": 8 * bh * pairs * dh}


def bounds(b, h, s, dh, dtype_name, causal) -> dict:
    """Least time (ms) for each kernel's work on this card, and what binds it."""
    bh, esize = b * h, {"bfloat16": 2, "float32": 4}[dtype_name]
    tile = bh * s * dh * esize
    rows = bh * s * 4
    flops = bounds_flops(b, h, s, dh, causal)
    nbytes = {  # each input read once, each output written once
        "flash_fwd": 4 * tile + rows,
        "flash_bwd_dq": 5 * tile + 2 * rows,
        "flash_bwd_dkv": 6 * tile + 2 * rows,
    }
    out = {}
    for name in flops:
        flops_n, nbytes_n = flops[name], nbytes[name]
        t_ops, t_bytes = flops_n / PEAK_FLOPS[dtype_name], nbytes_n / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")
    return out


def _in_turns(name: str, kernel, library, library_name: str) -> tuple:
    """A kernel and a library call timed in turns (kernel, library, library,
    kernel), three rounds: the median of each (ms)."""
    ks, ls = [], []
    for _ in range(3):
        for run in (ks, ls, ls, ks):
            run.append(time_ms(kernel if run is ks else library))
    print(f"time {name} in turns with {library_name}: kernel "
          f"{[round(x, 4) for x in sorted(ks)]} ms, SDPA "
          f"{[round(x, 4) for x in sorted(ls)]} ms", flush=True)
    return float(np.median(ks)), float(np.median(ls))


def time_kernels(b, h, s, dh, dtype, causal) -> dict:
    """Kernel, plain version and library times (ms) at the main path's shape."""
    import torch
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _ = _inputs(b, h, s, dh, dtype, seed=1)
    scale = dh ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    # K1 against SDPA's forward; K2 and K3 each against SDPA's whole backward
    # (dQ, dK and dV together), since no PyTorch call computes either alone
    k1, sdpa_fwd = _in_turns(
        "flash_fwd", lambda: fa.flash_fwd(q, k, v, causal, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), "SDPA's forward")
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_backward():
        return torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

    k2, sdpa_bwd_k2 = _in_turns(
        "flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
        sdpa_backward, "SDPA's backward")
    k3, sdpa_bwd = _in_turns(
        "flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale),
        sdpa_backward, "SDPA's backward")
    t = {
        "flash_fwd": (
            k1, time_ms(lambda: fa._dense_reference_lse(q, k, v, causal, scale), iters=5),
        ),
        "flash_bwd_dq": (
            k2, time_ms(lambda: fa._plain_bwd_dq(q, k, v, do, lse, delta, causal, scale), iters=5),
        ),
        "flash_bwd_dkv": (
            k3, time_ms(lambda: fa._plain_bwd_dkv(q, k, v, do, lse, delta, causal, scale), iters=5),
        ),
    }
    for name, (ms, plain_ms) in t.items():
        print(f"time {name}: kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms", flush=True)
    print(f"time SDPA (library yardstick, never called by the port): forward "
          f"{sdpa_fwd:.4f} ms, backward (dQ, dK, dV together) {sdpa_bwd_k2:.4f} ms in turns "
          f"with K2, {sdpa_bwd:.4f} ms in turns with K3", flush=True)
    return {"times": t, "sdpa_fwd": sdpa_fwd,
            "sdpa_bwd": {"flash_bwd_dq": sdpa_bwd_k2, "flash_bwd_dkv": sdpa_bwd}}


def check_repeatable(b, h, s, dh) -> None:
    """Two launches on the same bf16 inputs give bitwise-equal outputs: K1's O
    and lse, K2's dQ, K3's dK and dV (none uses atomics)."""
    import torch

    from byteps_tpu_torch.ops import flash_attention as fa

    q, k, v, do, dlse = _inputs(b, h, s, dh, torch.bfloat16, seed=12)
    o1, lse1 = fa.flash_fwd(q, k, v, False, dh ** -0.5)
    o2, lse2 = fa.flash_fwd(q, k, v, False, dh ** -0.5)
    if not (torch.equal(o1, o2) and torch.equal(lse1, lse2)):
        fail(f"K1 B={b} H={h} S={s} dh={dh}: two launches on the same inputs differ")
    delta = (do.float() * o1.float()).sum(-1) - dlse
    dq1 = fa.flash_bwd_dq(q, k, v, do, lse1, delta, False, dh ** -0.5)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse1, delta, False, dh ** -0.5)
    if not torch.equal(dq1, dq2):
        fail(f"K2 B={b} H={h} S={s} dh={dh}: two launches on the same inputs differ")
    dk1, dv1 = fa.flash_bwd_dkv(q, k, v, do, lse1, delta, False, dh ** -0.5)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse1, delta, False, dh ** -0.5)
    if not (torch.equal(dk1, dk2) and torch.equal(dv1, dv2)):
        fail(f"K3 B={b} H={h} S={s} dh={dh}: two launches on the same inputs differ")
    print(f"check K1, K2, K3 repeatable: B={b} H={h} S={s} dh={dh} bf16, O and lse, dQ, dK "
          "and dV bitwise equal across two launches", flush=True)


def check_kernels() -> dict:
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    # the bf16 dh=64 kernels (K1, K2, K3): S at and around their tiles' edges
    for i, s in enumerate(TILE_EDGE_SEQS):
        for causal in (False, True):
            check_case(f"tile edge bf16 S={s}", 1, 2, s, 64, bf16, causal, seed=20 + 2 * i + causal)
    main = check_case("bert-large bf16", BATCH, 16, SEQ, 64, bf16, False)
    check_repeatable(BATCH, 16, SEQ, 64)
    check_case("bert-large f32", BATCH, 16, SEQ, 64, f32, False, seed=1)
    check_case("causal bf16", 2, 16, SEQ, 64, bf16, True, seed=2)
    check_case("causal f32", 2, 16, SEQ, 64, f32, True, seed=3)
    check_case("ragged f32", 2, 4, 200, 64, f32, True, seed=4)
    check_case("ragged bf16", 3, 2, 200, 64, bf16, False, seed=5)
    check_case("dh32 f32", 2, 4, 130, 32, f32, False, seed=6)
    check_case("dh32 bf16", 2, 4, 256, 32, bf16, True, seed=7)
    check_case("dh128 f32", 2, 4, 320, 128, f32, True, seed=8)
    check_case("dh128 bf16", 2, 4, 77, 128, bf16, False, seed=9)
    return main


def _onebit_input(n: int, seed: int, specials: bool):
    """float32[n] on the card: normal draws with +-0.0 and denormals mixed in, and
    with ``specials`` also +-inf and NaNs of both signs (sign bit set and clear)."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    vals = [0.0, -0.0, 1e-40, -1e-40, np.float32(1.4e-45), -np.float32(1.4e-45)]
    if specials:  # first, so that even n = 1 holds a non-finite value
        nan = np.float32(np.nan)
        vals = [np.inf, -np.inf, nan, -nan] + vals
    idx = rng.permutation(n)[: min(n, 4 * len(vals))]
    x[idx] = np.resize(np.array(vals, dtype=np.float32), idx.size)
    return torch.from_numpy(x).cuda()


def _check_onebit_payload(label: str, x) -> float:
    """K4 on ``x`` against its plain version: the words bitwise, two launches
    bitwise equal, the card's decode the CPU's; the scale within rtol 1e-6 on
    finite inputs, non-finite in both where ``x`` holds infs or NaNs.  Returns
    |scale(K4) - scale(plain)| (0.0 on non-finite inputs)."""
    import torch

    from byteps_tpu_torch.ops import onebit_device as ob

    n = x.numel()
    specials = not bool(x.isfinite().all())
    got = ob.onebit_payload_device(x, scaling=True)
    again = ob.onebit_payload_device(x, scaling=True)
    want = ob._plain_payload(x, scaling=True)
    torch.cuda.synchronize()
    if got.numel() != ob.wire_nbytes(n) or not torch.equal(got[4:], want[4:]):
        fail(f"K4 {label} specials={specials}: sign words differ from the plain "
             f"version ({int((got[4:] != want[4:]).sum())} bytes)")
    if not torch.equal(got, again):
        fail(f"K4 {label}: two launches on the same input differ")
    # the decoder (plain torch ops) decodes the payload on the card as on the
    # CPU, bit for bit
    dec = ob.onebit_decompress_device(*ob.split_payload(got), n)
    dec_cpu = ob.onebit_decompress_device(*ob.split_payload(got.cpu()), n)
    if not torch.equal(dec.view(torch.int32).cpu(), dec_cpu.view(torch.int32)):
        fail(f"onebit decoder {label}: the card's decode differs from the CPU's")
    s_got, s_want = float(ob.split_payload(got)[0]), float(ob.split_payload(want)[0])
    if specials:
        if math.isfinite(s_got) or math.isfinite(s_want):
            fail(f"K4 {label}: scale over infs and NaNs {s_got} vs plain {s_want}")
        return 0.0
    err = abs(s_got - s_want)
    if not err <= 1e-6 * abs(s_want):
        fail(f"K4 {label}: scale {s_got!r} vs plain {s_want!r} beyond rtol 1e-6")
    return err


def _check_onebit_streams() -> None:
    """Two inputs packed at the same time, one on each of two streams, eight
    launches each, held back by an event until both streams are full: each
    payload bitwise the sequential launch's on its own input."""
    import torch

    from byteps_tpu_torch.ops import onebit_device as ob

    xs = [_onebit_input(ONEBIT_TIMED_N, seed=s, specials=False) for s in (21, 22)]
    want = [ob.onebit_payload_device(x, scaling=True) for x in xs]
    torch.cuda.synchronize()
    gate, streams = torch.cuda.Stream(), [torch.cuda.Stream(), torch.cuda.Stream()]
    with torch.cuda.stream(gate):
        torch.cuda._sleep(SLEEP_CYCLES)
    opened = torch.cuda.Event()
    opened.record(gate)
    outs = [[], []]
    for s in streams:
        s.wait_event(opened)
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(ob.onebit_payload_device(xs[i], scaling=True))
    torch.cuda.synchronize()
    for i in range(2):
        if not all(torch.equal(o, want[i]) for o in outs[i]):
            fail(f"K4 on two streams: input {i} packed beside the other differs from "
                 "its sequential launch")


def check_onebit() -> float:
    """K4 against its plain version at every n of ONEBIT_NS, and on views of
    ONEBIT_VIEW_NS elements starting 4, 8 and 12 bytes past a 16-byte boundary;
    scaling off; two streams at once.  Returns the largest
    |scale(K4) - scale(plain)|."""
    from byteps_tpu_torch.ops import onebit_device as ob

    worst = 0.0
    for i, n in enumerate(ONEBIT_NS):
        for specials in (False, True):
            x = _onebit_input(n, seed=100 + i, specials=specials)
            worst = max(worst, _check_onebit_payload(f"n={n}", x))
        # scaling off: the scale word is 1.0
        off = ob.onebit_payload_device(_onebit_input(n, seed=7, specials=False), scaling=False)
        if float(ob.split_payload(off)[0]) != 1.0:
            fail(f"K4 n={n}: scaling off gives scale {float(ob.split_payload(off)[0])}")
    for i, n in enumerate(ONEBIT_VIEW_NS):
        for k in (1, 2, 3):
            for specials in (False, True):
                base = _onebit_input(n + 3, seed=300 + 4 * i + k, specials=specials)
                x = base[k:k + n]
                if x.data_ptr() % 16 != 4 * k:
                    fail(f"K4 view test: a view at element {k} starts {x.data_ptr() % 16} "
                         "bytes past a 16-byte boundary")
                worst = max(worst, _check_onebit_payload(f"n={n} at +{4 * k} bytes", x))
    _check_onebit_streams()
    print(f"check onebit K4: n in {list(ONEBIT_NS)}, and n in {list(ONEBIT_VIEW_NS)} on "
          "views at +4, +8, +12 bytes: words bitwise equal to the plain version, scale "
          f"max abs err {worst:.2e} (rtol 1e-6), repeatable bitwise; two streams at once "
          "bitwise their sequential launches", flush=True)
    return worst


def _cold_events_ms(launch, flush, iters: int = 20, sleep_cycles: int = SLEEP_CYCLES) -> list:
    """The device time of ``launch`` with the L2 cold, as the engine finds a
    gradient: before each launch a write of ``flush`` evicts the L2 and a
    device-side sleep of ``sleep_cycles`` lets the host enqueue the timed
    pair (and every kernel ``launch`` makes); CUDA events around the launch
    alone.  ``iters`` times (ms, sorted) after one warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(iters + 1):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        launch()
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return sorted(times)


def _cold_profiled_ms(launch, flush, match: str, iters: int = 20) -> tuple:
    """``iters`` launches, each after a write of ``flush``, under torch.profiler:
    the self device time a launch (ms) of the kernels whose name holds
    ``match``, and their count a launch; (None, None) where the profiler shows
    no such device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            launch()
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key
            and e.self_device_time_total > 0]
    if not ours:
        return None, None
    return (sum(e.self_device_time_total for e in ours) / iters / 1e3,
            sum(e.count for e in ours) / iters)


def time_onebit() -> dict:
    """K4 at one full partition: its device time with L2 cold (``ms``: the
    median of 20, CUDA events), the profiler's, the wrapper's time back to
    back (``call_ms``: 20 calls after 3 warm-up, the input staying in L2,
    paced by the host), and the plain version's, against the bytes bound.
    Then what holds it there, on the profiler's yardstick with L2 cold: K4 at
    one element (its fixed cost) and at 4x and 64x the partition (its
    streaming rate), and PyTorch's own elementwise kernel reading the same
    input (torch.signbit) at one element and at the partition."""
    import torch

    from byteps_tpu_torch.ops import onebit_device as ob

    n = ONEBIT_TIMED_N
    x = _onebit_input(n, seed=11, specials=False)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = _cold_events_ms(lambda: ob.onebit_payload_device(x, scaling=True), flush)
    ms = float(np.median(times))
    prof_ms, per_launch = _cold_profiled_ms(
        lambda: ob.onebit_payload_device(x, scaling=True), flush, "onebit_")
    call_ms = time_ms(lambda: ob.onebit_payload_device(x, scaling=True))
    plain_ms = time_ms(lambda: ob._plain_payload(x, scaling=True))
    nbytes = 4 * n + ob.wire_nbytes(n)  # read x once, write the payload once
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"time onebit K4 n={n}: device {ms:.5f} ms with L2 cold (median of "
          f"{len(times)}: {[round(t, 5) for t in times]}; {nbytes / ms / 1e6:.1f} GB/s, "
          f"{bound_ms / ms:.3f} of the bound), profiler "
          + (f"{prof_ms:.5f} ms in {per_launch:g} kernels a call" if prof_ms is not None
             else "shows no device time (not measured)")
          + f"; call back to back {call_ms:.5f} ms; bound {bound_ms:.5f} ms (bytes), "
          f"plain version {plain_ms:.4f} ms; no single PyTorch call computes the packing "
          "(library: none)", flush=True)
    floor = {}
    for m in (1, 4 * n, 64 * n):
        xm = x[:1] if m == 1 else torch.randn(m, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(m))
        k_ms = _cold_profiled_ms(lambda: ob.onebit_payload_device(xm, scaling=True), flush,
                                 "onebit_")[0]
        floor[f"K4 n={m}"] = k_ms
    for m, xm in ((1, x[:1]), (n, x)):
        floor[f"torch.signbit n={m}"] = _cold_profiled_ms(lambda: torch.signbit(xm), flush,
                                                          "signbit")[0]
    big = floor[f"K4 n={64 * n}"]
    print("time onebit K4 what holds it (profiler, L2 cold): " + ", ".join(
        f"{k} {v:.5f} ms" if v is not None else f"{k} not measured" for k, v in floor.items())
        + (f"; K4 streams {(4 + 4 / 32) * 64 * n / big / 1e9:.3f} TB/s at n={64 * n}"
           if big else ""), flush=True)
    del flush

    # what a server does with each such partition on this machine's CPU: decode
    # the push, encode the merged round for the pull (the C++ entries, OpenMP;
    # their numpy plain versions beside)
    from byteps_tpu_torch.compression.impl import OneBitCompressor

    host = x.cpu().numpy()
    codec = OneBitCompressor(n, scaling=True)
    payload = codec.compress(host)
    host_ms = {}
    for label, fn in (("compress", lambda: codec.compress(host)),
                      ("decompress", lambda: codec.decompress(payload, n)),
                      ("numpy compress", lambda: codec.compress_plain(host)),
                      ("numpy decompress", lambda: codec.decompress_plain(payload, n))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms[label] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"time onebit host codec n={n} (host CPU, mean of 20): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in host_ms.items()), flush=True)
    return {"ms": ms, "call_ms": call_ms, "profiler_ms": prof_ms,
            "kernels_a_call": per_launch, "plain_ms": plain_ms, "bound_ms": bound_ms}


def _train_small(cfg, sd, tokens, targets, dev):
    """Logits (on the host, f32) and the losses of three AdamW steps of one
    model, through init -> DistributedOptimizer on ``dev``."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.transformer import Transformer, build_train_step

    model = Transformer(cfg, device=dev)
    model.load_state_dict(sd)
    tok = torch.as_tensor(tokens, device=dev)
    tgt = torch.as_tensor(targets, device=dev)
    with torch.no_grad():
        logits = model(tok).float().cpu()
    bps.init(device=dev)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
    )
    step = build_train_step(model, opt)
    losses = [float(step(tok, tgt)) for _ in range(3)]
    bps.shutdown()
    return logits, losses


def check_model() -> None:
    """A 2-layer model at BERT-large's widths (B=2, S=128), logits and the
    losses of three optimizer steps: in f32 on the card (kernels) against the
    CPU (plain versions); in bf16 on the card, flash attention (kernels) and
    dense attention, each against the f32 logits."""
    import torch

    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import bert_large, init_params

    cfg = dataclasses.replace(
        bert_large(max_seq=128, use_flash=True, remat=True), n_layers=2
    )
    sd = params_from_jax(init_params(cfg, seed=1), cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, cfg.max_seq))
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1  # ignored position

    lg, lc = _train_small(cfg, sd, tokens, targets, "cuda")
    cg, cc = _train_small(cfg, sd, tokens, targets, "cpu")
    err = float((lg - cg).abs().max())
    if not err <= 1e-3:  # f32 over d_model 1024 and vocab 30528, summed in other orders
        fail(f"model logits: card vs CPU max abs err {err:.3e} > 1e-3")
    if not np.allclose(lc, cc, rtol=1e-4, atol=1e-4):
        fail(f"model losses: card {lc} vs CPU {cc}")
    print(f"model check (2 layers, f32, B=2, S=128): logits max abs err {err:.2e}; "
          f"losses card {lc} CPU {cc}", flush=True)

    # bf16: at these widths and this init, bf16 compute lands far from f32
    # whatever the attention (byteps_tpu's own bf16 forward of this model does
    # too), so the kernels are held to the dense bf16 attention's distance from
    # the card's f32 logits: no more than 1.25 times it
    bf = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    fg, fl = _train_small(bf, sd, tokens, targets, "cuda")
    dg, dl = _train_small(dataclasses.replace(bf, use_flash=False), sd, tokens, targets, "cuda")
    ef, ed = float((fg - lg).abs().mean()), float((dg - lg).abs().mean())
    if not ef <= 1.25 * ed:
        fail(f"bf16 model logits: flash kernels {ef:.3e} from f32 on average, dense "
             f"attention {ed:.3e}")
    if not all(math.isfinite(x) for x in fl):
        fail(f"bf16 model losses: {fl}")
    print(f"model check (2 layers, bf16, B=2, S=128): mean abs logit distance from f32, "
          f"flash kernels {ef:.3e}, dense attention {ed:.3e}; losses flash {fl} "
          f"dense {dl}", flush=True)


def check_full_depth(model, cfg, tok, tgt) -> None:
    """The first step's loss and logits at full depth, on the main path's
    weights and tokens before any update, three ways on the card: bf16 through
    the kernels, bf16 with dense attention, and f32 with dense attention (no
    TF32).  The kernels' mean abs logit distance from f32 must be no more than
    1.25 times dense bf16 attention's, as in check_model."""
    import torch

    from byteps_tpu_torch.models.transformer import Transformer, token_loss

    runs = {}
    with torch.no_grad():
        for label, c in (
            ("f32 dense", dataclasses.replace(cfg, use_flash=False, compute_dtype=torch.float32)),
            ("bf16 dense", dataclasses.replace(cfg, use_flash=False)),
            ("bf16 kernels", cfg),
        ):
            m = model
            if c is not cfg:
                m = Transformer(c, device=tok.device)
                m.load_state_dict(model.state_dict())
            logits = m(tok).float()
            runs[label] = (logits, float(token_loss(logits, tgt)))
            del m
    ref = runs["f32 dense"][0]
    ef = float((runs["bf16 kernels"][0] - ref).abs().mean())
    ed = float((runs["bf16 dense"][0] - ref).abs().mean())
    losses = {k: round(v[1], 4) for k, v in runs.items()}
    del runs, ref
    if not all(math.isfinite(x) for x in losses.values()):
        fail(f"full-depth first losses: {losses}")
    if not ef <= 1.25 * ed:
        fail(f"full-depth bf16 logits: kernels {ef:.3e} from f32 on average, dense "
             f"attention {ed:.3e}")
    print(f"main path: first loss before any update, {cfg.n_layers} layers: {losses}; "
          f"mean abs logit distance from f32, kernels {ef:.3e}, dense attention {ed:.3e}",
          flush=True)


def profile_step(step, tok, tgt, step_ms: float) -> tuple:
    """One more step under torch.profiler: device time by kernel family and
    the device's busy share, of the profiled step's wall time and of
    ``step_ms``, the mean step time without the profiler.  Only the device's
    own events are summed (kernels, copies): a CPU operator's row carries
    the device time of the kernels it launched, and a user annotation
    (``Optimizer.step#...``) spans kernels; either would count them twice.
    Returns (the step's loss, device busy ms or None where not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(step(tok, tgt))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profile: no device time recorded (not measured)", flush=True)
        return loss, None
    families = {"flash attention kernels": 0.0, "onebit packer (K4)": 0.0, "matmul": 0.0,
                "optimizer (multi_tensor_apply)": 0.0, "copies": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        fam = ("flash attention kernels" if "flash_" in name
               else "onebit packer (K4)" if "onebit_" in name
               else "copies" if "memcpy" in name
               else "matmul" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass"))
               else "optimizer (multi_tensor_apply)" if "multi_tensor_apply" in name
               else "other")
        families[fam] += e.self_device_time_total / 1e3
    busy, busy_plain = 100 * total_ms / wall_ms, 100 * total_ms / step_ms
    print(f"profile: step wall {wall_ms:.1f} ms under the profiler, device busy "
          f"{total_ms:.1f} ms ({busy:.1f}% of it, idle {100 - busy:.1f}%; "
          f"{busy_plain:.1f}% of the {step_ms:.1f} ms step without the profiler); "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in families.items()), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    return loss, total_ms


#: what later phases compare with the main path: its ms a step
MAIN_PATH: dict = {}


def train_main_path(card: str) -> dict:
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa

    bps.init()
    t0 = time.perf_counter()
    cfg, model, tok, tgt = _bert(N_LAYERS_FULL)
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
    )
    step = build_train_step(model, opt)
    print(f"main path: setup {time.perf_counter() - t0:.1f} s", flush=True)
    check_full_depth(model, cfg, tok, tgt)

    # the check models' parameters and optimizer state sit in reference cycles
    # (each gradient hook holds its optimizer): free them before the peak is read
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses = [float(step(tok, tgt)) for _ in range(WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(tok, tgt) for _ in range(STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    losses.append(profile_step(step, tok, tgt, dt / STEPS * 1e3)[0])
    counts = dict(fa.launches)
    bps.shutdown()

    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    n = WARMUP + STEPS + 1
    want = {"flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
            "flash_bwd_dkv": cfg.n_layers * n}
    if counts != want:
        fail(f"kernel launches on the main path {counts}, expected {want}")
    sps = BATCH * STEPS / dt
    MAIN_PATH["step_ms"] = dt / STEPS * 1e3
    print(f"main path: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}: "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"main path: {sps:.2f} samples/s ({dt / STEPS * 1e3:.1f} ms/step over {STEPS} "
          f"steps), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"on {card}", flush=True)
    print(f"main path: launches {counts}", flush=True)
    return counts


def _start_ps_processes(env: dict, log_dir: str, server_env: dict = None,
                        server_ports: list = None, sched_args: list = None,
                        sched_env: dict = None, per_server_env: list = None,
                        server_args: list = None) -> tuple:
    """A scheduler and two servers of the port, as `python -m
    byteps_tpu_torch.server` processes (the servers with ``server_env``
    added, server i with ``per_server_env[i]`` too, and the interpreter
    arguments ``server_args`` instead, when given; the scheduler with
    ``sched_env`` added, and the interpreter arguments ``sched_args``
    instead, when given), each server's stderr in a file of ``log_dir``;
    returns (scheduler port, processes), and the servers' ports in
    ``server_ports`` when given (each server prints its port before it
    registers)."""
    import socket

    # the three start at once, the scheduler on a port picked here: each
    # spends seconds importing, and a server dials until the scheduler
    # listens (BYTEPS_CONNECT_RETRY_S)
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = str(probe.getsockname()[1])
    procs = [_track(subprocess.Popen(
        [sys.executable, *(sched_args or ["-m", "byteps_tpu_torch.server"])], cwd=REPO,
        env={**env, **(sched_env or {}), "DMLC_ROLE": "scheduler", "DMLC_PS_ROOT_PORT": port},
        stdout=subprocess.PIPE, text=True,
    ), "scheduler", node=True)]
    for i in range(2):
        path = os.path.join(log_dir, f"server{i}.log")
        with open(path, "w") as log:
            procs.append(_track(subprocess.Popen(
                [sys.executable, *(server_args or ["-m", "byteps_tpu_torch.server"])], cwd=REPO,
                env={"BYTEPS_CONNECT_RETRY_S": "60", **env, **(server_env or {}),
                     **(per_server_env[i] if per_server_env else {}),
                     "DMLC_ROLE": "server", "DMLC_PS_ROOT_PORT": port},
                stdout=subprocess.PIPE, stderr=log, text=True,
            ), f"server {i}", path, node=True))
    line = procs[0].stdout.readline().strip()
    if line != f"BYTEPS_SCHEDULER_PORT={port}":
        for p in procs:
            p.kill()
        fail(f"the scheduler process did not report port {port} (got {line!r})")
    for i, proc in enumerate(procs[1:]):
        line = proc.stdout.readline().strip()
        if not line.startswith("BYTEPS_SERVER_PORT="):
            for p in procs:
                p.kill()
            fail(f"server {i} did not report its port (got {line!r})")
        if server_ports is not None:
            server_ports.append(int(line.split("=", 1)[1]))
    return port, procs


#: the fleet processes now running: Popen -> (name, the file its stderr
#: goes to or None when it is this script's, whether it is a server or a
#: scheduler, which dump their threads' stacks on SIGUSR1)
_FLEET: dict = {}


def _track(proc, name: str, log: str = None, node: bool = False):
    """Register a fleet process, so that a phase that fails or stalls prints
    its log's tail (``_fleet_tails``); returns ``proc``."""
    _FLEET[proc] = (name, log, node)
    return proc


def _fleet_tails(why: str, procs=None, nbytes: int = 6000) -> None:
    """The tail of each tracked process's log (of ``procs`` when given) on
    stderr: what a failed or stalled phase's servers said."""
    for proc, (name, log, _node) in list(_FLEET.items()):
        if procs is not None and proc not in procs:
            continue
        head = f"--- {why}: {name} (pid {proc.pid}, exit {proc.poll()})"
        if log is None:
            print(f"{head}: its stderr is this script's", file=sys.stderr, flush=True)
            continue
        try:
            with open(log, errors="replace") as f:
                text = f.read()[-nbytes:]
        except OSError as e:
            text = f"(unreadable: {e})"
        print(f"{head}, the tail of {os.path.basename(log)}:\n{text}", file=sys.stderr,
              flush=True)


def _stop_processes(procs) -> None:
    """The launcher's stop, with 30 s a process: a server logs its summed
    pushes and rounds and its histograms (``_server_report``) as it stops.
    Called while an exception propagates (a phase raised or failed), it
    prints each stopped process's log tail first, while the phase's
    temporary directory still holds the logs."""
    from byteps_tpu_torch.launcher.launch import stop_processes

    failing = sys.exc_info()[0] is not None
    stop_processes(procs, timeout=30)
    if failing:
        _fleet_tails("a phase failed", procs)
    for p in procs:
        _FLEET.pop(p, None)


def _children(pid: int) -> list:
    """The pids of a process's children (a launcher's workers)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(c) for c in f.read().split()]
    except OSError:
        return []


def _stall() -> None:
    """A phase ran past PHASE_STALL_S: this process's stacks, each live
    server's and scheduler's and each launcher host's workers' (SIGUSR1,
    into its log or this stderr), and every fleet log's tail go to stderr;
    the fleet is killed, and the script exits 1."""
    print(f"chip_smoke: FAIL: a phase ran past {PHASE_STALL_S} s; the stacks follow",
          file=sys.stderr, flush=True)
    faulthandler.dump_traceback(all_threads=True)
    for proc, (_name, _log, node) in list(_FLEET.items()):
        if proc.poll() is not None:
            continue
        for pid in [proc.pid] if node else _children(proc.pid):
            try:
                os.kill(pid, signal.SIGUSR1)
            except OSError:
                pass
    time.sleep(3)
    _fleet_tails("a phase stalled")
    for proc in list(_FLEET):
        if proc.poll() is None:
            proc.kill()
    sys.stderr.flush()
    os._exit(1)


class _Watchdog:
    """Calls ``_stall`` once a phase has run PHASE_STALL_S; ``arm`` starts a
    phase's clock.  A C-level dump 60 s later backs it up, for a stall
    that holds the interpreter lock."""

    def __init__(self) -> None:
        self._deadline = None
        threading.Thread(target=self._loop, name="chip-smoke-watchdog", daemon=True).start()

    def arm(self) -> None:
        self._deadline = time.monotonic() + PHASE_STALL_S
        faulthandler.dump_traceback_later(PHASE_STALL_S + 60, exit=True)

    def cancel(self) -> None:
        self._deadline = None
        faulthandler.cancel_dump_traceback_later()

    def _loop(self) -> None:
        while True:
            time.sleep(1)
            if self._deadline is not None and time.monotonic() > self._deadline:
                _stall()


@contextlib.contextmanager
def _ps_fleet(label: str, server_env: dict = None, worker_env: dict = None,
              sched_env: dict = None, per_server_env: list = None):
    """A scheduler (with ``sched_env``) and two server processes (with
    ``server_env``, and server i with ``per_server_env[i]``) for one
    worker (this process, with ``worker_env``), the worker's environment
    set while the block runs: a new job, so the tensor registry starts
    empty (a declaration merges into an earlier one of the same name, and
    an earlier phase's codec would stay).  Yields the fleet: ``log_dir``
    holds the servers' stderr while the block runs, and ``report`` the
    servers' stop reports (``_server_report``) after it.  Fails if a
    process died during the block; stops every process after it."""
    import types

    from byteps_tpu_torch.common.registry import reset_registry

    reset_registry()
    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "DMLC_PS_ROOT_URI": "127.0.0.1",
           "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO}
    saved = dict(os.environ)
    with tempfile.TemporaryDirectory() as log_dir:
        fleet = types.SimpleNamespace(log_dir=log_dir, report=None, server_ports=[])
        port, procs = _start_ps_processes(env, log_dir, server_env, fleet.server_ports,
                                          sched_env=sched_env, per_server_env=per_server_env)
        try:
            os.environ.update({**env, **(worker_env or {}), "DMLC_PS_ROOT_PORT": port})
            yield fleet
            dead = [p.args for p in procs if p.poll() is not None]
            if dead:
                fail(f"{label}: a PS process exited: {dead}")
        finally:
            os.environ.clear()
            os.environ.update(saved)
            _stop_processes(procs)
            fleet.report = _server_report(log_dir)


#: BERT-large's weights (init_params, seed 0) by depth, made once
_WEIGHTS: dict = {}


def _bert_cfg(n_layers: int, **overrides):
    """BERT-large's config at ``n_layers`` (seq SEQ, bf16, remat, flash,
    unless ``overrides`` say otherwise)."""
    import torch

    from byteps_tpu_torch.models.transformer import bert_large

    return dataclasses.replace(bert_large(max_seq=SEQ, compute_dtype=torch.bfloat16, remat=True,
                                          use_flash=True), n_layers=n_layers, **overrides)


def _bert_weights(cfg) -> dict:
    """The weights of ``init_params(cfg, seed=0)``, made once a depth."""
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import init_params

    if cfg.n_layers not in _WEIGHTS:
        _WEIGHTS[cfg.n_layers] = params_from_jax(init_params(cfg, seed=0), cfg)
    return _WEIGHTS[cfg.n_layers]


def _bert(n_layers: int, batch: int = BATCH, **overrides):
    """BERT-large (seq SEQ, bf16, remat, flash, unless ``overrides`` say
    otherwise) at ``n_layers`` on the bound device, with the weights of
    ``init_params(seed=0)``, and the main path's tokens (numpy seed 0) cut
    to ``batch``: (cfg, model, tokens, targets)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.transformer import Transformer

    cfg = _bert_cfg(n_layers, **overrides)
    model = Transformer(cfg)
    model.load_state_dict(_bert_weights(cfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)[:batch]
    tok = torch.as_tensor(tokens, device=bps.device()).long()
    tgt = torch.as_tensor(np.roll(tokens, -1, axis=1), device=bps.device()).long()
    return cfg, model, tok, tgt


def _timed_steps(model, opt, tok, tgt, steps: int) -> tuple:
    """``steps`` train steps, split: forward + backward (the hooks submit
    each gradient as backward produces it), then the wait for the last
    pulls, then the optimizer.  Returns (losses, split seconds, seconds)."""
    import torch

    split = {"forward+backward": 0.0, "wait for pulls": 0.0, "optimizer": 0.0}
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        a = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        torch.cuda.synchronize()
        b = time.perf_counter()
        opt.synchronize()
        torch.cuda.synchronize()
        c = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        d = time.perf_counter()
        split["forward+backward"] += b - a
        split["wait for pulls"] += c - b
        split["optimizer"] += d - c
        losses.append(float(loss.detach()))
    return losses, split, time.perf_counter() - t0


def _split_line(split: dict, steps: int) -> str:
    return ", ".join(f"{k} {v / steps * 1e3:.1f} ms" for k, v in split.items())


def _hist_lines(hists: dict, steps: int) -> list:
    """One line per histogram of a metrics snapshot (the worker's stage
    dwell and round trips): observations and seconds a step, p50, p99."""
    return [f"{name}: {h['count'] / steps:.1f} a step, {h['sum'] / steps * 1e3:.1f} ms a "
            f"step, p50 {h['p50'] * 1e3:.3f} ms, p99 {h['p99'] * 1e3:.3f} ms"
            if "_seconds" in name else
            f"{name}: {h['count'] / steps:.1f} a step, mean {h['sum'] / max(1, h['count']):.2f}, "
            f"p50 {h['p50']:g}, p99 {h['p99']:g}"
            for name, h in sorted(hists.items())]


def _server_report(log_dir: str, servers: int = 2) -> list:
    """Each server's (pushes summed, rounds published, {histogram: (count,
    sum s, p50 s, p99 s)}, async pulls parked, server-side updates applied
    (these two None from a C++ engine), {recovery counter: count}), from
    the lines a server logs when it stops (None for a server that logged
    none), for ``servers`` logs ``server<i>.log``."""
    import re

    found = []
    for i in range(servers):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            text = f.read()
        m = re.findall(r"summed (\d+) pushes into (\d+) rounds(?:, parked (\d+) async pulls, "
                       r"applied (\d+) server-side updates)?", text)
        hists = {name: tuple(float(v) for v in vals) for name, *vals in re.findall(
            r"(\w+_seconds) count=(\d+) sum=([\d.e+-]+) p50=([\d.e+-]+) p99=([\d.e+-]+)",
            text)}
        rec = re.findall(r"recovery (.*)", text)
        recovery = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", rec[-1])} if rec else {}
        if m:
            pushes, rounds, parked, updates = m[-1]
            found.append((int(pushes), int(rounds), hists, int(parked) if parked else None,
                          int(updates) if updates else None, recovery))
        else:
            found.append(None)
    return found


def _server_lines(report: list) -> list:
    return [f"server {i}: summed {r[0]} pushes into {r[1]} rounds"
            + ("" if r[3] is None else f", parked {r[3]} async pulls, applied {r[4]} "
               "server-side updates")
            + ("; recovery " + " ".join(f"{k}={v}" for k, v in r[5].items()) if r[5] else "")
            + "; "
            + "; ".join(f"{name} count {int(c)}, sum {s * 1e3:.1f} ms, p50 {p50 * 1e3:.3f} ms, "
                        f"p99 {p99 * 1e3:.3f} ms" for name, (c, s, p50, p99) in r[2].items())
            for i, r in enumerate(report) if r is not None]


def _run_distributed(card: str, label: str, steps: int, server_native: bool = False,
                     client_native: bool = False, server_env: dict = None,
                     worker_env: dict = None, journal_ab: bool = False,
                     layers: int = N_LAYERS_FULL) -> dict:
    """BERT-large as on the main path (at ``layers``) through one worker (this process) and
    two server processes behind a scheduler process, onebit with scaling on
    every float32 gradient of at least BYTEPS_MIN_COMPRESS_BYTES; the
    servers' data plane in C++ when ``server_native``
    (BYTEPS_SERVER_NATIVE=1), the worker's lanes when ``client_native``
    (BYTEPS_NATIVE_CLIENT=1).  One warm-up step, ``steps`` timed and one
    profiled; then the same forward and backward with the engine idle, and
    the engine alone.  Fails unless the losses are finite, K4 and flash
    launch as the partition table and the depth say, d2h, wire_tx and
    wire_rx bytes equal the table's, and every round of one onebit
    partition is a CPU replay of the servers' codec.  Prints the step and
    its split, the worker's stage dwell and round trips over the timed
    steps, the device's busy share, the servers' report, the bytes and the
    launches; returns what it measured, the parameters' digest after the
    steps among it.  ``server_env`` and ``worker_env`` are added to the
    servers' and the worker's environment.  With ``journal_ab``, after the
    counts are read, steps in turns with the round journal on and off
    (JOURNAL_AB) and the journal's copy time and bytes a step."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    wall = time.perf_counter()
    with _ps_fleet(label, {**({"BYTEPS_SERVER_NATIVE": "1"} if server_native else {}),
                           **(server_env or {})},
                   {**({"BYTEPS_NATIVE_CLIENT": "1"} if client_native else {}),
                    **(worker_env or {})}) as fleet:
        t0 = time.perf_counter()
        bps.init()
        cfg, model, tok, tgt = _bert(layers)
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = build_train_step(model, opt)
        setup_s = time.perf_counter() - t0
        client = get_state().ps_client
        lanes = sorted({type(sc).__name__ for sc in client._servers})

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        with _tap_onebit_rounds(client) as tap:
            t0 = time.perf_counter()
            losses = [float(step(tok, tgt)) for _ in range(DIST_WARMUP)]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            metrics().reset()
            timed, split, dt = _timed_steps(model, opt, tok, tgt, steps)
            hists = metrics().snapshot()["histograms"]
            losses += timed
            loss, busy_ms = profile_step(step, tok, tgt, dt / steps * 1e3)
            losses.append(loss)
            torch.cuda.synchronize()
        launches = {**fa.launches, **ob.launches}
        stats = counters().snapshot()
        digest = _param_digest(model)
        table = get_state().engine.partition_table()
        tapped = next(r for r in table if r["key"] == tap["key"])
        tap.update(length=tapped["length"],
                   kwargs=dict(get_registry().get(tapped["name"]).kwargs))
        peak = torch.cuda.max_memory_allocated() / 2**30
        state_bytes = _state_bytes(opt)
        ab = _journal_ab(get_state().engine, model, opt, tok, tgt) if journal_ab else None
        # after the counts are read: the same forward + backward with the
        # gradient hooks skipping (they accumulate while a step has more
        # backward passes to go), so the engine stays idle
        opt.backward_passes_per_step = 2
        opt.zero_grad(set_to_none=True)
        a = time.perf_counter()
        model.loss(tok, tgt).backward()
        torch.cuda.synchronize()
        idle_fb = time.perf_counter() - a
        # and the engine alone: those gradients pushed and pulled under the
        # optimizer's names and priorities, with no backward running beside
        a = time.perf_counter()
        handles = [bps.push_pull_async(p.grad, name=f"Gradient.{n}", priority=-i)
                   for i, (n, p) in enumerate(model.named_parameters())]
        for h in handles:
            bps.synchronize(h)
        torch.cuda.synchronize()
        engine_alone = time.perf_counter() - a
        opt.backward_passes_per_step = 1
        opt.zero_grad(set_to_none=True)
        bps.shutdown()
        del model, opt, step

    n = DIST_WARMUP + steps + 1
    # the gradients' partitions (broadcast_parameters also initialized the
    # parameters' own keys, before the counts were reset)
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    compressed = [r for r in grads if r["wire_nbytes"] is not None]
    want_d2h = (sum(r["wire_nbytes"] for r in compressed)
                + sum(r["length"] * r["itemsize"] for r in grads if r["wire_nbytes"] is None))
    raw_bytes = sum(r["length"] * r["itemsize"] for r in grads)
    want_flash = {"flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
                  "flash_bwd_dkv": cfg.n_layers * n}
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss: {losses}")
    want_parts, want_step = onebit_table(layers)
    if len(compressed) != want_parts or want_d2h != want_step:
        bad.append(f"the partition table: {len(compressed)} compressed partitions, "
                   f"{want_d2h} bytes a step, expected {want_parts} and {want_step}")
    if launches["onebit_pack"] != n * len(compressed):
        bad.append(f"K4 launched {launches['onebit_pack']} times in {n} steps, expected "
                   f"{len(compressed)} compressed partitions a step")
    if {k: launches[k] for k in want_flash} != want_flash:
        bad.append(f"flash launches {launches}, expected {want_flash}")
    bad += [f"{k} {stats.get(k, 0) / n:.0f} a step, expected {want_d2h} (the partition "
            "table's compressed payloads plus raw small tensors)"
            for k in ("d2h_bytes", "wire_tx_bytes", "wire_rx_bytes")
            if stats.get(k, 0) != n * want_d2h]
    if lanes != ["_NativeServerConn" if client_native else "_ServerConn"]:
        bad.append(f"the worker's connections are {lanes}")
    if any(r is None for r in fleet.report):
        bad.append(f"a server logged no stop report: {fleet.report}")
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    _check_server_rounds(label, [tap])

    sps = BATCH * steps / dt
    split["engine alone"] = engine_alone * steps
    split["forward+backward, engine idle"] = idle_fb * steps
    busy = ("device busy not measured" if busy_ms is None else
            f"device busy {busy_ms:.1f} ms a step ({100 * busy_ms / (dt / steps * 1e3):.1f}%)")
    print(f"{label}: BERT-large at {layers} layers, seq {SEQ} bf16 remat flash, batch "
          f"{BATCH}, 1 worker "
          f"({', '.join(lanes)}) + 2 server processes "
          f"({'C++' if server_native else 'Python'} data plane), onebit (scaling) on "
          f"{len(compressed)} of {len(grads)} gradient partitions: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"{label}: {sps:.2f} samples/s ({dt / steps * 1e3:.1f} ms/step over {steps} steps; "
          f"first step {first_s:.1f} s with the init barriers; setup {setup_s:.1f} s), {busy}, "
          f"peak memory {peak:.2f} GiB, on {card}", flush=True)
    print(f"{label}: step split {_split_line(split, steps)}", flush=True)
    for line in _hist_lines(hists, steps) + _server_lines(fleet.report):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: per step K4 launches {launches['onebit_pack'] // n} (= compressed "
          f"partitions {len(compressed)}), flash { {k: v // n for k, v in want_flash.items()} }, "
          f"d2h_bytes {want_d2h} (raw gradient {raw_bytes}, {raw_bytes / want_d2h:.1f}x "
          f"more), wire_tx_bytes {stats.get('wire_tx_bytes', 0) // n}, wire_rx_bytes "
          f"{stats.get('wire_rx_bytes', 0) // n}; phase wall {time.perf_counter() - wall:.1f} s",
          flush=True)
    if ab is not None:
        print(f"{label}: the round journal (BYTEPS_JOURNAL_ROUNDS=2, the default) records "
              f"{ab['records']} pushes, {ab['bytes']} bytes a step, copying them in "
              f"{ab['copy_ms']:.2f} ms a step ({ab['stats']['rounds']} rounds, "
              f"{ab['stats']['bytes']} bytes held under the cap of {ab['cap']}, "
              f"{ab['stats']['evicted']} evicted); steps in turns, on "
              f"{[round(x, 1) for x in ab['ms']['on']]} ms, off "
              f"{[round(x, 1) for x in ab['ms']['off']]} ms; on {card}", flush=True)
    return {"losses": losses, "onebit_launches": launches["onebit_pack"],
            "wire_tx_step": stats.get("wire_tx_bytes", 0) // n, "step_ms": dt / steps * 1e3,
            "state_bytes": state_bytes, "digest": digest, "counters": stats, "steps": n,
            "report": fleet.report, "split": {k: v / steps * 1e3 for k, v in split.items()},
            "launches": launches, "journal_ab": ab}


#: the journal's steps in turns
JOURNAL_AB = ("on", "off", "off", "on")


def _journal_ab(engine, model, opt, tok, tgt) -> dict:
    """One step at a time with the engine's round journal on and off, in
    turns (JOURNAL_AB), each timed as ``_timed_steps`` times a step; the
    journal's records, bytes and the time its copies took, a step on."""
    j = engine._journal
    record = j.record
    spent = {"s": 0.0, "bytes": 0, "n": 0}

    def timed(key, version, cmd, payload, fused=False):
        t0 = time.perf_counter()
        record(key, version, cmd, payload, fused)
        spent["s"] += time.perf_counter() - t0
        spent["bytes"] += memoryview(payload).nbytes
        spent["n"] += 1

    j.record = timed
    ms: dict = {"on": [], "off": []}
    try:
        for mode in JOURNAL_AB:
            engine._journal = j if mode == "on" else None
            ms[mode].append(_timed_steps(model, opt, tok, tgt, 1)[2] * 1e3)
    finally:
        engine._journal = j
        del j.record
    on = len(ms["on"])
    return {"ms": ms, "copy_ms": spent["s"] * 1e3 / on, "bytes": spent["bytes"] // on,
            "records": spent["n"] // on, "stats": j.stats(), "cap": j.max_bytes}


def train_distributed(card: str) -> dict:
    """The distributed path on the Python lanes: the servers' data plane
    and the worker's client in Python; then the round journal's cost, in
    turns (``_journal_ab``)."""
    return _run_distributed(card, "distributed path", DIST_STEPS, journal_ab=True)


#: phase (a): every fault kind at about one frame in a thousand, both ways
#: over the wire, the deadline at 1 s
CHAOS_FAULTS = {"BYTEPS_VAN": "chaos:tcp", "BYTEPS_CHAOS_SEED": "13",
                "BYTEPS_CHAOS_DROP": "0.001", "BYTEPS_CHAOS_DISCONNECT": "0.001",
                "BYTEPS_CHAOS_TRUNCATE": "0.001", "BYTEPS_CHAOS_CORRUPT": "0.001",
                "BYTEPS_CHAOS_PAYLOAD_CORRUPT": "0.001", "BYTEPS_CHAOS_DELAY": "0.001",
                "BYTEPS_CHAOS_DELAY_MS": "20"}
CHAOS_HEAL = {"BYTEPS_RPC_DEADLINE_S": "1", "BYTEPS_INIT_DEADLINE_S": "1",
              "BYTEPS_RPC_RETRIES": "4", "BYTEPS_RPC_BACKOFF_S": "0.05"}
CHAOS_KINDS = ("drop", "delay", "disconnect", "truncate", "corrupt", "payload_corrupt")


def train_chaos(card: str, dist: dict) -> dict:
    """Phase (a): the distributed path (Python lanes, bare onebit, the same
    steps, weights and tokens) under the chaos van, every fault kind on
    the worker's frames and on the servers' replies, with the RPC deadline
    at 1 s.  The losses and the parameters after the steps must be bitwise
    the fault-free run's (``dist``); every fault kind must have fired, and
    retries, revivals and the servers' dedupes of resent pushes.  Prints
    the faults and heals a step and the step beside the fault-free one.
    Returns the kernels' launches a step."""
    label = "faults"
    wall = time.perf_counter()
    run = _run_distributed(card, label, DIST_STEPS, server_env=CHAOS_FAULTS,
                           worker_env={**CHAOS_FAULTS, **CHAOS_HEAL})
    n, c = run["steps"], run["counters"]
    servers = {k: sum(r[5].get(k, 0) for r in run["report"] if r) for k in
               (*(f"chaos_{k}" for k in CHAOS_KINDS), "push_dedup", "init_replay_ack",
                "wire_checksum_fail")}
    fired = {k: c.get(f"chaos_{k}", 0) + servers[f"chaos_{k}"] for k in CHAOS_KINDS}
    heals = {k: c.get(k, 0) for k in ("rpc_retry", "rpc_deadline_expired", "conn_revive",
                                      "wire_checksum_fail", "resync_attempt",
                                      "resync_replayed_rounds", "rpc_giveup",
                                      "degraded_jobs", "wire_rpc")}
    print(f"{label}: faults over the phase's {n} steps (the worker's and the servers' "
          f"injections) {fired}, a step {({k: round(v / n, 2) for k, v in fired.items()})}; "
          f"the worker's heals {heals}; the servers' dedupes and checksum drops "
          f"{ {k: servers[k] for k in ('push_dedup', 'init_replay_ack', 'wire_checksum_fail')} }",
          flush=True)
    print(f"{label}: {run['step_ms']:.1f} ms a step under faults against {dist['step_ms']:.1f} "
          f"fault-free; split {', '.join(f'{k} {v:.1f} ms' for k, v in run['split'].items())}; "
          f"phase wall {time.perf_counter() - wall:.1f} s; on {card}", flush=True)
    bad = []
    if run["losses"] != dist["losses"]:
        bad.append(f"losses {run['losses']} are not the fault-free run's {dist['losses']}")
    if run["digest"] != dist["digest"]:
        bad.append("the parameters after the steps are not bitwise the fault-free run's")
    if not all(fired.values()):
        bad.append(f"a fault kind never fired: {fired}")
    for k in ("rpc_retry", "conn_revive"):
        if not heals[k]:
            bad.append(f"{k} never fired")
    if not servers["push_dedup"]:
        bad.append("the servers deduped no resent push")
    if heals["degraded_jobs"] or heals["rpc_giveup"]:
        bad.append(f"a step degraded: {heals}")
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    print(f"{label}: losses and parameters bitwise the fault-free run's", flush=True)
    return {k: v // n for k, v in run["launches"].items()}


def train_distributed_native(card: str, python_first_loss: float) -> None:
    """The distributed path on the native lanes: both servers' data plane
    in C++ (BYTEPS_SERVER_NATIVE=1) and the worker's client lanes
    (BYTEPS_NATIVE_CLIENT=1), NATIVE_STEPS timed steps at full depth; then
    each half alone, NATIVE_HALF_STEPS timed steps at NATIVE_HALF_LAYERS:
    the C++ servers with the Python client, the Python servers with the
    native client.  The first step's loss (same weights, same tokens, no
    update yet) must be bitwise the Python-lane run's at full depth, and at
    NATIVE_HALF_LAYERS bitwise the loss of the same model's forward in
    this process without the PS."""
    import torch

    import byteps_tpu_torch as bps

    bps.init()
    _, model, tok, tgt = _bert(NATIVE_HALF_LAYERS)
    half_first = float(model.loss(tok, tgt).detach())
    bps.shutdown()
    del model
    runs = {}
    for label, steps, server, client, layers in (
            ("native lanes", NATIVE_STEPS, True, True, N_LAYERS_FULL),
            ("native server, Python client", NATIVE_HALF_STEPS, True, False, NATIVE_HALF_LAYERS),
            ("Python server, native client", NATIVE_HALF_STEPS, False, True, NATIVE_HALF_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        runs[label] = _run_distributed(card, label, steps, server_native=server,
                                       client_native=client, layers=layers)
        runs[label]["want_first"] = (python_first_loss if layers == N_LAYERS_FULL
                                     else half_first)
    bad = {label: r["losses"][0] for label, r in runs.items()
           if r["losses"][0] != r["want_first"]}
    if bad:
        fail(f"native lanes: first-step losses {bad} differ from the Python lanes' "
             f"{python_first_loss!r} (24 layers) or the forward's {half_first!r} "
             f"({NATIVE_HALF_LAYERS} layers)")
    print(f"native lanes: first-step loss bitwise the Python lanes' ({python_first_loss!r}) "
          f"at {N_LAYERS_FULL} layers, and at {NATIVE_HALF_LAYERS} layers the halves' bitwise "
          f"the forward's without the PS ({half_first!r}); ms a step: "
          + ", ".join(f"{label} {r['step_ms']:.1f}" for label, r in runs.items()), flush=True)


def check_f1_division() -> None:
    """ROADMAP Queue 3 F1, on the card: ``common.types.divide`` and the
    engine's average (``_finalize`` with 3 workers) equal the CPU's true
    division bitwise, over 3, 6 and 7, for float32 and bfloat16; a Python
    scalar divisor on the card (a multiply by the reciprocal) is counted
    beside, not required to differ."""
    import types

    import torch

    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.types import divide, to_datatype
    from byteps_tpu_torch.core.engine import PipelineEngine, _Job
    from byteps_tpu_torch.core.state import get_state

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    engine = PipelineEngine(Config(), types.SimpleNamespace(num_workers=3))
    rng = np.random.default_rng(11)
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        x_cpu = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).to(dtype)
        x = x_cpu.cuda()
        for n in (3, 6, 7):
            want = x_cpu / n
            got = divide(x, n).cpu()
            scalar = (x / n).cpu()
            if not torch.equal(bits(got), bits(want)):
                fail(f"F1: divide() of {dtype} by {n} on the card is not the CPU's division")
            lines.append(f"{str(dtype)[6:]} / {n}: {int((scalar != want).sum())} of "
                         f"{want.numel()} differ with a Python-scalar divisor")
        # the engine's average over 3 workers, on its device lane
        handle = get_state().handles.allocate()
        job = _Job("f1", types.SimpleNamespace(partitions=[None], version=1), x.reshape(-1),
                   int(to_datatype(dtype)), True, handle, tuple(x.shape), True, x.device, None)
        job.device_parts = {0: x.reshape(-1)}
        torch.cuda.synchronize()
        engine._finalize(job)
        res = get_state().handles.wait_and_clear(handle)
        res.event.synchronize()
        if not torch.equal(bits(res.tensor.cpu()), bits(x_cpu / 3)):
            fail(f"F1: the engine's average of {dtype} over 3 workers on the card is not "
                 "the CPU's division")
    print("F1: divide() over 3, 6, 7 and the engine's average over 3 workers equal the "
          "CPU's division bitwise for float32 and bfloat16 on the card; "
          + "; ".join(lines), flush=True)


#: the compression config BytePS documents, and its learning rate for the
#: error-feedback residual
CHAIN_PARAMS = {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov",
                "scaling": True}
EF_LR = 1e-4
CHAIN_WARMUP, CHAIN_STEPS = 1, 2
#: BERT-large's raw gradient a step: 4 bytes for each of its 365,258,752 parameters
RAW_GRAD_BYTES = 1_461_035_008
# the device codecs' phases: 2 layers at BERT-large's widths, so the
# partitions stay full size
CODEC_LAYERS, CODEC_STEPS = 2, 3
TOPK_PARAMS = {"compressor": "topk", "k": 0.01}
DITHER_PARAMS = {"compressor": "dithering", "k": 4, "partition": "natural",
                 "normalize": "l2"}
RANDOMK_PARAMS = {"compressor": "randomk", "k": 0.01, "ef": "vanilla", "seed": 42}
# DDP and CrossBarrier: 2 layers in f32 without remat, a smaller batch
DDP_BATCH, DDP_STEPS = 8, 3


@contextlib.contextmanager
def _tap_first_compress():
    """Record the first partition a host codec chain compresses: the
    tensor's declare kwargs, a copy of the host copy of its gradient, and
    the payload the worker sent."""
    import threading

    from byteps_tpu_torch.core import engine

    orig = engine.PipelineEngine._compress_once
    lock = threading.Lock()
    seen: dict = {}

    def tap(self, task):
        with lock:
            first = not seen and task.compressed is None
            if first:
                seen.update(key=task.key, kwargs=dict(task.context.ctx.kwargs),
                            host=np.array(task.cpubuff, copy=True))
        orig(self, task)
        if first:
            seen["payload"] = bytes(task.compressed)

    engine.PipelineEngine._compress_once = tap
    try:
        yield seen
    finally:
        engine.PipelineEngine._compress_once = orig


def _check_replay(label: str, seen: dict, lr: float) -> None:
    """The payload the worker sent for its first compressed partition, bit
    for bit a fresh chain's (first round, residuals zero) on the same host
    copy, run here on the CPU."""
    from byteps_tpu_torch.compression.registry import apply_lr_to_chain, create_compressor

    if "payload" not in seen:
        fail(f"{label}: no partition went through a host codec chain")
    chain = create_compressor(seen["kwargs"], seen["host"].size)
    apply_lr_to_chain(chain, lr)
    replay = chain.compress(seen["host"])
    if replay != seen["payload"]:
        fail(f"{label}: the payload sent for key {seen['key']} differs from a CPU replay "
             f"of the chain ({len(seen['payload'])} vs {len(replay)} bytes)")
    print(f"{label}: key {seen['key']}'s first payload ({len(replay)} bytes, "
          f"{seen['host'].size} elements) is bitwise a CPU replay of the chain", flush=True)


def _server_lrs(log_dir: str) -> list:
    """The error-feedback lr each server's log says it applied."""
    out = []
    for i in range(2):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            lrs = [float(line.split("error-feedback lr ")[1].split()[0])
                   for line in f if "error-feedback lr " in line]
        out.append(lrs)
    return out


def train_compressed_chain(card: str, bare_wire_step: int) -> None:
    """BytePS's documented compressed training: BERT-large at full depth on
    this card, one worker and two server processes, onebit + error feedback
    + Nesterov momentum with scaling on every float32 gradient of at least
    BYTEPS_MIN_COMPRESS_BYTES, the lr fed to the chains before the first
    step.  Error-feedback chains take the host lane, so the whole raw
    gradient crosses to the host and K4 does not run."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    label = "compressed chain"
    wall = time.perf_counter()
    with _ps_fleet(label) as fleet:
        bps.init()
        cfg, model, tok, tgt = _bert(N_LAYERS_FULL)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=EF_LR, weight_decay=1e-4),
            named_parameters=model.named_parameters(), compression_params=CHAIN_PARAMS,
        )
        bps.set_compression_lr(EF_LR)
        step = build_train_step(model, opt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        t0 = time.perf_counter()
        with _tap_first_compress() as seen:
            losses = [float(step(tok, tgt)) for _ in range(CHAIN_WARMUP)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        timed, split, dt = _timed_steps(model, opt, tok, tgt, CHAIN_STEPS)
        losses += timed
        losses.append(profile_step(step, tok, tgt, dt / CHAIN_STEPS * 1e3)[0])
        torch.cuda.synchronize()
        launches = {**fa.launches, **ob.launches}
        stats = counters().snapshot()
        engine = get_state().engine
        table = engine.partition_table()
        wire = {k: c.wire_nbytes() for k, c in engine._compressors.items()}
        worker_lrs = {c.inner.lr for c in engine._compressors.values()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        bps.shutdown()
        del model, opt, step
        server_lrs = _server_lrs(fleet.log_dir)

    n = CHAIN_WARMUP + CHAIN_STEPS + 1
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss: {losses}")
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    raw_bytes = sum(r["length"] * r["itemsize"] for r in grads)
    want_wire = sum(wire.get(r["key"], r["length"] * r["itemsize"]) for r in grads)
    if raw_bytes != RAW_GRAD_BYTES:
        fail(f"{label}: the partition table holds {raw_bytes} gradient bytes, not "
             f"BERT-large's {RAW_GRAD_BYTES}")
    if stats.get("d2h_bytes", 0) != n * raw_bytes:
        fail(f"{label}: {stats.get('d2h_bytes', 0) / n:.0f} bytes a step crossed device "
             f"to host, expected the whole raw gradient, {raw_bytes}")
    if stats.get("wire_tx_bytes", 0) != n * want_wire or want_wire != bare_wire_step:
        fail(f"{label}: wire_tx_bytes {stats.get('wire_tx_bytes', 0) / n:.0f} a step, "
             f"expected {want_wire} from the chains' payload sizes and the bare-onebit "
             f"run's {bare_wire_step}")
    if launches["onebit_pack"] != 0:
        fail(f"{label}: K4 launched {launches['onebit_pack']} times on the host lane")
    want_flash = {"flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
                  "flash_bwd_dkv": cfg.n_layers * n}
    if {k: launches[k] for k in want_flash} != want_flash:
        fail(f"{label}: flash launches {launches}, expected {want_flash}")
    if worker_lrs != {EF_LR}:
        fail(f"{label}: the worker's error-feedback chains hold lr {worker_lrs}")
    if not all(lrs and set(lrs) == {EF_LR} for lrs in server_lrs):
        fail(f"{label}: the servers report error-feedback lr {server_lrs}, expected {EF_LR}")
    _check_replay(label, seen, EF_LR)
    print(f"{label}: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}, {cfg.n_layers} "
          f"layers, 1 worker + 2 server processes, {CHAIN_PARAMS} with lr {EF_LR} on "
          f"{len(wire)} of {len(grads)} gradient partitions: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"{label}: {BATCH * CHAIN_STEPS / dt:.2f} samples/s ({dt / CHAIN_STEPS * 1e3:.1f} "
          f"ms/step over {CHAIN_STEPS} steps; first step {first_s:.1f} s with the init "
          f"barriers), peak memory {peak:.2f} GiB, on {card}; step split "
          f"{_split_line(split, CHAIN_STEPS)}", flush=True)
    print(f"{label}: per step d2h_bytes {raw_bytes} (the raw gradient), wire_tx_bytes "
          f"{want_wire} (= the bare-onebit run's {bare_wire_step}), wire_rx_bytes "
          f"{stats.get('wire_rx_bytes', 0) // n}; launches {launches}; servers applied lr "
          f"{server_lrs}; phase wall {time.perf_counter() - wall:.1f} s", flush=True)


def _train_codec(card: str, label: str, params: dict, lr: float = 0.0) -> dict:
    """CODEC_STEPS steps of BERT-large's widths at CODEC_LAYERS layers
    through one worker and two server processes with ``params``; returns
    what was counted: losses, launches, counters, the partition table, the
    chains' payload sizes, the first compressed partition (tapped), s/step."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    wall = time.perf_counter()
    with _ps_fleet(label):
        bps.init()
        cfg, model, tok, tgt = _bert(CODEC_LAYERS)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(), compression_params=params,
        )
        if lr:
            bps.set_compression_lr(lr)
        step = build_train_step(model, opt)
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        with _tap_first_compress() as seen:
            losses = [float(step(tok, tgt))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [float(step(tok, tgt)) for _ in range(CODEC_STEPS - 1)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (CODEC_STEPS - 1)
        out = {"losses": losses, "launches": {**fa.launches, **ob.launches},
               "stats": counters().snapshot(), "table": get_state().engine.partition_table(),
               "wire": {k: c.wire_nbytes() for k, c in get_state().engine._compressors.items()},
               "seen": seen, "step_s": dt, "n_layers": cfg.n_layers}
        bps.shutdown()
        del model, opt, step
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss: {losses}")
    want_flash = {"flash_fwd": 2 * cfg.n_layers * CODEC_STEPS,
                  "flash_bwd_dq": cfg.n_layers * CODEC_STEPS,
                  "flash_bwd_dkv": cfg.n_layers * CODEC_STEPS}
    if {k: out["launches"][k] for k in want_flash} != want_flash:
        fail(f"{label}: flash launches {out['launches']}, expected {want_flash}")
    out["wall_s"] = time.perf_counter() - wall
    return out


def train_device_codecs(card: str) -> None:
    """Bare topk and bare dithering on the device lane: the codec runs on
    the card and only its payload crosses to the host (8k bytes a partition
    for topk, 4 + n for dithering)."""
    for name, params in (("topk", TOPK_PARAMS), ("dithering", DITHER_PARAMS)):
        label = f"device {name} lane"
        out = _train_codec(card, label, params)
        grads = [r for r in out["table"] if r["name"].startswith("Gradient.")]
        compressed = [r for r in grads if r["wire_nbytes"] is not None]
        raw = [r for r in grads if r["wire_nbytes"] is None]
        if len(compressed) != len(out["wire"]) or not compressed:
            fail(f"{label}: {len(compressed)} partitions on the device lane of "
                 f"{len(out['wire'])} compressed")
        for r in compressed:
            want = (8 * max(1, int(0.01 * r["length"])) if name == "topk"
                    else 4 + r["length"])
            if r["wire_nbytes"] != want:
                fail(f"{label}: key {r['key']} ({r['length']} elements) has a {r['wire_nbytes']}"
                     f"-byte payload, expected {want}")
        want_d2h = (sum(r["wire_nbytes"] for r in compressed)
                    + sum(r["length"] * r["itemsize"] for r in raw))
        if out["stats"].get("d2h_bytes", 0) != CODEC_STEPS * want_d2h:
            fail(f"{label}: {out['stats'].get('d2h_bytes', 0) / CODEC_STEPS:.0f} bytes a step "
                 f"crossed device to host, expected {want_d2h} (the device payloads plus "
                 "raw small tensors)")
        if out["launches"]["onebit_pack"]:
            fail(f"{label}: K4 launched {out['launches']['onebit_pack']} times")
        raw_bytes = sum(r["length"] * r["itemsize"] for r in grads)
        print(f"{label}: BERT-large widths, {out['n_layers']} layers, batch {BATCH}, "
              f"{params} on {len(compressed)} of {len(grads)} gradient partitions: losses "
              f"{[round(x, 4) for x in out['losses']]}; {out['step_s'] * 1e3:.1f} ms/step; per "
              f"step d2h_bytes {want_d2h} (raw gradient {raw_bytes}, "
              f"{raw_bytes / want_d2h:.1f}x more), wire_tx_bytes "
              f"{out['stats'].get('wire_tx_bytes', 0) // CODEC_STEPS}; phase wall "
              f"{out['wall_s']:.1f} s, on {card}", flush=True)


def check_device_codecs() -> None:
    """The device topk and dithering on the card at one full partition:
    topk on an input whose magnitudes tie at the k-th place bitwise the
    CPU plain version's and the host codec's payload; dithering decoded by
    the host codec bit for bit as on the card, and unbiased (the statistics
    of tests/test_ops.py:273); then each timed with L2 cold (median of 20,
    CUDA events) beside its bytes bound, and each adapter's whole compress
    (codec and the copy to pinned host memory, host clock, median of 20);
    and the servers' host codecs at that partition."""
    import torch

    from byteps_tpu_torch.compression.impl import DitheringCompressor, TopKCompressor
    from byteps_tpu_torch.core.device_codec import device_codec_for
    from byteps_tpu_torch.ops import codecs_device as cd

    n = ONEBIT_TIMED_N
    k = int(TOPK_PARAMS["k"] * n)
    rng = np.random.default_rng(5)
    tied = (rng.choice([-3.0, -2.0, -1.0, -0.0, 0.0, 1.0, 2.0, 3.0], size=n)
            * 0.25).astype(np.float32)
    xt = torch.from_numpy(tied).cuda()
    card_payload = cd.topk_payload_device(xt, k).cpu().numpy().tobytes()
    if card_payload != cd.topk_payload_device(torch.from_numpy(tied), k).numpy().tobytes():
        fail("device topk: the card's payload differs from the CPU plain version's on tied "
             "magnitudes")
    if card_payload != TopKCompressor(n, k).compress(tied):
        fail("device topk: the card's payload differs from the host codec's")
    dec = cd.topk_decompress_device(torch.from_numpy(
        np.frombuffer(card_payload, np.uint8).copy()).cuda(), n)
    if not np.array_equal(dec.cpu().numpy(), TopKCompressor(n, k).decompress(card_payload, n)):
        fail("device topk: the card's decode differs from the host codec's")

    s, natural, l2 = DITHER_PARAMS["k"], True, True
    x = torch.randn(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    payload = cd.dithering_payload_device(x, gen, s, natural, l2)
    host = DitheringCompressor(n, k=s, partition="natural", normalize="l2")
    if not np.array_equal(cd.dithering_decompress_device(payload, n, s, natural).cpu().numpy(),
                          host.decompress(payload.cpu().numpy().tobytes(), n)):
        fail("device dithering: the card's decode differs from the host codec's")
    levels = payload[4:].view(torch.int8).int()
    if int(levels.abs().max()) > s:
        fail(f"device dithering: a level beyond {s}")
    m, trials = 512, 200
    g = torch.from_numpy(np.random.default_rng(3).normal(size=m).astype(np.float32)).cuda()
    acc = torch.zeros(m, dtype=torch.float64, device="cuda")
    for t in range(trials):
        p = cd.dithering_payload_device(g, torch.Generator(device="cuda").manual_seed(t), 4)
        acc += cd.dithering_decompress_device(p, m, 4).double()
    se = float(g.abs().max()) / 4 / math.sqrt(trials)
    worst = float((acc / trials - g.double()).abs().max())
    if not worst <= 6 * se:
        fail(f"device dithering: mean of {trials} draws {worst:.3e} from the input, beyond "
             f"6 standard errors ({6 * se:.3e})")
    print(f"check device codecs n={n}: topk (k={k}) on tied magnitudes bitwise the CPU plain "
          "version's and the host codec's payload; dithering (natural, l2, 4 levels) decoded "
          f"bitwise by the host codec; unbiased: mean of {trials} draws within {worst:.3e} "
          f"(bound {6 * se:.3e})", flush=True)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    # the full partition the path runs, and four times it
    for m in (n, 4 * n):
        xm = x if m == n else torch.randn(m, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(m))
        km = int(TOPK_PARAMS["k"] * m)
        cases = (
            ("topk", lambda: cd.topk_payload_device(xm, km), 4 * m + 8 * km,
             device_codec_for({"byteps_compressor_type": "topk",
                               "byteps_compressor_k": "0.01"}, m)),
            ("dithering", lambda: cd.dithering_payload_device(xm, gen, s, natural, l2), 5 * m + 4,
             device_codec_for({"byteps_compressor_type": "dithering", "byteps_compressor_k": "4",
                               "byteps_dithering_partition": "1",
                               "byteps_dithering_normalize": "1"}, m)),
        )
        for name, launch, nbytes, adapter in cases:
            # tens of launches a call: a sleep long enough for a slow host to
            # enqueue them all, so the events time the device, not the enqueue
            ms = float(np.median(_cold_events_ms(launch, flush,
                                                 sleep_cycles=20 * SLEEP_CYCLES)))
            calls = []
            for i in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                adapter.compress(xm)
                if i:
                    calls.append((time.perf_counter() - t0) * 1e3)
            bound_ms = nbytes / PEAK_BYTES * 1e3
            print(f"time device {name} n={m}: device {ms:.5f} ms with L2 cold (median of 20, "
                  f"events), bound {bound_ms:.5f} ms (bytes: {nbytes}), {bound_ms / ms:.3f} of "
                  f"it; the adapter's compress (codec + copy to pinned host memory) "
                  f"{float(np.median(calls)):.4f} ms (host clock, median of 20)",
                  flush=True)
    del flush

    # what a server does with each such partition on this machine's CPU:
    # decode a push, encode the merged round for the pull (numpy, one
    # thread, median of 3)
    from byteps_tpu_torch.compression.registry import (
        create_compressor, translate_compression_params,
    )

    host = x.cpu().numpy()
    for name, params in (("topk", TOPK_PARAMS), ("randomk", RANDOMK_PARAMS),
                         ("dithering", DITHER_PARAMS)):
        codec = create_compressor(translate_compression_params(
            {k: v for k, v in params.items() if k != "ef"}), n, server=True)
        payload = codec.compress(host)
        times = {}
        # the C++ entries where the codec has them, and the numpy plain versions
        for label, fn in (("compress", lambda: codec.compress(host)),
                          ("decompress", lambda: codec.decompress(payload, n)),
                          ("numpy compress", lambda: codec.compress_plain(host)),
                          ("numpy decompress",
                           lambda: getattr(codec, "decompress_plain", codec.decompress)(
                               payload, n))):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                runs.append((time.perf_counter() - t0) * 1e3)
            times[label] = float(np.median(runs))
        print(f"time {name} host codec n={n} (host CPU, median of 3): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()), flush=True)


def train_randomk_ef(card: str) -> None:
    """randomk with error feedback on the host lane, 2 layers: finite losses,
    and the first payload bitwise a CPU replay of the chain."""
    label = "randomk + EF host lane"
    out = _train_codec(card, label, RANDOMK_PARAMS, lr=EF_LR)
    grads = [r for r in out["table"] if r["name"].startswith("Gradient.")]
    raw_bytes = sum(r["length"] * r["itemsize"] for r in grads)
    if out["stats"].get("d2h_bytes", 0) != CODEC_STEPS * raw_bytes:
        fail(f"{label}: {out['stats'].get('d2h_bytes', 0) / CODEC_STEPS:.0f} bytes a step "
             f"crossed device to host, expected the raw gradient, {raw_bytes}")
    _check_replay(label, out["seen"], EF_LR)
    print(f"{label}: {RANDOMK_PARAMS} with lr {EF_LR} on {len(out['wire'])} of {len(grads)} "
          f"gradient partitions, {out['n_layers']} layers: losses "
          f"{[round(x, 4) for x in out['losses']]}; {out['step_s'] * 1e3:.1f} ms/step; per "
          f"step wire_tx_bytes {out['stats'].get('wire_tx_bytes', 0) // CODEC_STEPS}; phase "
          f"wall {out['wall_s']:.1f} s, on {card}", flush=True)


def _max_diff(a, b) -> float:
    """The largest abs difference between two models' parameters."""
    import torch

    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(a.parameters(), b.parameters()))


def check_ddp_cross_barrier(card: str) -> None:
    """DistributedDataParallel and CrossBarrier on the card, through one
    worker and two server processes, raw: 2 layers at BERT-large's widths in
    f32 without remat.  DDP + AdamW leaves the parameters bitwise those of
    DistributedOptimizer + AdamW after DDP_STEPS steps (one worker averages
    by 1); CrossBarrier(adam) matches torch.optim.Adam, stepping a copy of
    its parameters, within atol 1e-6 after DDP_STEPS steps;
    two backward passes in a row push the second gradient (the first plus
    the second, as autograd accumulated them), not zeros."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import cross_barrier as cb_mod
    from byteps_tpu_torch.models.transformer import build_train_step, token_loss

    label = "DDP and CrossBarrier"
    wall = time.perf_counter()

    def model():
        _, m, tok, tgt = _bert(CODEC_LAYERS, batch=DDP_BATCH, compute_dtype=torch.float32,
                               remat=False)
        return m, tok, tgt

    with _ps_fleet(label):
        bps.init()
        m1, tok, tgt = model()
        ddp = bps.parallel.DistributedDataParallel(m1)
        o1 = torch.optim.AdamW(m1.parameters(), lr=1e-4, weight_decay=1e-4)
        for _ in range(DDP_STEPS):
            o1.zero_grad(set_to_none=True)
            token_loss(ddp(tok), tgt).backward()
            ddp.grad_sync()
            o1.step()
        m2, _, _ = model()
        o2 = bps.DistributedOptimizer(
            torch.optim.AdamW(m2.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=m2.named_parameters())
        step = build_train_step(m2, o2)
        for _ in range(DDP_STEPS):
            step(tok, tgt)
        torch.cuda.synchronize()
        diff = _max_diff(m1, m2)
        if diff != 0.0:
            fail(f"{label}: DDP + AdamW and DistributedOptimizer + AdamW differ after "
                 f"{DDP_STEPS} steps, max abs {diff:.3e}")
        buckets = len(ddp._buckets)
        del ddp, o1, m1, o2, m2, step

        # torch's Adam steps a copy of CrossBarrier's parameters as each
        # forward left them, so both optimizers see the same gradients: Adam
        # divides by sqrt(v), and a gradient near 0 that differs in the last
        # place between two runs would move a parameter by up to lr
        m3, _, _ = model()
        cb = bps.CrossBarrier(m3, opt_name="adam", lr=1e-4)
        m4, _, _ = model()
        o4 = torch.optim.Adam(m4.parameters(), lr=1e-4)
        for _ in range(DDP_STEPS):
            m3.loss(tok, tgt).backward()
            with torch.no_grad():
                for a, b in zip(m3.parameters(), m4.parameters()):
                    b.copy_(a)
            o4.zero_grad(set_to_none=True)
            m4.loss(tok, tgt).backward()
            o4.step()
        cb.step()
        torch.cuda.synchronize()
        cb_diff = _max_diff(m3, m4)
        if not cb_diff <= 1e-6:
            fail(f"{label}: CrossBarrier(adam) and torch.optim.Adam differ by {cb_diff:.3e} "
                 f"after {DDP_STEPS} steps (atol 1e-6)")
        del cb, m3, m4, o4

        m5, _, _ = model()
        params = list(m5.parameters())
        g = torch.autograd.grad(m5.loss(tok, tgt), params)
        names = {f"CrossBarrier.{cb_mod.CrossBarrier._instances}.{n}": i
                 for i, (n, _) in enumerate(m5.named_parameters())}
        cb5 = bps.CrossBarrier(m5, opt_name="sgd", lr=1e-4)
        pushed, orig = [], cb_mod.push_pull_async
        cb_mod.push_pull_async = lambda t, **kw: (pushed.append((kw["name"], t)),
                                                  orig(t, **kw))[1]
        try:
            losses = [m5.loss(tok, tgt) for _ in range(2)]
            losses[0].backward()
            losses[1].backward()
            cb5.step()
        finally:
            cb_mod.push_pull_async = orig
        torch.cuda.synchronize()
        second = pushed[len(params):]
        if len(second) != len(params):
            fail(f"{label}: {len(pushed)} pushes in two backward passes of {len(params)} "
                 "parameters")
        worst = 0.0
        for name, t in second:
            want = 2 * g[names[name]]
            if not bool(t.abs().max() > 0):
                fail(f"{label}: the second backward pushed zeros for {name}")
            worst = max(worst, float(((t - want).abs() - 1e-6 * want.abs()).max()))
        if not worst <= 1e-7:
            fail(f"{label}: the second backward's pushes are not the accumulated gradient "
                 f"(worst {worst:.3e} beyond rtol 1e-6, atol 1e-7)")
        bps.shutdown()
    print(f"{label}: 2 layers at BERT-large's widths, f32, batch {DDP_BATCH}, 1 worker + 2 "
          f"server processes, raw: DDP ({buckets} buckets) + AdamW bitwise "
          f"DistributedOptimizer + AdamW after {DDP_STEPS} steps; CrossBarrier(adam) within "
          f"{cb_diff:.3e} of torch.optim.Adam; two backward passes in a row pushed the "
          f"accumulated gradient, not zeros; phase wall {time.perf_counter() - wall:.1f} s, on "
          f"{card}", flush=True)


# the hybrid path: two hosts (launchers) of one process each on this card,
# DMLC_NUM_WORKER=2 behind a scheduler and two servers
HYBRID_HOSTS = 2
HYBRID_BATCH = BATCH // HYBRID_HOSTS  # per host: 16, the main path's 32 together
# two timed steps (six, and 8 steps in all, before the data plane's phase (f)
# joined): with two workers the servers re-sign the sum of two 1-bit
# payloads, so each partition's pull carries the signs of the host whose
# scale is the larger (checked bitwise on one partition:
# _check_server_rounds); two hosts at 2 layers on bare onebit fell from
# 10.84 to 10.49 in 3 steps in phase (b) (NVIDIA H100 80GB HBM3, 700 W)
HYBRID_WARMUP, HYBRID_STEPS = 1, 2
#: the hybrid's BERT-large depth, cut from 24 with online resharding's phase
#: and from 6 with the data plane's, to keep the script under 75% of its
#: time limit (its partition table under bare onebit: ``onebit_table``)
HYBRID_LAYERS = 2
# the 2-layer equivalence: f32, SGD, 4 sequences a host, 3 steps.  Bitwise one
# process that averages the two halves' gradients as the servers do, and
# within atol 1e-5 + rtol 1e-4 of one process on the combined batch of 8: the
# same f32 sums split in two and averaged differ in the last places, and the
# embeddings (layer-normed at init from values ~0.02) grow such a difference
# ~30x a step at lr 1e-3 (9.7e-6 after three steps on the card), ~10x at 3e-4,
# while the parameters move ~2e-4
EQ_LAYERS, EQ_BATCH, EQ_STEPS, EQ_LR = 2, 4, 3, 3e-4
EQ_ATOL, EQ_RTOL = 1e-5, 1e-4
# the step builders at one rank: 2 layers, f32, batch 8 (two micro-batches of
# 4 for accumulate_steps=2), 3 optimizer steps, within 1e-6 of
# DistributedOptimizer at one worker
BUILDER_STEPS, BUILDER_ATOL = 3, 1e-6


def _param_digest(model) -> str:
    """sha256 over every parameter's bytes, in order: equal digests are
    bitwise equal parameters."""
    import hashlib

    import torch

    h = hashlib.sha256()
    with torch.no_grad():
        for p in model.parameters():
            h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _check_one_rank_nccl(mesh) -> list:
    """Each collective of the host's one-rank NCCL group leaves its input
    bitwise as it was: this checks NCCL's bring-up and the wiring, not a
    reduction."""
    import torch

    from byteps_tpu_torch.comm import collectives as coll

    x = torch.randn(4099, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    rows = x[:4096].reshape(64, 64)
    runs = {
        "all_reduce": (coll.push_pull(x, average=False), x),
        "all_reduce (scatter_gather: reduce_scatter_tensor + all_gather_into_tensor)":
            (coll.push_pull(x, average=False, mode="scatter_gather"), x),
        "reduce_scatter_tensor": (coll.reduce_scatter(rows, average=False), rows),
        "all_gather_into_tensor": (coll.all_gather(rows), rows),
        "broadcast": (coll.broadcast(x), x),
    }
    torch.cuda.synchronize()
    bad = [k for k, (got, want) in runs.items()
           if got.device.type != "cuda" or not torch.equal(got, want)]
    if bad:
        fail(f"hybrid: one-rank NCCL collectives changed their input: {bad}")
    return list(runs)


@contextlib.contextmanager
def _tap_onebit_rounds(client):
    """Record what this worker's PS client sends and receives for its
    compressed (onebit) partitions: the scale of every push, by key in
    round order, and for the first key pushed, the whole payload of every
    push and of every pull.  The engine's stage threads hold their stage
    functions from its start, so the tap wraps the client's calls."""
    import threading

    from byteps_tpu_torch.common.types import RequestType

    push, pull = client.push, client.pull
    lock = threading.Lock()
    seen: dict = {"key": None, "scales": {}, "pushed": [], "pulled": []}

    def tap_push(key, payload, *args, **kwargs):
        if kwargs.get("request_type") == RequestType.COMPRESSED_PUSH_PULL:
            buf = bytes(memoryview(payload).cast("B"))
            with lock:
                if seen["key"] is None:
                    seen["key"] = key
                seen["scales"].setdefault(key, []).append(
                    float(np.frombuffer(buf[:4], np.float32)[0]))
                if key == seen["key"]:
                    seen["pushed"].append(buf)
        return push(key, payload, *args, **kwargs)

    def tap_pull(key, version, on_pull, *args, **kwargs):
        if key == seen["key"]:
            def on_pull_tapped(payload):
                with lock:
                    seen["pulled"].append(bytes(payload))
                on_pull(payload)
            return pull(key, version, on_pull_tapped, *args, **kwargs)
        return pull(key, version, on_pull, *args, **kwargs)

    client.push, client.pull = tap_push, tap_pull
    try:
        yield seen
    finally:
        client.push, client.pull = push, pull


@contextlib.contextmanager
def _tap_blocking_requests(client):
    """Count and time the PS client's blocking requests (each partition's
    init barrier and its codec registration): {name: [calls, seconds]}."""
    seen = {"init_tensor": [0, 0.0], "register_compressor": [0, 0.0]}
    orig = {name: getattr(client, name) for name in seen}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig[name](*args, **kwargs)
            finally:
                seen[name][0] += 1
                seen[name][1] += time.perf_counter() - t0
        return call

    for name in seen:
        setattr(client, name, timed(name))
    try:
        yield seen
    finally:
        for name, fn in orig.items():
            setattr(client, name, fn)


def hybrid_host(work: str) -> None:
    """One host of the hybrid phase, run by the port's launcher at
    BYTEPS_LOCAL_SIZE=1 (``chip_smoke.py --hybrid-host <dir>``): init()
    brings up a one-rank NCCL group on the card from the launcher's
    rendezvous and makes it the global mesh, so every push_pull is
    host-level (the group's all-reduce, the PS across the two hosts, the
    broadcast); then the 2-layer equivalence through HybridDataParallel and
    BERT-large at HYBRID_LAYERS through DistributedOptimizer(AdamW) with
    bare onebit.  Writes what it measured to <dir>/host<h>.json and its onebit
    rounds (``_tap_onebit_rounds``) to <dir>/host<h>.rounds.pkl."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob
    from byteps_tpu_torch.parallel import HybridDataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    _host_go()
    t0 = time.perf_counter()
    bps.init()
    mesh = get_global_mesh()
    if mesh is None or mesh.backend != "nccl" or mesh.size != bps.local_size():
        fail(f"hybrid host {host}: init() under the launcher brought up {mesh!r}, expected "
             f"the host's NCCL group of {bps.local_size()}")
    out = {"host": host, "rank": bps.rank(), "size": bps.size(), "mesh": repr(mesh),
           "device": str(bps.device()), "init_s": time.perf_counter() - t0,
           "nccl_checks": _check_one_rank_nccl(mesh)}

    # the 2-layer equivalence, f32
    fa.reset_launches()
    _, model, tok, tgt = _bert(EQ_LAYERS, batch=HYBRID_HOSTS * EQ_BATCH,
                               compute_dtype=torch.float32, remat=False)
    rows = slice(host * EQ_BATCH, (host + 1) * EQ_BATCH)
    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=EQ_LR))
    out["eq_losses"] = [hdp.step((tok[rows], tgt[rows]), lambda m, b: m.loss(*b))
                        for _ in range(EQ_STEPS)]
    torch.cuda.synchronize()
    out["eq_digest"] = _param_digest(model)
    out["eq_launches"] = dict(fa.launches)
    if host == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   os.path.join(work, "eq_params.pt"))
    del hdp, model

    # BERT-large at HYBRID_LAYERS, this host's 16 of the main path's 32 sequences
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, tok, tgt = _bert(HYBRID_LAYERS)
    rows = slice(host * HYBRID_BATCH, (host + 1) * HYBRID_BATCH)
    tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression_params={"compressor": "onebit", "scaling": True},
    )
    step = build_train_step(model, opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ob.reset_launches()
    counters().reset()
    metrics().reset()
    client = get_state().ps_client
    with _tap_onebit_rounds(client) as rounds, _tap_blocking_requests(client) as blocking:
        t0 = time.perf_counter()
        losses = [float(step(tok, tgt)) for _ in range(HYBRID_WARMUP)]
        torch.cuda.synchronize()
        out["first_s"] = time.perf_counter() - t0
        out["first_hists"] = metrics().snapshot()["histograms"]
        out["first_blocking"] = dict(blocking)
        metrics().reset()
        timed, split, dt = _timed_steps(model, opt, tok, tgt, HYBRID_STEPS)
        out["hists"] = metrics().snapshot()["histograms"]
        losses += timed
        loss, busy_ms = profile_step(step, tok, tgt, dt / HYBRID_STEPS * 1e3)
        losses.append(loss)
        torch.cuda.synchronize()
    table = get_state().engine.partition_table()
    tapped = next(r for r in table if r["key"] == rounds["key"])
    rounds.update(length=tapped["length"], kwargs=dict(get_registry().get(tapped["name"]).kwargs))
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    compressed = [r for r in grads if r["wire_nbytes"] is not None]
    out.update(
        losses=losses, step_s=dt / HYBRID_STEPS,
        split_ms={k: v / HYBRID_STEPS * 1e3 for k, v in split.items()},
        busy_ms=busy_ms, launches={**fa.launches, **ob.launches},
        counters=counters().snapshot(), steps=HYBRID_WARMUP + HYBRID_STEPS + 1,
        compressed_parts=len(compressed),
        want_d2h=(sum(r["wire_nbytes"] for r in compressed)
                  + sum(r["length"] * r["itemsize"] for r in grads
                        if r["wire_nbytes"] is None)),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        digest=_param_digest(model), n_layers=cfg.n_layers,
    )
    bps.shutdown()
    with open(os.path.join(work, f"host{host}.rounds.pkl"), "wb") as f:
        pickle.dump(rounds, f)
    with open(os.path.join(work, f"host{host}.json"), "w") as f:
        json.dump(out, f)


def _check_server_rounds(label: str, taps: list) -> list:
    """The servers' arithmetic on the workers' 1-bit pushes: every round of
    the first partition the workers tapped, pulled bitwise as a CPU replay
    of the server's codec (decode the first push, add the others, re-sign
    the sum); with two workers, its pulled signs bitwise those of the one
    whose scale was the larger.  Returns, a round, the share of all onebit
    partitions in which worker 0's scale was the larger: whose signs the
    pulls carried (two workers; empty for one)."""
    from byteps_tpu_torch.compression.registry import create_compressor

    a = taps[0]
    if a["key"] is None or any(t["key"] != a["key"] or t["scales"].keys() != a["scales"].keys()
                               for t in taps):
        fail(f"{label}: the workers tapped different onebit partitions")
    n, rounds = a["length"], len(a["pushed"])
    if not rounds or {len(t[k]) for t in taps for k in ("pushed", "pulled")} != {rounds}:
        fail(f"{label}: key {a['key']}'s rounds: pushed and pulled "
             f"{[(len(t['pushed']), len(t['pulled'])) for t in taps]}")
    codec = create_compressor(a["kwargs"], n, server=True)
    for i in range(rounds):
        acc = np.array(codec.decompress(a["pushed"][i], n), dtype=np.float32)
        for t in taps[1:]:
            codec.sum_into(t["pushed"][i], acc)
        replay = bytes(codec.compress(acc))
        if any(replay != t["pulled"][i] for t in taps):
            fail(f"{label}: round {i} of key {a['key']}: the pulled payload is not a CPU "
                 "replay of the servers' decode, sum and re-sign of the pushes")
        if len(taps) == 2:
            b = taps[1]
            lead = a if a["scales"][a["key"]][i] > b["scales"][a["key"]][i] else b
            if replay[4:] != lead["pushed"][i][4:]:
                fail(f"{label}: round {i} of key {a['key']}: the pulled signs are not the "
                     "larger-scale worker's")
    print(f"{label}: key {a['key']} ({n} elements), {rounds} rounds: each pull bitwise a CPU "
          f"replay of the servers' decode, sum and re-sign of the {len(taps)} workers' pushes"
          + (", and bitwise the signs of the worker with the larger scale"
             if len(taps) == 2 else ""), flush=True)
    if len(taps) != 2:
        return []
    s0 = np.array([a["scales"][k] for k in sorted(a["scales"])])
    s1 = np.array([taps[1]["scales"][k] for k in sorted(taps[1]["scales"])])
    if s0.shape != s1.shape:
        fail(f"{label}: the workers pushed {s0.shape} and {s1.shape} onebit partitions x rounds")
    return [float(v) for v in (s0 > s1).mean(axis=0)]


def _host_go() -> None:
    """A launcher host's start before its go: CUDA's context, the matmul
    libraries and what the first optimizer step imports, then a wait for
    the file HOST_GO names, which its phase writes (``_await_hosts``: at
    once, or when the phase comes if ``main`` started the hosts ahead)."""
    import torch

    warm = torch.ones(8, 8, device="cuda" if torch.cuda.is_available() else "cpu",
                      requires_grad=True)
    warm.matmul(warm).sum().backward()
    torch.optim.AdamW([warm], lr=1e-4, weight_decay=1e-4).step()
    float(warm.sum())
    deadline = time.monotonic() + PHASE_STALL_S
    while not os.path.exists(os.environ["HOST_GO"]):
        if time.monotonic() > deadline:
            sys.exit(f"host {os.environ.get('DMLC_WORKER_ID')}: no go file after "
                     f"{PHASE_STALL_S} s")
        time.sleep(0.05)


def _launch_hosts(env: dict, flag: str, work: str, server_env: dict = None,
                  host_env=None) -> dict:
    """A scheduler and two servers (their logs in ``work``; the servers with
    ``server_env``), and HYBRID_HOSTS hosts, each `python -m
    byteps_tpu_torch.launcher.launch` running `chip_smoke.py <flag> <work>`
    as worker DMLC_WORKER_ID=h, with ``host_env(h, server ports)`` added;
    each host comes up and waits for <work>/go (``_host_go``).  Returns what
    ``_await_hosts`` takes."""
    server_ports: list = []
    port, procs = _start_ps_processes(env, work, server_env, server_ports)
    hosts = []
    try:
        for h in range(HYBRID_HOSTS):
            path = os.path.join(work, f"host{h}.log")
            with open(path, "w") as log:
                hosts.append(_track(subprocess.Popen(
                    [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                     sys.executable, os.path.join(REPO, "chip_smoke.py"), flag, work],
                    cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port, "DMLC_WORKER_ID": str(h),
                                   "HOST_GO": os.path.join(work, "go"),
                                   **(host_env(h, server_ports) if host_env else {})},
                    stdout=log, stderr=subprocess.STDOUT), f"host {h}", path))
    except BaseException:
        _stop_processes(hosts + procs)
        raise
    return {"work": work, "fleet": procs, "hosts": hosts}


def _await_hosts(label: str, started: dict, timeout: float) -> dict:
    """Let the hosts ``_launch_hosts`` started go, wait for them (at most
    ``timeout`` s), stop every process, and fail unless every host exited
    0.  Returns each host's output."""
    work, hosts = started["work"], started["hosts"]
    open(os.path.join(work, "go"), "w").close()
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in hosts) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in hosts):
                break
            time.sleep(0.5)
        rcs = [p.poll() for p in hosts]
    finally:
        _stop_processes(hosts)
        _stop_processes(started["fleet"])
    logs = {}
    for h in range(HYBRID_HOSTS):
        with open(os.path.join(work, f"host{h}.log")) as f:
            logs[h] = f.read()
    if rcs != [0] * HYBRID_HOSTS:
        for h, text in logs.items():
            print(f"--- {label} host {h} (exit {rcs[h]}):\n{text[-6000:]}", file=sys.stderr)
        fail(f"{label}: the hosts exited {rcs}")
    return logs


def _start_hosts(prefix: str, launch) -> dict:
    """``launch(work)`` (a ``_launch_hosts``) in a directory of its own:
    a phase's fleet and hosts started ahead by ``main``, their start
    overlapping the phases before it; ``stop_hosts`` stops them."""
    work = tempfile.mkdtemp(prefix=prefix)
    try:
        return launch(work)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def stop_hosts(started: dict) -> None:
    """Stop what ``_start_hosts`` started and remove its directory."""
    _stop_processes([p for p in started["hosts"] + started["fleet"] if p in _FLEET])
    shutil.rmtree(started["work"], ignore_errors=True)


def _two_hosts_env() -> dict:
    """The environment of a phase's two launcher hosts of one process each
    (DMLC_NUM_WORKER=2, two servers, CRC32C) and of their fleet."""
    env = {**os.environ, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker"}
    env.pop("BYTEPS_FORCE_DISTRIBUTED", None)
    return env


def start_hybrid() -> dict:
    """The hybrid phase's fleet and hosts, each host up and waiting for its
    go: ``main`` starts them ahead of the compressed chain."""
    return _start_hosts("chip_smoke_hybrid_",
                        lambda work: _launch_hosts(_two_hosts_env(), "--hybrid-host", work))


def train_hybrid(card: str, started: dict = None) -> dict:
    """The hybrid path: a scheduler and two servers of the port, and two
    hosts, each `python -m byteps_tpu_torch.launcher.launch` at
    BYTEPS_LOCAL_SIZE=1 on this card (NCCL refuses two ranks of one group on
    one GPU, so each host's group is one process), DMLC_NUM_WORKER=2: the
    port's first run with two workers, real sums on the servers
    (``started``, or started here: ``start_hybrid``).  Checks the
    hosts' one-rank NCCL collectives, the 2-layer equivalence with one
    process on the combined batch, and BERT-large at HYBRID_LAYERS: falling
    losses, both hosts' parameters bitwise equal, bytes against the
    partition table, K1-K4 launched, two pushes summed into every round."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.transformer import build_train_step

    label = "hybrid"
    wall = time.perf_counter()
    started = started or start_hybrid()
    work = started["work"]
    results = []
    try:
        logs = _await_hosts(label, started, timeout=420)
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.json")) as f:
                results.append(json.load(f))
        pushes = _server_report(work)
        eq_params = torch.load(os.path.join(work, "eq_params.pt"))
        taps = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.rounds.pkl"), "rb") as f:
                taps.append(pickle.load(f))
    finally:
        stop_hosts(started)
    led = _check_server_rounds(label, taps)
    for h, text in logs.items():
        for line in text.splitlines():
            if line.startswith("profile: step wall"):
                print(f"{label} host {h} {line}", flush=True)

    # one process on the combined batch, no PS: the equivalence's reference
    bps.init()
    _, model, tok, tgt = _bert(EQ_LAYERS, batch=HYBRID_HOSTS * EQ_BATCH,
                               compute_dtype=torch.float32, remat=False)
    step = build_train_step(model, torch.optim.SGD(model.parameters(), lr=EQ_LR))
    eq_ref = [float(step(tok, tgt)) for _ in range(EQ_STEPS)]
    worst, moved = 0.0, 0.0
    with torch.no_grad():
        for k, v in model.state_dict().items():
            got = eq_params[k].to(v.device)
            worst = max(worst, float(((got - v).abs() - EQ_RTOL * v.abs()).max()))
            moved = max(moved, float((v - _WEIGHTS[EQ_LAYERS][k].to(v.device)).abs().max()))
    del model, step
    # one process averaging the two hosts' halves, the servers' sum then the
    # engine's division: the hybrid's arithmetic, to the bit
    _, halves, _, _ = _bert(EQ_LAYERS, batch=HYBRID_HOSTS * EQ_BATCH,
                            compute_dtype=torch.float32, remat=False)
    opt = torch.optim.SGD(halves.parameters(), lr=EQ_LR)
    for _ in range(EQ_STEPS):
        grads = []
        for h in range(HYBRID_HOSTS):
            opt.zero_grad(set_to_none=True)
            rows = slice(h * EQ_BATCH, (h + 1) * EQ_BATCH)
            halves.loss(tok[rows], tgt[rows]).backward()
            grads.append([p.grad for p in halves.parameters()])
        for p, g0, g1 in zip(halves.parameters(), *grads):
            p.grad = (g0 + g1) / HYBRID_HOSTS
        opt.step()
    halves_digest = _param_digest(halves)
    bps.shutdown()
    del halves, opt, grads

    a, b = results
    n = a["steps"]
    want_flash = {"flash_fwd": 2 * HYBRID_LAYERS * n, "flash_bwd_dq": HYBRID_LAYERS * n,
                  "flash_bwd_dkv": HYBRID_LAYERS * n}
    # the loss of the global batch: the hosts' losses are over their halves
    mean = [sum(v) / HYBRID_HOSTS for v in zip(*(r["losses"] for r in results))]
    print(f"{label}: 2 hosts, each `python -m byteps_tpu_torch.launcher.launch` at "
          f"BYTEPS_LOCAL_SIZE=1 on {a['device']} ({a['mesh']}), DMLC_NUM_WORKER=2, 2 server "
          f"processes; host ranks {[r['rank'] for r in results]}; one-rank NCCL "
          f"{', '.join(a['nccl_checks'])} each bitwise its input (a check of NCCL's bring-up "
          f"and wiring, not of a reduction)", flush=True)
    print(f"{label}: {EQ_LAYERS} layers at BERT-large's widths, f32, SGD lr {EQ_LR}, "
          f"{EQ_BATCH} sequences a host, {EQ_STEPS} steps through HybridDataParallel: the "
          f"hosts' parameters bitwise equal {a['eq_digest'] == b['eq_digest']}, and bitwise one "
          f"process averaging the two halves' gradients {a['eq_digest'] == halves_digest}; "
          f"worst |hybrid - "
          f"one process on the combined batch of {HYBRID_HOSTS * EQ_BATCH}| beyond rtol "
          f"{EQ_RTOL}: {worst:.3e} (atol {EQ_ATOL}; the parameters moved up to {moved:.3e}); "
          f"losses host 0 {[round(x, 5) for x in a['eq_losses']]}, one process "
          f"{[round(x, 5) for x in eq_ref]}", flush=True)
    for r in results:
        sps = HYBRID_HOSTS * HYBRID_BATCH / r["step_s"]
        busy = ("not measured" if r["busy_ms"] is None else
                f"{r['busy_ms']:.1f} ms ({100 * r['busy_ms'] / (r['step_s'] * 1e3):.1f}% of the "
                "step)")
        print(f"{label} host {r['host']}: BERT-large {r['n_layers']} layers seq {SEQ} bf16 remat "
              f"flash, batch {HYBRID_BATCH} a host ({HYBRID_HOSTS * HYBRID_BATCH} together), "
              f"DistributedOptimizer(AdamW) + bare onebit (scaling): losses "
              f"{[round(x, 4) for x in r['losses']]}; {sps:.2f} global samples/s "
              f"({r['step_s'] * 1e3:.1f} ms/step over {HYBRID_STEPS} steps; first step "
              f"{r['first_s']:.1f} s); split "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in r["split_ms"].items())
              + f"; device busy {busy}; peak memory {r['peak_gib']:.2f} GiB; init "
              f"{r['init_s']:.1f} s; on {card}", flush=True)
        c = r["counters"]
        print(f"{label} host {r['host']}: per step K4 launches "
              f"{r['launches']['onebit_pack'] / n:g} (compressed partitions "
              f"{r['compressed_parts']}), flash "
              f"{ {k: r['launches'][k] / n for k in want_flash} }, d2h_bytes "
              f"{c.get('d2h_bytes', 0) / n:.0f}, wire_tx_bytes "
              f"{c.get('wire_tx_bytes', 0) / n:.0f}, wire_rx_bytes "
              f"{c.get('wire_rx_bytes', 0) / n:.0f} (partition table {r['want_d2h']})",
              flush=True)
    print(f"{label}: share of the {len(taps[0]['scales'])} onebit partitions whose pull "
          f"carried host 0's signs (its scale the larger), a step: "
          f"{[round(x, 4) for x in led]}", flush=True)
    for r in results:
        blocking = ", ".join(f"{k} {c} calls {t:.2f} s"
                             for k, (c, t) in r["first_blocking"].items())
        print(f"{label} host {r['host']}: first step {r['first_s']:.2f} s, of which the blocking "
              f"requests on the training thread: {blocking}; its stage dwell and round trips:",
              flush=True)
        for line in _hist_lines(r["first_hists"], 1):
            print(f"{label} host {r['host']} first step: {line}", flush=True)
        for line in _hist_lines(r["hists"], HYBRID_STEPS):
            print(f"{label} host {r['host']} timed steps: {line}", flush=True)
    for line in _server_lines(pushes):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: the global batch's loss (the hosts' mean) {[round(x, 4) for x in mean]}; "
          f"servers' (pushes summed, rounds) {[p and p[:2] for p in pushes]}; the hosts' "
          f"{HYBRID_LAYERS}-layer parameters bitwise equal {a['digest'] == b['digest']}; phase wall "
          f"{time.perf_counter() - wall:.1f} s", flush=True)

    bad = []
    if {r["rank"] for r in results} != {0, 1} or {r["size"] for r in results} != {2}:
        bad.append(f"the hosts' ranks and sizes {[(r['rank'], r['size']) for r in results]}")
    if not worst <= EQ_ATOL:
        bad.append(f"{EQ_LAYERS} layers through HybridDataParallel differ from one process on "
                   f"the combined batch by {worst:.3e} beyond atol {EQ_ATOL} + rtol {EQ_RTOL}")
    if a["eq_digest"] != b["eq_digest"] or a["digest"] != b["digest"]:
        bad.append("the two hosts' parameters differ")
    if a["eq_digest"] != halves_digest:
        bad.append(f"{EQ_LAYERS} layers through HybridDataParallel are not bitwise one process "
                   "averaging the two halves' gradients")
    if not (all(math.isfinite(x) for r in results for x in r["losses"]) and mean[-1] < mean[0]):
        bad.append(f"the global batch's losses not finite and falling: {mean}")
    want_parts, want_step = onebit_table(HYBRID_LAYERS)
    for r in results:
        h, c = r["host"], r["counters"]
        if (r["compressed_parts"] != want_parts
                or r["want_d2h"] != want_step):
            bad.append(f"host {h}'s partition table: {r['compressed_parts']} compressed "
                       f"partitions, {r['want_d2h']} bytes a step, expected "
                       f"{want_parts} and {want_step}")
        bad += [f"host {h} {k} {c.get(k, 0) / n:.0f} a step, expected {want_step}"
                for k in ("d2h_bytes", "wire_tx_bytes", "wire_rx_bytes")
                if c.get(k, 0) != n * want_step]
        if r["launches"]["onebit_pack"] != n * want_parts:
            bad.append(f"host {h} launched K4 {r['launches']['onebit_pack']} times in {n} "
                       f"steps, expected {want_parts} a step")
        if {k: r["launches"][k] for k in want_flash} != want_flash:
            bad.append(f"host {h} flash launches {r['launches']}, expected {want_flash}")
        if r["eq_launches"] != {k: EQ_LAYERS * EQ_STEPS for k in want_flash}:
            bad.append(f"host {h} {EQ_LAYERS}-layer flash launches {r['eq_launches']}")
    if not all(p and p[0] == HYBRID_HOSTS * p[1] and p[1] > 0 for p in pushes):
        bad.append(f"the servers' (pushes summed, rounds): {pushes}, expected "
                   f"{HYBRID_HOSTS} pushes a round")
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return {"launches_a_step": {k: v // n for k, v in a["launches"].items()}}


# --- small-tensor fusion, the server-side optimizer, async ------------------

#: fusion: every onebit payload of BERT-large's partitions (at most 128,004
#: bytes) and every raw partition below BYTEPS_MIN_COMPRESS_BYTES fits, so all
#: 641 gradient partitions fuse; fusion_bytes at its default (262,144)
FUSION_THRESHOLD = 131072
#: 2 timed steps a run at 2 layers (6 before the resharding phase joined, 12
#: before the elastic one, 3 steps at 24 before the self-healing plane's
#: phases), to keep the script under 75% of its time limit
FUSION_STEPS, FUSION_LAYERS = 2, 2
#: the fusion phase's unfused tcp run on the Python lanes, which phase (f1)
#: holds its vans to
_FUSION_BASE: dict = {}
#: the server-side optimizer: Adam on the servers, a seed round and 3 steps
SERVER_OPT_RULE, SERVER_OPT_HP, SERVER_OPT_STEPS = "adam", {"lr": 1e-4}, 3
#: its depth: 2 layers since the observability phase (j) joined (6 since the
#: resharding phase, 12 before, 24 before the elastic one), to keep the
#: script under 75% of its time limit
SERVER_OPT_LAYERS = 2
#: the tensors whose every pulled partition is held against a CPU replay of
#: the servers' Adam: the word embedding, layer 0's Q, K and V weights, and
#: the final LayerNorm
SERVER_OPT_TAPPED = ("embed", "layers.0.wq", "layers.0.wk", "layers.0.wv", "ln_f_s", "ln_f_b")
#: async: local AdamW (lr 1e-4, weight decay 1e-4) and the weight-delta loop
#: of byteps_tpu/tensorflow/__init__.py:219-230 over push_pull(average=False)
ASYNC_STEPS, ASYNC_LR = 3, 1e-4
#: the async phase's depth: cut from 24 so that the script, with the
#: self-healing phases (to 6) and the resharding phase (to 2), stays within
#: three quarters of its time limit
ASYNC_LAYERS = 2
#: the server-wide async run against bare AdamW on the card: one worker's store
#: is the sum of its deltas, prev + (cur - prev), which rounds to cur except
#: where the two differ by more than a factor of 2 (parameters near zero).
#: Bitwise it is AdamW with that rounding done on the card; against bare
#: AdamW, a last-place difference changes the next bf16 forward and so the
#: gradients, and an AdamW update is at most ~lr an element (|m^ / sqrt(v^)|
#: <= 1 at step 1), so the two trajectories part by at most ~2 lr a step
ASYNC_ATOL = 2 * ASYNC_LR * ASYNC_STEPS
#: the per-key profile on two launcher hosts: bounded staleness 1, 3 steps (4,
#: with a second lag at step 3, before the kit's phase (k) joined: one lag
#: parks pulls enough, 222 with two in PR 22 call 2)
ASYNC_HOST_STEPS, ASYNC_BOUND = 3, 1
#: host 1 sleeps ASYNC_LAG_S before its pushes of these training steps, so
#: host 0 runs rounds ahead of it and its next pulls must park
ASYNC_LAG_STEPS, ASYNC_LAG_S = (1,), 4.0


def _state_bytes(opt) -> int:
    """Bytes of the tensors an optimizer holds as its state."""
    import torch

    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))


@contextlib.contextmanager
def _tap_compressed_payloads(client):
    """A digest of every compressed payload this worker's PS client sends,
    by (key, version): plain pushes and fused frames' members alike."""
    import hashlib

    from byteps_tpu_torch.common.types import RequestType, decode_command_type

    push, push_fused = client.push, client.push_fused
    seen: dict = {}

    def digest(payload) -> str:
        return hashlib.blake2b(memoryview(payload).cast("B"), digest_size=16).hexdigest()

    def tap_push(key, payload, dtype_id, version, *args, **kwargs):
        if kwargs.get("request_type") == RequestType.COMPRESSED_PUSH_PULL:
            seen[key, version] = digest(payload)
        return push(key, payload, dtype_id, version, *args, **kwargs)

    def tap_push_fused(members, *args, **kwargs):
        for key, cmd, version, payload in members:
            if decode_command_type(cmd)[0] == RequestType.COMPRESSED_PUSH_PULL:
                seen[key, version] = digest(payload)
        return push_fused(members, *args, **kwargs)

    client.push, client.push_fused = tap_push, tap_push_fused
    try:
        yield seen
    finally:
        client.push, client.push_fused = push, push_fused


def _fusion_run(card: str, label: str, fused: bool, native: bool, van: str = "tcp",
                native_client: bool = None) -> dict:
    """One worker and two server processes, BERT-large through
    DistributedOptimizer(AdamW) with bare onebit (scaling), as the
    distributed path: one warm-up step (its compressed payloads tapped) and
    FUSION_STEPS timed, with BYTEPS_FUSION_THRESHOLD=FUSION_THRESHOLD when
    ``fused``; the servers' data plane in C++ when ``native``, and the
    worker's lanes when ``native_client`` (default: ``native``); the
    servers on the van ``van`` (their socket files in a directory of
    their own, which the run holds to be empty once the fleet stopped,
    with no ring file of this process left in /dev/shm).  Returns what it
    measured; the caller compares it with the other runs."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    wall = time.perf_counter()
    worker_env = {"BYTEPS_FUSION_THRESHOLD": str(FUSION_THRESHOLD if fused else 0)}
    if native if native_client is None else native_client:
        worker_env["BYTEPS_NATIVE_CLIENT"] = "1"
    server_env = {"BYTEPS_SERVER_NATIVE": "1"} if native else {}
    sock_dir = None
    if van != "tcp":
        sock_dir = _socket_dir()
        server_env.update(BYTEPS_VAN=van, BYTEPS_SOCKET_PATH=sock_dir)
    with _ps_fleet(label, server_env, worker_env) as fleet:
        bps.init()
        cfg, model, tok, tgt = _bert(FUSION_LAYERS)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = build_train_step(model, opt)
        engine = get_state().engine
        with _tap_compressed_payloads(get_state().ps_client) as payloads:
            losses = [float(step(tok, tgt))]
            torch.cuda.synchronize()
        gc.collect()
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        metrics().reset()
        timed, split, dt = _timed_steps(model, opt, tok, tgt, FUSION_STEPS)
        launches = {**fa.launches, **ob.launches}
        stats = counters().snapshot()
        hists = metrics().snapshot()["histograms"]
        losses += timed
        table = engine.partition_table()
        digest = _param_digest(model)
        servers = [addr for addr, _ in get_state().ps_client._server_addrs]
        bps.shutdown()
        del model, opt, step
    leftovers = _leftovers(sock_dir) if sock_dir is not None else []
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    compressed = [r for r in grads if r["wire_nbytes"] is not None]
    fits = [r for r in grads if (r["wire_nbytes"] if r["wire_nbytes"] is not None
                                 else r["length"] * r["itemsize"]) <= FUSION_THRESHOLD]
    want_d2h = (sum(r["wire_nbytes"] for r in compressed)
                + sum(r["length"] * r["itemsize"] for r in grads if r["wire_nbytes"] is None))
    out = {"label": label, "fused": fused, "native": native, "losses": losses,
           "step_ms": dt / FUSION_STEPS * 1e3, "split": split, "launches": launches,
           "stats": stats, "hists": hists, "digest": digest, "payloads": payloads,
           "compressed": len(compressed), "partitions": len(grads), "fits": len(fits),
           "want_d2h": want_d2h, "van": van, "servers": servers, "leftovers": leftovers,
           "report": fleet.report, "wall": time.perf_counter() - wall}
    return out


def train_fusion(card: str) -> dict:
    """Small-tensor fusion on the distributed path: BERT-large through one
    worker and two servers with bare onebit, on the Python lanes and on the
    native lanes, each unfused and fused (BYTEPS_FUSION_THRESHOLD=131072) in
    turns from the same weights and tokens, FUSION_LAYERS deep.  Holds, on
    each lane: the parameters after the timed steps bitwise the unfused
    run's (one worker: the servers' sum is a copy), K4 at one launch a
    compressed partition a step, every compressed
    payload of the warm-up step bitwise the unfused run's of the same
    partition and round, d2h_bytes (and the wire bytes) equal to the
    partition table's, every partition in a fused frame.  Prints the fused frames
    a step and keys a frame, the bytes, the stage split with FUSE's dwell,
    and ms a step and samples/s beside the unfused run's.  Returns the
    kernels' launches a step of the fused Python-lane run."""
    label = "fusion"
    runs = []
    _FUSION_BASE.clear()
    for native in (False, True):
        lane = "native lanes" if native else "Python lanes"
        for fused in (False, True):
            gc.collect()
            runs.append(_fusion_run(card, f"{label}, {lane}, {'fused' if fused else 'unfused'}",
                                    fused, native))
    bad = []
    n = FUSION_STEPS
    for r in runs:
        s, ln = r["stats"], r["launches"]
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"{r['label']}: non-finite loss {r['losses']}")
        if ((r["compressed"], r["want_d2h"]) != (runs[0]["compressed"], runs[0]["want_d2h"])
                or ln["onebit_pack"] != n * r["compressed"]):
            bad.append(f"{r['label']}: K4 launched {ln['onebit_pack']} times in {n} steps, "
                       f"expected {r['compressed']} a step, as many as the unfused Python "
                       f"run's compressed partitions ({runs[0]['compressed']})")
        if {k: ln[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} != {
                "flash_fwd": 2 * FUSION_LAYERS * n, "flash_bwd_dq": FUSION_LAYERS * n,
                "flash_bwd_dkv": FUSION_LAYERS * n}:
            bad.append(f"{r['label']}: flash launches {ln}")
        bad += [f"{r['label']}: {k} {s.get(k, 0) / n:.0f} a step, expected {r['want_d2h']} "
                "(the partition table)"
                for k in ("d2h_bytes", "wire_tx_bytes", "wire_rx_bytes")
                if s.get(k, 0) != n * r["want_d2h"]]
        want_keys = n * r["partitions"] if r["fused"] else 0
        if s.get("fused_keys", 0) != want_keys or (r["fused"] and r["fits"] != r["partitions"]):
            bad.append(f"{r['label']}: {s.get('fused_keys', 0)} fused keys in {n} steps, "
                       f"expected {want_keys} ({r['fits']} of {r['partitions']} partitions "
                       "fit the threshold)")
        if r["report"] is None or any(x is None for x in r["report"]):
            bad.append(f"{r['label']}: a server logged no stop report")
    for plain, fused in zip(runs[0::2], runs[1::2]):
        if fused["digest"] != plain["digest"]:
            bad.append(f"{fused['label']}: the parameters after {n} steps are not bitwise "
                       "the unfused run's")
        if len(plain["payloads"]) != plain["compressed"] or fused["payloads"] != plain["payloads"]:
            diff = [k for k in plain["payloads"] if fused["payloads"].get(k) != plain["payloads"][k]]
            bad.append(f"{fused['label']}: {len(fused['payloads'])} tapped onebit payloads, "
                       f"{len(diff)} of the unfused run's {len(plain['payloads'])} differ")
    for r in runs:
        s = r["stats"]
        frames = s.get("fused_frames", 0) / n
        print(f"{r['label']}: {BATCH * n / (r['step_ms'] * n / 1e3):.2f} samples/s "
              f"({r['step_ms']:.1f} ms/step over {n} steps); losses "
              f"{[round(x, 4) for x in r['losses']]}; fused frames {frames:.1f} a step, "
              f"{s.get('fused_keys', 0) / max(1, s.get('fused_frames', 0)):.1f} keys a frame "
              f"(flushes: full {s.get('fusion_flush_full', 0) / n:.1f}, idle "
              f"{s.get('fusion_flush_idle', 0) / n:.1f}, cycle "
              f"{s.get('fusion_flush_cycle', 0) / n:.1f} a step; fallbacks "
              f"{s.get('fused_fallback', 0)}); d2h_bytes {s.get('d2h_bytes', 0) // n}, "
              f"wire_tx_bytes {s.get('wire_tx_bytes', 0) // n}, wire_rx_bytes "
              f"{s.get('wire_rx_bytes', 0) // n} a step; K4 "
              f"{r['launches']['onebit_pack'] // n} a step; step split "
              f"{_split_line(r['split'], n)}; phase wall {r['wall']:.1f} s", flush=True)
        for line in _hist_lines(r["hists"], n) + _server_lines(r["report"] or []):
            print(f"{r['label']}: {line}", flush=True)
    for plain, fused in zip(runs[0::2], runs[1::2]):
        print(f"{fused['label']}: {fused['step_ms']:.1f} ms a step against the unfused "
              f"{plain['step_ms']:.1f} ({fused['step_ms'] / plain['step_ms']:.3f}x), parameters "
              f"bitwise {fused['digest'] == plain['digest']}, the warm-up step's "
              f"{len(plain['payloads'])} onebit payloads bitwise "
              f"{fused['payloads'] == plain['payloads']}; on {card}", flush=True)
    print(f"{label}: the four runs' parameters bitwise equal "
          f"{len({r['digest'] for r in runs}) == 1}", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    _FUSION_BASE["tcp"] = runs[0]  # phase (f1)'s baseline
    return {k: v // n for k, v in runs[1]["launches"].items()}


@contextlib.contextmanager
def _tap_tensor_rounds(client, engine, names):
    """Every payload the PS client pushes and pulls for the partitions of
    the tensors ``names``, by key, in round order (a pull that landed in
    its sink is read from there)."""
    from byteps_tpu_torch.comm.ps_client import ZERO_COPIED

    push, pull = client.push, client.pull
    seen: dict = {}

    def wanted(key) -> bool:
        return engine._table.get(key, (None,))[0] in names

    def tap_push(key, payload, *args, **kwargs):
        if wanted(key):
            seen.setdefault(key, {"pushed": [], "pulled": []})["pushed"].append(
                bytes(memoryview(payload).cast("B")))
        return push(key, payload, *args, **kwargs)

    def tap_pull(key, version, cb, *args, **kwargs):
        if not wanted(key):
            return pull(key, version, cb, *args, **kwargs)
        sink = kwargs.get("sink")

        def cb_tapped(payload):
            seen.setdefault(key, {"pushed": [], "pulled": []})["pulled"].append(
                bytes(sink) if payload is ZERO_COPIED else bytes(payload))
            cb(payload)
        return pull(key, version, cb_tapped, *args, **kwargs)

    client.push, client.pull = tap_push, tap_pull
    try:
        yield seen
    finally:
        client.push, client.pull = push, pull


def train_server_opt(card: str, adamw_state_bytes: int) -> dict:
    """The server-side optimizer: BERT-large, SERVER_OPT_LAYERS deep, through
    one worker and two Python-engine servers with
    DistributedOptimizer(None, server_side=True,
    server_rule="adam", server_hp={"lr": 1e-4}) on raw f32 gradients: the
    first step seeds the servers with the parameters, then every step pushes
    gradients and copies the servers' parameters in.  Holds every pulled
    partition of the word embedding, layer 0's Q, K and V weights and the
    final LayerNorm, in every round, bitwise a CPU replay of the port's
    update_rules.Adam on the tapped gradients; finite, falling losses; no
    optimizer state on the worker.  Then the round journal's cost on these
    raw f32 pushes, steps in turns with it on and off (JOURNAL_AB).  Then
    the same worker against native servers must raise at its first INIT
    with their refusal.  Prints ms a
    step, bytes each way, the servers' apply time (their publish histogram)
    and the worker's optimizer-state bytes beside DistributedOptimizer(AdamW)'s
    (``adamw_state_bytes``, from the distributed path).  Returns the
    kernels' launches a step."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob
    from byteps_tpu_torch.server import update_rules

    label = "server optimizer"
    wall = time.perf_counter()
    tapped = {f"Gradient.{n}" for n in SERVER_OPT_TAPPED}
    with _ps_fleet(label) as fleet:
        bps.init()
        cfg, model, tok, tgt = _bert(SERVER_OPT_LAYERS)
        opt = bps.DistributedOptimizer(None, named_parameters=model.named_parameters(),
                                       server_side=True, server_rule=SERVER_OPT_RULE,
                                       server_hp=SERVER_OPT_HP)
        step = build_train_step(model, opt)
        engine = get_state().engine
        fa.reset_launches()
        ob.reset_launches()
        with _tap_tensor_rounds(get_state().ps_client, engine, tapped) as rounds:
            t0 = time.perf_counter()
            losses = [float(step(tok, tgt))]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counters().reset()
            t0 = time.perf_counter()
            losses += [float(step(tok, tgt)) for _ in range(SERVER_OPT_STEPS - 1)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {**fa.launches, **ob.launches}
        stats = counters().snapshot()
        state_bytes = _state_bytes(opt)
        # the journal on raw f32 pushes, past its cap: after the tapped
        # rounds, which the replay holds to their count
        ab = _journal_ab(engine, model, opt, tok, tgt)
        bps.shutdown()
        del model, opt, step

    bad = []
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        bad.append(f"losses not finite and falling: {losses}")
    if state_bytes != 0:
        bad.append(f"the worker holds {state_bytes} bytes of optimizer state")
    # raw f32 gradients: K4 packs nothing
    if launches != {"flash_fwd": 2 * cfg.n_layers * SERVER_OPT_STEPS,
                    "flash_bwd_dq": cfg.n_layers * SERVER_OPT_STEPS,
                    "flash_bwd_dkv": cfg.n_layers * SERVER_OPT_STEPS, "onebit_pack": 0}:
        bad.append(f"kernel launches {launches}")
    names = {engine._table[k][0] for k in rounds}
    if names != tapped:
        bad.append(f"tapped {sorted(names)}, expected {sorted(tapped)}")
    checked = 0
    for key, rec in sorted(rounds.items()):
        pushed, pulled = rec["pushed"], rec["pulled"]
        if len(pushed) != SERVER_OPT_STEPS + 1 or len(pulled) != SERVER_OPT_STEPS + 1:
            bad.append(f"key {key}: {len(pushed)} pushes and {len(pulled)} pulls, expected "
                       f"the seed and {SERVER_OPT_STEPS} rounds")
            continue
        # the seed round: the servers adopt the parameters as they are
        store = np.frombuffer(pushed[0], np.float32).copy()
        rule = update_rules.make_rule(SERVER_OPT_RULE, {"average": True, **SERVER_OPT_HP},
                                      store.size, np.float32)
        if pulled[0] != pushed[0]:
            bad.append(f"key {key}: the seed round's pull is not the pushed parameters")
        for t in range(1, SERVER_OPT_STEPS + 1):
            rule.apply(store, np.frombuffer(pushed[t], np.float32), 1, t)
            if store.tobytes() != pulled[t]:
                bad.append(f"key {key}: round {t}'s pull is not the replay of Adam")
                break
            checked += 1
    print(f"{label}: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}, 1 worker + 2 "
          f"Python-engine server processes, DistributedOptimizer(None, server_side=True, "
          f"server_rule={SERVER_OPT_RULE!r}, server_hp={SERVER_OPT_HP}) on raw f32 gradients: "
          f"losses {[round(x, 4) for x in losses]}; {dt / (SERVER_OPT_STEPS - 1) * 1e3:.1f} "
          f"ms a step over {SERVER_OPT_STEPS - 1} steps ({BATCH * (SERVER_OPT_STEPS - 1) / dt:.2f}"
          f" samples/s; the first, with the init barriers and the seed round, {first_s:.1f} s); "
          f"wire_tx_bytes {stats.get('wire_tx_bytes', 0) // (SERVER_OPT_STEPS - 1)}, "
          f"wire_rx_bytes {stats.get('wire_rx_bytes', 0) // (SERVER_OPT_STEPS - 1)} a step; "
          f"on {card}", flush=True)
    for line in _server_lines(fleet.report or []):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: the round journal (BYTEPS_JOURNAL_ROUNDS=2, the default) records "
          f"{ab['records']} raw f32 pushes, {ab['bytes']} bytes a step, copying them in "
          f"{ab['copy_ms']:.2f} ms a step ({ab['stats']['rounds']} rounds, "
          f"{ab['stats']['bytes']} bytes held under the cap of {ab['cap']}, "
          f"{ab['stats']['evicted']} evicted); steps in turns, on "
          f"{[round(x, 1) for x in ab['ms']['on']]} ms, off "
          f"{[round(x, 1) for x in ab['ms']['off']]} ms; on {card}", flush=True)
    print(f"{label}: {len(rounds)} partitions of {len(tapped)} tensors, {checked} of their "
          f"rounds after the seed bitwise a CPU replay of update_rules.Adam; the worker's "
          f"optimizer state {state_bytes} bytes against {adamw_state_bytes} for "
          f"DistributedOptimizer(AdamW) on the distributed path (24 layers)", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))

    # the C++ engine has no update rule: it refuses the profile, and the
    # worker raises with the reason at the first INIT
    with _ps_fleet(f"{label}, native servers", {"BYTEPS_SERVER_NATIVE": "1"}) as fleet:
        bps.init()
        _, model, tok, tgt = _bert(SERVER_OPT_LAYERS)
        opt = bps.DistributedOptimizer(None, named_parameters=model.named_parameters(),
                                       server_side=True, server_rule=SERVER_OPT_RULE,
                                       server_hp=SERVER_OPT_HP)
        try:
            build_train_step(model, opt)(tok, tgt)
        except RuntimeError as e:
            refusal = str(e)
        else:
            refusal = None
        bps.shutdown()
        del model, opt
    if refusal is None or "server-side optimizer" not in refusal:
        fail(f"{label}: against native servers the worker did not raise with their "
             f"refusal (got {refusal!r})")
    print(f"{label}: against native servers the worker raised at its first INIT: "
          f"{refusal}; phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    return {k: v // SERVER_OPT_STEPS for k, v in launches.items()}


def _async_delta_step(model, prev: dict, check_store: bool) -> int:
    """The async weight-delta loop (byteps_tpu/tensorflow/__init__.py:219-230,
    with the root's store seeded by its parameters: ``prev`` starts at zeros
    on the root, at the parameters elsewhere): push each parameter's change
    since the store it last adopted with push_pull(average=False), adopt
    the pulled store.  With ``check_store`` (one worker) returns how many
    elements of the pulled stores differ from prev + delta, the sum of this
    worker's deltas, else 0."""
    import torch

    import byteps_tpu_torch as bps

    handles = []
    for i, (name, p) in enumerate(model.named_parameters()):
        delta = p.detach() - prev[name]
        handles.append((name, p, delta, bps.push_pull_async(
            delta, name=f"AsyncParam.{name}", average=False, priority=-i)))
    differ = 0
    with torch.no_grad():
        for name, p, delta, h in handles:
            new = bps.synchronize(h)
            if check_store:
                differ += int((new != prev[name] + delta).sum())
            p.copy_(new)
            prev[name] = new
    return differ


def _async_prev(model, root: bool) -> dict:
    import torch

    return {n: (torch.zeros_like(p) if root else p.detach().clone())
            for n, p in model.named_parameters()}


def _async_one_worker(card: str, label: str, native: bool) -> dict:
    """Server-wide async (BYTEPS_ENABLE_ASYNC=1 on the worker and both
    servers): BERT-large with local AdamW and the delta loop, ASYNC_STEPS
    steps.  Returns losses, ms a step, the parameters, and the elements of
    the pulled stores that were not prev + delta."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    env = {"BYTEPS_ENABLE_ASYNC": "1"}
    server_env = {**env, **({"BYTEPS_SERVER_NATIVE": "1"} if native else {})}
    with _ps_fleet(label, server_env, env) as fleet:
        bps.init()
        _, model, tok, tgt = _bert(ASYNC_LAYERS)
        opt = torch.optim.AdamW(model.parameters(), lr=ASYNC_LR, weight_decay=1e-4)
        prev = _async_prev(model, root=True)
        fa.reset_launches()
        ob.reset_launches()
        losses, differ = [], 0
        t0 = time.perf_counter()
        for _ in range(ASYNC_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = model.loss(tok, tgt)
            loss.backward()
            opt.step()
            differ += _async_delta_step(model, prev, check_store=True)
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {**fa.launches, **ob.launches}
        params = [p.detach().clone() for p in model.parameters()]
        bps.shutdown()
        del model, opt, prev
    return {"losses": losses, "step_ms": dt / ASYNC_STEPS * 1e3, "params": params,
            "differ": differ, "launches": launches, "report": fleet.report}


def async_host(work: str) -> None:
    """One host of the per-key async phase, run by the port's launcher at
    BYTEPS_LOCAL_SIZE=1 with BYTEPS_ASYNC=1 and BYTEPS_STALENESS_BOUND=1
    (``chip_smoke.py --async-host <dir>``): BERT-large at ASYNC_LAYERS on its
    half of the batch with local AdamW and the delta loop for
    ASYNC_HOST_STEPS steps, host 1 sleeping ASYNC_LAG_S before its pushes of
    the steps ASYNC_LAG_STEPS.  Two seed rounds come first (the root's
    parameters, a barrier, zero deltas), after which both hosts hold the
    root's parameters.  Records, for every pull of the training steps, its
    round and the store version the server answered with (the pushes of
    both hosts it had applied); writes <dir>/async<h>.json."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.transport import Op
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    host = int(os.environ["DMLC_WORKER_ID"])
    _host_go()
    bps.init()
    _, model, tok, tgt = _bert(ASYNC_LAYERS)
    rows = slice(host * HYBRID_BATCH, (host + 1) * HYBRID_BATCH)
    tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
    opt = torch.optim.AdamW(model.parameters(), lr=ASYNC_LR, weight_decay=1e-4)
    prev = _async_prev(model, root=host == 0)
    client = get_state().ps_client
    # the seed: the root pushes its parameters, the other host zeros; once
    # both pushes are in (the barrier), a round of zero deltas hands every
    # host the whole store, before a pull could see a store without the seed
    _async_delta_step(model, prev, check_store=False)
    client.barrier()
    _async_delta_step(model, prev, check_store=False)
    seeded = _param_digest(model)
    pulls: list = []
    request = client._async_rpc

    def tapped(key, make_msg, deliver, on_error, **kwargs):
        probe = make_msg(0)
        if probe.op == Op.PULL:
            version, inner = probe.version, deliver

            def deliver(msg):
                pulls.append((version, msg.version))
                inner(msg)
        return request(key, make_msg, deliver, on_error, **kwargs)

    client._async_rpc = tapped
    fa.reset_launches()
    ob.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(ASYNC_HOST_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        opt.step()
        if host == 1 and i in ASYNC_LAG_STEPS:
            torch.cuda.synchronize()
            time.sleep(ASYNC_LAG_S)  # host 0 runs ahead until the bound parks it
        _async_delta_step(model, prev, check_store=False)
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**fa.launches, **ob.launches}
    client._async_rpc = request
    bps.shutdown()
    # a pull of round v comes after this host's v pushes of the key, so the
    # store's version less v is what the other host had applied
    other = [rv - v for v, rv in pulls]
    out = {"host": host, "losses": losses, "step_s": dt / ASYNC_HOST_STEPS, "seeded": seeded,
           "launches": launches,
           "pulls": len(pulls),
           "over_bound": sum(o < v - ASYNC_BOUND for (v, _), o in zip(pulls, other)),
           "behind": sum(o < v for (v, _), o in zip(pulls, other)),
           "ahead": sum(o > v for (v, _), o in zip(pulls, other))}
    with open(os.path.join(work, f"async{host}.json"), "w") as f:
        json.dump(out, f)


def _async_server_wide(card: str, label: str) -> tuple:
    """``train_async``'s server-wide runs, on Python and on native servers,
    each against bare AdamW on the card.  Returns (the failures, the
    kernels' launches a step of the run on Python servers, the launches
    expected a step)."""
    import torch

    import byteps_tpu_torch as bps

    # bare AdamW on the card, the same weights, tokens and steps; and AdamW
    # with the store's rounding (p = prev + (p - prev)) done on the card
    bare, bare_losses = {}, {}
    for emulated in (False, True):
        bps.init()
        _, model, tok, tgt = _bert(ASYNC_LAYERS)
        opt = torch.optim.AdamW(model.parameters(), lr=ASYNC_LR, weight_decay=1e-4)
        prev = [torch.zeros_like(p) for p in model.parameters()]
        bare_losses[emulated] = []
        for _ in range(ASYNC_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = model.loss(tok, tgt)
            loss.backward()
            opt.step()
            if emulated:
                with torch.no_grad():
                    for p, q in zip(model.parameters(), prev):
                        p.copy_(q + (p - q))
                        q.copy_(p)
            bare_losses[emulated].append(float(loss.detach()))
        bare[emulated] = [p.detach().clone() for p in model.parameters()]
        bps.shutdown()
        del model, opt, prev
        gc.collect()
    # a step of BERT-large at ASYNC_LAYERS; raw deltas, so K4 packs nothing
    want_step = {"flash_fwd": 2 * ASYNC_LAYERS, "flash_bwd_dq": ASYNC_LAYERS,
                 "flash_bwd_dkv": ASYNC_LAYERS, "onebit_pack": 0}
    bad, a_step = [], None
    for native in (False, True):
        engine = "native" if native else "Python"
        run = _async_one_worker(card, f"{label}, server-wide, {engine} servers", native)
        worst = max(float((a - b).abs().max()) for a, b in zip(run["params"], bare[False]))
        same = sum(int((a == b).sum()) for a, b in zip(run["params"], bare[False]))
        total = sum(a.numel() for a in bare[False])
        exact = all(torch.equal(a, b) for a, b in zip(run["params"], bare[True]))
        print(f"{label}, server-wide, {engine} servers: BERT-large, batch {BATCH}, 1 worker + 2 "
              f"server processes, BYTEPS_ENABLE_ASYNC=1, local AdamW (lr {ASYNC_LR}) and the "
              f"weight-delta loop: losses {[round(x, 4) for x in run['losses']]} (bare AdamW "
              f"{[round(x, 4) for x in bare_losses[False]]}, with the store's rounding "
              f"{[round(x, 4) for x in bare_losses[True]]}); {run['step_ms']:.1f} ms a step; "
              f"pulled store elements not prev + delta: {run['differ']}; parameters after "
              f"{ASYNC_STEPS} steps bitwise AdamW with the store's rounding {exact}; max "
              f"|async - bare AdamW| {worst:.3e} (held to {ASYNC_ATOL:.1e}), {same} of {total} "
              f"elements bitwise; on {card}", flush=True)
        for line in _server_lines(run["report"] or []):
            print(f"{label}, server-wide, {engine} servers: {line}", flush=True)
        if not all(math.isfinite(x) for x in run["losses"]):
            bad.append(f"{engine} servers: non-finite loss {run['losses']}")
        if run["differ"]:
            bad.append(f"{engine} servers: {run['differ']} pulled elements are not the sum "
                       "of the worker's deltas")
        if not exact:
            bad.append(f"{engine} servers: the parameters are not bitwise AdamW with the "
                       "store's rounding")
        if run["launches"] != {k: v * ASYNC_STEPS for k, v in want_step.items()}:
            bad.append(f"{engine} servers: kernel launches {run['launches']} in "
                       f"{ASYNC_STEPS} steps, expected {want_step} a step")
        if a_step is None:
            a_step = {k: v // ASYNC_STEPS for k, v in run["launches"].items()}
        if not worst <= ASYNC_ATOL:
            bad.append(f"{engine} servers: parameters {worst:.3e} from bare AdamW, beyond "
                       f"{ASYNC_ATOL:.1e}")
        del run
        gc.collect()
        torch.cuda.empty_cache()

    return bad, a_step, want_step


def train_async(card: str) -> dict:
    """Async on the distributed path.  Server-wide (BYTEPS_ENABLE_ASYNC=1),
    once with Python-engine servers and once with native ones: one worker
    with local AdamW pushes its weight deltas and adopts the pulled store,
    held bitwise to prev + delta at every pull and within ASYNC_ATOL of bare
    AdamW on the card after ASYNC_STEPS steps.  Per key with bounded
    staleness (BYTEPS_ASYNC=1, BYTEPS_STALENESS_BOUND=1) on two launcher
    hosts of one process each through two Python servers, the same loop for
    ASYNC_HOST_STEPS steps with host 1 lagging two rounds behind in some:
    finite losses on both hosts, pulls parked by the servers, and no pull
    answered with a store more than one round ahead of the other host's
    applied pushes.  Prints the servers' parked pulls.  Returns the
    kernels' launches a step of the server-wide run on Python servers."""
    label = "async"
    wall = time.perf_counter()
    # per key, bounded staleness 1, two hosts: their fleet and hosts come up
    # while the server-wide runs go
    env = {**_two_hosts_env(), "BYTEPS_ASYNC": "1", "BYTEPS_STALENESS_BOUND": str(ASYNC_BOUND)}
    per_key = _start_hosts("chip_smoke_async_",
                           lambda work: _launch_hosts(env, "--async-host", work))
    try:
        bad, a_step, want_step = _async_server_wide(card, label)
        _await_hosts(f"{label}, per key", per_key, timeout=420)
        results = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(per_key["work"], f"async{h}.json")) as f:
                results.append(json.load(f))
        report = _server_report(per_key["work"])
    finally:
        stop_hosts(per_key)
    for r in results:
        print(f"{label}, per key, host {r['host']}: BYTEPS_ASYNC=1 BYTEPS_STALENESS_BOUND="
              f"{ASYNC_BOUND}, BERT-large, batch {HYBRID_BATCH} a host, local AdamW and the "
              f"delta loop: losses {[round(x, 4) for x in r['losses']]}; "
              f"{r['step_s'] * 1e3:.1f} ms a step (host 1 sleeps {ASYNC_LAG_S} s before its "
              f"pushes of steps {ASYNC_LAG_STEPS}); {r['pulls']} pulls, answered while the other "
              f"host had applied fewer of the key's pushes {r['behind']}, more {r['ahead']}, "
              f"beyond the bound {r['over_bound']}; on {card}", flush=True)
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"per key, host {r['host']}: non-finite loss {r['losses']}")
        if r["over_bound"] or not r["pulls"]:
            bad.append(f"per key, host {r['host']}: {r['over_bound']} of {r['pulls']} pulls "
                       f"answered beyond the staleness bound {ASYNC_BOUND}")
        if r["launches"] != {k: v * ASYNC_HOST_STEPS for k, v in want_step.items()}:
            bad.append(f"per key, host {r['host']}: kernel launches {r['launches']}")
    for line in _server_lines(report):
        print(f"{label}, per key: {line}", flush=True)
    if results[0]["seeded"] != results[1]["seeded"]:
        bad.append("per key: the hosts' parameters after the seed rounds differ")
    if any(x is None for x in report):
        bad.append(f"per key: a server logged no stop report: {report}")
    else:
        # host 1's lag must have made the bound hold pulls back, else the
        # check above could not tell a server that ignores the bound
        parked = sum(r[3] or 0 for r in report)
        print(f"{label}, per key: the servers parked {parked} pulls while host 1 lagged",
              flush=True)
        if not parked:
            bad.append("per key: no pull was parked although host 1 lagged two rounds")
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return a_step


#: phase (b): three steps, host 1's pushes to server 0 lost in the second;
#: its depth cut from 24 so that the script stays within three quarters of
#: its time limit (phase (a) is the full-depth run under faults)
HEAL_STEPS, HEAL_FAULT_STEP, HEAL_LAYERS = 3, 1, 2


def heal_host(work: str) -> None:
    """One host of phase (b), run by the port's launcher at
    BYTEPS_LOCAL_SIZE=1 (``chip_smoke.py --heal-host <dir>``): BERT-large
    at HEAL_LAYERS on its 16 sequences through DistributedOptimizer(AdamW)
    with bare onebit, HEAL_STEPS steps from the same weights twice in one
    process (the second model and optimizer reuse the tensor names, so the
    rounds go on): fault-free, then with faults.  Host 1 dials with the
    chaos van dropping every push to server 0 (BYTEPS_CHAOS_OPS=push,
    BYTEPS_CHAOS_TARGET_PORT) under a fault budget of 0; in the faulted
    step it opens the budget and its 1 s RPC deadline (its config's other
    steps have none, so pulls parked on host 0 never expire), and closes
    the budget as soon as a heal starts.  With BYTEPS_RPC_RETRIES=1 the
    pushes give up and heal in place.  Writes <dir>/heal<h>.json."""
    import threading

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import chaos
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    _host_go()
    bps.init()
    cfg = get_config()
    deadline = cfg.rpc_deadline_s
    cfg.rpc_deadline_s = 0.0
    client, engine = get_state().ps_client, get_state().engine
    out = {"host": host}
    for run in ("clean", "faults"):
        gc.collect()
        torch.cuda.empty_cache()
        _, model, tok, tgt = _bert(HEAL_LAYERS)
        rows = slice(host * HYBRID_BATCH, (host + 1) * HYBRID_BATCH)
        tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = build_train_step(model, opt)
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        losses, ms = [], []
        with _tap_blocking_requests(client) as blocking:
            for i in range(HEAL_STEPS):
                armed = run == "faults" and host == 1 and i == HEAL_FAULT_STEP
                done = threading.Event()
                if armed:
                    cfg.rpc_deadline_s = deadline
                    chaos.reset_fault_budget(1 << 30)

                    def close_on_heal() -> None:
                        while not done.is_set():
                            if counters().get("resync_attempt"):
                                chaos.reset_fault_budget(0)
                                return
                            time.sleep(0.002)

                    threading.Thread(target=close_on_heal, daemon=True).start()
                t0 = time.perf_counter()
                losses.append(float(step(tok, tgt)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                done.set()
                if armed:
                    chaos.reset_fault_budget(0)
                    cfg.rpc_deadline_s = 0.0
        compressed = sum(r["name"].startswith("Gradient.") and r["wire_nbytes"] is not None
                         for r in engine.partition_table())
        out[run] = {"losses": losses, "ms": ms, "digest": _param_digest(model),
                    "compressed_parts": compressed,
                    "counters": counters().snapshot(),
                    "labeled": counters().snapshot_labeled(),
                    "launches": {**fa.launches, **ob.launches}, "blocking": dict(blocking),
                    "reinit": sorted(engine._reinit_names)}
        del model, opt, step
    bps.shutdown()
    with open(os.path.join(work, f"heal{host}.json"), "w") as f:
        json.dump(out, f)


def _heal_host_env(h: int, ports: list) -> dict:
    """Host 1 of phase (b) drops every push to server 0 (under a fault
    budget its heal_host opens) and gives up after one retry."""
    if h != 1:
        return {}
    return {"BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "push",
            "BYTEPS_CHAOS_TARGET_PORT": str(ports[0]), "BYTEPS_CHAOS_FAULT_BUDGET": "0",
            "BYTEPS_RPC_RETRIES": "1", "BYTEPS_RPC_DEADLINE_S": "1",
            "BYTEPS_RPC_BACKOFF_S": "0.05"}


def start_heal() -> dict:
    """Phase (b)'s fleet and hosts, each host up and waiting for its go:
    ``main`` starts them ahead of phase (a)."""
    return _start_hosts("chip_smoke_heal_", lambda work: _launch_hosts(
        _two_hosts_env(), "--heal-host", work, server_env={"BYTEPS_VAN": "chaos:tcp"},
        host_env=_heal_host_env))


def train_heal(card: str, started: dict = None) -> dict:
    """Phase (b): the one-sided heal.  A scheduler, two Python servers
    under the chaos van (no faults of their own) and two launcher hosts of
    one process each (``heal_host``; ``started``, or started here:
    ``start_heal``), bare onebit, HEAL_LAYERS deep.  Host 1's
    pushes to server 0 die in one step until its retries give up
    (BYTEPS_RPC_RETRIES=1): its client heals in place (RESYNC_QUERY, the
    journaled rounds replayed, a fresh attempt).  Fails unless the heal
    ran and replayed rounds, no step degraded, no init barrier ran in the
    faulted run, and every host's losses and parameters are bitwise its
    fault-free run's and the other host's.  Returns host 1's launches a
    step in the faulted run."""
    label = "one-sided heal"
    wall = time.perf_counter()
    started = started or start_heal()
    work = started["work"]
    try:
        _await_hosts(label, started, timeout=420)
        results = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"heal{h}.json")) as f:
                results.append(json.load(f))
        report = _server_report(work)
    finally:
        stop_hosts(started)
    bad = []
    for r in results:
        clean, faults = r["clean"], r["faults"]
        c = faults["counters"]
        print(f"{label}, host {r['host']}: losses fault-free {[round(x, 4) for x in clean['losses']]}, "
              f"with faults {[round(x, 4) for x in faults['losses']]}; ms a step fault-free "
              f"{[round(x, 1) for x in clean['ms']]}, with faults "
              f"{[round(x, 1) for x in faults['ms']]}; counters "
              f"{ {k: c.get(k, 0) for k in ('chaos_drop', 'rpc_deadline_expired', 'rpc_retry', 'conn_revive', 'resync_attempt', 'resync_replayed_rounds', 'resync_giveup', 'rpc_giveup', 'degraded_jobs')} }, "
              f"per server {r['faults']['labeled'].get('resync_attempt', {})}; init barriers "
              f"and codec registrations in the faulted run {faults['blocking']}; on {card}",
              flush=True)
        if faults["losses"] != clean["losses"] or faults["digest"] != clean["digest"]:
            bad.append(f"host {r['host']}: losses or parameters with faults are not bitwise "
                       "the fault-free run's")
        if c.get("degraded_jobs") or c.get("rpc_giveup") or faults["reinit"]:
            bad.append(f"host {r['host']}: a step degraded ({c}, {faults['reinit']})")
        if any(v[0] for v in faults["blocking"].values()):
            bad.append(f"host {r['host']}: init barriers ran in the faulted run: "
                       f"{faults['blocking']}")
        want = {"flash_fwd": 2 * HEAL_LAYERS * HEAL_STEPS,
                "flash_bwd_dq": HEAL_LAYERS * HEAL_STEPS,
                "flash_bwd_dkv": HEAL_LAYERS * HEAL_STEPS,
                "onebit_pack": faults["compressed_parts"] * HEAL_STEPS}
        if faults["launches"] != want:
            bad.append(f"host {r['host']}: launches {faults['launches']}, expected {want}")
    h1 = results[1]["faults"]["counters"]
    if not (h1.get("resync_attempt") and h1.get("resync_replayed_rounds")
            and h1.get("chaos_drop")):
        bad.append(f"host 1 did not give up and heal in place: {h1}")
    if results[0]["faults"]["digest"] != results[1]["faults"]["digest"]:
        bad.append("the hosts' parameters differ")
    for line in _server_lines(report):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    print(f"{label}: host 1 gave up on the server it targeted and healed in place ("
          f"{h1['resync_attempt']} resyncs, {h1['resync_replayed_rounds']} rounds replayed); "
          "both hosts bitwise their fault-free runs and each other", flush=True)
    return {k: v // HEAL_STEPS for k, v in results[1]["faults"]["launches"].items()}


#: phase (c), elastic membership: depth, steps a stage, the probe key's size
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_PROBE_N = 2, 2, 1024
#: the membership knobs of its fleet (eviction after 2 s without a beat)
ELASTIC_ENV = {"BYTEPS_HEARTBEAT_INTERVAL": "0.5", "BYTEPS_DEAD_NODE_TIMEOUT_S": "2",
               "BYTEPS_SCHED_RECONNECT_BACKOFF_S": "0.1", "BYTEPS_SCHED_RECONNECT_RETRIES": "60"}


def _mark(work: str, name: str, value=None) -> None:
    """A phase (c) cue between the main process and the hosts: a JSON file in
    ``work``, renamed into place so that a reader never sees it half
    written."""
    path = os.path.join(work, f"{name}.mark")
    with open(path + ".tmp", "w") as f:
        json.dump({"t": time.time(), "value": value}, f)
    os.replace(path + ".tmp", path)


def _await_mark(work: str, name: str, timeout: float = 300.0) -> dict:
    path = os.path.join(work, f"{name}.mark")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            fail(f"no cue {name!r} in {timeout:.0f} s")
        time.sleep(0.02)
    with open(path) as f:
        return json.load(f)


def _memory(settle: float = 0.5) -> dict:
    """What this process's live tensors hold, once the device is idle and,
    after ``settle`` s, the engine's stage threads too (a stage polls its
    queue every 0.2 s): the device bytes they requested (free of the
    caching allocator's block rounding, which moves ``memory_allocated``
    by up to a block from run to run; that is given beside it), the
    pinned host bytes in use, and the live threads.  The device allocator
    counts a freed block whose stream was recorded as requested until an
    allocation finds that stream's event done: a one-byte allocation
    makes it look.  The host allocator's stats count its free cache as
    allocated, and in torch 2.11 its ``active_bytes`` never falls: the
    cache is emptied first (the allocator looks at its events and returns
    every free block), so that what stays allocated is in use; the next
    step pins its staging anew."""
    import torch

    torch.cuda.synchronize()
    time.sleep(settle)
    gc.collect()
    torch.empty(1, dtype=torch.uint8, device="cuda")
    if not hasattr(torch._C, "_host_emptyCache"):
        fail("elastic: this torch cannot empty its pinned host cache")
    torch._C._host_emptyCache()
    dev = torch.cuda.memory_stats()
    host = torch.cuda.host_memory_stats()
    if "requested_bytes.all.current" not in dev or "allocated_bytes.current" not in host:
        fail("elastic: this torch reports no requested device bytes or no pinned "
             f"bytes ({sorted(dev)[:8]}, {sorted(host)})")
    return {"device": dev["requested_bytes.all.current"],
            "allocated": torch.cuda.memory_allocated(),
            "pinned": host["allocated_bytes.current"],
            "threads": threading.active_count()}


def _pinned_probe() -> dict:
    """The pinned reading's own check: a 1 MiB pinned block filled from the
    device by a non_blocking copy (so that the allocator records the copy's
    stream on it, as on the engine's staging) shows in the reading while it
    lives and leaves it once freed."""
    import torch

    base = _memory(0)
    src = torch.ones(1 << 20, dtype=torch.uint8, device="cuda")
    host = torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
    host.copy_(src, non_blocking=True)
    live = _memory(0)
    del host, src
    return {"base": base["pinned"], "live": live["pinned"], "freed": _memory(0)["pinned"]}


def elastic_host(work: str) -> None:
    """One host of phase (c), run by the port's launcher at
    BYTEPS_LOCAL_SIZE=1 (``chip_smoke.py --elastic-host <dir>``):
    BERT-large at ELASTIC_LAYERS on its 16 sequences through
    DistributedOptimizer(AdamW) with bare onebit, and a probe key
    (``elastic.probe``, ELASTIC_PROBE_N float32 set to rank + 1, summed).
    ELASTIC_STEPS steps at each stage: (1) both hosts; (2) host 1 suspends,
    host 0 resumes at one worker and trains alone; (3) host 0 resumes at two
    workers, then host 1 resumes; (4) host 0 resumes at three servers (its
    book parks until the main process's third server registers), host 1 follows
    the book live; (5) host 1 resumes at two servers, host 0 follows, the
    third server stops; (6) the same steps twice from one state, the second
    time with the scheduler killed and restarted between them; (7) host 1
    kills itself, host 0's next step completes once the scheduler evicted
    it.  The cues go through ``work`` (``_mark``); each host writes
    <dir>/elastic<h>.json (host 1 before it dies)."""
    import copy

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    out = {"host": host, "stages": {}}
    path = os.path.join(work, f"elastic{host}.json")

    def save() -> None:
        with open(path, "w") as f:
            json.dump(out, f)

    bps.init()
    _, model, tok, tgt = _bert(ELASTIC_LAYERS)
    rows = slice(host * HYBRID_BATCH, (host + 1) * HYBRID_BATCH)
    tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression_params={"compressor": "onebit", "scaling": True},
    )
    step = build_train_step(model, opt)
    probe_name = "elastic.probe"
    bps.declare_tensor(probe_name)

    def client():
        return get_state().ps_client

    def keys() -> dict:
        reg = get_registry()
        return {n: reg.get(n).declared_key for n in reg._order}

    def train(label: str, steps: int = ELASTIC_STEPS, t_from: float = None,
              before_step=None, mem: bool = False) -> dict:
        """``steps`` steps; each step's loss, ms, probe value, launches and
        d2h bytes, and the seconds from ``t_from`` (time.time()) to the end
        of the first step, with the blocking requests in that step; with
        ``mem``, the memory after each step (``_memory``, outside the
        step's time)."""
        rec = {"losses": [], "ms": [], "probe": [], "launches": [], "d2h": [], "t_end": [],
               "mem": []}
        for i in range(steps):
            if before_step is not None:
                before_step(i)
            fa.reset_launches()
            ob.reset_launches()
            d2h0 = counters().get("d2h_bytes")
            with _tap_blocking_requests(client()) as blocking:
                t0 = time.perf_counter()
                loss = step(tok, tgt)
                probe = torch.full((ELASTIC_PROBE_N,), float(bps.rank() + 1),
                                   device=bps.device())
                pulled = bps.push_pull(probe, name=probe_name, average=False)
                rec["losses"].append(float(loss))
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["t_end"].append(time.time())
            vals = torch.unique(pulled).cpu().tolist()
            rec["probe"].append(vals[0] if len(vals) == 1 else vals)
            rec["launches"].append({**fa.launches, **ob.launches})
            rec["d2h"].append(counters().get("d2h_bytes") - d2h0)
            if i == 0 and t_from is not None:
                rec["recover_s"] = time.time() - t_from
                rec["recover_blocking"] = dict(blocking)
            if mem:
                del pulled, probe, loss
                rec["mem"].append(_memory())
        rec.update(rank=bps.rank(), size=bps.size(),
                   generation=client().server_generation, epoch=client().membership_epoch,
                   num_servers=client().num_servers,
                   compressed_parts=sum(r["name"].startswith("Gradient.")
                                        and r["wire_nbytes"] is not None
                                        for r in get_state().engine.partition_table()))
        out["stages"][label] = rec
        save()
        return rec

    def resume(**kw) -> float:
        t = time.time()
        bps.resume(**kw)
        return t

    if host == 1:
        out["pinned_probe"] = _pinned_probe()
    # both hosts read their memory after each step of stages 1 and 3: the
    # readings with no suspend between them are the control of host 1's
    # readings across its suspend
    train("1 both", mem=True)
    # (2) host 1 suspends; host 0 resumes alone
    if host == 1:
        out["keys_before"] = keys()
        bps.suspend()
        out["mem_after_suspend"] = _memory(0)
        _mark(work, "h1-suspended")
    else:
        _await_mark(work, "h1-suspended")
        bps.suspend()
        train("2 alone", t_from=resume(num_workers=1))
        # (3) host 0 resumes at two workers first, so that it keeps rank 0
        bps.suspend()
        t = resume(num_workers=2)
        _mark(work, "h0-back")
    if host == 1:
        _await_mark(work, "h0-back")
        t = resume(num_workers=2)
        out["mem_after_resume"] = _memory(0)
        out["keys_after"] = keys()
    train("3 both again", t_from=t, mem=True)
    # (4) three servers: host 0 resumes, host 1 follows the book live
    homes = {r["key"]: client().server_for(r["key"]) for r in get_state().engine.partition_table()}
    gen = client().server_generation
    if host == 0:
        bps.suspend()
        _mark(work, "want-server3")
        t = resume(num_servers=3)
    else:
        t = None
        deadline = time.monotonic() + 120
        while client().server_generation == gen and time.monotonic() < deadline:
            time.sleep(0.02)
    rec = train("4 three servers", t_from=t)
    rec["keys_moved"] = sum(client().server_for(k) != s for k, s in homes.items())
    rec["keys"] = len(homes)
    # (5) back to two servers: host 1 resumes, host 0 follows the book live
    gen = client().server_generation
    if host == 1:
        bps.suspend()
        t = resume(num_servers=2)
    else:
        t = None
        deadline = time.monotonic() + 120
        while client().server_generation == gen and time.monotonic() < deadline:
            time.sleep(0.02)
    train("5 two servers", t_from=t)
    # (6) the same steps twice from one state: without, then with the
    # scheduler killed and restarted between its two steps
    state = (copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict()))
    clean = train("6 clean")
    out["stages"]["6 clean"]["digest"] = _param_digest(model)
    model.load_state_dict(state[0])
    opt.load_state_dict(state[1])
    epoch0, inc0 = client().membership_epoch, client().sched_incarnation
    restart = {}

    def kill_between(i: int) -> None:
        if i == 1:
            if host == 0:
                _mark(work, "kill-sched")
            restart.update(_await_mark(work, "sched-restarted"))

    crash = train("6 scheduler restart", before_step=kill_between)
    crash["digest"] = _param_digest(model)
    deadline = time.monotonic() + 60
    while counters().get("sched_rejoin") < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    crash.update(restart_to_step_end_s=crash["t_end"][1] - restart["t"],
                 epoch_before=epoch0, epoch_after=client().membership_epoch,
                 incarnation_newer=client().sched_incarnation > inc0,
                 counters={k: counters().get(k) for k in (
                     "sched_reconnect", "sched_rejoin", "sched_stale_book",
                     "worker_evicted", "server_evicted")},
                 clean_losses=clean["losses"], clean_digest=out["stages"]["6 clean"]["digest"])
    save()
    # (7) host 1 dies; host 0 goes on once the scheduler evicted it
    if host == 1:
        _mark(work, "h1-dying")
        os.kill(os.getpid(), signal.SIGKILL)
    _await_mark(work, "h1-dying")
    t = time.time()
    rec = train("7 after host 1 died", steps=1, t_from=t)
    deadline = time.monotonic() + 10
    while counters().get("worker_evicted") < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    rec["worker_evicted"] = counters().get("worker_evicted")
    save()
    bps.shutdown()


def train_elastic(card: str) -> dict:
    """Phase (c): elastic membership.  A scheduler, two Python servers and a
    third waiting to be started, and two launcher hosts of one process each
    (``elastic_host``); this process starts the third server on host 0's cue,
    and kills the scheduler (SIGKILL) on another and restarts it on the
    same port.  Fails unless every probe pull is exactly the sum over the
    members of its step, host 1's keys are the same after its resume, the
    most device and pinned memory its step ends after the resume held (or
    it held right after the resume) exceed the most its step ends before
    the suspend held by no more than two step ends with no suspend
    between them grew, its threads at those step ends are as many, a
    1 MiB pinned probe shows in the pinned reading while it lives, the keys
    re-homed at three servers and the generation moved, the third server
    exited on SHUTDOWN, the steps through the scheduler's restart are
    bitwise the steps without it (losses and parameters), every node
    reconnected and rejoined with no eviction and a newer epoch, and host
    0's step after host 1's death completed with the eviction counted.
    Returns host 0's launches a step at the first stage."""

    label = "elastic"
    wall = time.perf_counter()
    env = {**os.environ, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker", **ELASTIC_ENV,
           # a host resumed at one worker stays a PS worker
           "BYTEPS_FORCE_DISTRIBUTED": "1"}
    bad = []
    with tempfile.TemporaryDirectory() as work:
        port, procs = _start_ps_processes(env, work)

        def waiting(role: str, go: str, log: str = None, **popen_kw) -> subprocess.Popen:
            """A node of ``role`` with its imports done, started when ``go``
            exists: the third server registers at once when host 0's
            resize asks for it, the scheduler's successor binds the port
            at once when its predecessor died."""
            return _track(subprocess.Popen(
                [sys.executable, "-c",
                 "import faulthandler, os, signal, sys, time\n"
                 "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
                 "from byteps_tpu_torch.server.server import run_server\n"
                 "while not os.path.exists(sys.argv[1]):\n    time.sleep(0.02)\n"
                 "run_server()\n", go],
                cwd=REPO, env={**env, "DMLC_ROLE": role, "DMLC_PS_ROOT_PORT": port},
                **popen_kw), f"waiting {role}", log, node=True)

        go_server, go_sched = os.path.join(work, "server2.go"), os.path.join(work, "sched.go")
        spare_log = os.path.join(work, "server2.log")
        with open(spare_log, "w") as log:
            spare = waiting("server", go_server, spare_log, stdout=subprocess.DEVNULL,
                            stderr=log)
        restarted = waiting("scheduler", go_sched, stdout=subprocess.PIPE, text=True)
        hosts = []
        try:
            for h in range(HYBRID_HOSTS):
                path = os.path.join(work, f"host{h}.log")
                with open(path, "w") as log:
                    hosts.append(_track(subprocess.Popen(
                        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                         sys.executable, os.path.join(REPO, "chip_smoke.py"), "--elastic-host",
                         work],
                        cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port, "DMLC_WORKER_ID": str(h)},
                        stdout=log, stderr=subprocess.STDOUT), f"host {h}", path))

            def watch(name: str) -> dict:
                path = os.path.join(work, f"{name}.mark")
                deadline = time.monotonic() + 420
                while not os.path.exists(path):
                    if any(p.poll() not in (None, 0) for p in hosts[:1]) or \
                            time.monotonic() > deadline:
                        return None
                    time.sleep(0.02)
                return _await_mark(work, name, 1)

            if watch("want-server3") is not None:
                time.sleep(0.5)  # host 0's REGISTER lands first
                open(go_server, "w").close()
            if watch("kill-sched") is not None:
                t_kill = time.time()
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(30)
                open(go_sched, "w").close()
                line = restarted.stdout.readline().strip()
                if line != f"BYTEPS_SCHEDULER_PORT={port}":
                    bad.append(f"the restarted scheduler reported {line!r}")
                _mark(work, "sched-restarted")
                print(f"{label}: the scheduler was killed and restarted on port {port} in "
                      f"{time.time() - t_kill:.2f} s", flush=True)
            deadline = time.monotonic() + 420
            while hosts[0].poll() is None and time.monotonic() < deadline:
                time.sleep(0.2)
            rcs = [p.poll() for p in hosts]
            spare_rc = spare.poll()
        finally:
            _stop_processes(hosts)
            _stop_processes(procs + [spare, restarted])
        logs = {}
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.log")) as f:
                logs[h] = f.read()
        if rcs[0] != 0 or rcs[1] in (None, 0):
            for h, text in logs.items():
                print(f"--- {label} host {h} (exit {rcs[h]}):\n{text[-6000:]}", file=sys.stderr)
            fail(f"{label}: the hosts exited {rcs} (host 0 must end with 0, host 1 killed)")
        results = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"elastic{h}.json")) as f:
                results.append(json.load(f))
        report = _server_report(work)
        with open(os.path.join(work, "server2.log")) as f:
            spare_log = f.read()
    # what each stage's probe must read: the sum of rank + 1 over its members
    want_probe = {"1 both": 3, "2 alone": 1, "3 both again": 3, "4 three servers": 3,
                  "5 two servers": 3, "6 clean": 3, "6 scheduler restart": 3,
                  "7 after host 1 died": 1}
    want_launch = {"flash_fwd": 2 * ELASTIC_LAYERS, "flash_bwd_dq": ELASTIC_LAYERS,
                   "flash_bwd_dkv": ELASTIC_LAYERS}
    for r in results:
        for name, rec in r["stages"].items():
            k4 = sorted({ln["onebit_pack"] for ln in rec["launches"]})
            print(f"{label}, host {r['host']}, stage {name}: rank {rec['rank']} of {rec['size']}, "
                  f"{rec['num_servers']} servers, generation {rec['generation']}, epoch "
                  f"{rec['epoch']}; ms a step {[round(x, 1) for x in rec['ms']]}; losses "
                  f"{[round(x, 4) for x in rec['losses']]}; probe {rec['probe']}; launches a "
                  f"step K1-K3 {[[ln[k] for k in want_launch] for ln in rec['launches']]}, "
                  f"K4 {k4}; d2h bytes a step {rec['d2h']}"
                  + (f"; recovery {rec['recover_s']:.3f} s, of which init barriers "
                     f"{rec['recover_blocking']['init_tensor'][1]:.3f} s "
                     f"({rec['recover_blocking']['init_tensor'][0]} calls) and codec "
                     f"registrations {rec['recover_blocking']['register_compressor'][1]:.3f} s "
                     f"({rec['recover_blocking']['register_compressor'][0]} calls)"
                     if rec.get("recover_s") is not None else "")
                  + (f"; {rec['keys_moved']} of {rec['keys']} keys re-homed"
                     if "keys_moved" in rec else "") + f"; on {card}", flush=True)
            if any(p != want_probe[name] for p in rec["probe"]):
                bad.append(f"host {r['host']} stage {name}: probe {rec['probe']}, want "
                           f"{want_probe[name]}")
            for ln in rec["launches"]:
                if ({k: ln[k] for k in want_launch} != want_launch
                        or ln["onebit_pack"] != rec["compressed_parts"]):
                    bad.append(f"host {r['host']} stage {name}: launches {ln}, "
                               f"{rec['compressed_parts']} compressed partitions")
    h0, h1 = results
    if h1.get("keys_before") != h1.get("keys_after"):
        bad.append("host 1's keys changed across its suspend")
    # memory across host 1's suspend: the most its step ends after the
    # resume held against the most they held before the suspend, within
    # the growth seen between step ends that no suspend separates (each
    # host's two steps of stages 1 and 3)
    kinds = ("device", "pinned")
    before, after = h1["stages"]["1 both"]["mem"], h1["stages"]["3 both again"]["mem"]
    spread = {kind: max(max(0, r["stages"][st]["mem"][1][kind] - r["stages"][st]["mem"][0][kind])
                        for r in results for st in ("1 both", "3 both again"))
              for kind in kinds}
    for kind in kinds + ("allocated", "threads"):
        print(f"{label}: host 1 {kind} at the step ends before its suspend "
              f"{[m[kind] for m in before]}, right after it {h1['mem_after_suspend'][kind]}, "
              f"right after the resume {h1['mem_after_resume'][kind]}, at the step ends after "
              f"it {[m[kind] for m in after]}; host 0 at the same step ends "
              f"{[m[kind] for m in h0['stages']['1 both']['mem']]}, "
              f"{[m[kind] for m in h0['stages']['3 both again']['mem']]}", flush=True)
    probe = h1["pinned_probe"]
    print(f"{label}: the pinned reading with a 1 MiB pinned block: before {probe['base']}, "
          f"while it lives {probe['live']}, once freed {probe['freed']}; the growth between "
          f"step ends no suspend separates {spread}", flush=True)
    if probe["live"] - probe["base"] != 1 << 20 or probe["freed"] != probe["base"]:
        bad.append(f"the pinned reading does not follow a live 1 MiB block: {probe}")
    if after[-1]["threads"] != before[-1]["threads"]:
        bad.append(f"host 1 runs {after[-1]['threads']} threads at a step end after its "
                   f"resume, {before[-1]['threads']} before its suspend")
    for kind in kinds:
        most = max(m[kind] for m in before)
        grew = max(max(m[kind] for m in after), h1["mem_after_resume"][kind]) - most
        if grew > spread[kind]:
            bad.append(f"host 1's {kind} memory grew across the suspend by {grew}, more than "
                       f"the {spread[kind]} two step ends with no suspend between them grew")
    for r in results:
        three = r["stages"]["4 three servers"]
        if three["num_servers"] != 3 or not three["keys_moved"]:
            bad.append(f"host {r['host']}: no keys re-homed at three servers ({three})")
    if h1["stages"]["4 three servers"]["generation"] < 1 or \
            h0["stages"]["5 two servers"]["generation"] < 1:
        bad.append("a live host did not bump its server generation")
    if spare_rc != 0 or "rank 2 summed" not in spare_log:
        bad.append(f"the third server did not exit on SHUTDOWN (exit {spare_rc})")
    for r in results:
        c = r["stages"]["6 scheduler restart"]
        print(f"{label}, host {r['host']}: through the scheduler's restart losses "
              f"{c['losses']} (without it {c['clean_losses']}), digests equal "
              f"{c['digest'] == c['clean_digest']}; from the restart to the end of the step "
              f"after it {c['restart_to_step_end_s']:.3f} s; epoch {c['epoch_before']} -> "
              f"{c['epoch_after']}; counters {c['counters']}", flush=True)
        if c["losses"] != c["clean_losses"] or c["digest"] != c["clean_digest"]:
            bad.append(f"host {r['host']}: the steps through the restart are not bitwise")
        if c["counters"]["sched_reconnect"] < 1 or c["counters"]["sched_rejoin"] < 1:
            bad.append(f"host {r['host']} did not reconnect and rejoin: {c['counters']}")
        if c["counters"]["worker_evicted"] or c["counters"]["server_evicted"]:
            bad.append(f"host {r['host']}: an eviction at the restart: {c['counters']}")
        if not c["epoch_after"] > c["epoch_before"] or not c["incarnation_newer"]:
            bad.append(f"host {r['host']}: the first book was not fenced above the last")
    for i, rep in enumerate(report):
        rc = rep[5] if rep else {}
        if rc.get("sched_reconnect", 0) < 1 or rc.get("sched_rejoin", 0) < 1:
            bad.append(f"server {i} did not reconnect and rejoin: {rc}")
    last = h0["stages"]["7 after host 1 died"]
    print(f"{label}: host 0's step after host 1 died took {last['ms'][0]:.1f} ms, "
          f"worker_evicted {last['worker_evicted']}", flush=True)
    if last["worker_evicted"] != 1:
        bad.append(f"host 1's eviction was not counted: {last['worker_evicted']}")
    for line in _server_lines(report):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    first = h0["stages"]["1 both"]["launches"][0]
    return {k: first[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "onebit_pack")}


#: phase (d), online resharding: depth, steps at each of its three stages
#: (two servers, three, two again), and the server-side Adam's settings (2
#: layers since the observability phase (j) joined, 6 before)
RESHARD_LAYERS, RESHARD_STAGE_STEPS = 2, 2
RESHARD_HP = {"lr": 1e-4}


def _waiting_server(env: dict, go: str, log) -> subprocess.Popen:
    """A server process that imports, prints "ready", and starts when the
    file ``go`` exists (its scheduler's port in it): it registers at once
    when a resize asks for it."""
    return _track(subprocess.Popen(
        [sys.executable, "-c",
         "import faulthandler, os, signal, sys, time\n"
         "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
         "from byteps_tpu_torch.server.server import run_server\n"
         "print('ready', flush=True)\n"
         "while not os.path.exists(sys.argv[1]):\n    time.sleep(0.02)\n"
         "with open(sys.argv[1]) as f:\n    os.environ['DMLC_PS_ROOT_PORT'] = f.read()\n"
         "run_server()\n", go],
        cwd=REPO, env={**env, "DMLC_ROLE": "server", "DMLC_NUM_SERVER": "3"},
        stdout=subprocess.PIPE, stderr=log, text=True), "waiting server", log.name, node=True)


def _waves(log_dir: str) -> list:
    """The migration waves the servers logged: (server log, server rank, map
    epoch, drain, keys, bytes, wall ms)."""
    import re

    out = []
    for i in range(3):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            for rank, epoch, drain, keys, nbytes, ms in re.findall(
                    r"rank (\d+) migration wave \(map epoch (\d+)(, drain)?\): shipped "
                    r"(\d+) keys, (\d+) bytes in ([\d.]+) ms", f.read()):
                out.append((i, int(rank), int(epoch), bool(drain), int(keys), int(nbytes),
                            float(ms)))
    return out


def _reshard_run(label: str, server_side: bool, resize: bool) -> dict:
    """One run of phase (d): BERT-large at RESHARD_LAYERS through one worker
    and a scheduler and two Python servers, every node with
    BYTEPS_ELASTIC_RESHARD=1 and CRC32C on, 3 * RESHARD_STAGE_STEPS steps;
    bare onebit with local AdamW, or with ``server_side`` Adam on the
    servers over raw f32.  With ``resize``, a third server waits: once the
    first partitions of the first step at the second stage were pushed, a
    second thread asks for three servers (``bps.resume(num_servers=3)``,
    which resizes the live worker) and the third server starts; before the
    third stage the worker asks for two, and the third server drains and
    exits.  Returns the losses, the parameters' digest, each step's ms, the
    kernels' launches, the keys and their expected moves, the worker's
    counters, the servers' reports and waves."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.hashing import HashRing
    from byteps_tpu_torch.common.registry import reset_registry
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    reset_registry()
    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "DMLC_PS_ROOT_URI": "127.0.0.1",
           "BYTEPS_WIRE_CHECKSUM": "1", "BYTEPS_ELASTIC_RESHARD": "1", "PYTHONPATH": REPO}
    saved = dict(os.environ)
    out = {"ms": [], "resize_s": {}}
    with tempfile.TemporaryDirectory() as log_dir:
        go = os.path.join(log_dir, "server2.go")
        spare = []
        if resize:
            # it imports beside the fleet, and is ready before the steps
            with open(os.path.join(log_dir, "server2.log"), "w") as log:
                spare.append(_waiting_server(env, go, log))
        port, procs = _start_ps_processes(env, log_dir)
        procs += spare
        try:
            if resize and procs[3].stdout.readline().strip() != "ready":
                fail(f"{label}: the third server did not start")
            os.environ.update({**env, "DMLC_PS_ROOT_PORT": port})
            bps.init()
            cfg, model, tok, tgt = _bert(RESHARD_LAYERS)
            if server_side:
                opt = bps.DistributedOptimizer(None, named_parameters=model.named_parameters(),
                                               server_side=True, server_rule="adam",
                                               server_hp=RESHARD_HP)
            else:
                bps.broadcast_parameters(model.state_dict(), root_rank=0)
                opt = bps.DistributedOptimizer(
                    torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
                    named_parameters=model.named_parameters(),
                    compression_params={"compressor": "onebit", "scaling": True})
            step = build_train_step(model, opt)
            client = get_state().ps_client
            fa.reset_launches()
            ob.reset_launches()
            counters().reset()
            losses = []
            for i in range(3 * RESHARD_STAGE_STEPS):
                scale_up = None
                if resize and i == RESHARD_STAGE_STEPS:
                    rpc0 = counters().get("wire_rpc")

                    def ask() -> None:
                        # once the step's first partitions went out
                        while counters().get("wire_rpc") < rpc0 + 8:
                            time.sleep(0.001)
                        t0 = time.perf_counter()
                        asker = threading.Thread(target=bps.resume, kwargs={"num_servers": 3})
                        asker.start()
                        time.sleep(0.5)  # the worker's REGISTER lands first
                        with open(go + ".tmp", "w") as f:
                            f.write(port)
                        os.replace(go + ".tmp", go)
                        t_go = time.perf_counter()
                        asker.join(120)
                        out["resize_s"]["up"] = time.perf_counter() - t0
                        out["resize_s"]["up_after_go"] = time.perf_counter() - t_go
                        out["up_alive"] = asker.is_alive()

                    scale_up = threading.Thread(target=ask)
                    scale_up.start()
                if resize and i == 2 * RESHARD_STAGE_STEPS:
                    t0 = time.perf_counter()
                    bps.resume(num_servers=2)
                    out["resize_s"]["drain"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                losses.append(float(step(tok, tgt)))
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                if scale_up is not None:
                    scale_up.join(180)
                    out["servers_at_three"] = len(client._servers)
            out["launches"] = {**fa.launches, **ob.launches}
            out["stats"] = counters().snapshot()
            out["generation"] = client.server_generation
            out["map_epoch"] = client.map_epoch
            out["digest"] = _param_digest(model)
            out["state_bytes"] = _state_bytes(opt)
            keys = [r["key"] for r in get_state().engine.partition_table()]
            two, three = HashRing([0, 1]), HashRing([0, 1, 2])
            out["keys"] = len(keys)
            out["rehomed"] = sum(two.owner(k) != three.owner(k) for k in keys)
            out["compressed_parts"] = sum(r["wire_nbytes"] is not None
                                          for r in get_state().engine.partition_table()
                                          if r["name"].startswith("Gradient."))
            bps.shutdown()
            del model, opt, step
            if resize:
                deadline = time.monotonic() + 60
                while procs[3].poll() is None and time.monotonic() < deadline:
                    time.sleep(0.1)
                out["spare_rc"] = procs[3].poll()
            out["dead"] = [p.args for p in procs[:3] if p.poll() is not None]
        finally:
            os.environ.clear()
            os.environ.update(saved)
            _stop_processes(procs)
        out["report"] = _server_report(log_dir, 3 if resize else 2)
        out["waves"] = _waves(log_dir) if resize else []
    out["losses"] = losses
    out["n_layers"] = cfg.n_layers
    return out


def train_reshard(card: str) -> dict:
    """Phase (d): online resharding.  For bare onebit, then for the
    server-side Adam on raw f32: a run on a fleet that never resizes and a
    run through a scale-up to three servers (overlapping a step's rounds)
    and a drain back to two (``_reshard_run``).  Fails unless the resized
    run's losses and parameters are bitwise the other's, the worker's
    ``server_generation`` stayed 0, it routed to three servers in the
    middle stage, the two old servers shipped as many keys as the ring
    re-homes from {0, 1} to {0, 1, 2} and the third shipped them all back,
    the third server exited 0 by itself, no server died, K1-K4 launched
    as the depth and the partition table say, and the server-side run left
    no optimizer state on the worker.  Prints each wave's wall ms, keys and
    bytes, the steps' ms beside the no-resize run's and the worker's
    redirects.  Returns the onebit stage's launches a step."""
    label = "reshard"
    wall = time.perf_counter()
    bad = []
    per_step = None
    for stage, server_side in (("bare onebit", False), ("server-side Adam, raw f32", True)):
        still = _reshard_run(f"{label} {stage}", server_side, resize=False)
        moved = _reshard_run(f"{label} {stage}", server_side, resize=True)
        n = 3 * RESHARD_STAGE_STEPS
        k4 = 0 if server_side else moved["compressed_parts"]
        want = {"flash_fwd": 2 * moved["n_layers"] * n, "flash_bwd_dq": moved["n_layers"] * n,
                "flash_bwd_dkv": moved["n_layers"] * n, "onebit_pack": k4 * n}
        waves = moved["waves"]
        up = sum(w[4] for w in waves if not w[3] and w[1] < 2)
        back = sum(w[4] for w in waves if w[3] and w[1] == 2)
        reported = [(r or (0, 0, {}, None, None, {}))[5].get("migration_keys_moved", 0)
                    for r in moved["report"]]
        print(f"{label}, {stage}: BERT-large at {moved['n_layers']} layers, seq {SEQ} bf16 "
              f"remat flash, batch {BATCH}, 1 worker, 2 Python servers and a third on "
              f"demand, BYTEPS_ELASTIC_RESHARD=1, CRC32C: losses {moved['losses']} (no resize "
              f"{still['losses']}); ms a step {[round(x, 1) for x in moved['ms']]} (no resize "
              f"{[round(x, 1) for x in still['ms']]}); the scale-up asked for "
              f"{moved['resize_s'].get('up', float('nan')):.3f} s (of which "
              f"{moved['resize_s'].get('up_after_go', float('nan')):.3f} s after the third "
              f"server was let start), the drain "
              f"{moved['resize_s'].get('drain', float('nan')):.3f} s; on {card}", flush=True)
        for _log, rank, epoch, drain, keys, nbytes, ms in waves:
            print(f"{label}, {stage}: server rank {rank} wave (map epoch {epoch}"
                  f"{', drain' if drain else ''}): {keys} keys, {nbytes} bytes in {ms:.1f} ms",
                  flush=True)
        stats = moved["stats"]
        print(f"{label}, {stage}: {moved['keys']} keys, {moved['rehomed']} re-homed by the "
              f"ring from {{0, 1}} to {{0, 1, 2}}; shipped up {up}, back {back}; servers' "
              f"migration_keys_moved {reported}; server_generation {moved['generation']}, map "
              f"epoch {moved['map_epoch']}; the worker's wrong_owner_redirect "
              f"{stats.get('wrong_owner_redirect', 0)}, rpc_retry {stats.get('rpc_retry', 0)}, "
              f"rpc_giveup {stats.get('rpc_giveup', 0)}; launches {moved['launches']}; the "
              f"third server exited {moved['spare_rc']}; the worker's optimizer state "
              f"{moved['state_bytes']} bytes", flush=True)
        for line in _server_lines(moved["report"]):
            print(f"{label}, {stage}: {line}", flush=True)
        if moved["losses"] != still["losses"] or moved["digest"] != still["digest"]:
            bad.append(f"{stage}: the resized run is not bitwise the run that never resized")
        if moved["generation"] != 0 or still["generation"] != 0:
            bad.append(f"{stage}: server_generation {moved['generation']}, "
                       f"{still['generation']} (a re-init)")
        if moved.get("servers_at_three") != 3 or moved.get("up_alive"):
            bad.append(f"{stage}: the worker did not route to three servers in the middle "
                       f"stage ({moved.get('servers_at_three')})")
        if not moved["rehomed"] or up != moved["rehomed"] or back != moved["rehomed"]:
            bad.append(f"{stage}: shipped {up} keys up and {back} back, the ring re-homes "
                       f"{moved['rehomed']}")
        if reported != [sum(w[4] for w in waves if w[0] == i) for i in range(3)]:
            bad.append(f"{stage}: the servers counted {reported} keys moved, their waves "
                       f"{waves}")
        if moved["spare_rc"] != 0:
            bad.append(f"{stage}: the drained server exited {moved['spare_rc']}, not 0 by "
                       "itself")
        if moved["dead"] or still["dead"]:
            bad.append(f"{stage}: a PS process died: {moved['dead'] or still['dead']}")
        for run in (still, moved):
            if run["launches"] != want:
                bad.append(f"{stage}: launches {run['launches']}, expected {want}")
        if server_side and (moved["state_bytes"] or still["state_bytes"]):
            bad.append(f"{stage}: the worker holds optimizer state")
        if not all(math.isfinite(x) for x in moved["losses"]):
            bad.append(f"{stage}: non-finite losses {moved['losses']}")
        if per_step is None:
            per_step = {k: v // n for k, v in moved["launches"].items()}
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return per_step


#: phase (e), the control plane: the codec, each stage's depth, batch and
#: steps (stage 2: two hosts of CONTROL_BATCH sequences each, steps before
#: the scheduler's restart, then after it), and how long the hosts wait
#: after both decisions landed, past the canaries' window (3 sweeps of
#: 0.2 s), before they train on
CONTROL_PARAMS = {"compressor": "topk", "k": 12000}
CONTROL_K = 12000
CONTROL_LAYERS_1, CONTROL_STEPS_1 = 2, 3
CONTROL_LAYERS_2, CONTROL_BATCH, CONTROL_STEPS_2, CONTROL_STEPS_3 = 2, 16, 6, 2
CONTROL_SETTLE_S = 3.0
CONTROL_ENV = {
    "BYTEPS_COMPRESSION_AUTO": "1", "BYTEPS_FUSION_THRESHOLD": str(FUSION_THRESHOLD),
    "BYTEPS_ELASTIC_RESHARD": "1", "BYTEPS_AUTOTUNE": "1", "BYTEPS_AUTOTUNE_INTERVAL_S": "0.2",
    "BYTEPS_AUTOTUNE_CANARY_SWEEPS": "3", "BYTEPS_HEARTBEAT_INTERVAL": "0.2",
    # only the scripted decisions: no rebalance from the servers' real load
    # (its streak would need the hot server at 1e9 times its peers' median)
    "BYTEPS_AUTOTUNE_FACTOR": "1e9",
}

#: the scheduler of phase (e)'s stage 2: it starts when its ``go`` file
#: exists (argv[1], "" for at once), sweeps its tuner only once
#: ``tuner_go`` exists (argv[2]: a forced move then finds the keys it moves
#: already live), and appends each sweep's ms and its actions and rollbacks
#: to argv[3]
CONTROL_SCHED = (
    "import faulthandler, os, signal, sys, time\n"
    "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
    "from byteps_tpu_torch.comm import rendezvous as rv\n"
    "go, tuner_go, log = sys.argv[1:4]\n"
    "while go and not os.path.exists(go):\n"
    "    time.sleep(0.02)\n"
    "sweep, loop = rv.Scheduler._tuner_sweep_once, rv.Scheduler._tuner_loop\n"
    "def timed(self):\n"
    "    t0 = time.perf_counter()\n"
    "    res = sweep(self)\n"
    "    with open(log, 'a') as f:\n"
    "        f.write('%.3f %d %d\\n' % ((time.perf_counter() - t0) * 1e3,\n"
    "                                 len(res['actions']), len(res['rollbacks'])))\n"
    "    return res\n"
    "def deferred(self):\n"
    "    while not os.path.exists(tuner_go):\n"
    "        if self._stop.wait(0.05):\n"
    "            return\n"
    "    loop(self)\n"
    "rv.Scheduler._tuner_sweep_once, rv.Scheduler._tuner_loop = timed, deferred\n"
    "from byteps_tpu_torch.server.server import run_server\n"
    "run_server()\n")


@contextlib.contextmanager
def _tap_control_rounds(client, keep):
    """What this worker's PS client sends and gets back, by (key, version):
    ``kinds`` "c" for a compressed push, "r" for a raw one; and for the
    (key, version) that ``keep`` accepts, the bytes of the push and of the
    pull (a fused member's slot of the reply, a raw pull from its sink)."""
    import threading

    from byteps_tpu_torch.comm.ps_client import ZERO_COPIED
    from byteps_tpu_torch.common.types import RequestType, decode_command_type

    push, push_fused, pull = client.push, client.push_fused, client.pull
    lock = threading.Lock()
    seen: dict = {"kinds": {}, "push": {}, "pull": {}}

    def note(key, version, compressed, payload) -> None:
        with lock:
            seen["kinds"][key, version] = "c" if compressed else "r"
            if keep(key, version):
                seen["push"][key, version] = bytes(memoryview(payload).cast("B"))

    def tap_push(key, payload, dtype_id, version, *args, **kwargs):
        note(key, version, kwargs.get("request_type") == RequestType.COMPRESSED_PUSH_PULL,
             payload)
        return push(key, payload, dtype_id, version, *args, **kwargs)

    def tap_push_fused(members, cb, *args, **kwargs):
        versions = {}
        for key, cmd, version, payload in members:
            note(key, version, decode_command_type(cmd)[0] == RequestType.COMPRESSED_PUSH_PULL,
                 payload)
            versions[key] = version

        def cb_tapped(replies):
            with lock:
                for key, _, payload in replies:
                    if keep(key, versions.get(key)):
                        seen["pull"][key, versions[key]] = bytes(payload)
            cb(replies)
        return push_fused(members, cb_tapped, *args, **kwargs)

    def tap_pull(key, version, cb, *args, **kwargs):
        if not keep(key, version):
            return pull(key, version, cb, *args, **kwargs)
        sink = kwargs.get("sink")

        def cb_tapped(payload):
            got = bytes(sink) if payload is ZERO_COPIED else bytes(payload)
            with lock:
                seen["pull"][key, version] = got
            cb(payload)
        return pull(key, version, cb_tapped, *args, **kwargs)

    client.push, client.push_fused, client.pull = tap_push, tap_push_fused, tap_pull
    try:
        yield seen
    finally:
        client.push, client.push_fused, client.pull = push, push_fused, pull


def _control_partitions() -> list:
    """Every declared gradient's partitions: (name, key, offset, length,
    compressed?, off?) with compressed? for a float32 tensor of at least
    BYTEPS_MIN_COMPRESS_BYTES (64 KiB) and off? where topk's wire (8 bytes
    a kept element, k at most the partition) is at least 0.9 of the raw."""
    from byteps_tpu_torch.common.registry import get_registry

    reg = get_registry()
    out = []
    for name in reg._order:
        ctx = reg.get(name)
        n = sum(p.length for p in ctx.partitions)
        compressed = name.startswith("Gradient.") and n * 4 >= 65536
        for p in ctx.partitions:
            off = compressed and 8 * min(CONTROL_K, p.length) >= 0.9 * 4 * p.length
            out.append((name, p.key, p.offset, p.length, compressed, off))
    return out


def _topk_decode(payload: bytes, n: int) -> np.ndarray:
    from byteps_tpu_torch.compression.impl import TopKCompressor

    return TopKCompressor(n, CONTROL_K).decompress(payload, n)


def _control_stage1(card: str) -> dict:
    """Stage 1 of phase (e): adaptive compression.  One worker through two
    server processes, BYTEPS_COMPRESSION_AUTO on, topk with k = 12000 at
    4,096,000-byte partitions.  Fails unless the engine's off set is the
    one the declared tensors give, every off partition pushed raw and every
    other compressed one topk's payload in every round, the last round's
    pulls are the decoded pushes (one worker: the sum of one) and the
    gradients the optimizer took, and the losses are finite and fall."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    label = "control (e) stage 1"
    bad = []
    with _ps_fleet(label, worker_env={"BYTEPS_COMPRESSION_AUTO": "1"}):
        bps.init()
        cfg, model, tok, tgt = _bert(CONTROL_LAYERS_1)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(), compression_params=CONTROL_PARAMS)
        eng, client = get_state().engine, get_state().ps_client
        fa.reset_launches()
        ob.reset_launches()
        with _tap_control_rounds(client, lambda key, v: v == CONTROL_STEPS_1) as seen:
            losses, split, secs = _timed_steps(model, opt, tok, tgt, CONTROL_STEPS_1)
        launches = {**fa.launches, **ob.launches}
        parts = _control_partitions()
        off_got = eng.auto_off_keys()
        codec_keys = set(eng._compressors)
        params = dict(model.named_parameters())
        grads = {name: params[name[len("Gradient."):]].grad.detach().reshape(-1).float().cpu()
                 .numpy() for name, *_ in parts if name.startswith("Gradient.")}
        bps.shutdown()
        del model, opt
    want_off = {key for _, key, _, _, _, off in parts if off}
    want_codec = {key for _, key, _, _, comp, _ in parts if comp}
    print(f"{label}: off set {len(off_got)} partitions, expected {len(want_off)}, of "
          f"{len(want_codec)} topk partitions; steps ms {[round(secs / len(losses) * 1e3, 1)]} "
          f"({_split_line(split, len(losses))}); losses {[round(x, 4) for x in losses]}; "
          f"launches {launches}; on {card}", flush=True)
    if off_got != want_off or codec_keys != want_codec:
        bad.append(f"off set {sorted(off_got)} (codec keys {len(codec_keys)}), expected "
                   f"{sorted(want_off)} ({len(want_codec)})")
    rounds = {}
    for (key, v), kind in seen["kinds"].items():
        rounds.setdefault(key, {})[v] = kind
    for name, key, offset, length, comp, off in parts:
        want = "c" if comp and not off else "r"
        kinds = rounds.get(key, {})
        if sorted(kinds) != list(range(1, CONTROL_STEPS_1 + 1)) or set(kinds.values()) != {want}:
            bad.append(f"key {key} ({name}, {length}): pushes {kinds}, want {want} a round")
            continue
        if not name.startswith("Gradient."):
            continue
        pushed = seen["push"].get((key, CONTROL_STEPS_1))
        pulled = seen["pull"].get((key, CONTROL_STEPS_1))
        grad = grads[name][offset: offset + length]
        if pushed is None or pulled is None:
            bad.append(f"key {key}: the last round was not tapped")
        elif want == "r":
            if not (pushed == pulled == grad.tobytes()):
                bad.append(f"key {key}: raw push, pull and gradient differ")
        elif len(pushed) != 8 * min(CONTROL_K, length) or not (
                _topk_decode(pulled, length).tobytes() == _topk_decode(pushed, length).tobytes()
                == grad.tobytes()):
            bad.append(f"key {key}: the pull is not the decoded push the optimizer took")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        bad.append(f"losses {losses}")
    want_flash = {"flash_fwd": 2 * cfg.n_layers * CONTROL_STEPS_1,
                  "flash_bwd_dq": cfg.n_layers * CONTROL_STEPS_1,
                  "flash_bwd_dkv": cfg.n_layers * CONTROL_STEPS_1}
    if {k: launches[k] for k in want_flash} != want_flash or launches["onebit_pack"]:
        bad.append(f"launches {launches}, want {want_flash} and no K4")
    if bad:
        fail(f"{label}: " + "; ".join(bad[:12]))
    return {"off": len(off_got), "codec": len(codec_keys), "losses": losses,
            "step_ms": secs / len(losses) * 1e3,
            "launches_a_step": {k: v // CONTROL_STEPS_1 for k, v in launches.items()}}


def control_host(work: str) -> None:
    """One host of phase (e)'s stage 2, under the port's launcher
    (``chip_smoke.py --control-host <dir>``): BERT-large at
    CONTROL_LAYERS_2 on its CONTROL_BATCH sequences through
    DistributedOptimizer(AdamW) with topk and adaptive compression.  It
    trains a step, waits at a cue until its engine adopted the forced move
    (the key routes to its new owner under a newer map) and the fleet's
    codec_off of topk, and CONTROL_SETTLE_S more; trains to step
    CONTROL_STEPS_2; waits for the scheduler's restart; and trains
    CONTROL_STEPS_3 steps more.  Writes <dir>/control<h>.json (per step:
    loss, ms, parameter digest, launches, map epoch, the moved key's owner;
    the kinds of every push; the books after the restart; counters) and
    <dir>/control<h>.npz (the sampled keys' pushes and pulls)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    key, target = int(os.environ["CONTROL_MOVE_KEY"]), int(os.environ["CONTROL_MOVE_RANK"])
    sample = {key, int(os.environ["CONTROL_OFF_KEY"])}
    bps.init()
    _, model, tok, tgt = _bert(CONTROL_LAYERS_2)
    rows = slice(host * CONTROL_BATCH, (host + 1) * CONTROL_BATCH)
    tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
    # both hosts load init_params(seed=0): no broadcast, so that the
    # gradients are the first tensors declared and their keys the ones
    # _control_keys computed for the forced move
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), compression_params=CONTROL_PARAMS)
    step = build_train_step(model, opt)
    eng, client = get_state().engine, get_state().ps_client
    books: list = []
    note = client._note_membership

    def tap_note(book: dict) -> None:
        books.append({"inc": book.get("sched_incarnation"), "map_epoch": book.get("map_epoch"),
                      "tuning": book.get("tuning"), "ring_overrides": book.get("ring_overrides")})
        note(book)

    client._note_membership = tap_note
    out = {"host": host, "steps": []}

    def train(n: int) -> None:
        for _ in range(n):
            fa.reset_launches()
            ob.reset_launches()
            t0 = time.perf_counter()
            loss = float(step(tok, tgt))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            omap = client._routing[2]
            out["steps"].append({"loss": loss, "ms": ms, "digest": _param_digest(model),
                                 "launches": {**fa.launches, **ob.launches},
                                 "map_epoch": client.map_epoch,
                                 "owner": omap.owner(key) if omap is not None else None,
                                 "tuning_epoch": client._tuning_epoch})

    def wait_for(cond, what: str, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                fail(f"control (e) host {host}: {what} never came")
            time.sleep(0.05)

    with _tap_control_rounds(client, lambda k, v: k in sample) as seen:
        train(1)
        epoch1 = client.map_epoch
        _mark(work, f"step1-host{host}")
        wait_for(lambda: (client.map_epoch > epoch1 and client._routing[2].owner(key) == target
                          and "topk" in eng._fleet_codec_off), "the forced move and topk's flip")
        time.sleep(CONTROL_SETTLE_S)
        _mark(work, f"tuned-host{host}", client._tuning_epoch)
        other = _await_mark(work, f"tuned-host{1 - host}", 120)["value"]
        wait_for(lambda: client._tuning_epoch >= other, "the other host's tuning epoch")
        train(CONTROL_STEPS_2 - 1)
        before = {"tuning": client.tuning, "overrides": dict(client._seen_ring_overrides),
                  "inc": client.sched_incarnation, "books": len(books)}
        _mark(work, f"step{CONTROL_STEPS_2}-host{host}")
        _await_mark(work, "sched-restarted", 120)
        wait_for(lambda: client.sched_incarnation > before["inc"] and not client._sched_dead
                 and client.tuning is not None, "the successor's books", 60)
        train(CONTROL_STEPS_3)
        out["kinds"] = [[k, v, kind] for (k, v), kind in seen["kinds"].items()]
        blobs = {f"{kind}_{k}_{v}": np.frombuffer(b, np.uint8)
                 for kind in ("push", "pull") for (k, v), b in seen[kind].items()}
    out.update(before=before, after_books=books[before["books"]:],
               after={"tuning": client.tuning, "overrides": dict(client._seen_ring_overrides)},
               codec_keys={str(k): int(c.size) for k, c in eng._compressors.items()},
               fleet_off={n: sorted(ks) for n, ks in eng._fleet_codec_off.items()},
               auto_off=sorted(eng.auto_off_keys()),
               counters=counters().snapshot_labeled(), epoch1=epoch1, tuned=other)
    np.savez(os.path.join(work, f"control{host}.npz"), **blobs)
    with open(os.path.join(work, f"control{host}.json"), "w") as f:
        json.dump(out, f)
    bps.shutdown()


def _control_keys(n_layers: int) -> tuple:
    """Stage 2's forced move and its sampled off partition, from the
    declared tensors of the model at ``n_layers``: the largest compressed
    partition that stays topk (the highest key among equals), the rank of
    the two servers that does not own it, and the smallest off one."""
    from byteps_tpu_torch.common.hashing import HashRing
    from byteps_tpu_torch.common.partition import partition_tensor
    from byteps_tpu_torch.common.registry import get_registry, reset_registry
    from byteps_tpu_torch.compression.registry import translate_compression_params
    from byteps_tpu_torch.models.transformer import Transformer, bert_large

    cfg = dataclasses.replace(bert_large(max_seq=SEQ), n_layers=n_layers)
    model = Transformer(cfg, device="meta")
    reset_registry()
    kw = translate_compression_params(CONTROL_PARAMS)
    for name, p in model.named_parameters():
        ctx = get_registry().declare(f"Gradient.{name}", **kw)
        partition_tensor(ctx, p.numel(), 4, 4096000)
    parts = _control_partitions()
    reset_registry()
    keep = [(length, key) for _, key, _, length, comp, off in parts if comp and not off]
    key = max(keep)[1]
    off = min((length, key) for _, key, _, length, _, o in parts if o)[1]
    return key, 1 - HashRing([0, 1]).owner(key), off


def _control_stage2(card: str) -> dict:
    """Stage 2 of phase (e): the tuner, with two launcher hosts of one
    process each (``control_host``), a scheduler and two Python servers.
    The tuner sweeps once both hosts trained a step: a forced move of
    ``_control_keys``' key to the server that does not own it, then
    codec_consensus on the hosts' topk verdicts.  After step
    CONTROL_STEPS_2 the scheduler is killed (SIGKILL) and restarted with no
    forced action.  Fails unless the hosts' parameters are bitwise equal
    after every step, the move raised the map epoch by one and was shipped
    by a migration wave, the key's rounds went on at its new owner, every
    topk key not already off was flipped (``tune_codec_off``) and pushed
    raw from the round after the flip, every sampled pull is the sum of the
    two hosts' decoded pushes, the successor's first books carried the
    same tuning section and overrides, no wave after the restart shipped a
    key, and a decision bundle was written for each action."""

    from byteps_tpu_torch.compression.impl import TopKCompressor

    label = "control (e) stage 2"
    key, target, off_key = _control_keys(CONTROL_LAYERS_2)
    env = {**os.environ, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker", **CONTROL_ENV,
           "CONTROL_MOVE_KEY": str(key), "CONTROL_MOVE_RANK": str(target),
           "CONTROL_OFF_KEY": str(off_key)}
    bad = []
    with tempfile.TemporaryDirectory() as work:
        bundles = os.path.join(work, "bundles")
        env["BYTEPS_FLIGHT_DIR"] = bundles
        tuner_go, sched_go = os.path.join(work, "tuner.go"), os.path.join(work, "sched2.go")
        sweeps = os.path.join(work, "sweeps.log")
        port, procs = _start_ps_processes(
            {**env, "BYTEPS_AUTOTUNE_FORCE": f"move={key}:{target}"}, work,
            sched_args=["-c", CONTROL_SCHED, "", tuner_go, sweeps])
        # the successor: imported already, it binds the port once its go
        # file exists, with no forced action, its tuner sweeping at once
        successor = _track(subprocess.Popen(
            [sys.executable, "-c", CONTROL_SCHED, sched_go, sched_go, sweeps], cwd=REPO,
            env={**env, "DMLC_ROLE": "scheduler", "DMLC_PS_ROOT_PORT": port},
            stdout=subprocess.PIPE, text=True), "successor scheduler", node=True)
        hosts = []
        try:
            for h in range(HYBRID_HOSTS):
                path = os.path.join(work, f"host{h}.log")
                with open(path, "w") as log:
                    hosts.append(_track(subprocess.Popen(
                        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                         sys.executable, os.path.join(REPO, "chip_smoke.py"), "--control-host",
                         work],
                        cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port, "DMLC_WORKER_ID": str(h)},
                        stdout=log, stderr=subprocess.STDOUT), f"host {h}", path))

            def cue(name: str) -> bool:
                deadline = time.monotonic() + 300
                while not all(os.path.exists(os.path.join(work, f"{name}-host{h}.mark"))
                              for h in range(HYBRID_HOSTS)):
                    if any(p.poll() is not None for p in hosts) or time.monotonic() > deadline:
                        return False
                    time.sleep(0.02)
                return True

            if cue("step1"):
                open(tuner_go, "w").close()
            if cue(f"step{CONTROL_STEPS_2}"):
                t_kill = time.time()
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(30)
                open(sched_go, "w").close()
                line = successor.stdout.readline().strip()
                if line != f"BYTEPS_SCHEDULER_PORT={port}":
                    bad.append(f"the successor reported {line!r}")
                _mark(work, "sched-restarted")
                print(f"{label}: the scheduler was killed and its successor listened in "
                      f"{time.time() - t_kill:.2f} s", flush=True)
            deadline = time.monotonic() + 300
            while any(p.poll() is None for p in hosts) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in hosts):
                    break
                time.sleep(0.2)
            rcs = [p.poll() for p in hosts]
        finally:
            _stop_processes(hosts)
            _stop_processes(procs + [successor])
        if rcs != [0] * HYBRID_HOSTS:
            for h in range(HYBRID_HOSTS):
                with open(os.path.join(work, f"host{h}.log")) as f:
                    print(f"--- {label} host {h} (exit {rcs[h]}):\n{f.read()[-6000:]}",
                          file=sys.stderr)
            fail(f"{label}: the hosts exited {rcs}")
        res, blobs = [], []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"control{h}.json")) as f:
                res.append(json.load(f))
            blobs.append(dict(np.load(os.path.join(work, f"control{h}.npz"))))
        waves = _waves_of(work, 2)
        with open(sweeps) as f:
            sweep_rows = [line.split() for line in f if line.strip()]
        decisions = []
        for path in sorted(glob.glob(os.path.join(bundles, "*", "decision.json"))):
            with open(path) as f:
                decisions.append((os.path.basename(os.path.dirname(path)), json.load(f)))
    # --- what it printed and what must hold ---
    ms = [round(float(r[0]), 3) for r in sweep_rows]
    print(f"{label}: {len(ms)} sweeps, ms each p50 {np.median(ms):.3f}, max {max(ms):.3f}; "
          f"{sum(int(r[1]) for r in sweep_rows)} actions, "
          f"{sum(int(r[2]) for r in sweep_rows)} rollbacks", flush=True)
    for name, d in decisions:
        act = d.get("action") or {}
        print(f"{label}: {d['kind']} {d['rule']} (tuning epoch {d['tuning_epoch']}, sweep "
              f"{d['sweep']}): set {act.get('set')}, evidence {act.get('evidence')}, baseline "
              f"step {d.get('baseline_step_s')} s"
              + (f", after {d['post_step_s']} s" if d["kind"] == "rollback" else ""), flush=True)
    # the scripted two, and whatever the fusion walk did on the real traffic
    rules = sorted(d["rule"] for _, d in decisions if d["kind"] == "action")
    n_actions = sum(int(r[1]) + int(r[2]) for r in sweep_rows)
    if not {"codec_consensus", "hot_key_rebalance"} <= set(rules) or \
            len(decisions) != n_actions:
        bad.append(f"decision bundles for {rules} ({len(decisions)}), the sweeps counted "
                   f"{n_actions} actions and rollbacks")
    rolled = sorted(d["rule"] for _, d in decisions if d["kind"] == "rollback")
    print(f"{label}: decisions that stood "
          f"{sorted(set(rules) - set(rolled))}, rolled back {rolled}", flush=True)
    h0, h1 = res
    for r in res:
        print(f"{label}, host {r['host']}: steps ms {[round(s['ms'], 1) for s in r['steps']]}; "
              f"losses {[round(s['loss'], 4) for s in r['steps']]}; map epochs "
              f"{[s['map_epoch'] for s in r['steps']]}; the moved key's owner "
              f"{[s['owner'] for s in r['steps']]}; K1-K4 a step "
              f"{[[s['launches'][k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv', 'onebit_pack')] for s in r['steps']]}"
              f"; off set {len(r['auto_off'])} of {len(r['codec_keys'])} topk partitions "
              f"(fleet {{'topk': {len(r['fleet_off'].get('topk', []))}}}); on {card}", flush=True)
    n_steps = CONTROL_STEPS_2 + CONTROL_STEPS_3
    for i in range(n_steps):
        if h0["steps"][i]["digest"] != h1["steps"][i]["digest"]:
            bad.append(f"the hosts' parameters differ after step {i + 1}")
    if not all(math.isfinite(s["loss"]) for r in res for s in r["steps"]):
        bad.append("a non-finite loss")
    want_launch = {"flash_fwd": 2 * CONTROL_LAYERS_2, "flash_bwd_dq": CONTROL_LAYERS_2,
                   "flash_bwd_dkv": CONTROL_LAYERS_2, "onebit_pack": 0}
    for r in res:
        for i, s in enumerate(r["steps"]):
            if s["launches"] != want_launch:
                bad.append(f"host {r['host']} step {i + 1}: launches {s['launches']}")
        # the move: one map epoch up, the key at its new owner from step 2 on
        if r["steps"][1]["map_epoch"] != r["epoch1"] + 1 or \
                any(s["owner"] != target for s in r["steps"][1:]):
            bad.append(f"host {r['host']}: map epochs {[s['map_epoch'] for s in r['steps']]}, "
                       f"owners {[s['owner'] for s in r['steps']]} (epoch at step 1 "
                       f"{r['epoch1']}, target {target})")
        codec = {int(k) for k in r["codec_keys"]}
        static_off = set(r["auto_off"]) - set(r["fleet_off"].get("topk", []))
        flipped = set(r["fleet_off"].get("topk", []))
        n_flip = r["counters"].get("tune_codec_off", {}).get('{codec="topk"}', 0)
        if flipped != codec - static_off or n_flip != len(flipped):
            bad.append(f"host {r['host']}: {len(flipped)} keys flipped, tune_codec_off "
                       f"{n_flip}, want {len(codec - static_off)}")
        kinds = {(k, v): kind for k, v, kind in r["kinds"]}
        for (k, v), kind in kinds.items():
            want = "r" if (k not in codec or k in static_off or v >= 2) else "c"
            if kind != want:
                bad.append(f"host {r['host']}: key {k} round {v} pushed {kind}, want {want}")
                break
        if r["after_books"][:1] and (
                r["after_books"][0]["tuning"] != r["before"]["tuning"]
                or (r["after_books"][0]["ring_overrides"] or {}) != r["before"]["overrides"]):
            bad.append(f"host {r['host']}: the successor's first book {r['after_books'][0]}, "
                       f"before the restart {r['before']}")
        later = r["after"]
        if not r["after_books"] or later["overrides"] != r["before"]["overrides"] or \
                (later["tuning"] or {}).get("codec_off") != r["before"]["tuning"].get("codec_off"):
            bad.append(f"host {r['host']}: tuning after the restart {later}")
        print(f"{label}, host {r['host']}: tuning before the restart {r['before']['tuning']}, "
              f"overrides {r['before']['overrides']}; the successor's first book "
              f"{r['after_books'][:1]}", flush=True)
    # every sampled pull: the sum of the two hosts' decoded pushes, and
    # for a compressed round the servers' topk of that sum
    checked = 0
    for name in blobs[0]:
        if not name.startswith("push_"):
            continue
        _, k, v = name.split("_")
        pull = f"pull_{k}_{v}"
        n = int(h0["codec_keys"].get(k, 0)) or len(blobs[0][name]) // 4
        if name not in blobs[1] or pull not in blobs[0] or pull not in blobs[1]:
            bad.append(f"key {k} round {v}: not tapped on both hosts")
            continue
        pushes = [b[name].tobytes() for b in blobs]
        compressed = len(pushes[0]) != 4 * n
        dec = [(_topk_decode(p, n) if compressed else np.frombuffer(p, np.float32))
               for p in pushes]
        total = dec[0] + dec[1]
        want = TopKCompressor(n, CONTROL_K).compress(total) if compressed else total.tobytes()
        got = [b[pull].tobytes() for b in blobs]
        if not (got[0] == got[1] == want):
            bad.append(f"key {k} round {v}: the pull is not the sum of the decoded pushes")
        checked += 1
    moved_waves = [w for w in waves if w[3] > 0]
    last_epoch = max(r["steps"][CONTROL_STEPS_2 - 1]["map_epoch"] for r in res)
    after = [w for w in waves if w[2] > last_epoch]
    for w in moved_waves:
        print(f"{label}: server {w[0]} (rank {w[1]}) migration wave at map epoch {w[2]}: "
              f"{w[3]} keys, {w[4]} bytes in {w[5]:.1f} ms", flush=True)
    if not any(w[2] == h0["epoch1"] + 1 and w[3] >= 1 for w in moved_waves):
        bad.append(f"no wave shipped the moved key at map epoch {h0['epoch1'] + 1}: {waves}")
    if any(w[3] for w in after):
        bad.append(f"keys migrated after the restart: {after}")
    print(f"{label}: {checked} sampled pulls checked; waves after the restart {after}",
          flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad[:12]))
    first = h0["steps"][0]["launches"]
    return {"launches_a_step": first, "sweeps": len(ms), "rolled": rolled,
            "step_ms": [s["ms"] for s in h0["steps"]]}


def _waves_of(log_dir: str, servers: int) -> list:
    """The migration waves ``servers`` servers logged: (server, rank, map
    epoch, keys, bytes, wall ms)."""
    import re

    out = []
    for i in range(servers):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            for rank, epoch, _drain, keys, nbytes, wall in re.findall(
                    r"rank (\d+) migration wave \(map epoch (\d+)(, drain)?\): shipped "
                    r"(\d+) keys, (\d+) bytes in ([\d.]+) ms", f.read()):
                out.append((i, int(rank), int(epoch), int(keys), int(nbytes), float(wall)))
    return out


def train_control(card: str) -> dict:
    """Phase (e), the closed-loop control plane: adaptive compression on one
    worker (``_control_stage1``), then the autotuner across two hosts and a
    scheduler restart (``_control_stage2``).  Returns stage 2's launches a
    step (host 0, step 1)."""
    wall = time.perf_counter()
    one = _control_stage1(card)
    two = _control_stage2(card)
    print(f"control (e): phase wall {time.perf_counter() - wall:.1f} s; stage 1 launches a "
          f"step {one['launches_a_step']}", flush=True)
    return two["launches_a_step"]


# --- phase (f): the rest of the data plane ----------------------------------

#: (f1): the fusion phase's unfused configuration on three fleets: (name,
#: van, C++ servers, native client)
VAN_FLEETS = (("shm, Python servers, Python lanes", "shm", False, False),
              ("uds, C++ servers, native client", "uds", True, True),
              ("shm, C++ servers, Python lanes", "shm", True, False))
#: (f2): BERT-large at 2 layers on two launcher hosts of HYBRID_BATCH
#: sequences each, 3 steps; the embedding's gradient goes out twice a step:
#: dense under a topk of k = 0.5 (its wire as large as the raw bytes, so
#: adaptive compression turns it off at registration and the lossless arm
#: probes its raw pushes) and row-sparse at the host's tokens
ROWSPARSE_LAYERS, ROWSPARSE_STEPS = 2, 3
ROWSPARSE_PARAMS = {"compressor": "topk", "k": 0.5}
ROWSPARSE_ENV = {"BYTEPS_COMPRESSION_AUTO": "1", "BYTEPS_WIRE_LOSSLESS": "1"}


def _socket_dir() -> str:
    """A fresh directory for a fleet's socket files: under the temp
    directory, or under /dev/shm (where the shm van's rings live) when a
    socket's path there would pass AF_UNIX's 107 bytes."""
    d = tempfile.mkdtemp(prefix="bps")
    if len(d) > 64:
        os.rmdir(d)
        d = tempfile.mkdtemp(prefix="bps", dir="/dev/shm")
    return d


def _leftovers(sock_dir: str) -> list:
    """The socket files left in ``sock_dir`` and the ring files of this
    process left in /dev/shm (a ring's name carries its maker's pid);
    removes ``sock_dir`` once it is empty."""
    left = [os.path.join(sock_dir, f) for f in os.listdir(sock_dir)]
    left += glob.glob(f"/dev/shm/byteps_ring_*_{os.getpid()}_*")
    if not os.listdir(sock_dir):
        os.rmdir(sock_dir)
    return left


def _round_trips(hists: dict) -> str:
    """The worker's rpc_round_trip_seconds, p50 and p99 a server."""
    return ", ".join(f"server {name.split('=')[1].strip(chr(34) + '}')} p50 "
                     f"{h['p50'] * 1e3:.3f} ms p99 {h['p99'] * 1e3:.3f} ms"
                     for name, h in sorted(hists.items())
                     if name.startswith("rpc_round_trip_seconds{"))


def train_vans(card: str) -> dict:
    """Phase (f1), the uds and shm vans: the fusion phase's unfused run
    (BERT-large at FUSION_LAYERS, bare onebit with scaling, CRC32C, one
    worker and two server processes) on each of VAN_FLEETS.  Holds each to
    the fusion phase's tcp run on the Python lanes: the losses and the
    parameters after the timed steps bitwise, K4 and K1-K3 at its launches a
    step, wire_tx_bytes equal; each server published its van's address,
    and no socket file nor ring file is left once the fleet stopped.
    Prints each fleet's ms a step and round trips beside tcp's.  Returns
    the kernels' launches a step of the first fleet."""
    import platform

    label = "vans (f1)"
    print(f"{label}: host {platform.machine()} (the shm van refuses a host that is "
          "not x86-64)", flush=True)
    wall = time.perf_counter()
    base = _FUSION_BASE.get("tcp")
    if base is None:  # the phase alone: its own tcp run
        base = _fusion_run(card, f"{label}, tcp, Python servers, Python lanes", False, False)
    runs = []
    for name, van, native, client in VAN_FLEETS:
        gc.collect()
        runs.append(_fusion_run(card, f"{label}, {name}", False, native, van, client))
    n = FUSION_STEPS
    want = {"flash_fwd": 2 * FUSION_LAYERS, "flash_bwd_dq": FUSION_LAYERS,
            "flash_bwd_dkv": FUSION_LAYERS, "onebit_pack": base["compressed"]}
    bad = []
    for r, (name, van, native, client) in zip(runs, VAN_FLEETS):
        per = {k: v / n for k, v in r["launches"].items()}
        scheme = {"uds": "unix://", "shm": "shm+unix://"}[van]
        if r["losses"] != base["losses"]:
            bad.append(f"{name}: losses {r['losses']} are not bitwise tcp's {base['losses']}")
        if r["digest"] != base["digest"]:
            bad.append(f"{name}: the parameters after {n} steps are not bitwise tcp's")
        if per != want:
            bad.append(f"{name}: launches a step {per}, expected {want}")
        if r["stats"].get("wire_tx_bytes", 0) != base["stats"].get("wire_tx_bytes", 0):
            bad.append(f"{name}: wire_tx_bytes {r['stats'].get('wire_tx_bytes', 0) // n} a "
                       f"step, tcp's {base['stats'].get('wire_tx_bytes', 0) // n}")
        if len(r["servers"]) != 2 or not all(h.startswith(scheme) for h in r["servers"]):
            bad.append(f"{name}: the servers published {r['servers']}")
        if r["leftovers"]:
            bad.append(f"{name}: left behind {r['leftovers']}")
        if r["report"] is None or any(x is None for x in r["report"]):
            bad.append(f"{name}: a server logged no stop report")
    for r in [base] + runs:
        s = r["stats"]
        print(f"{r['label']}: {r['step_ms']:.1f} ms a step over {n} steps (tcp "
              f"{base['step_ms']:.1f}); losses {[round(x, 4) for x in r['losses']]}; "
              f"wire_tx_bytes {s.get('wire_tx_bytes', 0) // n} a step; K4 "
              f"{r['launches']['onebit_pack'] // n} a step; round trips "
              f"{_round_trips(r['hists'])}; step split {_split_line(r['split'], n)}; "
              f"phase wall {r['wall']:.1f} s; on {card}", flush=True)
        for line in _hist_lines(r["hists"], n) + _server_lines(r["report"] or []):
            print(f"{r['label']}: {line}", flush=True)
    print(f"{label}: losses and parameters bitwise tcp's on every van "
          f"{all(r['losses'] == base['losses'] and r['digest'] == base['digest'] for r in runs)}"
          f"; nothing left behind {not any(r['leftovers'] for r in runs)}; phase wall "
          f"{time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return {k: v // n for k, v in runs[0]["launches"].items()}


def rowsparse_host(work: str) -> None:
    """One host of phase (f2), under the port's launcher (``chip_smoke.py
    --rowsparse-host <dir>``): BERT-large at ROWSPARSE_LAYERS on its
    HYBRID_BATCH sequences through DistributedOptimizer(AdamW) over every
    parameter but the word embedding, whose gradient each step goes out
    (a) dense, as ``embed.dense`` under ROWSPARSE_PARAMS, and (b) row-sparse
    at the host's tokens, as ``embed.rows``; the embedding's gradient then
    takes (a)'s result.  Taps the PS client's sends (each push's lossless
    flag and on-wire bytes).  Writes <dir>/rowsparse<h>.json."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.ps_client import _ServerConn
    from byteps_tpu_torch.comm.transport import Op
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.compression.registry import translate_compression_params
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    _host_go()
    bps.init()
    cfg, model, tok, tgt = _bert(ROWSPARSE_LAYERS)
    rows = slice(host * HYBRID_BATCH, (host + 1) * HYBRID_BATCH)
    tok, tgt = tok[rows].contiguous(), tgt[rows].contiguous()
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=[(n, p) for n, p in model.named_parameters() if n != "embed"])
    bps.declare_tensor("embed.dense", **translate_compression_params(ROWSPARSE_PARAMS))
    sent: list = []
    send = _ServerConn.send

    def tap_send(sc, msg) -> None:
        send(sc, msg)  # the payload is the container once it went lossless
        if msg.op == Op.PUSH:
            sent.append((int(msg.key), int(msg.version), bool(msg._lossless_applied),
                         memoryview(msg.payload).nbytes))

    _ServerConn.send = tap_send
    uniq = torch.unique(tok.reshape(-1))
    steps = []
    for _ in range(ROWSPARSE_STEPS):
        fa.reset_launches()
        ob.reset_launches()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        g = model.embed.grad
        t1 = time.perf_counter()
        dense = bps.push_pull(g, name="embed.dense")
        t2 = time.perf_counter()
        sparse = bps.push_pull_rowsparse(uniq, g[uniq], name="embed.rows",
                                         total_rows=cfg.vocab_size)
        t3 = time.perf_counter()
        same = bool(torch.equal(dense[uniq].view(torch.int32), sparse.view(torch.int32)))
        model.embed.grad = dense
        opt.step()
        torch.cuda.synchronize()
        steps.append({"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
                      "dense_ms": (t2 - t1) * 1e3, "rows_ms": (t3 - t2) * 1e3,
                      "same": same, "launches": {**fa.launches, **ob.launches}})
    _ServerConn.send = send
    reg = get_registry()
    dense_keys = [p.key for p in reg.get("embed.dense").partitions]
    rows_key = reg.get("embed.rows").partitions[0].key
    eng = get_state().engine
    gauges = metrics().snapshot()["gauges"]
    out = {"host": host, "steps": steps, "rows": int(uniq.numel()),
           "total_rows": cfg.vocab_size, "row_len": cfg.d_model,
           "raw": model.embed.numel() * model.embed.element_size(),
           "digest": _param_digest(model), "dense_keys": dense_keys, "rows_key": rows_key,
           "sent": sent, "lossless_keys": sorted(eng._lossless_keys),
           "auto_off": sorted(eng.auto_off_keys()),
           "entropy": {str(k): gauges.get(f'lossless_probe_entropy{{key="{k}"}}')
                       for k in dense_keys},
           "counters": counters().snapshot_labeled()}
    with open(os.path.join(work, f"rowsparse{host}.json"), "w") as f:
        json.dump(out, f)
    bps.shutdown()


def train_rowsparse(card: str) -> dict:
    """Phase (f2), row-sparse push_pull and the lossless arm: a scheduler
    and two Python servers on tcp with CRC32C, and two launcher hosts
    (``rowsparse_host``) under BYTEPS_COMPRESSION_AUTO=1 and
    BYTEPS_WIRE_LOSSLESS=1.  Holds: every step on each host, the
    row-sparse rows bitwise the dense result at the host's rows; the
    hosts' parameters bitwise equal after the last step; each partition of
    the dense push in the off set, probed at or under the entropy cutoff,
    and every one of its pushes flagged lossless; K1-K3 at their launches a
    step.  Prints the rows, the row-sparse payload bytes and the dense
    push's raw and on-wire bytes, a host and a step.  Returns the kernels'
    launches a step of host 0."""
    from byteps_tpu_torch.compression.lossless import lossless_entropy_cutoff

    label = "row-sparse (f2)"
    wall = time.perf_counter()
    env = {**os.environ, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker", **ROWSPARSE_ENV}
    env.pop("BYTEPS_FORCE_DISTRIBUTED", None)
    with tempfile.TemporaryDirectory() as work:
        _await_hosts(label, _launch_hosts(env, "--rowsparse-host", work), timeout=300)
        results = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"rowsparse{h}.json")) as f:
                results.append(json.load(f))
        report = _server_report(work)
    cutoff = lossless_entropy_cutoff()
    want = {"flash_fwd": 2 * ROWSPARSE_LAYERS, "flash_bwd_dq": ROWSPARSE_LAYERS,
            "flash_bwd_dkv": ROWSPARSE_LAYERS, "onebit_pack": 0}
    bad = []
    for r in results:
        h, keys = r["host"], set(r["dense_keys"])
        for i, st in enumerate(r["steps"]):
            if not st["same"]:
                bad.append(f"host {h} step {i + 1}: the row-sparse rows are not bitwise the "
                           "dense result's")
            if st["launches"] != want:
                bad.append(f"host {h} step {i + 1}: launches {st['launches']}, expected {want}")
        if set(r["auto_off"]) & keys != keys or set(r["lossless_keys"]) & keys != keys:
            bad.append(f"host {h}: of {len(keys)} dense partitions, {len(keys & set(r['auto_off']))}"
                       f" are off and {len(keys & set(r['lossless_keys']))} lossless")
        ent = r["entropy"]
        if any(e is None or e > cutoff for e in ent.values()):
            bad.append(f"host {h}: probe entropies {ent} (cutoff {cutoff})")
        dense_sent = [s for s in r["sent"] if s[0] in keys]
        if len(dense_sent) < len(keys) * ROWSPARSE_STEPS or not all(s[2] for s in dense_sent):
            bad.append(f"host {h}: {sum(s[2] for s in dense_sent)} of {len(dense_sent)} dense "
                       "pushes carried LOSSLESS_FLAG")
        r["wire"] = {}
        for key, ver, _, nbytes in dense_sent:
            r["wire"][ver] = r["wire"].get(ver, 0) + nbytes
    if results[0]["digest"] != results[1]["digest"]:
        bad.append("the hosts' parameters after the last step are not bitwise equal")
    if any(x is None for x in report):
        bad.append(f"a server logged no stop report: {report}")
    for r in results:
        n, raw = r["rows"], r["raw"]
        rs_bytes = 8 + 4 * n + 4 * r["row_len"] * n
        print(f"{label} host {r['host']}: {n} of {r['total_rows']} rows touched by its "
              f"{HYBRID_BATCH}x{SEQ} tokens; row-sparse payload {rs_bytes} bytes a "
              f"step against the dense {raw} ({raw / rs_bytes:.2f}x); the dense "
              f"push on the wire {[r['wire'][v] for v in sorted(r['wire'])]} bytes a step "
              f"({[round(r['wire'][v] / raw, 4) for v in sorted(r['wire'])]} of raw); probe "
              f"entropy {min(r['entropy'].values()):.3f}-{max(r['entropy'].values()):.3f} "
              f"bits a byte over {len(r['entropy'])} partitions; losses "
              f"{[round(s['loss'], 4) for s in r['steps']]}; ms a step "
              f"{[round(s['ms'], 1) for s in r['steps']]} (dense push_pull "
              f"{[round(s['dense_ms'], 1) for s in r['steps']]}, row-sparse "
              f"{[round(s['rows_ms'], 1) for s in r['steps']]}); rows bitwise "
              f"{all(s['same'] for s in r['steps'])}; on {card}", flush=True)
    for line in _server_lines(report):
        print(f"{label}: {line}", flush=True)
    print(f"{label}: hosts' parameters bitwise equal "
          f"{results[0]['digest'] == results[1]['digest']}; phase wall "
          f"{time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return results[0]["steps"][-1]["launches"]


def train_data_plane(card: str) -> dict:
    """Phase (f): the vans (f1), then row-sparse and the lossless arm (f2).
    Returns each stage's kernel launches a step."""
    return {"vans": train_vans(card), "rowsparse": train_rowsparse(card)}


#: phase (g), job namespaces: BERT-large's depth, each host's sequences and
#: steps; job 1 (the latency job: two hosts, priority 4) and job 2 (the
#: bulk job: one host, under a quota in the shared run), each host's numpy
#: seed of its tokens (3 steps since the observability phase (j) joined, 4
#: before)
TENANCY_LAYERS, TENANCY_BATCH, TENANCY_STEPS = 2, 16, 3
TENANCY_JOB1_PRIORITY = 4
TENANCY_SEEDS = {"job1.h0": 101, "job1.h1": 102, "job2.h0": 202}
#: job 2's quota in the shared run, a share of its solo push rate: a quarter
#: (a half until PR 22). Beside job 1 alone job 2 pushes at about half its
#: solo rate (770.0 against 415.9 ms a step in PR 22 call 3), so a quota of a
#: half hardly bound and the meter's 0.25 s burst let one server defer
#: nothing; under a quarter every server's meter binds whatever the contention
TENANCY_QUOTA_SHARE = 0.25


def _merged_round_trips(hist_states: dict) -> dict:
    """rpc_round_trip_seconds over every server (and job): count, p50, p99."""
    from byteps_tpu_torch.core.telemetry import _state_percentile

    bounds, counts, total = None, None, 0
    for (name, _labels), (b, c, _s, n) in hist_states.items():
        if name != "rpc_round_trip_seconds":
            continue
        bounds = b
        counts = list(c) if counts is None else [x + y for x, y in zip(counts, c)]
        total += n
    if counts is None:
        return {"count": 0, "p50": float("nan"), "p99": float("nan")}
    return {"count": total, "p50": _state_percentile(bounds, counts, 0.50),
            "p99": _state_percentile(bounds, counts, 0.99)}


def tenant_host(work: str) -> None:
    """One host of phase (g), under the port's launcher (``chip_smoke.py
    --tenant-host <dir>``).  It imports torch and brings up CUDA, then
    waits for <dir>/go.json, whose entry for ``TENANT_NAME`` is more
    environment (the shared run's quota), and trains: BERT-large at
    TENANCY_LAYERS with the weights the driver saved (``TENANT_WEIGHTS``,
    ``init_params(seed=0)``: every host starts from the same parameters,
    so none are broadcast) on TENANCY_BATCH sequences of its own numpy
    seed (TENANCY_SEEDS), bare onebit with scaling under AdamW,
    TENANCY_STEPS steps; its job and share come from ``BYTEPS_JOB_*``.
    Taps its INITs' payload bytes.  Writes <dir>/<TENANT_RUN>-<name>.json:
    losses, ms, wire bytes and launches a step, the parameters' digest, the
    book's job map, its ranks, its job-labelled wire bytes, its round
    trips, and the seconds since its processes started (``TENANT_T0``) at which
    it entered, was ready, was let go, came up, built the model, trained
    and shut down."""
    marks = {"entered": time.time()}
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.ps_client import _ServerConn
    from byteps_tpu_torch.comm.transport import Op
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, name = os.environ["TENANT_RUN"], os.environ["TENANT_NAME"]
    # before the go: CUDA's context and the matmul libraries, and what the
    # first optimizer and its first step import (torch._dynamo and the
    # foreach ops' modules: 8.5-9.4 s on the card's host when three hosts
    # did it after their go)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    warm = torch.ones(8, 8, device=dev, requires_grad=True)
    warm.matmul(warm).sum().backward()
    torch.optim.AdamW([warm], lr=1e-4, weight_decay=1e-4).step()
    float(warm.sum())
    marks["ready"] = time.time()
    go = os.path.join(work, "go.json")
    deadline = time.monotonic() + PHASE_STALL_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            sys.exit(f"{run} {name}: no go file after {PHASE_STALL_S} s")
        time.sleep(0.05)
    with open(go) as f:
        os.environ.update(json.load(f).get(name, {}))
    marks["go"] = time.time()
    init_bytes = [0]
    send = _ServerConn.send

    def tap_send(sc, msg) -> None:
        if msg.op == Op.INIT:
            init_bytes[0] += memoryview(msg.payload).nbytes
        send(sc, msg)

    _ServerConn.send = tap_send
    _WEIGHTS[TENANCY_LAYERS] = torch.load(os.environ["TENANT_WEIGHTS"])
    bps.init()
    marks["init"] = time.time()
    cfg, model, _, _ = _bert(TENANCY_LAYERS, batch=TENANCY_BATCH)
    marks["bert"] = time.time()
    tokens = np.random.default_rng(TENANCY_SEEDS[name]).integers(
        0, cfg.vocab_size, size=(TENANCY_BATCH, SEQ)).astype(np.int32)
    tok = torch.as_tensor(tokens, device=bps.device()).long()
    tgt = torch.as_tensor(np.roll(tokens, -1, axis=1), device=bps.device()).long()
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression_params={"compressor": "onebit", "scaling": True})
    marks["optimizer"] = time.time()
    step = build_train_step(model, opt)
    client = get_state().ps_client
    marks["model"] = time.time()
    steps = []
    for _ in range(TENANCY_STEPS):
        fa.reset_launches()
        ob.reset_launches()
        tx0 = counters().get("wire_tx_bytes")
        t0 = time.perf_counter()
        loss = float(step(tok, tgt))
        torch.cuda.synchronize()
        steps.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                      "tx": counters().get("wire_tx_bytes") - tx0,
                      "launches": {**fa.launches, **ob.launches}})
        marks.setdefault("step1", time.time())
    _ServerConn.send = send
    marks["trained"] = time.time()
    job = str(get_state().config.job_id)
    tx_job = sum(v for key, v in counters().labeled_raw().get("wire_tx_bytes", {}).items()
                 if dict(key).get("job") == job)
    out = {"run": run, "name": name, "job": int(job), "steps": steps,
           "digest": _param_digest(model), "jobs": client.jobs, "rank": client.rank,
           "job_rank": bps.rank(), "size": bps.size(), "wire_tx_job": tx_job,
           "init_bytes": init_bytes[0],
           "compressed_parts": sum(r["wire_nbytes"] is not None
                                   for r in get_state().engine.partition_table()
                                   if r["name"].startswith("Gradient.")),
           "round_trips": _merged_round_trips(metrics()._hist_states())}
    bps.shutdown()
    marks["shutdown"] = time.time()
    t0 = float(os.environ["TENANT_T0"])
    out["marks"] = {k: round(v - t0, 2) for k, v in marks.items()}
    with open(os.path.join(work, f"{run}-{name}.json"), "w") as f:
        json.dump(out, f)


def _server_jobs(log_dir: str, servers: int = 2) -> list:
    """Each server's job lines from its stop report: {job: {series: value}}."""
    import re

    found = []
    for i in range(servers):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            text = f.read()
        jobs: dict = {}
        for job, rest in re.findall(r"rank \d+ job (\d+) (.*)", text):
            jobs[job] = {k: float(v) for k, v in re.findall(r"(\w+)=([\d.e+-]+)", rest)}
        found.append(jobs)
    return found


def _tenant_start(work: str, run: str, hosts: list, fleet_workers: int, t0: float) -> dict:
    """Start one run of phase (g): a scheduler for ``fleet_workers``
    workers, two Python servers with CRC32C (logs in <work>/<run>), and a
    launcher host (``tenant_host``) for each (name, environment) of
    ``hosts``, which comes up and waits for the run's go file."""
    run_dir = os.path.join(work, run)
    os.makedirs(run_dir)
    env = {**os.environ, "DMLC_NUM_WORKER": str(fleet_workers), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker", "BYTEPS_FORCE_DISTRIBUTED": "1",
           "TENANT_RUN": run, "TENANT_T0": repr(t0),
           "TENANT_WEIGHTS": os.path.join(work, "weights.pt")}
    for k in ("BYTEPS_JOB_ID", "BYTEPS_JOB_PRIORITY", "BYTEPS_JOB_QUOTA_MBPS"):
        env.pop(k, None)
    port, procs = _start_ps_processes(env, run_dir)
    launched = []
    for h, (name, extra) in enumerate(hosts):
        path = os.path.join(run_dir, f"host{h}.log")
        with open(path, "w") as log:
            launched.append(_track(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                 sys.executable, os.path.join(REPO, "chip_smoke.py"), "--tenant-host", run_dir],
                cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port, "DMLC_WORKER_ID": str(h),
                               "TENANT_NAME": name, **extra},
                stdout=log, stderr=subprocess.STDOUT), f"{run} {name}", path))
    return {"run": run, "dir": run_dir, "hosts": hosts, "fleet": procs, "launched": launched}


def _tenant_go(label: str, r: dict, go: dict, timeout: float = 240) -> dict:
    """Let run ``r``'s hosts train (<dir>/go.json holds ``go``: {name:
    environment}), wait for them, stop its fleet and fail unless every host
    exited 0; returns {name: host result}, with the servers' reports and
    job lines under "servers" and the run's seconds from its go under
    "wall"."""
    t_go = time.time()
    with open(os.path.join(r["dir"], "go.json.tmp"), "w") as f:
        json.dump(go, f)
    os.replace(os.path.join(r["dir"], "go.json.tmp"), os.path.join(r["dir"], "go.json"))
    hosts = r["launched"]
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in hosts) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in hosts):
                break
            time.sleep(0.2)
        rcs = [p.poll() for p in hosts]
    finally:
        _stop_processes(hosts)
        _stop_processes(r["fleet"])
    if rcs != [0] * len(hosts):
        for h, (name, _) in enumerate(r["hosts"]):
            with open(os.path.join(r["dir"], f"host{h}.log")) as f:
                print(f"--- {label} {r['run']} {name} (exit {rcs[h]}):\n{f.read()[-6000:]}",
                      file=sys.stderr)
        fail(f"{label} {r['run']}: the hosts exited {rcs}")
    out = {}
    for name, _ in r["hosts"]:
        with open(os.path.join(r["dir"], f"{r['run']}-{name}.json")) as f:
            out[name] = json.load(f)
    out["servers"] = {"report": _server_report(r["dir"]), "jobs": _server_jobs(r["dir"])}
    out["wall"] = time.time() - t_go
    return out


def start_tenancy() -> dict:
    """Phase (g)'s processes: every run's scheduler, servers and hosts
    (``_tenant_start``), each host coming up and waiting for its run's go.
    ``main`` starts them ahead of the data plane's phase (f), so that their
    start (the hosts ready after 25-30 s, PR 24 call 2) overlaps it.
    Returns what ``train_tenancy`` takes; ``stop_tenancy`` stops it."""
    work = tempfile.mkdtemp(prefix="chip_smoke_g_")
    j1, j2 = {"DMLC_NUM_WORKER": "2"}, {"DMLC_NUM_WORKER": "1"}
    j1s = {**j1, "BYTEPS_JOB_ID": "1", "BYTEPS_JOB_PRIORITY": str(TENANCY_JOB1_PRIORITY)}
    t0 = time.time()
    started = {"work": work, "runs": []}
    try:
        for run, hosts, n in (
                ("solo2", [("job2.h0", j2)], 1),
                ("solo1", [("job1.h0", j1), ("job1.h1", j1)], 2),
                ("shared", [("job1.h0", j1s), ("job1.h1", j1s),
                            ("job2.h0", {**j2, "BYTEPS_JOB_ID": "2"})], 3)):
            started["runs"].append(_tenant_start(work, run, hosts, n, t0))
    except BaseException:
        stop_tenancy(started)
        raise
    return started


def stop_tenancy(started: dict) -> None:
    """Stop what ``start_tenancy`` started and remove its directory."""
    for r in started["runs"]:
        _stop_processes([p for p in r["launched"] + r["fleet"] if p in _FLEET])
    shutil.rmtree(started["work"], ignore_errors=True)


def train_tenancy(card: str, started: dict = None) -> dict:
    """Phase (g), job namespaces: two jobs that declare the same tensor
    names.  Every run's fleet and hosts start at once and come up (torch,
    CUDA; ``started``, or started here: ``start_tenancy``); then the runs
    train one after another, each alone on the card.
    (g1) each job alone, as job 0, on a fleet of its own: job 2 (one
    host), then job 1 (two hosts).  (g2) both on one fleet of three
    workers: job 1 as BYTEPS_JOB_ID=1 with priority 4, job 2 as
    BYTEPS_JOB_ID=2 under a quota of TENANCY_QUOTA_SHARE of its solo push
    rate (its solo wire bytes a step over its solo seconds a step).  Fails unless
    each job's losses and parameters in (g2) are bitwise its (g1) run's;
    a worker's book maps job 1 to two ranks at priority 4 and job 2 to one
    with its quota, halved over the two servers; both servers deferred
    job 2 (``job_quota_deferred``), never job 1, and meter half its quota;
    the servers' ``server_job_bytes`` of each job is its workers'
    job-labelled wire bytes and INIT payloads; and every tenant worker
    launched K1-K4 each step as the depth and its partitions say.  Prints
    each job's ms a step and round trips, solo and shared.  Returns job 2's
    shared launches a step."""
    import torch

    label = "tenancy (g)"
    wall = time.perf_counter()
    bad = []
    started = started or start_tenancy()
    runs = started["runs"]
    try:
        torch.save(_bert_weights(_bert_cfg(TENANCY_LAYERS)),
                   os.path.join(started["work"], "weights.pt"))
        solo = _tenant_go(label, runs[0], {})
        walls = {"solo2": solo.pop("wall")}
        solo.update(_tenant_go(label, runs[1], {}))
        walls["solo1"] = solo.pop("wall")
        s2 = solo["job2.h0"]["steps"][1:]
        rate = sum(s["tx"] for s in s2) / (sum(s["ms"] for s in s2) / 1e3)
        quota = rate * TENANCY_QUOTA_SHARE / 1e6
        shared = _tenant_go(label, runs[2], {"job2.h0": {"BYTEPS_JOB_QUOTA_MBPS": repr(quota)}})
        walls["shared"] = shared.pop("wall")
    finally:
        stop_tenancy(started)
    names = list(TENANCY_SEEDS)
    for name in names:
        a, b = solo[name], shared[name]
        if [s["loss"] for s in a["steps"]] != [s["loss"] for s in b["steps"]]:
            bad.append(f"{name}: the shared run's losses are not bitwise its solo run's")
        if a["digest"] != b["digest"]:
            bad.append(f"{name}: the shared run's parameters are not bitwise its solo run's")
        for run, r in (("solo", a), ("shared", b)):
            k4 = r["compressed_parts"]
            want = {"flash_fwd": 2 * TENANCY_LAYERS, "flash_bwd_dq": TENANCY_LAYERS,
                    "flash_bwd_dkv": TENANCY_LAYERS, "onebit_pack": k4}
            off = [i + 1 for i, s in enumerate(r["steps"]) if s["launches"] != want]
            if off:
                bad.append(f"{name} {run} steps {off}: launches "
                           f"{r['steps'][off[0] - 1]['launches']}, expected {want}")
            if not all(math.isfinite(s["loss"]) for s in r["steps"]):
                bad.append(f"{name} {run}: non-finite losses")
    if solo["job1.h0"]["digest"] != solo["job1.h1"]["digest"]:
        bad.append("job 1's hosts' parameters differ after the solo run")
    jobs = shared["job2.h0"]["jobs"]
    j1m, j2m = jobs.get("1", {}), jobs.get("2", {})
    if len(j1m.get("workers", ())) != 2 or j1m.get("priority") != TENANCY_JOB1_PRIORITY:
        bad.append(f"the book's job 1: {j1m}")
    if (len(j2m.get("workers", ())) != 1 or j2m.get("quota_mbps_total") != quota
            or j2m.get("quota_mbps") != quota / 2):
        bad.append(f"the book's job 2: {j2m} (quota {quota!r})")
    if sorted(shared[n]["job_rank"] for n in ("job1.h0", "job1.h1")) != [0, 1] or \
            shared["job2.h0"]["job_rank"] != 0:
        bad.append("the jobs' ranks within the job are not 0..size-1")
    sj = shared["servers"]["jobs"]
    for i, jl in enumerate(sj):
        if jl.get("2", {}).get("job_quota_deferred", 0) <= 0:
            bad.append(f"server {i} deferred no request of job 2: {jl}")
        if jl.get("1", {}).get("job_quota_deferred"):
            bad.append(f"server {i} deferred job 1: {jl}")
        if jl.get("2", {}).get("server_job_quota_mbps") != quota / 2:
            bad.append(f"server {i} meters job 2 at {jl.get('2', {}).get('server_job_quota_mbps')}"
                       f", not {quota / 2!r}")
    by_job = {}
    for job, hosts_of in (("1", ("job1.h0", "job1.h1")), ("2", ("job2.h0",))):
        served = sum(int(jl.get(job, {}).get("server_job_bytes", 0)) for jl in sj)
        sent = sum(shared[n]["wire_tx_job"] + shared[n]["init_bytes"] for n in hosts_of)
        by_job[job] = (served, sent)
        if served != sent:
            bad.append(f"job {job}: the servers counted {served} bytes, its workers sent "
                       f"{sent} (wire_tx_bytes{{job}} and INIT payloads)")
    if any(r is None for r in shared["servers"]["report"]):
        bad.append(f"a server logged no stop report: {shared['servers']['report']}")

    def ms(r):
        return sum(s["ms"] for s in r["steps"][1:]) / (len(r["steps"]) - 1)

    for name in names:
        a, b = solo[name], shared[name]
        print(f"{label} {name}: BERT-large at {TENANCY_LAYERS} layers, seq {SEQ} bf16 remat "
              f"flash, {TENANCY_BATCH} sequences, bare onebit, CRC32C; losses "
              f"{[s['loss'] for s in b['steps']]} (bitwise solo "
              f"{[s['loss'] for s in a['steps']] == [s['loss'] for s in b['steps']]}, "
              f"parameters {a['digest'] == b['digest']}); ms a step after the first: solo "
              f"{ms(a):.1f} {[round(s['ms'], 1) for s in a['steps']]}, shared {ms(b):.1f} "
              f"{[round(s['ms'], 1) for s in b['steps']]}; wire bytes a step "
              f"{b['steps'][-1]['tx']}; rpc_round_trip_seconds p50/p99 solo "
              f"{a['round_trips']['p50'] * 1e3:.3f}/{a['round_trips']['p99'] * 1e3:.3f} ms, "
              f"shared {b['round_trips']['p50'] * 1e3:.3f}/{b['round_trips']['p99'] * 1e3:.3f} "
              f"ms; fleet rank {b['rank']}, job rank {b['job_rank']}, size {b['size']}; "
              f"launches a step {b['steps'][-1]['launches']}; on {card}", flush=True)
    print(f"{label}: each run's wall s from its go: {walls}; the hosts' marks (s from the "
          f"processes' start): " + "; ".join(
              f"{run} {n} {r[n]['marks']}" for run, r in (("solo", solo), ("shared", shared))
              for n in names), flush=True)
    print(f"{label}: job 2's solo push rate {rate / 1e6:.3f} MB/s, quota {quota:.3f} MB/s "
          f"({quota / 2:.3f} a server); the book's jobs {json.dumps(jobs, sort_keys=True)}; "
          f"the servers' job lines {sj}; server_job_bytes against the workers' bytes "
          f"{by_job}", flush=True)
    for line in _server_lines(shared["servers"]["report"]):
        print(f"{label} shared: {line}", flush=True)
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return shared["job2.h0"]["steps"][-1]["launches"]


# --- phase (h): model parallelism -------------------------------------------

#: phase (h)'s host: four ranks of one launcher on the one card, a gloo group
#: over the staged transport (NCCL refuses two ranks of one group on one
#: device); its local rank 0 is the one worker of a scheduler and two
#: Python servers, which (h4)'s and (h5)'s hybrids push through; each run
#: trains MP_STEPS steps (3 before (h5) joined: PERF.md section 4)
MP_RANKS, MP_STEPS, MP_BATCH = 4, 2, 4
MP_DEVICE, MP_TRANSPORT = "cuda", "staged"
#: the device each rank binds: every rank on the one card (on one GPU a rank,
#: tools/torch_port_model_parallel.py leaves it to the launcher: "")
MP_HOST_DEVICE = "cuda:0"
#: each bf16 run's losses against one process of the same model, weights and
#: tokens on the card (AdamW lr 1e-4): relative, bf16 sums in other orders
MP_LOSS_RTOL = 2e-2
#: the f32 runs: one SGD step at MP_F32_LR (at BERT-large's widths a larger
#: step grows the embeddings' last-place differences), each parameter
#: gathered within atol + rtol * |one process's|
MP_F32_LR, MP_F32_RTOL, MP_F32_ATOL = 3e-4, 1e-5, 1e-6
#: (run, model, depth, mesh axes, config overrides, through HybridDataParallel)
MP_RUNS = (
    ("h1", "bert", 4, {"pp": 2, "tp": 2}, {"microbatches": 4}, False),
    ("h2", "gpt2", 2, {"sp": 2, "tp": 2}, {"seq_parallel_impl": "ring"}, False),
    ("h3", "gpt2", 2, {"sp": 2, "tp": 2}, {"seq_parallel_impl": "ulysses"}, False),
    ("h4", "bert", 2, {"dp": 2, "tp": 2}, {}, True),
    ("h5", "bert", 2, {"dp": 2, "pp": 2}, {"microbatches": 2}, True),
    ("h1 f32", "bert", 2, {"pp": 2, "tp": 2}, {"microbatches": 4, "dtype": "float32"}, False),
    ("h2 f32", "gpt2", 2, {"sp": 2, "tp": 2}, {"seq_parallel_impl": "ring",
                                               "dtype": "float32"}, False),
)


def _mp_cfg(model: str, layers: int, overrides: dict):
    """BERT-large (seq 512), GPT-2 medium (seq 1024, its published
    context) or ("moe") GPT-2 medium with expert layers at the reference's
    defaults (8 experts, top-2, capacity factor 2.0, aux 0.01) at
    ``layers``: remat, flash, bf16 unless ``overrides`` say float32
    (``batch`` in ``overrides`` is the run's, not the config's)."""
    import torch

    from byteps_tpu_torch.models.transformer import bert_large, gpt2_medium

    kw = {"remat": True, "use_flash": True, "moe": model == "moe"}
    kw.update((k, v) for k, v in overrides.items() if k != "batch")
    kw["compute_dtype"] = getattr(torch, kw.pop("dtype", "bfloat16"))
    make, seq = (bert_large, SEQ) if model == "bert" else (gpt2_medium, 1024)
    return dataclasses.replace(make(max_seq=seq, **kw), n_layers=layers)


def _mp_tokens(cfg, batch: int = MP_BATCH) -> tuple:
    """``batch`` sequences of numpy seed 0 and their next-token targets (the
    causal model's last position ignored)."""
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, cfg.max_seq)).astype(np.int64)
    targets = np.roll(tokens, -1, axis=1)
    if cfg.causal:
        targets[:, -1] = -1
    return tokens, targets


def _mp_dir(work: str, what: str) -> str:
    return os.path.join(work, what.replace(" ", "-"))


def _mp_save(path: str, arrays: dict) -> None:
    os.makedirs(path)
    for name, arr in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), arr)


def _mp_load(path: str) -> dict:
    return {f[:-4]: np.load(os.path.join(path, f), mmap_mode="r") for f in os.listdir(path)}


def _mp_want(run: tuple, coords: dict) -> dict:
    """K1-K3 launches a step on the rank at ``coords``: each attention call
    launches K1 once forward and once when its checkpointed layer
    recomputes, and K2 and K3 once in backward.  A layer makes one call a
    microbatch with sp at 1 and under Ulysses; a causal ring one a hop the
    rank does not skip, one more for each upstream rank (sp index + 1)."""
    _, model, layers, axes, overrides, _ = run
    pp = axes.get("pp", 1)
    calls = layers // pp * (overrides.get("microbatches") or pp)
    if axes.get("sp", 1) > 1 and _mp_cfg(model, layers, overrides).seq_parallel_impl == "ring":
        calls = layers * (coords["sp"] + 1)
    return {"flash_fwd": 2 * calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}


def _reference_keys(cfg, pp: int) -> list:
    """The keys the reference's hybrid pushes for ``cfg`` on a mesh of ``pp``
    stages, less their "Hybrid.<instance>" prefix: one a leaf of
    ``init_params(cfg, pp_size=pp)`` in sorted order, a layer parameter
    stacked (pp, layers a stage) + its shape."""
    from byteps_tpu_torch.models.transformer import is_layer_param, param_shapes

    return [[f"['{n}']", [pp, cfg.n_layers // pp, *s] if is_layer_param(n) else list(s)]
            for n, s in sorted(param_shapes(cfg).items())]


def _mp_one_process(run: tuple, work: str) -> dict:
    """The run's model, weights and tokens in this process alone on the
    card: its losses and ms a step (the f32 runs: one SGD step, its
    parameters saved for the hosts to compare), and (h4, h5) the keys the
    reference's hybrid pushes for this model on the run's mesh."""
    import torch

    from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax
    from byteps_tpu_torch.models.transformer import Transformer, build_train_step

    name, model_name, layers, axes, overrides, hybrid = run
    cfg = _mp_cfg(model_name, layers, overrides)
    model = Transformer(cfg, device=MP_DEVICE)
    model.load_state_dict(params_from_jax(_mp_load(_mp_dir(work, f"w {model_name} {layers}")),
                                          cfg))
    tokens, targets = _mp_tokens(cfg, overrides.get("batch", MP_BATCH))
    tok, tgt = (torch.as_tensor(a, device=MP_DEVICE) for a in (tokens, targets))
    f32 = cfg.compute_dtype == torch.float32
    opt = (torch.optim.SGD(model.parameters(), lr=MP_F32_LR) if f32 else
           torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = build_train_step(model, opt)
    losses, ms = [], []
    for _ in range(1 if f32 else MP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tok, tgt)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "ms": ms}
    if f32:
        _mp_save(_mp_dir(work, f"ref {name}"), params_to_jax(model.state_dict(), cfg))
    if hybrid:
        out["keys"] = _reference_keys(cfg, axes.get("pp", 1))
    return out


def _mp_host_run(run: tuple, work: str) -> dict:
    """One run of phase (h) on this rank: the mesh, this rank's shards of
    the weights and its block of the tokens, MP_STEPS steps (f32: one),
    each step's loss, ms and K1-K3 launches.  (h4) and
    (h5) train through HybridDataParallel, each pull checked on the way:
    bitwise the host's pushed sum over the group (one worker), averaged.
    The f32 runs gather the parameters after their step and compare them
    on rank 0 with the one-process step's."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.convert import params_to_jax, shard_params_from_jax
    from byteps_tpu_torch.models.transformer import Transformer, build_train_step, shard_batch
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.parallel import hybrid as hybrid_mod
    from byteps_tpu_torch.parallel import moe
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    name, model_name, layers, axes, overrides, hybrid = run
    cfg = _mp_cfg(model_name, layers, overrides)
    mesh = make_training_mesh(axis_sizes=axes)
    dev = bps.device()
    model = Transformer(cfg, device=dev, mesh=mesh)
    model.load_state_dict(shard_params_from_jax(
        _mp_load(_mp_dir(work, f"w {model_name} {layers}")), cfg, mesh))
    tok, tgt = (shard_batch(torch.as_tensor(a), mesh).to(dev)
                for a in _mp_tokens(cfg, overrides.get("batch", MP_BATCH)))
    f32 = cfg.compute_dtype == torch.float32
    opt = (torch.optim.SGD(model.parameters(), lr=MP_F32_LR) if f32 else
           torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4))
    out = {"coords": {ax: mesh.axis_index(ax) for ax in ("dp", "pp", "sp", "tp")},
           "transport": mesh.transport, "steps": []}
    if hybrid:
        hdp = hybrid_mod.HybridDataParallel(
            model, opt, mesh=mesh, param_specs=model.param_specs(),
            grad_sync_axes=model.grad_sync_axes())
        out["keys"] = [[k, list(s)] for k, s in hdp.keys]
        pushed, bad_pulls = {}, []
        push, sync = hybrid_mod.host_push_pull_async, hybrid_mod.synchronize

        def tap_push(g, key, *args, **kw):
            h = push(g, key, *args, **kw)
            pushed[h] = (key, g)
            return h

        def tap_sync(h):
            got = sync(h)
            key, g = pushed.pop(h)
            if not torch.equal(got * mesh.axis_size("dp") * bps.size(), g):
                bad_pulls.append(key)
            return got

        hybrid_mod.host_push_pull_async, hybrid_mod.synchronize = tap_push, tap_sync

        def step(t, y):
            return hdp.step((t, y), lambda m, b: m.loss(*b, over=("pp", "sp")))
    else:
        step = build_train_step(model, opt)
    # an expert layer's forward adds its drops, and so does its recompute
    # in backward: the first (local layers x microbatches) are the forward's
    forwards = layers // mesh.axis_size("pp") * (cfg.microbatches or mesh.axis_size("pp"))
    try:
        for _ in range(1 if f32 else MP_STEPS):
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe.count_drops() as drops:
                loss = float(step(tok, tgt))
            torch.cuda.synchronize()
            out["steps"].append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                                 "launches": dict(fa.launches),
                                 "drops": [int(d) for d in drops[:forwards]]})
    finally:
        if hybrid:
            hybrid_mod.host_push_pull_async, hybrid_mod.synchronize = push, sync
    if hybrid:
        out["bad_pulls"] = bad_pulls
    if f32:
        got = params_to_jax(model.state_dict(), cfg, pp_size=mesh.axis_size("pp"), mesh=mesh)
        if bps.local_rank() == 0:
            want = _mp_load(_mp_dir(work, f"ref {name}"))
            errs = {}
            for k, w in want.items():
                d = np.abs(got[k].reshape(w.shape) - w)  # (pp, lps) stacked as (1, layers)
                errs[k] = [float(d.max()), float((d - MP_F32_RTOL * np.abs(w)).max())]
            out["f32"] = errs
    return out


def mp_host(work: str) -> None:
    """One rank of phase (h)'s host, under the port's launcher
    (``chip_smoke.py --mp-host <dir>``, BYTEPS_LOCAL_SIZE=4,
    BYTEPS_MESH_TRANSPORT=staged): imports torch, brings up CUDA and what
    the first optimizer step imports, then init() on the card (the staged
    group; rank 0 joins the PS), waits for <dir>/go, and runs MP_RUNS in
    turn, writing <dir>/<run>.<rank>.json after each.  Then phase (i)'s
    runs, MOE_HOST_RUNS, once <dir>/go-i exists (none if <dir>/no-i does),
    each writing its file the same way."""
    marks = {"entered": time.time()}
    import torch

    import byteps_tpu_torch as bps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warm = torch.ones(8, 8, device=MP_DEVICE, requires_grad=True)
    warm.matmul(warm).sum().backward()
    torch.optim.AdamW([warm], lr=1e-4, weight_decay=1e-4).step()
    torch.optim.SGD([warm], lr=1e-4).step()
    float(warm.sum())
    bps.init(device=os.environ["MP_HOST_DEVICE"] or None)
    rank = bps.local_rank()
    marks["ready"] = time.time()
    go = os.path.join(work, "go")
    deadline = time.monotonic() + PHASE_STALL_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            sys.exit(f"model parallel rank {rank}: no go file after {PHASE_STALL_S} s")
        time.sleep(0.05)
    marks["go"] = time.time()

    def write(name: str, out: dict) -> None:
        marks[name] = time.time()
        out["marks"] = {k: round(v - marks["entered"], 2) for k, v in marks.items()}
        path = os.path.join(work, f"{_mp_dir('', name)}.{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
        gc.collect()
        torch.cuda.empty_cache()

    for run in MP_RUNS:
        write(run[0], _mp_host_run(run, work))
    deadline = time.monotonic() + PHASE_STALL_S
    while not os.path.exists(os.path.join(work, "go-i")):
        if os.path.exists(os.path.join(work, "no-i")):
            break
        if time.monotonic() > deadline:
            sys.exit(f"model parallel rank {rank}: no go-i file after {PHASE_STALL_S} s")
        time.sleep(0.05)
    else:
        marks["go-i"] = time.time()
        for run in MOE_HOST_RUNS:
            write(run[0], _moe_host_run(run, work))
    from byteps_tpu_torch.core.state import get_state

    torch.distributed.barrier(group=get_state().mesh.group)
    bps.shutdown()


def check_mp_kernel_shapes() -> None:
    """K1-K3 at the shapes phase (h) gives them, against their plain
    versions: tp-local heads of BERT-large (8 at S 512), a ring hop of
    GPT-2 medium at sp 2 (S 512 a rank: its own block causal, an upstream
    one full), and Ulysses's full sequence on 4 heads (S 1024, causal)."""
    import torch

    bf16 = torch.bfloat16
    check_case("(h) tp heads bf16", 1, 8, SEQ, 64, bf16, False, seed=40)
    check_case("(h) ring hop diagonal bf16", MP_BATCH, 8, 512, 64, bf16, True, seed=41)
    check_case("(h) ring hop full bf16", MP_BATCH, 8, 512, 64, bf16, False, seed=42)
    check_case("(h) ulysses bf16", MP_BATCH, 4, 1024, 64, bf16, True, seed=43)
    check_case("(h) ring hop f32", MP_BATCH, 8, 512, 64, torch.float32, True, seed=44)


# --- phase (i): mixture-of-experts and generation ------------------------------

#: phase (i)'s weights, drawn by a process beside phase (h): GPT-2 medium
#: with expert layers at 4 and 2 layers (the dense 2-layer weights are phase
#: (h)'s; (i4)'s dense 24-layer generation runs on phase (l)'s checkpoint)
MOE_WEIGHTS = [("moe", 4), ("moe", 2)]
#: (i1)'s depth, (i2)-(i5)'s, and the sequences of every training run (the
#: first MOE_F32_CPU_ROWS of them for (i1)'s f32 step against the CPU: the
#: CPU takes seconds a sequence at GPT-2 medium's widths)
MOE_LAYERS, MOE_MESH_LAYERS, MOE_BATCH, MOE_F32_CPU_ROWS = 4, 2, 8, 1
#: the no-drop capacity of top-2 over 8 experts (cf = E / k: capacity = the
#: token count) without the aux term: the loss no longer depends on the mesh
MOE_NODROP = {"batch": MOE_BATCH, "capacity_factor": 4.0, "moe_aux_coef": 0.0}
#: generation: prompts (the first GEN_PROMPT_LEN tokens of the training
#: sequences), new tokens greedy, and the new tokens of (i5)'s decode
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW, MOE_DECODE_NEW = 8, 128, 64, 16
#: phase (i)'s runs on phase (h)'s host: (run, model, depth, mesh axes,
#: config overrides, mode: False trains, True trains through
#: HybridDataParallel, "decode" decodes with the KV cache, "dryrun" runs
#: byteps_tpu_torch.dryrun.dryrun_multichip on the host's ranks)
MOE_HOST_RUNS = (
    ("i2", "moe", MOE_MESH_LAYERS, {"sp": 2, "tp": 2}, MOE_NODROP, False),
    ("i2 default", "moe", MOE_MESH_LAYERS, {"sp": 2, "tp": 2}, {"batch": MOE_BATCH}, False),
    ("i3", "moe", MOE_MESH_LAYERS, {"dp": 2, "sp": 2}, MOE_NODROP, True),
    ("i2 f32", "moe", MOE_MESH_LAYERS, {"sp": 2, "tp": 2}, {**MOE_NODROP, "dtype": "float32"},
     False),
    ("i5 sp2 tp2", "moe", MOE_MESH_LAYERS, {"sp": 2, "tp": 2}, {"dtype": "float32"}, "decode"),
    ("i5 pp2 tp2", "moe", MOE_MESH_LAYERS, {"pp": 2, "tp": 2}, {"dtype": "float32"}, "decode"),
    ("i6", "", 0, {}, {}, "dryrun"),
)
#: runs whose loss depends on the mesh (each rank routes its own tokens at
#: a capacity of its own token count, and the aux term is a sum over the
#: mesh, as the reference's): held to finite and falling losses only
MP_MESH_DEPENDENT = {"i2 default"}


def _gen_prompt(cfg) -> np.ndarray:
    return _mp_tokens(cfg, GEN_PROMPTS)[0][:, :GEN_PROMPT_LEN]


def _moe_host_run(run: tuple, work: str) -> dict:
    """One run of phase (i) on this rank of the host (``mp_host``)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.convert import shard_params_from_jax
    from byteps_tpu_torch.models.transformer import Transformer, build_generate_cached
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    name, model_name, layers, axes, overrides, mode = run
    if mode == "dryrun":
        from byteps_tpu_torch import dryrun

        t0 = time.perf_counter()
        lines = dryrun.dryrun_multichip(MP_RANKS)
        return {"lines": lines, "s": time.perf_counter() - t0}
    if mode != "decode":
        return _mp_host_run(run, work)
    cfg = _mp_cfg(model_name, layers, overrides)
    mesh = make_training_mesh(axis_sizes=axes)
    model = Transformer(cfg, device=bps.device(), mesh=mesh)
    model.load_state_dict(shard_params_from_jax(
        _mp_load(_mp_dir(work, f"w {model_name} {layers}")), cfg, mesh))
    gen = build_generate_cached(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = gen(_gen_prompt(cfg), MOE_DECODE_NEW)
    torch.cuda.synchronize()
    return {"tokens": tokens.tolist(), "s": time.perf_counter() - t0,
            "coords": {ax: mesh.axis_index(ax) for ax in ("dp", "pp", "sp", "tp")},
            "cache_shapes": gen.cache_shapes}


def check_moe_kernel_shapes() -> None:
    """K1-K3 at the shapes phase (i) gives them, against their plain
    versions: GPT-2 medium's 16 heads at S 1024 causal on MOE_BATCH
    sequences (one process: (i1), and (l)'s recompute), and a causal
    ring's diagonal and full hops on MOE_BATCH sequences of 512 with 8
    tp-local heads ((i2))."""
    import torch

    bf16 = torch.bfloat16
    check_case("(i) one process bf16", MOE_BATCH, 16, 1024, 64, bf16, True, seed=50)
    check_case("(i) ring hop diagonal bf16", MOE_BATCH, 8, 512, 64, bf16, True, seed=51)
    check_case("(i) ring hop full bf16", MOE_BATCH, 8, 512, 64, bf16, False, seed=52)


def _moe_one_process(card: str, work: str) -> tuple:
    """(i1): GPT-2 medium with expert layers at MOE_LAYERS alone on the
    card, bf16, AdamW (lr 1e-4), MP_STEPS steps on MOE_BATCH sequences:
    each step's loss, ms, K1-K3 launches and the assignments dropped per
    layer.  Then the f32 model at MOE_MESH_LAYERS on the card, one SGD step
    (MP_F32_LR) on MOE_F32_CPU_ROWS sequences, its parameters returned for
    the CPU's step.  Returns (the failures, the result)."""
    import torch

    from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax
    from byteps_tpu_torch.models.transformer import Transformer, build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.parallel import moe

    cfg = _mp_cfg("moe", MOE_LAYERS, {})
    model = Transformer(cfg, device=MP_DEVICE)
    model.load_state_dict(params_from_jax(_mp_load(_mp_dir(work, f"w moe {MOE_LAYERS}")), cfg))
    tok, tgt = (torch.as_tensor(a, device=MP_DEVICE) for a in _mp_tokens(cfg, MOE_BATCH))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    steps = []
    for _ in range(MP_STEPS):
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        with moe.count_drops() as drops:  # the forward's; the recompute adds its own
            loss = model.loss(tok, tgt)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        steps.append({"loss": float(loss.detach()), "ms": (time.perf_counter() - t0) * 1e3,
                      "launches": dict(fa.launches), "drops": [int(d) for d in drops]})
    del model, opt
    torch.cuda.empty_cache()
    want = {"flash_fwd": 2 * MOE_LAYERS, "flash_bwd_dq": MOE_LAYERS,
            "flash_bwd_dkv": MOE_LAYERS}
    losses = [s["loss"] for s in steps]
    bad = []
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        bad.append(f"i1: losses {losses} not finite and falling")
    off = [i + 1 for i, s in enumerate(steps) if s["launches"] != want]
    if off:
        bad.append(f"i1 steps {off}: launches {steps[off[0] - 1]['launches']}, expected {want}")
    f32 = _mp_cfg("moe", MOE_MESH_LAYERS, {"dtype": "float32"})
    sd = params_from_jax(_mp_load(_mp_dir(work, f"w moe {MOE_MESH_LAYERS}")), f32)
    tokens, targets = (a[:MOE_F32_CPU_ROWS] for a in _mp_tokens(f32, MOE_BATCH))
    after = {}
    for dev in (MP_DEVICE, "cpu"):
        model = Transformer(f32, device=dev)
        model.load_state_dict(sd)
        step = build_train_step(model, torch.optim.SGD(model.parameters(), lr=MP_F32_LR))
        loss = float(step(torch.as_tensor(tokens, device=dev), torch.as_tensor(targets,
                                                                                device=dev)))
        after[dev] = (loss, params_to_jax(model.state_dict(), f32))
        del model, step
    errs = {k: [float(np.abs(after[MP_DEVICE][1][k] - w).max()),
                float((np.abs(after[MP_DEVICE][1][k] - w) - MP_F32_RTOL * np.abs(w)).max())]
            for k, w in after["cpu"][1].items()}
    over = {k: e for k, e in errs.items() if e[1] > MP_F32_ATOL}
    if over:
        bad.append(f"i1 f32: parameters beyond atol {MP_F32_ATOL} + rtol {MP_F32_RTOL} of the "
                   f"CPU's: {over}")
    worst = max(errs.items(), key=lambda kv: kv[1][0])
    print(f"moe and generation (i) i1: GPT-2 medium with 8 experts (top-2, capacity factor "
          f"2.0, aux 0.01) at {MOE_LAYERS} layers, seq {cfg.max_seq}, bf16, remat, flash, "
          f"{MOE_BATCH} sequences, AdamW, one process: losses {losses}; ms a step "
          f"{[round(s['ms'], 1) for s in steps]}; assignments dropped per layer a step (of "
          f"{2 * MOE_BATCH * cfg.max_seq}) {[s['drops'] for s in steps]}; K1-K3 launches a "
          f"step {steps[-1]['launches']} (want {want}); f32 at {MOE_MESH_LAYERS} layers, one "
          f"SGD step (lr {MP_F32_LR}) on {MOE_F32_CPU_ROWS} sequence: loss card "
          f"{after[MP_DEVICE][0]!r}, CPU {after['cpu'][0]!r}; each parameter against the "
          f"CPU's: max abs err {worst[1][0]:.3e} ({worst[0]}), all within atol {MP_F32_ATOL} "
          f"+ rtol {MP_F32_RTOL}: {not over}; on {card}", flush=True)
    return bad, {"steps": steps, "launches": steps[-1]["launches"]}


def _generate_timed(gen, prompt, n_new: int) -> tuple:
    """(tokens, seconds, K1-K3 launches) of one generation call."""
    import torch

    from byteps_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = gen(prompt, n_new)
    torch.cuda.synchronize()
    return tokens, time.perf_counter() - t0, dict(fa.launches)


def _generation_one_process(card: str, work: str) -> tuple:
    """(i4): GPT-2 medium, dense, at 2 layers alone on the card, GEN_PROMPTS
    prompts of GEN_PROMPT_LEN tokens, GEN_NEW new tokens greedy: in f32
    the two builders' tokens (``build_generate``, K1 causal on the max_seq
    window; ``build_generate_cached``) on the card and the cached
    builder's on the CPU are equal; in bf16 the prefill logits (flash) are
    no further from the card's f32 logits, on average, than 1.25 times the
    dense attention's bf16 logits are (the model check's rule); the share
    of bf16 tokens equal to f32's is printed.  The 24-layer generation
    (tokens a second, K1's launches) is phase (l)'s (l4), on the imported
    checkpoint.  Returns (the failures, the result)."""
    import torch

    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import (Transformer, build_forward,
                                                     build_generate, build_generate_cached)

    bad = []
    prompt = _gen_prompt(_mp_cfg("gpt2", 2, {}))
    sd = params_from_jax(_mp_load(_mp_dir(work, "w gpt2 2")), _mp_cfg("gpt2", 2, {}))
    runs = {}
    for label, overrides, dev in (("f32", {"dtype": "float32"}, MP_DEVICE),
                                  ("f32 cpu", {"dtype": "float32"}, "cpu"),
                                  ("bf16", {}, MP_DEVICE),
                                  ("bf16 dense", {"use_flash": False}, MP_DEVICE)):
        small = Transformer(_mp_cfg("gpt2", 2, overrides), device=dev)
        small.load_state_dict(sd)
        x = torch.as_tensor(prompt, device=dev)
        runs[label] = {"logits": build_forward(small)(x).float().cpu(),
                       "cached": build_generate_cached(small)(prompt, GEN_NEW)}
        if label == "f32":
            runs[label]["recompute"] = build_generate(small)(prompt, GEN_NEW)
        del small
    f32 = runs["f32"]
    if not (np.array_equal(f32["recompute"], f32["cached"])
            and np.array_equal(f32["cached"], runs["f32 cpu"]["cached"])):
        bad.append("i4 f32: the builders' tokens on the card and the CPU's differ")
    ef = float((runs["bf16"]["logits"] - f32["logits"]).abs().mean())
    ed = float((runs["bf16 dense"]["logits"] - f32["logits"]).abs().mean())
    if not ef <= 1.25 * ed:
        bad.append(f"i4 bf16 prefill logits: flash {ef:.3e} from f32 on average, dense "
                   f"attention {ed:.3e}")
    same = float((runs["bf16"]["cached"] == f32["cached"])[:, GEN_PROMPT_LEN:].mean())
    print(f"moe and generation (i) i4: GPT-2 medium at 2 layers, {GEN_PROMPTS} prompts of "
          f"{GEN_PROMPT_LEN} tokens, {GEN_NEW} new greedy: in f32 the builders on the card "
          f"and the CPU's cached tokens equal {'i4 f32' not in ' '.join(bad)}; bf16 prefill "
          f"logits mean abs from f32 {ef:.3e} (dense attention {ed:.3e}); bf16 greedy tokens "
          f"equal to f32's {same:.3f} (at 24 layers: phase (l)'s l4); on {card}", flush=True)
    return bad, {"bf16_same": same}


def _moe_generation(card: str, work: str, host, path: str, draws: list,
                    one_process: bool, beside=None) -> dict:
    """Phase (i), mixture-of-experts and generation, on phase (h)'s host
    (``train_model_parallel`` runs it; its ranks wait for <work>/go-i).
    K1-K3 at the phase's shapes against their plain versions; the
    one-process references of the host's runs on the card; then, with the
    host's runs going on, (i1) (``_moe_one_process``) when
    ``one_process``.  The host: (i2) GPT-2 medium with 8 experts at 2
    layers on {sp:2, tp:2}, 4 experts a rank, at no-drop capacity without
    the aux term (losses within MP_LOSS_RTOL of one process's) and at the
    defaults (finite, falling; each rank's drops printed), (i3) the
    no-drop model on {dp:2, sp:2} through HybridDataParallel and the two
    servers (the experts pushed whole, every pull bitwise the host's sum),
    one f32 step of (i2) within atol MP_F32_ATOL + rtol MP_F32_RTOL per
    parameter, (i5) the f32 model's cached decode on {sp:2, tp:2} and
    {pp:2, tp:2} (tokens equal one process's), (i6) ``dryrun_multichip``
    on the four ranks.  ``beside()``, when given, runs after (i1) while
    the host's runs go on.  After the host, (i4)
    (``_generation_one_process``) alone on the card when ``one_process``.
    Fails on any failure.  Returns {"i1": K1-K3 a step, "i2": each rank's,
    "beside": what ``beside`` returned}."""
    import torch

    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import Transformer, build_generate_cached

    label = "moe and generation (i)"
    wall = time.perf_counter()
    check_moe_kernel_shapes()
    t0 = time.perf_counter()
    for proc in draws:
        if proc.wait(timeout=PHASE_STALL_S) != 0:
            fail(f"{label}: drawing the weights exited {proc.returncode}")
    draws_s = time.perf_counter() - t0
    train = [run for run in MOE_HOST_RUNS if run[5] in (False, True)]
    one = {run[0]: _mp_one_process(run, work) for run in train
           if run[0] not in MP_MESH_DEPENDENT}
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t0 - draws_s
    t_go = time.perf_counter()
    open(os.path.join(work, "go-i"), "w").close()
    bad, result = [], {}
    if one_process:
        b, result["i1"] = _moe_one_process(card, work)
        bad += b
        gc.collect()
        torch.cuda.empty_cache()
    if beside is not None:
        result["beside"] = beside()
        gc.collect()
        torch.cuda.empty_cache()
    res = _mp_await(label, host, path, work, MOE_HOST_RUNS)
    host_s = time.perf_counter() - t_go
    b, launches = _mp_check(label, train, one, res, card)
    bad += b
    result["i2"] = [launches["i2"][r][-1] for r in range(MP_RANKS)]
    # (i5): the host's decodes against one process's on the card
    cfg = _mp_cfg("moe", MOE_MESH_LAYERS, {"dtype": "float32"})
    single = Transformer(cfg, device=MP_DEVICE)
    single.load_state_dict(params_from_jax(
        _mp_load(_mp_dir(work, f"w moe {MOE_MESH_LAYERS}")), cfg))
    want = build_generate_cached(single)(_gen_prompt(cfg), MOE_DECODE_NEW)
    del single
    torch.cuda.empty_cache()
    for run in MOE_HOST_RUNS:
        if run[5] != "decode":
            continue
        ranks = res[run[0]]
        same = [np.array_equal(np.asarray(rr["tokens"]), want) for rr in ranks]
        if not all(same):
            bad.append(f"{run[0]}: tokens equal to one process's per rank {same}")
        print(f"{label} {run[0]}: GPT-2 medium with 8 experts at {MOE_MESH_LAYERS} layers, "
              f"f32, KV-cached decode of {GEN_PROMPTS} prompts of {GEN_PROMPT_LEN} tokens, "
              f"{MOE_DECODE_NEW} new, on {run[3]}: tokens equal to one process's per rank "
              f"{same}; cache shapes per rank {[rr['cache_shapes'][0] for rr in ranks]} "
              f"({len(ranks[0]['cache_shapes'])} layers a rank); s per rank "
              f"{[round(rr['s'], 2) for rr in ranks]}", flush=True)
    lines = res["i6"][0]["lines"]
    if len(lines) != 2 or any(rr["lines"] != lines for rr in res["i6"]):
        bad.append(f"i6: summary lines {[rr['lines'] for rr in res['i6']]}")
    for line in lines:
        print(f"{label} i6: dryrun_multichip OK: {line}", flush=True)
    print(f"{label} i6: dryrun_multichip({MP_RANKS}) on the host's ranks, s per rank "
          f"{[round(rr['s'], 2) for rr in res['i6']]}", flush=True)
    if one_process:
        gc.collect()
        bad += _generation_one_process(card, work)[0]
    print(f"{label}: weights drawn beside phase (h), waited {draws_s:.1f} s; one-process "
          f"references {refs_s:.1f} s; the host's runs {host_s:.1f} s; the ranks' marks (s) "
          f"{[rr['marks'] for rr in res['i6']]}; phase wall {time.perf_counter() - wall:.1f} s",
          flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return result


def _mp_check(label: str, runs: tuple, one: dict, res: dict, card: str) -> tuple:
    """The checks of a host's training runs against one process's (see
    ``train_model_parallel``); prints each run's line.  Returns (the
    failures, {run: every rank's launches a step})."""
    bad = []
    launches = {}
    for run in runs:
        name, model_name, layers, axes, overrides, hybrid = run
        want_losses = one[name]["losses"] if name in one else None
        ranks = res[name]
        f32 = overrides.get("dtype") == "float32"
        for r, rr in enumerate(ranks):
            losses = [s["loss"] for s in rr["steps"]]
            if rr["transport"] != (MP_TRANSPORT or ("nccl" if MP_DEVICE == "cuda" else "gloo")):
                bad.append(f"{name} rank {r}: transport {rr['transport']}")
            if not all(math.isfinite(x) for x in losses):
                bad.append(f"{name} rank {r}: non-finite losses {losses}")
            if name in MP_MESH_DEPENDENT:
                if not losses[-1] < losses[0]:
                    bad.append(f"{name} rank {r}: losses {losses} do not fall")
            elif not f32 and not np.allclose(losses, want_losses, rtol=MP_LOSS_RTOL, atol=0):
                bad.append(f"{name} rank {r}: losses {losses}, one process {want_losses}")
            want = _mp_want(run, rr["coords"])
            off = [i + 1 for i, s in enumerate(rr["steps"]) if s["launches"] != want]
            if off:
                bad.append(f"{name} rank {r} {rr['coords']} steps {off}: launches "
                           f"{rr['steps'][off[0] - 1]['launches']}, expected {want}")
        launches[name] = [[s["launches"] for s in rr["steps"]] for rr in ranks]
        if f32:
            errs = ranks[0]["f32"]
            over = {k: e for k, e in errs.items() if e[1] > MP_F32_ATOL}
            if over:
                bad.append(f"{name}: parameters beyond atol {MP_F32_ATOL} + rtol "
                           f"{MP_F32_RTOL}: {over}")
            worst = max(errs.items(), key=lambda kv: kv[1][0])
            print(f"{label} {name}: one SGD step (lr {MP_F32_LR}) at {layers} layers, f32, on "
                  f"{axes}: loss {ranks[0]['steps'][0]['loss']!r}, one process "
                  f"{want_losses[0]!r}; each parameter gathered against one process's: max "
                  f"abs err {worst[1][0]:.3e} ({worst[0]}), all within atol {MP_F32_ATOL} + "
                  f"rtol {MP_F32_RTOL}: {not over}", flush=True)
            continue
        if hybrid:
            for r, rr in enumerate(ranks):
                # the hybrid's keys less their "Hybrid.<instance>" prefix: the
                # reference's stacked tree (_reference_keys)
                if [[k[k.index("["):], shape] for k, shape in rr["keys"]] != one[name]["keys"]:
                    bad.append(f"{name} rank {r}: keys {rr['keys'][:3]}..., one process's "
                               f"{one[name]['keys'][:3]}...")
                if rr["bad_pulls"]:
                    bad.append(f"{name} rank {r}: pulls not the host's sum: {rr['bad_pulls']}")
        ms = [[round(s["ms"], 1) for s in rr["steps"]] for rr in ranks]
        keys_note = (f"; keys {len(ranks[0]['keys'])} the reference's stacked tree "
                     f"({ranks[0]['keys'][-1]} last), pulls bitwise" if hybrid else "")
        models = {"bert": "BERT-large", "gpt2": "GPT-2 medium",
                  "moe": "GPT-2 medium with 8 experts (top-2)"}
        drops = ("" if model_name != "moe" else
                 f"; assignments dropped per layer a step (of top_k x the rank's tokens) per "
                 f"rank {[[s['drops'] for s in rr['steps']] for rr in ranks]}")
        print(f"{label} {name}: {models[model_name]} at "
              f"{layers} layers, seq {_mp_cfg(model_name, layers, overrides).max_seq}, bf16, "
              f"remat, flash, {overrides.get('batch', MP_BATCH)} sequences, {overrides} on {axes}"
              f"{' through HybridDataParallel and 2 servers' if hybrid else ''}, transport "
              f"{ranks[0]['transport']}: losses rank 0 {[s['loss'] for s in ranks[0]['steps']]}"
              f", one process {want_losses}; ms a step per rank {ms}, one process "
              f"{[round(x, 1) for x in one.get(name, {'ms': []})['ms']]}; K1-K3 launches a "
              f"step per rank "
              f"{[rr['steps'][-1]['launches'] for rr in ranks]} at coordinates "
              f"{[rr['coords'] for rr in ranks]}"
              f"{keys_note}"
              f"{drops}; on {card}", flush=True)
    return bad, launches


def _mp_draw(work: str, specs: list) -> None:
    """Draw ``init_params(cfg, seed=0)`` of each (model, layers) of
    ``specs`` and save it under ``work`` (``python -c`` in a process of its
    own, beside phase (h))."""
    from byteps_tpu_torch.models.transformer import init_params

    for model_name, layers in specs:
        path = _mp_dir(work, f"w {model_name} {layers}")
        _mp_save(path + ".part", init_params(_mp_cfg(model_name, layers, {}), seed=0))
        os.replace(path + ".part", path)


#: the (model, depth) of phase (h)'s weights, drawn by a child of
#: ``start_model_parallel``
MP_WEIGHTS = [("bert", 4), ("bert", 2), ("gpt2", 2)]


def start_model_parallel() -> dict:
    """Phase (h)'s processes: a scheduler and two Python servers, one
    launcher host of MP_RANKS ranks on this card over the staged transport
    (each comes up, then waits for <work>/go), and a child that draws and
    saves (h)'s weights (``init_params(seed=0)`` of MP_WEIGHTS).  ``main``
    starts them ahead of the fusion phase: the ranks' start (25.0 s on a
    fast host, 41.8 s on a slow one, PR 24 calls 1 and 2) then overlaps
    the phases before (h).  Returns what ``train_model_parallel`` takes;
    ``stop_model_parallel`` stops it."""
    work = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "PYTHONPATH": REPO, "DMLC_ROLE": "worker",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_LOCAL_SIZE": str(MP_RANKS),
           "BYTEPS_MESH_TRANSPORT": MP_TRANSPORT}
    for k in ("BYTEPS_JOB_ID", "BYTEPS_JOB_PRIORITY", "BYTEPS_JOB_QUOTA_MBPS"):
        env.pop(k, None)
    port, fleet = _start_ps_processes(env, work)
    path = os.path.join(work, "host.log")
    with open(path, "w") as log:
        host = _track(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
             sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mp-host", work],
            cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port, "MP_HOST_DEVICE": MP_HOST_DEVICE},
            stdout=log, stderr=subprocess.STDOUT), "model parallel host", path)
    draw = _track(subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as cs; cs._mp_draw({work!r}, {MP_WEIGHTS!r})"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}), f"weights {MP_WEIGHTS}")
    return {"work": work, "host": host, "path": path, "draw": draw, "procs": [host, draw] + fleet}


def stop_model_parallel(started: dict) -> None:
    """Stop what ``start_model_parallel`` started and remove its directory."""
    _stop_processes([p for p in started["procs"] if p in _FLEET])
    shutil.rmtree(started["work"], ignore_errors=True)


def train_model_parallel(card: str, after_h=None, one_process_i: bool = True,
                         started: dict = None, beside_i=None) -> dict:
    """Phase (h), model parallelism, then phase (i) on the same host: a
    scheduler, two Python servers and one launcher host of MP_RANKS ranks
    on this card over the staged transport (``started``, or started here:
    ``start_model_parallel``), warmed up while a child draws the weights
    (``init_params(seed=0)``; another draws phase (i)'s meanwhile)
    and this process runs every run alone in one process on the card.
    Then the host trains, each run in turn, its
    ranks holding the shards ``shard_params_from_jax`` cuts: (h1)
    BERT-large at 4 layers on {pp:2, tp:2}, 4 microbatches; (h2) GPT-2
    medium at 2 layers on {sp:2, tp:2}, the ring of flash hops; (h3) the
    same on Ulysses; (h4) BERT-large at 2 layers on {dp:2, tp:2} and (h5)
    on {dp:2, pp:2} (a layer a stage, 2 microbatches) through
    HybridDataParallel and the PS; and one f32 SGD step of (h1) and (h2) at
    2 layers.  Fails unless every bf16 run's losses are within
    MP_LOSS_RTOL of one process's on every rank, every f32 parameter
    gathered within atol MP_F32_ATOL + rtol MP_F32_RTOL of one process's,
    every rank launched K1-K3 a step as its coordinates say, (h4)'s and
    (h5)'s keys are the reference hybrid's (``_reference_keys``, from
    param_shapes and the sorted order) and every pull is bitwise the
    host's pushed sum.  Prints the launches of every rank, the
    step ms and the transport.  Calls ``after_h`` once (h) passed, then
    runs phase (i) (``_moe_generation``; without its one-process parts
    (i1) and (i4) unless ``one_process_i``; ``beside_i``, when given, is
    called while the host runs phase (i), its result under "beside").
    Returns {"h": {run: [each rank's launches a step]}, "i": phase (i)'s}."""
    import torch

    label = "model parallel (h)"
    wall = time.perf_counter()
    started = started or start_model_parallel()
    work, host, path = started["work"], started["host"], started["path"]
    draws = [_track(subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as cs; cs._mp_draw({work!r}, {MOE_WEIGHTS!r})"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}), f"weights {MOE_WEIGHTS}")]
    try:
        check_mp_kernel_shapes()
        t0 = time.perf_counter()
        if started["draw"].wait(timeout=PHASE_STALL_S) != 0:
            fail(f"{label}: drawing the weights exited {started['draw'].returncode}")
        weights_s = time.perf_counter() - t0
        one = {run[0]: _mp_one_process(run, work) for run in MP_RUNS}
        torch.cuda.empty_cache()
        refs_s = time.perf_counter() - t0 - weights_s
        t_go = time.perf_counter()
        open(os.path.join(work, "go"), "w").close()
        res = _mp_await(label, host, path, work, MP_RUNS)
        host_s = time.perf_counter() - t_go
        bad, launches = _mp_check(label, MP_RUNS, one, res, card)
        print(f"{label}: waited for the weights {weights_s:.1f} s, one-process runs "
              f"{refs_s:.1f} s, the host's runs {host_s:.1f} s; the ranks' marks (s) "
              f"{[rr['marks'] for rr in res[MP_RUNS[-1][0]]]}; phase wall "
              f"{time.perf_counter() - wall:.1f} s", flush=True)
        if bad:
            open(os.path.join(work, "no-i"), "w").close()
            fail(f"{label}: " + "; ".join(bad))
        if after_h is not None:
            after_h()
        moe_i = _moe_generation(card, work, host, path, draws, one_process_i, beside_i)
    finally:
        _stop_processes(draws)
        stop_model_parallel(started)
    return {"h": {run[0]: [launches[run[0]][r][-1] for r in range(MP_RANKS)] for run in MP_RUNS
                  if run[4].get("dtype") != "float32"}, "i": moe_i}


def _mp_await(label: str, host, path: str, work: str, runs: tuple) -> dict:
    """Wait until every rank wrote the result of every run of ``runs`` (or
    the host exited, or PHASE_STALL_S passed); fails unless all did.
    Returns {run: [each rank's result]}."""
    names = [os.path.join(work, f"{_mp_dir('', run[0])}.{r}.json")
             for run in runs for r in range(MP_RANKS)]
    deadline = time.monotonic() + PHASE_STALL_S
    while not all(os.path.exists(n) for n in names):
        rc = host.poll()
        if rc is not None or time.monotonic() > deadline:
            with open(path) as f:
                print(f"--- {label} host (exit {rc}):\n{f.read()[-8000:]}", file=sys.stderr)
            fail(f"{label}: the host exited {rc} before its results")
        time.sleep(0.2)
    res = {}
    for run in runs:
        res[run[0]] = []
        for r in range(MP_RANKS):
            with open(os.path.join(work, f"{_mp_dir('', run[0])}.{r}.json")) as f:
                res[run[0]].append(json.load(f))
    return res


# --- phase (l): GPT-2 medium from a HuggingFace checkpoint ---------------------

#: GPT-2 medium as HF's gpt2-medium config.json states it (the GPT-2 paper's
#: 345M row, Radford et al. 2019, Table 2): the fields the importer reads
HF_GPT2_MEDIUM = {"vocab_size": 50257, "n_positions": 1024, "n_embd": 1024, "n_layer": 24,
                  "n_head": 16, "n_inner": None, "layer_norm_epsilon": 1e-5,
                  "activation_function": "gelu_new"}
#: (l2)'s sequences; (l3)'s sequences and AdamW steps; (l4)'s new tokens
#: (on GEN_PROMPTS prompts of GEN_PROMPT_LEN) and the depth of its f32 run
HF_CHECK_ROWS, HF_BATCH, HF_STEPS, HF_NEW, HF_DECODE_LAYERS = 2, 8, 3, 32, 2
#: (l2): the port's f32 logits against the independent forward's, max abs
#: (check_full_depth's rule); (l3): its first bf16 loss against the
#: independent forward's f32 loss, relative (MP_LOSS_RTOL's)
HF_F32_ATOL, HF_LOSS_RTOL = 1e-3, 2e-2
#: (l3)'s AdamW rate, a GPT-2 fine-tuning rate: at 1e-4 the third loss rose
#: past the first (each step moves every c_proj weight, std 0.02 / sqrt(48),
#: by ~3% of its std)
HF_LR = 2e-5


def _hf_keys(n_layer: int) -> list:
    """HF GPT2LMHeadModel's state-dict keys, ``lm_head.weight`` (tied to the
    token embedding) aside."""
    keys = ["transformer.wte.weight", "transformer.wpe.weight"]
    for i in range(n_layer):
        keys += [f"transformer.h.{i}.{k}" for k in (
            "ln_1.weight", "ln_1.bias", "attn.c_attn.weight", "attn.c_attn.bias",
            "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
            "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")]
    return keys + ["transformer.ln_f.weight", "transformer.ln_f.bias"]


def _hf_draw(path: str) -> None:
    """Draw GPT-2 medium's checkpoint in HF's key names and layouts from
    numpy seed 0 and save it under ``path`` (``python -c`` in a process of
    its own, started before the phase): weights normal with std 0.02 as HF
    initialises them (the residual projections ``c_proj`` 0.02 /
    sqrt(2 n_layer)), LayerNorm scales 1 + N(0, 0.05), every bias N(0, 0.02)
    so that a bias mapped wrong cannot hide behind zeros.  f32; Conv1D
    weights (in, out)."""
    c = HF_GPT2_MEDIUM
    d, f, n = c["n_embd"], c["n_inner"] or 4 * c["n_embd"], c["n_layer"]
    shapes = (("wte.weight", (c["vocab_size"], d)), ("wpe.weight", (c["n_positions"], d)),
              ("c_attn.weight", (d, 3 * d)), ("c_attn.bias", (3 * d,)),
              ("attn.c_proj.weight", (d, d)), ("c_fc.weight", (d, f)), ("c_fc.bias", (f,)),
              ("mlp.c_proj.weight", (f, d)))
    rng = np.random.default_rng(0)
    os.makedirs(path + ".part")
    for key in _hf_keys(n):
        shape = next((shp for suffix, shp in shapes if key.endswith(suffix)), (d,))
        z = rng.standard_normal(shape, dtype=np.float32)
        if "ln_" in key and key.endswith(".weight"):
            arr = 1 + np.float32(0.05) * z
        elif key.endswith("c_proj.weight"):
            arr = np.float32(0.02 / math.sqrt(2 * n)) * z
        else:
            arr = np.float32(0.02) * z
        np.save(os.path.join(path + ".part", key + ".npy"), arr)
    os.replace(path + ".part", path)


def start_hf_gpt2() -> dict:
    """Phase (l)'s checkpoint, drawn by a child (``_hf_draw``): ``main``
    starts it with phase (h)'s processes, so the draw overlaps the phases
    before (l).  ``stop_hf_gpt2`` stops it and removes its directory."""
    work = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    path = os.path.join(work, "gpt2-medium")
    draw = _track(subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as cs; cs._hf_draw({path!r})"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}), "GPT-2 medium checkpoint")
    return {"work": work, "path": path, "draw": draw}


def stop_hf_gpt2(started: dict) -> None:
    _stop_processes([started["draw"]])
    shutil.rmtree(started["work"], ignore_errors=True)


def _hf_model(state: dict, n_layer: int):
    """A GPT-2 model as the importer reads one, with no ``transformers``
    behind it: a namespace ``config`` (HF_GPT2_MEDIUM at ``n_layer``) and a
    ``state_dict()`` in HF's key names, ``lm_head.weight`` tied as HF's."""
    config = types.SimpleNamespace(**{**HF_GPT2_MEDIUM, "n_layer": n_layer})
    return types.SimpleNamespace(config=config, state_dict=lambda: {
        **state, "lm_head.weight": state["transformer.wte.weight"]})


def _hf_sources(hf: dict, n_layer: int) -> dict:
    """The port's state-dict name → the HF tensor it must equal, mapped here
    by hand: Conv1D weights are (in, out) as the port's; c_attn's thirds
    on its output axis are q, k and v, each split by head; c_proj's input
    axis is (head, d_head); the head is the token embedding transposed."""
    c = HF_GPT2_MEDIUM
    d, h = c["n_embd"], c["n_head"]
    src = {"embed": hf["transformer.wte.weight"], "pos": hf["transformer.wpe.weight"],
           "ln_f_s": hf["transformer.ln_f.weight"], "ln_f_b": hf["transformer.ln_f.bias"],
           "head": hf["transformer.wte.weight"].t()}
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        q, k, v = hf[p + "attn.c_attn.weight"].split(d, dim=1)
        qb, kb, vb = hf[p + "attn.c_attn.bias"].split(d)
        src.update({f"layers.{i}.{name}": t for name, t in {
            "ln1_s": hf[p + "ln_1.weight"], "ln1_b": hf[p + "ln_1.bias"],
            "ln2_s": hf[p + "ln_2.weight"], "ln2_b": hf[p + "ln_2.bias"],
            "wq": q.reshape(d, h, d // h), "wk": k.reshape(d, h, d // h),
            "wv": v.reshape(d, h, d // h), "wq_b": qb.reshape(h, d // h),
            "wk_b": kb.reshape(h, d // h), "wv_b": vb.reshape(h, d // h),
            "wo": hf[p + "attn.c_proj.weight"].reshape(h, d // h, d),
            "wo_b": hf[p + "attn.c_proj.bias"],
            "w1": hf[p + "mlp.c_fc.weight"], "b1": hf[p + "mlp.c_fc.bias"],
            "w2": hf[p + "mlp.c_proj.weight"], "b2": hf[p + "mlp.c_proj.bias"]}.items()})
    return src


def gpt2_forward(hf: dict, n_layer: int, tokens):
    """GPT-2's forward in plain torch, straight from an HF state dict and
    nothing of the port's model, in the tensors' dtype: Conv1D products
    ``x @ W + b``, heads split, a causal softmax, gelu_new written out,
    LayerNorm at eps 1e-5, the head ``wte.T``.  (B, S) → (B, S, vocab)."""
    import torch
    import torch.nn.functional as F

    c = HF_GPT2_MEDIUM
    d, h, eps = c["n_embd"], c["n_head"], c["layer_norm_epsilon"]
    b, s = tokens.shape
    causal = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()

    def ln(x, name):
        return F.layer_norm(x, (d,), hf[name + ".weight"], hf[name + ".bias"], eps)

    def conv1d(x, name):
        return x @ hf[name + ".weight"] + hf[name + ".bias"]

    def heads(x):  # (B, S, D) → (B, H, S, dh)
        return x.reshape(b, s, h, d // h).transpose(1, 2)

    x = hf["transformer.wte.weight"][tokens] + hf["transformer.wpe.weight"][:s]
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        q, k, v = (heads(t) for t in conv1d(ln(x, p + "ln_1"), p + "attn.c_attn").split(d, -1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d // h)
        attn = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + conv1d(attn.transpose(1, 2).reshape(b, s, d), p + "attn.c_proj")
        u = conv1d(ln(x, p + "ln_2"), p + "mlp.c_fc")
        u = 0.5 * u * (1 + torch.tanh(math.sqrt(2 / math.pi) * (u + 0.044715 * u ** 3)))
        x = x + conv1d(u, p + "mlp.c_proj")
    return ln(x, "transformer.ln_f") @ hf["transformer.wte.weight"].t()


def _gpt2_greedy(hf: dict, n_layer: int, prompt, n_new: int) -> np.ndarray:
    """Greedy decoding by ``gpt2_forward``'s argmax on the whole prefix:
    (B, P + n_new) int64 numpy."""
    import torch

    x = torch.as_tensor(prompt, device=hf["transformer.wte.weight"].device)
    with torch.no_grad():
        for _ in range(n_new):
            x = torch.cat([x, gpt2_forward(hf, n_layer, x)[:, -1].argmax(-1)[:, None]], dim=1)
    return x.cpu().numpy()


def train_hf_gpt2(card: str, started: dict = None) -> dict:
    """Phase (l): GPT-2 medium at its published widths (HF_GPT2_MEDIUM) from
    an HF-layout checkpoint drawn from numpy seed 0 (``started``, or started
    here: ``start_hf_gpt2``) into the port, without ``transformers``.

    (l1) ``hf_import.load_gpt2_weights`` on a duck-typed model, then
    ``params_from_jax``, then ``Transformer(use_flash=True, bf16)`` on the
    card: every parameter bitwise the HF tensor it came from
    (``_hf_sources``).  (l2) ``gpt2_forward`` in f32 at 24 layers on
    HF_CHECK_ROWS sequences of 1024: the port's f32 model (dense attention)
    within HF_F32_ATOL max abs of it; the port's bf16 logits through K1 no
    further from it, on average, than 1.25 times the bf16 dense
    attention's (check_model's rule).  (l4) at HF_DECODE_LAYERS layers in
    f32 both builders' greedy tokens equal ``gpt2_forward``'s; at 24
    layers in bf16 both builders on GEN_PROMPTS prompts of
    GEN_PROMPT_LEN, HF_NEW new tokens: tokens a second, K1's launches, the
    tokens equal between the builders and to ``gpt2_forward``'s f32
    greedy.  (l3) HF_STEPS steps of HF_BATCH sequences of 1024 (numpy seed
    0) through init -> broadcast_parameters -> DistributedOptimizer(AdamW at
    HF_LR)
    -> build_train_step, bf16 on K1-K3 with the attention biases and the
    importer's remat=False: finite, falling losses, the first within
    HF_LOSS_RTOL of ``gpt2_forward``'s f32 loss on the batch, K1-K3
    24/24/24 a step; ms a step, samples/s and peak memory.  Fails on any
    failure.  Returns {"l3 a step": K1-K3 launches, "build_generate" and
    "build_generate_cached": a 24-layer call's tokens a second, s and
    K1-K3 launches}."""
    import torch
    import torch.nn.functional as F

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.hf_import import load_gpt2_weights
    from byteps_tpu_torch.models.transformer import (Transformer, build_generate,
                                                     build_generate_cached, build_train_step)
    from byteps_tpu_torch.ops import flash_attention as fa

    label = "GPT-2 from an HF checkpoint (l)"
    wall = time.perf_counter()
    parts, tick = {}, [wall]

    def lap(name: str) -> None:  # each part's wall seconds
        now = time.perf_counter()
        parts[name] = round(now - tick[0], 1)
        tick[0] = now

    own = started is None
    started = started or start_hf_gpt2()
    bad, out = [], {}
    n, dev, bf16 = HF_GPT2_MEDIUM["n_layer"], MP_DEVICE, torch.bfloat16
    try:
        check_case("(l) GPT-2 medium bf16", HF_CHECK_ROWS, 16, 1024, 64, bf16, True, seed=60)
        t0 = time.perf_counter()
        if started["draw"].wait(timeout=PHASE_STALL_S) != 0:
            fail(f"{label}: drawing the checkpoint exited {started['draw'].returncode}")
        waited_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = {k: torch.from_numpy(np.load(os.path.join(started["path"], k + ".npy")))
                 for k in _hf_keys(n)}
        read_s = time.perf_counter() - t0

        # (l1) the import
        t0 = time.perf_counter()
        cfg, params = load_gpt2_weights(_hf_model(state, n))
        sd = params_from_jax(params, cfg)
        del params
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        flash_cfg = dataclasses.replace(cfg, use_flash=True, compute_dtype=bf16)
        model = Transformer(flash_cfg, device=dev)
        model.load_state_dict(sd)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        hf = {k: v.to(dev) for k, v in state.items()}
        src = _hf_sources(hf, n)
        got = dict(model.state_dict())
        if set(got) != set(src):
            bad.append(f"l1: parameters {sorted(set(got) ^ set(src))[:4]} on one side only")
        unequal = [k for k in src if k in got and not (
            got[k].shape == src[k].shape and torch.equal(got[k], src[k]))]
        if unequal:
            bad.append(f"l1: {len(unequal)} parameters not bitwise their HF tensors, "
                       f"{unequal[:4]}")
        print(f"{label} l1: GPT-2 medium {HF_GPT2_MEDIUM}, {len(state)} HF tensors "
              f"({sum(v.numel() for v in state.values()) * 4} bytes, f32): checkpoint drawn "
              f"beside the phases before, waited {waited_s:.1f} s, read {read_s:.2f} s; "
              f"load_gpt2_weights + params_from_jax {import_s:.2f} s; onto the card "
              f"{load_s:.2f} s; {len(got)} parameters, bitwise their HF tensors: "
              f"{not unequal and set(got) == set(src)}; config {cfg}; on {card}", flush=True)
        del got, src
        lap("check, wait, read, l1")

        # (l2) the architecture against gpt2_forward, in f32 at full depth
        tokens, targets = _mp_tokens(cfg, HF_BATCH)
        tok, tgt = (torch.as_tensor(a, device=dev) for a in (tokens, targets))
        rows = tok[:HF_CHECK_ROWS]
        runs = {}
        with torch.no_grad():
            ref = gpt2_forward(hf, n, rows)
            ref_loss = float(F.cross_entropy(gpt2_forward(hf, n, tok).flatten(0, 1),
                                             tgt.flatten(), ignore_index=-1))
            for name, c in (("f32", dataclasses.replace(cfg, compute_dtype=torch.float32)),
                            ("bf16 dense", dataclasses.replace(flash_cfg, use_flash=False)),
                            ("bf16 flash", None)):
                m = model
                if c is not None:
                    m = Transformer(c, device=dev)
                    m.load_state_dict(sd)
                fa.reset_launches()
                runs[name] = m(rows).float()
                runs[name + " launches"] = dict(fa.launches)
                del m
        err = float((runs["f32"] - ref).abs().max())
        ef = float((runs["bf16 flash"] - ref).abs().mean())
        ed = float((runs["bf16 dense"] - ref).abs().mean())
        if not err <= HF_F32_ATOL:
            bad.append(f"l2: the port's f32 logits {err:.3e} from gpt2_forward's, max abs, "
                       f"beyond {HF_F32_ATOL}")
        if not ef <= 1.25 * ed:
            bad.append(f"l2: bf16 logits through K1 {ef:.3e} from f32 on average, dense "
                       f"attention {ed:.3e}")
        if runs["bf16 flash launches"].get("flash_fwd") != n:
            bad.append(f"l2: K1 launches {runs['bf16 flash launches']}, expected {n}")
        print(f"{label} l2: {n} layers, {HF_CHECK_ROWS} sequences of {cfg.max_seq}: the port "
              f"in f32 (dense attention) against the independent GPT-2 forward, max abs "
              f"{err:.3e} (limit {HF_F32_ATOL}); mean abs from its f32 logits, bf16 through "
              f"K1 {ef:.3e}, bf16 dense attention {ed:.3e} (limit 1.25x); K1 launches "
              f"{runs['bf16 flash launches']}; on {card}", flush=True)
        del runs, ref
        lap("l2")

        # (l4) decoding, before (l3) trains the model
        prompt = tokens[:GEN_PROMPTS, :GEN_PROMPT_LEN]
        small_cfg, small = load_gpt2_weights(_hf_model(state, HF_DECODE_LAYERS))
        sm = Transformer(dataclasses.replace(small_cfg, use_flash=True), device=dev)
        sm.load_state_dict(params_from_jax(small, small_cfg))
        want = _gpt2_greedy(hf, HF_DECODE_LAYERS, prompt, HF_NEW)
        f32_tokens = {b.__name__: b(sm)(prompt, HF_NEW)
                      for b in (build_generate, build_generate_cached)}
        same_f32 = {k: bool(np.array_equal(v, want)) for k, v in f32_tokens.items()}
        if not all(same_f32.values()):
            bad.append(f"l4: f32 greedy tokens at {HF_DECODE_LAYERS} layers equal to "
                       f"gpt2_forward's {same_f32}")
        del sm, small
        gen_tokens = {}
        for b in (build_generate, build_generate_cached):
            gen = b(model)
            gen(prompt, 2)
            gen_tokens[b.__name__], s, launches = _generate_timed(gen, prompt, HF_NEW)
            want = {"flash_fwd": n * HF_NEW if b is build_generate else 0,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if {k: launches.get(k, 0) for k in want} != want:
                bad.append(f"l4 {b.__name__}: launches {launches}, expected {want}")
            out[b.__name__] = {"tokens_per_s": GEN_PROMPTS * HF_NEW / s, "s": s,
                               "launches": launches}
        greedy = _gpt2_greedy(hf, n, prompt, HF_NEW)
        new = slice(GEN_PROMPT_LEN, None)
        agree = float((gen_tokens["build_generate"] == gen_tokens["build_generate_cached"])
                      [:, new].mean())
        same = {k: float((v == greedy)[:, new].mean()) for k, v in gen_tokens.items()}
        print(f"{label} l4: at {HF_DECODE_LAYERS} layers in f32, {GEN_PROMPTS} prompts of "
              f"{GEN_PROMPT_LEN}, {HF_NEW} new: both builders' greedy tokens equal to the "
              f"independent forward's {same_f32}; at {n} layers, bf16, flash: recompute "
              f"{out['build_generate']['tokens_per_s']:.1f} tokens/s "
              f"({out['build_generate']['s']:.3f} s), launches "
              f"{out['build_generate']['launches']}; KV cache "
              f"{out['build_generate_cached']['tokens_per_s']:.1f} tokens/s "
              f"({out['build_generate_cached']['s']:.3f} s), launches "
              f"{out['build_generate_cached']['launches']}; new tokens equal between the two "
              f"{agree:.3f}, to the independent forward's f32 greedy {same}; on {card}",
              flush=True)

        lap("l4")

        # (l3) fine-tuning through the normal entry points
        del hf
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bps.init()
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=HF_LR, weight_decay=1e-4),
            named_parameters=model.named_parameters())
        step = build_train_step(model, opt)
        steps = []
        for _ in range(HF_STEPS):
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(tok, tgt))
            torch.cuda.synchronize()
            steps.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": dict(fa.launches)})
        peak = torch.cuda.max_memory_allocated()
        bps.shutdown()
        losses = [s["loss"] for s in steps]
        # the importer's remat=False: K1 once a layer forward, no recompute;
        # K2 and K3 once a layer in backward
        want_l = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        if not (all(math.isfinite(x) for x in losses)
                and all(b < a for a, b in zip(losses, losses[1:]))):
            bad.append(f"l3: losses {losses} not finite and falling")
        if not abs(losses[0] - ref_loss) <= HF_LOSS_RTOL * abs(ref_loss):
            bad.append(f"l3: first loss {losses[0]!r}, the independent forward's f32 "
                       f"{ref_loss!r}")
        off = [i + 1 for i, s in enumerate(steps) if s["launches"] != want_l]
        if off:
            bad.append(f"l3 steps {off}: launches {steps[off[0] - 1]['launches']}, "
                       f"expected {want_l}")
        timed = [s["ms"] for s in steps[1:]]
        print(f"{label} l3: {n} layers, {HF_BATCH} sequences of {cfg.max_seq}, bf16, flash, "
              f"attention biases, remat {flash_cfg.remat}, through init -> "
              f"broadcast_parameters -> DistributedOptimizer(AdamW, lr {HF_LR}) -> "
              f"build_train_step: "
              f"losses {losses}, the independent forward's f32 loss on the batch "
              f"{ref_loss!r} (first loss off by {abs(losses[0] - ref_loss) / ref_loss:.2e}, "
              f"limit {HF_LOSS_RTOL}); ms a step {[round(s['ms'], 1) for s in steps]} "
              f"({HF_BATCH * len(timed) / sum(timed) * 1e3:.2f} samples/s after the first); "
              f"peak memory {peak / 2**30:.2f} GiB; K1-K3 launches a step "
              f"{steps[-1]['launches']} (want {want_l}); on {card}", flush=True)
        out["l3 a step"] = steps[-1]["launches"]
        del model, opt, step
        lap("l3")
    finally:
        if own:
            stop_hf_gpt2(started)
    print(f"{label}: phase wall {time.perf_counter() - wall:.1f} s ({parts})", flush=True)
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    return out


#: phase (j), the observability plane: BERT-large at OBS_LAYERS through one
#: worker, a Python server and a C++ one, OBS_STEPS traced steps (the last
#: under profiler.trace) and one untraced step; the SLO under any step
OBS_LAYERS, OBS_STEPS, OBS_SLO_S = 2, 3, 0.05
#: the hand kernels' launches in one step at OBS_LAYERS (PERF.md §6)
OBS_LAUNCHES = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2, "onebit_pack": 99}


def _free_port() -> int:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _device_launches(prof) -> tuple:
    """Each hand kernel's launches among a profile's device events, and the
    events' names with their counts."""
    from torch.autograd import DeviceType

    out, keys = dict.fromkeys(OBS_LAUNCHES, 0), {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        for name in out:
            if name in e.key:
                out[name] += e.count
                keys[e.key[:60]] = e.count
    return out, keys


def _tool(args: list, timeout: float = 120) -> subprocess.CompletedProcess:
    """One of the repo's stdlib tools, run as a tool."""
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def _span_checks(events: list) -> list:
    """What is wrong with a merged timeline's spans: a child whose parent
    or trace is missing, a worker PUSH/PULL span or a FUSED_RPC without
    server children, a server whose children are not all of one engine, no
    C++ children tagged ``engine: "native"``."""
    spans = [e for e in events if e.get("cat") == "span" and e.get("ph") == "X"]
    owners, packs, kids, bad = {}, {}, {}, []
    for e in spans:
        a = e["args"]
        if "parent" in a:
            kids.setdefault(a["parent"], []).append(e)
        else:
            owners.setdefault(a["span"], set()).add((a["trace"], e["name"]))
            if e["name"] == "FUSED_RPC":
                packs[a["trace"]] = a["span"]
    fused_kids = {}
    for parent, ks in kids.items():
        for k in ks:
            if parent not in owners:
                bad.append(f"a child without its parent: {k}")
            elif k["args"].get("fused"):
                fused_kids.setdefault(k["args"]["trace"], 0)
                fused_kids[k["args"]["trace"]] += k["args"]["trace"] in packs
            elif k["args"]["trace"] not in {t for t, _ in owners[parent]}:
                bad.append(f"a child off its parent's trace: {k}")
    for span, names in owners.items():
        if {"PUSH", "PULL"} & {n for _, n in names} and not kids.get(span):
            bad.append(f"a worker span without server children: {sorted(names)}")
    missing = [t for t in packs if not fused_kids.get(t)]
    if not packs or missing:
        bad.append(f"{len(packs)} FUSED_RPC packs, {len(missing)} without member children")
    engines = {}
    for ks in kids.values():
        for k in ks:
            engines.setdefault(k["pid"], set()).add(k["args"].get("engine", "python"))
    if sorted(map(sorted, engines.values())) != [["native"], ["python"]]:
        bad.append(f"the servers' children by engine: {engines}")
    return bad


def train_observability(card: str) -> dict:
    """Phase (j): the observability plane on BERT-large's traced distributed
    step.  One worker (this process), a scheduler, a Python server and a
    C++ one; bare onebit, fusion at FUSION_THRESHOLD, BYTEPS_TRACE_ON with
    the envelopes' window over the timed steps, BYTEPS_METRICS_PORT on the
    worker and the scheduler, BYTEPS_JOB_SLO_S under the step with
    BYTEPS_FLIGHT_UPLOAD.  OBS_STEPS steps, the last under
    ``profiler.trace``, and one untraced.  Fails unless (j1) the first loss
    is bitwise the same model's forward without the PS; (j2)
    tools/trace_merge.py joins the worker's and both servers' files with no
    orphan, every worker PUSH/PULL span and FUSED_RPC has server children
    and the C++ server's are tagged ``engine: "native"``; (j3) the
    profiler's device trace of its step holds K1-K4 at OBS_LAUNCHES; (j4)
    both endpoints serve the round trips and the stage dwell, and
    tools/bps_top.py reads them; (j5) slo_breach fired, its bundle holds
    its files, tools/bps_doctor.py diagnoses it, and its upload landed in
    the scheduler's flight directory.  Prints (j6) the traced step's wall
    beside the untraced one's.  Returns the hand kernels' launches a step."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import profiler
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    label = "observability (j)"
    wall = time.perf_counter()
    bps.init()
    _, model, tok, tgt = _bert(OBS_LAYERS)
    want_first = float(model.loss(tok, tgt).detach())
    bps.shutdown()
    del model
    work = tempfile.mkdtemp(prefix="bps-obs-")
    trace_dir, prof_dir = os.path.join(work, "trace"), os.path.join(work, "prof")
    node_flight, sched_flight = os.path.join(work, "flight"), os.path.join(work, "sched-flight")
    traced = {"BYTEPS_TRACE_ON": "1", "BYTEPS_TRACE_DIR": trace_dir}
    sched_port = _free_port()
    worker_env = {**traced, "BYTEPS_TRACE_START_STEP": "2",
                  "BYTEPS_TRACE_END_STEP": str(OBS_STEPS),
                  "BYTEPS_FUSION_THRESHOLD": str(FUSION_THRESHOLD),
                  "BYTEPS_METRICS_PORT": str(_free_port()), "BYTEPS_JOB_SLO_S": str(OBS_SLO_S),
                  "BYTEPS_FLIGHT_UPLOAD": "1", "BYTEPS_FLIGHT_DIR": node_flight,
                  "BYTEPS_HEARTBEAT_INTERVAL": "1"}
    bad = []
    with _ps_fleet(label, traced, worker_env,
                   sched_env={"BYTEPS_METRICS_PORT": str(sched_port),
                              "BYTEPS_FLIGHT_DIR": sched_flight},
                   per_server_env=[{}, {"BYTEPS_SERVER_NATIVE": "1"}]):
        bps.init()
        cfg, model, tok, tgt = _bert(OBS_LAYERS)
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = build_train_step(model, opt)
        st = get_state()
        fa.reset_launches()
        ob.reset_launches()

        def timed() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(tok, tgt)))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        losses, ms = [], []
        for i in range(OBS_STEPS):
            if i == OBS_STEPS - 1:
                with profiler.trace(prof_dir) as prof:
                    ms.append(timed())
                device, device_keys = _device_launches(prof)
            else:
                ms.append(timed())
        launches = {**fa.launches, **ob.launches}
        st.tracer.enabled = False  # (j6): the same step untraced
        ms.append(timed())
        traced_files = glob.glob(os.path.join(prof_dir, "**", "comm*.json"), recursive=True)
        # (j4) the worker's endpoint and the scheduler's aggregate, once a
        # heartbeat carried the steps' histograms
        urls = [f"http://127.0.0.1:{st.metrics_http.port}/metrics",
                f"http://127.0.0.1:{sched_port}/metrics"]
        families = ("byteps_rpc_round_trip_seconds_bucket", "byteps_stage_dwell_seconds_bucket")
        uploaded = []
        deadline = time.monotonic() + 30
        while True:
            texts = [_scrape(u) for u in urls]
            uploaded = [d for d in (os.listdir(sched_flight) if os.path.isdir(sched_flight)
                                    else []) if "-worker0-" in d and "slo_breach" in d]
            if (all(f in t for f in families for t in texts) and uploaded
                    and "byteps_flight_bundle_rx_total" in texts[1]) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        top = _tool(["tools/bps_top.py", "--once", *urls])
        fired = counters().labeled_raw().get("flight_trigger", {})
        bundles = list(st.flightrec.bundles_written)
        bps.shutdown()
        del model, opt, step
    n_fired = fired.get((("rule", "slo_breach"),), 0)

    # (j1)
    if losses[0] != want_first or not all(math.isfinite(x) for x in losses):
        bad.append(f"(j1) losses {losses}: the first is not the forward's {want_first!r}")
    # (j2)
    merged, attrib = os.path.join(work, "merged.json"), os.path.join(work, "attrib.json")
    # a copy of the tool outside the repo, run isolated: its optional
    # hot-stripe check imports the JAX package's flight recorder when it
    # can, and from there it finds none
    merge_tool = shutil.copy(os.path.join(REPO, "tools", "trace_merge.py"), work)
    if subprocess.run([sys.executable, "-I", "-c", "import byteps_tpu.core.flightrec"],
                      cwd=work, capture_output=True, timeout=60).returncode == 0:
        bad.append("(j2) the JAX package imports outside the repo: trace_merge would run it")
    res = subprocess.run([sys.executable, "-I", merge_tool, "-o", merged, "--critical-path",
                          attrib, trace_dir, prof_dir], cwd=work, capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        bad.append(f"(j2) trace_merge exited {res.returncode}: {res.stderr[-2000:]}")
        meta, span_bad, engines = {}, [], {}
    else:
        with open(merged) as f:
            doc = json.load(f)
        meta = doc["otherData"]
        span_bad = _span_checks(doc["traceEvents"])
        with open(attrib) as f:
            by_engine = json.load(f)["engines"]
        engines = {k: v["rpcs"] for k, v in by_engine.items()}
        hot = {k: v["hot_stripe"] for k, v in by_engine.items() if "hot_stripe" in v}
        if hot:
            bad.append(f"(j2) trace_merge ran a hot-stripe rule it cannot import here: {hot}")
        if meta["orphaned_spans"] or not meta["linked_spans"]:
            bad.append(f"(j2) {meta['orphaned_spans']} orphaned spans, "
                       f"{meta['linked_spans']} linked")
        bad += [f"(j2) {b}" for b in span_bad[:5]]
        if sorted(engines) != ["native", "python"]:
            bad.append(f"(j2) the critical path's engines {engines}")
    if not traced_files:
        bad.append(f"(j2) profiler.trace left no host trace under {prof_dir}")
    # (j3)
    if device != OBS_LAUNCHES:
        bad.append(f"(j3) the profiled step's device trace holds {device}, expected "
                   f"{OBS_LAUNCHES}: {device_keys}")
    if launches != {k: v * OBS_STEPS for k, v in OBS_LAUNCHES.items()}:
        bad.append(f"(j3) the wrappers counted {launches} in {OBS_STEPS} steps")
    # (j4)
    missing = [f"{u}: {f}" for u, t in zip(urls, texts) for f in families if f not in t]
    if missing:
        bad.append(f"(j4) families missing: {missing}")
    if top.returncode != 0 or "unreachable" in top.stdout:
        bad.append(f"(j4) bps_top exited {top.returncode}: {top.stdout[-1500:]}"
                   f"{top.stderr[-1500:]}")
    # (j5)
    slo = [b for b in bundles if b.rsplit("-", 2)[-2] == "slo_breach"]
    want_files = {"trigger.json", "ledger.jsonl", "metrics.json", "config.json",
                  "trace_window.json"}
    if not n_fired or not slo:
        bad.append(f"(j5) slo_breach fired {n_fired} times, bundles {bundles}")
    else:
        got = set(os.listdir(slo[0]))
        if got != want_files:
            bad.append(f"(j5) the bundle holds {sorted(got)}")
        doctor = _tool(["tools/bps_doctor.py", "--json", slo[0]])
        rules = ([f["rule"] for f in json.loads(doctor.stdout)] if doctor.returncode == 0
                 else None)
        if not rules or "slo_breach" not in rules:
            bad.append(f"(j5) bps_doctor exited {doctor.returncode} with {rules}: "
                       f"{doctor.stderr[-1500:]}")
    if not uploaded:
        bad.append(f"(j5) no slo_breach upload from worker0 in the scheduler's "
                   f"{sched_flight}: {os.listdir(sched_flight) if os.path.isdir(sched_flight) else None}")
    if bad:
        fail(f"{label}: " + "; ".join(bad))
    print(f"{label}: BERT-large at {OBS_LAYERS} layers, seq {SEQ} bf16 remat flash, batch "
          f"{BATCH}, 1 worker + a Python and a C++ server, bare onebit, fusion at "
          f"{FUSION_THRESHOLD}: losses {[round(x, 4) for x in losses]}, the first bitwise the "
          f"forward's without the PS ({want_first!r})", flush=True)
    print(f"{label}: trace_merge: {meta['linked_spans']} linked spans, "
          f"{meta['cross_process_children']} cross-process children, 0 orphans; the critical "
          f"path's rpcs by engine {engines}; K1-K4 in the profiled step's device trace "
          f"{device}", flush=True)
    print(f"{label}: endpoints {urls} and bps_top --once read; slo_breach fired {n_fired} "
          f"times (SLO {OBS_SLO_S} s), bundle {os.path.basename(slo[0])} diagnosed "
          f"{rules}, uploaded as {uploaded[0]}", flush=True)
    print(f"{label}: step wall ms, traced: {[round(x, 1) for x in ms[:OBS_STEPS]]} (the first "
          f"with the init barriers, the last under the profiler), untraced: {ms[OBS_STEPS]:.1f};"
          f" on {card}; phase wall {time.perf_counter() - wall:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {k: v // OBS_STEPS for k, v in launches.items()}


def _scrape(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def check_int8_ring_ops() -> None:
    """The int8 ring's quantize and dequantize (plain torch ops, as the
    reference leaves them to XLA) on one full partition on the card: bitwise
    their CPU run, and timed with L2 cold as K4 is, beside their bytes
    bounds, so that a later slice knows whether one needs a kernel."""
    import torch

    from byteps_tpu_torch.ops.quantized_allreduce import dequantize, quantize

    n = ONEBIT_TIMED_N
    x = _onebit_input(n, seed=13, specials=False)
    q, s = quantize(x)
    deq = dequantize(q, s)
    qc, sc = quantize(x.cpu())
    differ = {"int8 words": int((q.cpu() != qc).sum()), "scales": int((s.cpu() != sc).sum()),
              "dequantized": int((deq.cpu() != dequantize(qc, sc)).sum())}
    if any(differ.values()):
        fail(f"int8 ring ops: quantize / dequantize on the card differ from their CPU run in "
             f"{differ} elements")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = {"quantize": _cold_events_ms(lambda: quantize(x), flush),
             "dequantize": _cold_events_ms(lambda: dequantize(q, s), flush)}
    del flush
    scales = 4 * n // 256
    nbytes = {"quantize": 4 * n + n + scales, "dequantize": n + scales + 4 * n}
    print(f"int8 ring ops n={n} float32, block 256 (plain torch ops): bitwise their CPU run; "
          + "; ".join(f"{k} {float(np.median(v)):.5f} ms with L2 cold (median of {len(v)}), "
                      f"bound {nbytes[k] / PEAK_BYTES * 1e3:.5f} ms (bytes, {nbytes[k]}), "
                      f"{nbytes[k] / PEAK_BYTES * 1e3 / float(np.median(v)):.3f} of it"
                      for k, v in times.items()), flush=True)


def check_step_builders(card: str) -> None:
    """build_data_parallel_step, build_zero1_step, accumulate_steps=2 and
    the int8 ring at one rank of an NCCL group on the card, 2 layers at
    BERT-large's widths in f32: each leaves the parameters within 1e-6 of
    DistributedOptimizer at one worker (AdamW, without foreach, for the
    first two and the ring; SGD on half of each micro-batch's loss with
    backward_passes_per_step=2 for the accumulation, whose mean it is)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import build_mesh
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.optim import build_data_parallel_step, build_zero1_step

    label = "step builders"
    wall = time.perf_counter()

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=1e-4, weight_decay=1e-4, foreach=False)

    def model():
        _, m, tok, tgt = _bert(EQ_LAYERS, batch=2 * EQ_BATCH, compute_dtype=torch.float32,
                               remat=False)
        return m, tok, tgt

    def loss_fn(m, batch):
        return m.loss(*batch)

    bps.init()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = build_mesh("dp:1", init_method="file://" + os.path.join(tmp, "store"))
        try:
            ref, tok, tgt = model()
            step = build_train_step(ref, bps.DistributedOptimizer(
                adamw(ref.parameters()), named_parameters=ref.named_parameters()))
            for _ in range(BUILDER_STEPS):
                step(tok, tgt)
            diffs = {}
            for name, kw in (("build_data_parallel_step", {}),
                             ("build_data_parallel_step(grad_quant_bits=8)",
                              {"grad_quant_bits": 8})):
                m, _, _ = model()
                dp = build_data_parallel_step(loss_fn, m, adamw(m.parameters()), mesh=mesh, **kw)
                for _ in range(BUILDER_STEPS):
                    dp((tok, tgt))
                diffs[name] = _max_diff(ref, m)
                del m, dp
            m, _, _ = model()
            init_fn, z1 = build_zero1_step(loss_fn, m, adamw, mesh=mesh)
            init_fn()
            for _ in range(BUILDER_STEPS):
                z1((tok, tgt))
            diffs["build_zero1_step"] = _max_diff(ref, m)
            del m, z1, init_fn, ref, step

            ref, _, _ = model()
            opt = bps.DistributedOptimizer(torch.optim.SGD(ref.parameters(), lr=EQ_LR),
                                           named_parameters=ref.named_parameters(),
                                           backward_passes_per_step=2)
            m, _, _ = model()
            acc = build_data_parallel_step(loss_fn, m, torch.optim.SGD(m.parameters(), lr=EQ_LR),
                                           mesh=mesh, accumulate_steps=2)
            halves = [slice(0, EQ_BATCH), slice(EQ_BATCH, 2 * EQ_BATCH)]
            for _ in range(BUILDER_STEPS):
                opt.zero_grad(set_to_none=True)
                for rows in halves:
                    (ref.loss(tok[rows], tgt[rows]) / 2).backward()
                    opt.step()
                    acc((tok[rows], tgt[rows]))
            diffs["build_data_parallel_step(accumulate_steps=2)"] = _max_diff(ref, m)
            moved = max(float((p.detach() - _WEIGHTS[EQ_LAYERS][k].to(p.device)).abs().max())
                        for k, p in m.named_parameters())
            del ref, opt, m, acc
        finally:
            mesh.destroy()
    bps.shutdown()
    bad = {k: v for k, v in diffs.items() if not v <= BUILDER_ATOL}
    if bad:
        fail(f"{label}: parameters beyond {BUILDER_ATOL} of DistributedOptimizer at one "
             f"worker: {bad}")
    print(f"{label}: one rank of an NCCL group on the card, {EQ_LAYERS} layers at "
          f"BERT-large's widths, f32, batch {2 * EQ_BATCH}, {BUILDER_STEPS} optimizer steps; max "
          f"abs difference from DistributedOptimizer at one worker: "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
          + f" (atol {BUILDER_ATOL}; the accumulated run moved the parameters up to "
          f"{moved:.3e}); phase wall {time.perf_counter() - wall:.1f} s, on {card}", flush=True)


# --- phase (k): the training kit and the conv models ------------------------

#: (k1) ResNet-50 at published widths (bench.py:168-198, the smaller of its
#: two batches), 3 SGD-momentum steps (optax.sgd(0.1, momentum=0.9), the
#: reference's conv bench) through the batch-statistics step; the card against
#: the CPU for ResNetTiny in f32 (one step: logits, loss, parameters and
#: running statistics within atol + rtol); the two-rank run of ResNet-18
CONV_BATCH, CONV_IMAGE, CONV_STEPS, CONV_LR = 64, 224, 3, 0.1
CONV_TINY_BATCH, CONV_TINY_IMAGE, CONV_TINY_ATOL, CONV_TINY_RTOL = 8, 32, 1e-4, 1e-4
CONV_RANKS, CONV_RANK_BATCH = 2, 8
#: the two ranks share the card over the staged transport, as phase (h)'s
CONV_HOST_DEVICE, CONV_TRANSPORT = "cuda:0", "staged"
#: (k2) BERT-large with bf16 parameters under master_weights(AdamW) wrapped by
#: dynamic_loss_scale: 4 steps, the second through a probe scaler whose
#: initial scale (f32's largest) makes the scaled loss inf
KIT_STEPS, KIT_OVERFLOW_STEP = 4, 1
#: (k3) VGG-16 at published widths, two hosts, bf16, the link shaped after two
#: unshaped steps (the first with the init barriers): a rate at which a step's
#: 1-bit payloads (8.7 MB a host to each server) take ~1.1 s each way, longer
#: than a whole unshaped step (646-894 ms in PR 22 calls 1-2: at 20 MB/s the
#: wire's 437 ms hid under the host's work)
VGG_BATCH, VGG_UNSHAPED_STEPS, VGG_SHAPED_STEPS, VGG_LR = 32, 2, 3, 0.01
SHAPE_RATE_MBYTES_S, SHAPE_DELAY_MS = 8.0, 2.0
#: a server that takes the shaping knobs once its cue file holds them, for the
#: connections it accepts from then on (the reference reads them at accept)
SHAPE_CUE_SERVER = (
    "import json, os, sys, threading, time\n"
    "def watch(cue=sys.argv[1]):\n"
    "    while not os.path.exists(cue):\n"
    "        time.sleep(0.02)\n"
    "    with open(cue) as f:\n"
    "        os.environ.update(json.load(f))\n"
    "    open(f'{cue}.{os.getpid()}', 'w').close()\n"
    "threading.Thread(target=watch, daemon=True).start()\n"
    "from byteps_tpu_torch.server.server import run_server\n"
    "run_server()\n")


def _conv_data(n: int, image: int, seed: int) -> tuple:
    """NHWC images and labels as bench.py makes them (numpy ``seed``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, image, image, 3), dtype=np.float32)
    return x, rng.integers(0, 1000, n)


def _ce(model, batch):
    import torch

    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def _one_process(dev):
    """A host group of this process alone: the batch-statistics step's
    averages over it are the values themselves."""
    from byteps_tpu_torch.comm.mesh import Mesh

    return Mesh(0, 1, dev, "nccl" if dev.type == "cuda" else "gloo")


def _wait_files(paths: list, timeout: float, label: str) -> None:
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            fail(f"{label}: no {[p for p in paths if not os.path.exists(p)]} in {timeout:.0f} s")
        time.sleep(0.05)


def _check_tiny_conv_on_the_card(dev) -> float:
    """ResNetTiny in f32, one batch-statistics step on the card and on the
    CPU from the same weights and inputs: the largest difference of the
    logits, the loss, every parameter and running statistic after it."""
    import torch

    from byteps_tpu_torch.models.resnet import ResNetTiny
    from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step

    x, y = _conv_data(CONV_TINY_BATCH, CONV_TINY_IMAGE, 3)
    y = y % 10
    out = {}
    for where in ("cpu", dev):
        model = ResNetTiny(seed=0).to(where)
        with torch.no_grad():
            logits = model(torch.from_numpy(x).to(where)).cpu()
        opt = torch.optim.SGD(model.parameters(), lr=CONV_LR, momentum=0.9)
        step = build_batchnorm_data_parallel_step(_ce, model, opt,
                                                  mesh=_one_process(torch.device(where)))
        loss = step((torch.from_numpy(x).to(where), torch.from_numpy(y).to(where)))
        out[str(where)] = {"logits": logits, "loss": loss.reshape(1).cpu(),
                           **{k: v.detach().cpu() for k, v in model.state_dict().items()}}
    worst = 0.0
    cpu, card = out["cpu"], out[str(dev)]
    for k in cpu:
        diff = (card[k] - cpu[k]).abs()
        if not bool((diff <= CONV_TINY_ATOL + CONV_TINY_RTOL * cpu[k].abs()).all()):
            fail(f"conv (k1): ResNetTiny's {k} on the card is {float(diff.max()):.3g} from the "
                 f"CPU's (atol {CONV_TINY_ATOL}, rtol {CONV_TINY_RTOL})")
        worst = max(worst, float(diff.max()))
    return worst


def _train_resnet50(card: str, dev) -> dict:
    """(k1): ResNet-50 at 224x224, 1000 classes, bf16, batch CONV_BATCH,
    CONV_STEPS SGD-momentum steps through the batch-statistics step."""
    import torch

    from byteps_tpu_torch.models.resnet import ResNet50
    from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step

    model = ResNet50(dtype=torch.bfloat16, seed=0).to(dev)
    x, y = _conv_data(CONV_BATCH, CONV_IMAGE, 0)
    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    opt = torch.optim.SGD(model.parameters(), lr=CONV_LR, momentum=0.9)
    step = build_batchnorm_data_parallel_step(_ce, model, opt, mesh=_one_process(dev))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(CONV_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))  # a host read: the step has ended
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"conv (k1): ResNet-50's losses {losses}: not finite and falling")
    ms = sum(times[1:]) / (CONV_STEPS - 1) * 1e3
    out = {"losses": losses, "first_ms": times[0] * 1e3, "ms": ms,
           "samples_s": CONV_BATCH / ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"conv (k1): ResNet-50 224x224 bf16 batch {CONV_BATCH}, SGD momentum: losses "
          f"{[round(v, 4) for v in losses]}; {ms:.1f} ms a step over steps 2-{CONV_STEPS} "
          f"(first {times[0] * 1e3:.1f}), {out['samples_s']:.2f} samples/s, peak memory "
          f"{out['peak_gib']:.2f} GiB, on {card}", flush=True)
    return out


def conv_host(work: str) -> None:
    """One rank of (k1)'s two-rank host, under the port's launcher
    (``chip_smoke.py --conv-host <dir>``, BYTEPS_LOCAL_SIZE=2,
    BYTEPS_MESH_TRANSPORT=staged, no PS): ResNet-18 at 224x224 in bf16,
    CONV_RANK_BATCH images a rank, one batch-statistics step once
    <dir>/go-k1 exists.  Writes <dir>/conv.<rank>.pt: the running
    statistics its own batch made, and the averaged ones after the step."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.models.resnet import ResNet18
    from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step

    torch.backends.cudnn.allow_tf32 = False
    bps.init(device=os.environ["MP_HOST_DEVICE"] or None)
    mesh, rank = get_global_mesh(), bps.local_rank()
    model = ResNet18(dtype=torch.bfloat16, seed=0).to(bps.device())
    stats = [b for b in model.buffers() if b.is_floating_point()]
    own: list = []

    def loss_fn(m, batch):
        loss = _ce(m, batch)
        own[:] = [b.detach().cpu().clone() for b in stats]  # before the average
        return loss

    opt = torch.optim.SGD(model.parameters(), lr=CONV_LR, momentum=0.9)
    step = build_batchnorm_data_parallel_step(loss_fn, model, opt, mesh=mesh)
    x, y = _conv_data(CONV_RANKS * CONV_RANK_BATCH, CONV_IMAGE, 5)
    rows = slice(rank * CONV_RANK_BATCH, (rank + 1) * CONV_RANK_BATCH)
    batch = (torch.from_numpy(x[rows]).to(bps.device()), torch.from_numpy(y[rows]).to(bps.device()))
    _wait_files([os.path.join(work, "go-k1")], PHASE_STALL_S, "conv host")
    loss = float(step(batch))
    torch.save({"own": own, "mean": [b.detach().cpu() for b in stats], "loss": loss,
                "mesh": repr(mesh)}, os.path.join(work, f"conv.{rank}.pt"))
    torch.distributed.barrier()
    bps.shutdown()


def _check_conv_ranks(work: str) -> dict:
    """Both ranks' running statistics bitwise equal, and each the mean of
    the two ranks' own (f32: (a + b) / 2, exact in the halving)."""
    import torch

    r = [torch.load(os.path.join(work, f"conv.{i}.pt")) for i in range(CONV_RANKS)]
    for i, (m0, m1, a, b) in enumerate(zip(r[0]["mean"], r[1]["mean"], r[0]["own"],
                                           r[1]["own"])):
        if not torch.equal(m0, m1):
            fail(f"conv (k1): the ranks' running statistic {i} differs after the step")
        if not torch.equal(m0, (a + b) / 2):
            fail(f"conv (k1): running statistic {i} is not the mean of the ranks' own "
                 f"(max |diff| {float((m0 - (a + b) / 2).abs().max()):.3g})")
        if torch.equal(a, b):
            fail(f"conv (k1): the ranks' batches made the same statistic {i}")
    print(f"conv (k1): ResNet-18 on {CONV_RANKS} ranks of one card ({r[0]['mesh']}), "
          f"{CONV_RANK_BATCH} images a rank: {len(r[0]['mean'])} running statistics bitwise "
          f"equal on both ranks and the mean of their own; losses "
          f"{[round(x['loss'], 4) for x in r]}", flush=True)
    return {"losses": [x["loss"] for x in r]}


def _train_kit_bert(card: str, dev, main_ms: float) -> dict:
    """(k2): BERT-large (seq SEQ, 24 layers, flash, remat, batch BATCH) with
    bf16 parameters under master_weights(AdamW) and dynamic_loss_scale, the
    batches through ShardedDataset and prefetch_to_device; step
    KIT_OVERFLOW_STEP through a probe scaler whose scaled loss is inf."""
    import torch

    from byteps_tpu_torch.data import ShardedDataset, prefetch_to_device
    from byteps_tpu_torch.mixed_precision import dynamic_loss_scale, master_weights
    from byteps_tpu_torch.ops import flash_attention as fa

    cfg, model, _, _ = _bert(N_LAYERS_FULL)
    model.to(torch.bfloat16)
    mw = master_weights(model.parameters(),
                        lambda ms: torch.optim.AdamW(ms, lr=1e-4, weight_decay=1e-4))
    opt = dynamic_loss_scale(mw, init_scale=2.0 ** 15)
    probe = dynamic_loss_scale(mw, init_scale=float(torch.finfo(torch.float32).max))
    # the main path's sequences, an epoch a step (each a reshuffle of them):
    # the losses of one batch fall, as the main path's do
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int64)
    data = ShardedDataset((tokens, np.roll(tokens, -1, axis=1)), BATCH, seed=0,
                          worker_rank=0, num_workers=1)
    batches = prefetch_to_device((b for e in range(KIT_STEPS) for b in data.epoch(e)), size=2,
                                 device=dev)

    def state() -> list:
        """The parameters, the masters and AdamW's state, as tensors."""
        return [*model.parameters(), *mw.masters,
                *(v for s in mw.inner.state.values() for v in s.values() if torch.is_tensor(v))]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times, skipped = [], [], None
    for i, (tok, tgt) in enumerate(batches):
        scaler = probe if i == KIT_OVERFLOW_STEP else opt
        before = [t.detach().clone() for t in state()] if scaler is probe else None
        t0 = time.perf_counter()
        loss = model.loss(tok, tgt)
        (loss * scaler.scale).backward()
        stepped = scaler.step()
        scaler.zero_grad()
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t0)
        if scaler is probe:
            after = state()
            skipped = {"stepped": stepped, "scale": probe.scale,
                       "unchanged": len(after) == len(before) and all(
                           torch.equal(a, b) for a, b in zip(after, before))}
            del before, after
        elif not stepped:
            fail(f"kit (k2): step {i} overflowed at scale {opt.scale}")
    counts = dict(fa.launches)
    n = len(losses)
    want = {"flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
            "flash_bwd_dkv": cfg.n_layers * n}
    if n != KIT_STEPS or counts != want:
        fail(f"kit (k2): {n} steps launched {counts}, expected {want}")
    if skipped["stepped"] or not skipped["unchanged"]:
        fail(f"kit (k2): the overflowing step moved the model or its optimizer: {skipped}")
    if skipped["scale"] != float(torch.finfo(torch.float32).max) / 2:
        fail(f"kit (k2): the probe's scale is {skipped['scale']} after its overflow")
    real = [x for i, x in enumerate(losses) if i != KIT_OVERFLOW_STEP]
    if not all(math.isfinite(x) for x in real) or not real[-1] < real[0]:
        fail(f"kit (k2): losses {losses}: not finite and falling")
    ms = sum(times[KIT_OVERFLOW_STEP + 1:]) / (n - KIT_OVERFLOW_STEP - 1) * 1e3
    print(f"kit (k2): BERT-large bf16 parameters, f32 masters under AdamW, dynamic loss "
          f"scale {opt.scale:g} (growth interval {opt.growth_interval}), batches through "
          f"ShardedDataset + prefetch_to_device: losses {[round(x, 4) for x in losses]}; "
          f"step {KIT_OVERFLOW_STEP} overflowed at scale {float(torch.finfo(torch.float32).max):g} "
          f"and was skipped (parameters, masters and AdamW's state bitwise unchanged, the "
          f"scale halved to {skipped['scale']:g}); {ms:.1f} ms a step (the main path's "
          f"{main_ms:.1f}), launches {counts} over {n} steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}", flush=True)
    del model, mw, opt, probe
    return {name: counts[name] // n for name in counts}


def _vgg_step(model, opt, batch) -> float:
    opt.zero_grad()
    loss = _ce(model, batch)
    loss.backward()
    opt.step()
    return float(loss)


def vgg_host(work: str) -> None:
    """One host of (k3), under the port's launcher at BYTEPS_LOCAL_SIZE=1
    (``chip_smoke.py --vgg-host <dir>``): VGG-16 at 224x224 in bf16, batch
    VGG_BATCH, through two Python servers with bare onebit.  Host 0 saves a
    checkpoint and writes one shard; host 1 starts from zeros and takes host
    0's state through ``restore_and_broadcast``; BroadcastGlobalVariables,
    LearningRateWarmup and MetricAverage drive the steps over
    ``ShardedDataset``'s disjoint shards: VGG_UNSHAPED_STEPS on plain
    links, then (once both hosts and the servers took the shaping cue,
    the hosts through suspend and resume) VGG_SHAPED_STEPS on shaped ones.
    Writes <dir>/vgg.<host>.json."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import checkpoint
    from byteps_tpu_torch.callbacks import (BroadcastGlobalVariablesCallback,
                                            LearningRateWarmupCallback, MetricAverageCallback)
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.data import ShardedDataset, prefetch_to_device, shard_for_worker
    from byteps_tpu_torch.models.vgg import VGG16
    from byteps_tpu_torch.ops import onebit_device as ob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = int(os.environ["DMLC_WORKER_ID"])
    bps.init()
    dev = bps.device()
    model = VGG16(dtype=torch.bfloat16, image=CONV_IMAGE,
                  seed=0 if host == 0 else None).to(dev)
    steps = VGG_UNSHAPED_STEPS + VGG_SHAPED_STEPS
    n = bps.size() * VGG_BATCH * steps
    images, labels = _conv_data(n, CONV_IMAGE, 11)
    data = ShardedDataset((images, labels), VGG_BATCH, seed=1, worker_rank=bps.rank(),
                          num_workers=bps.size())
    _mark(work, f"vgg-ready.{host}", bps.rank())
    _await_mark(work, "go-k3", PHASE_STALL_S)
    out = {"host": host, "rank": bps.rank()}

    # startup: host 0's checkpoint, its state broadcast to host 1 from zeros
    t0 = time.perf_counter()
    ckpt, shard = os.path.join(work, "vgg16.pt"), os.path.join(work, "vgg16.dense_2.shard")
    if host == 0:
        checkpoint.save(ckpt, model.state_dict())
        out["shard_bytes"] = checkpoint.write_shard(
            shard, model.Dense_2.weight.detach().cpu().numpy().tobytes())
        _mark(work, "vgg-saved")
    else:
        with torch.no_grad():
            for t in model.state_dict().values():
                t.zero_()
        _await_mark(work, "vgg-saved", PHASE_STALL_S)
    root = _await_mark(work, "vgg-ready.0", 60)["value"]
    tree = checkpoint.restore_and_broadcast(ckpt, dict(model.state_dict()), root_rank=root)
    model.load_state_dict(tree)
    out["restored_digest"] = _param_digest(model)
    out["shard_is_host0s"] = (checkpoint.read_shard(shard)
                              == model.Dense_2.weight.detach().cpu().numpy().tobytes())
    out["startup_s"] = time.perf_counter() - t0

    opt = bps.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=VGG_LR, momentum=0.9),
                                   named_parameters=model.named_parameters(),
                                   compression_params={"compressor": "onebit", "scaling": True})
    BroadcastGlobalVariablesCallback(root_rank=root).on_train_begin(model.state_dict(), opt)
    warmup = LearningRateWarmupCallback(VGG_LR, warmup_epochs=steps)
    metric = MetricAverageCallback()
    out["steps"] = []

    def run(i: int, batch) -> dict:
        lr = warmup.apply(opt, i)
        ob.reset_launches()
        counters().reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _vgg_step(model, opt, batch)
        torch.cuda.synchronize()
        return {"loss": loss, "s": time.perf_counter() - t0, "lr": lr,
                "k4": ob.launches["onebit_pack"],
                "tx": counters().snapshot().get("wire_tx_bytes", 0),
                "digest": _param_digest(model)}

    batches = prefetch_to_device(data.epoch(0), size=2, device=dev)
    for i in range(VGG_UNSHAPED_STEPS):
        out["steps"].append({**run(i, next(batches)), "shaped": False})
    # the shaping cue: the servers take the knobs for the connections they
    # accept from now on; the hosts reconnect through suspend and resume
    _mark(work, f"vgg-unshaped.{host}")
    knobs = {"BYTEPS_VAN_RATE_MBYTES_S": str(SHAPE_RATE_MBYTES_S),
             "BYTEPS_VAN_DELAY_MS": str(SHAPE_DELAY_MS)}
    if host == 0:
        _await_mark(work, "vgg-unshaped.1", PHASE_STALL_S)
        cue = os.path.join(work, "shape-cue.json")
        with open(cue + ".tmp", "w") as f:
            json.dump(knobs, f)
        os.replace(cue + ".tmp", cue)
    deadline = time.monotonic() + 60
    while len(glob.glob(os.path.join(work, "shape-cue.json.*[0-9]"))) < 2:
        if time.monotonic() > deadline:
            fail(f"vgg host {host}: the servers did not take the shaping cue")
        time.sleep(0.02)
    os.environ.update(knobs)
    t0 = time.perf_counter()
    bps.suspend()
    bps.resume()
    out["reshape_s"] = time.perf_counter() - t0
    client = get_state().ps_client
    from byteps_tpu_torch.comm.shaping import ShapedSocket

    out["shaped_conns"] = [isinstance(sc.sock, ShapedSocket) for sc in client._servers]
    for i in range(VGG_UNSHAPED_STEPS, steps):
        out["steps"].append({**run(i, next(batches)), "shaped": True})
    table = get_state().engine.partition_table()
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    out["compressed_parts"] = sum(r["wire_nbytes"] is not None for r in grads)
    out["tx_by_server"] = {}
    for r in grads:
        sid = str(client.server_for(r["key"]))
        nbytes = r["wire_nbytes"] if r["wire_nbytes"] is not None else r["length"] * r["itemsize"]
        out["tx_by_server"][sid] = out["tx_by_server"].get(sid, 0) + nbytes
    out["metric"] = metric.on_epoch_end({"loss": out["steps"][-1]["loss"]})
    out["indices"] = shard_for_worker(n, bps.rank(), bps.size(), seed=data.seed).tolist()
    bps.shutdown()
    with open(os.path.join(work, f"vgg.{host}.json"), "w") as f:
        json.dump(out, f)


def _check_vgg(work: str, report: list) -> dict:
    """(k3)'s checks over the hosts' files and the servers' stop reports."""
    r = []
    for h in range(HYBRID_HOSTS):
        with open(os.path.join(work, f"vgg.{h}.json")) as f:
            r.append(json.load(f))
    label = "vgg (k3)"
    if r[0]["restored_digest"] != r[1]["restored_digest"]:
        fail(f"{label}: host 1's parameters after restore_and_broadcast are not host 0's")
    if not (r[0]["shard_is_host0s"] and r[1]["shard_is_host0s"]):
        fail(f"{label}: read_shard did not return host 0's bytes")
    if set(r[0]["indices"]) & set(r[1]["indices"]):
        fail(f"{label}: the hosts' ShardedDataset shards overlap")
    if r[0]["metric"] != r[1]["metric"]:
        fail(f"{label}: the averaged metric differs: {r[0]['metric']} {r[1]['metric']}")
    want = (r[0]["steps"][-1]["loss"] + r[1]["steps"][-1]["loss"]) / 2
    if abs(r[0]["metric"]["loss"] - want) > 1e-12 * max(1.0, abs(want)):
        fail(f"{label}: the averaged metric {r[0]['metric']} is not the hosts' mean {want}")
    for i, (a, b) in enumerate(zip(r[0]["steps"], r[1]["steps"])):
        if a["digest"] != b["digest"]:
            fail(f"{label}: the hosts' parameters differ after step {i}")
        if not (math.isfinite(a["loss"]) and math.isfinite(b["loss"])):
            fail(f"{label}: step {i}'s losses {a['loss']}, {b['loss']}")
    for x in r:
        if not all(x["shaped_conns"]):
            fail(f"{label}: host {x['host']}'s connections after the cue are not all shaped")
        for i, s in enumerate(x["steps"]):
            if s["k4"] != x["compressed_parts"]:
                fail(f"{label}: host {x['host']} step {i} launched K4 {s['k4']} times, "
                     f"VGG-16 has {x['compressed_parts']} partitions of at least 64 KiB")
            if s["tx"] != sum(x["tx_by_server"].values()):
                fail(f"{label}: host {x['host']} step {i} sent {s['tx']} bytes, its partition "
                     f"table says {sum(x['tx_by_server'].values())}")
    rate = SHAPE_RATE_MBYTES_S * 1e6
    shaped = [[s["s"] for s in x["steps"] if s["shaped"]][1:] for x in r]
    plain = [x["steps"][VGG_UNSHAPED_STEPS - 1]["s"] for x in r]
    bounds = [max(x["tx_by_server"].values()) / rate for x in r]
    for x, steps, bound in zip(r, shaped, bounds):
        if min(steps) < bound:
            fail(f"{label}: host {x['host']}'s shaped step {min(steps):.3f} s is under the "
                 f"wire's bound {bound:.3f} s")
    if any(v is None for v in report):
        fail(f"{label}: a server logged no stop report: {report}")
    print(f"vgg (k3): VGG-16 224x224 bf16, {VGG_BATCH} images a host, 2 hosts, 2 Python "
          f"servers, bare onebit: startup (host 0's checkpoint and shard, host 1 from zeros "
          f"through restore_and_broadcast) {r[0]['startup_s']:.1f} s, digests equal; losses "
          f"{[[round(s['loss'], 4) for s in x['steps']] for x in r]}, lr "
          f"{[s['lr'] for s in r[0]['steps']]}, averaged metric {r[0]['metric']}; K4 "
          f"{r[0]['compressed_parts']} launches a step (VGG-16's partitions >= 64 KiB); "
          f"bytes a step to each server {[x['tx_by_server'] for x in r]}", flush=True)
    print(f"vgg (k3): link shaped at {SHAPE_RATE_MBYTES_S:g} MB/s and {SHAPE_DELAY_MS:g} ms "
          f"(after the cue; reconnect {[round(x['reshape_s'], 2) for x in r]} s): a step "
          f"{[[round(v * 1e3, 1) for v in s] for s in shaped]} ms against the wire's bound "
          f"{[round(b * 1e3, 1) for b in bounds]} ms; unshaped step "
          f"{[round(v * 1e3, 1) for v in plain]} ms", flush=True)
    print("vgg (k3): " + "; ".join(_server_lines(report)), flush=True)
    return {"onebit_pack": r[0]["compressed_parts"]}


def train_kit(card: str, main_ms: float) -> dict:
    """Phase (k): the training kit and the conv models.  A two-rank host
    for (k1) and (k3)'s fleet (a scheduler, two Python servers that take
    the shaping knobs on a cue, two launcher hosts) start first and warm up
    while this process runs (k1) ResNetTiny on the card against the CPU
    and ResNet-50, and (k2) BERT-large in mixed precision; then the
    two-rank ResNet-18 step and (k3) VGG-16 through the PS, together.
    Returns the launches a step of K1-K3 in (k2) and of K4 in (k3)."""
    import torch

    import byteps_tpu_torch as bps

    with tempfile.TemporaryDirectory() as work:
        base = {**os.environ, "PYTHONPATH": REPO, "DMLC_ROLE": "worker",
                "DMLC_PS_ROOT_URI": "127.0.0.1"}
        for k in ("BYTEPS_JOB_ID", "BYTEPS_JOB_PRIORITY", "BYTEPS_JOB_QUOTA_MBPS",
                  "BYTEPS_VAN_RATE_MBYTES_S", "BYTEPS_VAN_RATE_MBPS", "BYTEPS_VAN_DELAY_MS",
                  "BYTEPS_FORCE_DISTRIBUTED"):
            base.pop(k, None)
        conv_log = os.path.join(work, "conv.log")
        with open(conv_log, "w") as log:
            conv = _track(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                 sys.executable, os.path.join(REPO, "chip_smoke.py"), "--conv-host", work],
                cwd=REPO, env={**base, "DMLC_NUM_WORKER": "1",
                               "BYTEPS_LOCAL_SIZE": str(CONV_RANKS),
                               "BYTEPS_MESH_TRANSPORT": CONV_TRANSPORT,
                               "MP_HOST_DEVICE": CONV_HOST_DEVICE},
                stdout=log, stderr=subprocess.STDOUT), "conv host", conv_log)
        vgg_env = {**base, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
                   "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_LOCAL_SIZE": "1"}
        port, fleet = _start_ps_processes(
            vgg_env, work, server_args=["-c", SHAPE_CUE_SERVER,
                                        os.path.join(work, "shape-cue.json")])
        hosts = []
        for h in range(HYBRID_HOSTS):
            path = os.path.join(work, f"vgg-host{h}.log")
            with open(path, "w") as log:
                hosts.append(_track(subprocess.Popen(
                    [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                     sys.executable, os.path.join(REPO, "chip_smoke.py"), "--vgg-host", work],
                    cwd=REPO, env={**vgg_env, "DMLC_PS_ROOT_PORT": port, "DMLC_WORKER_ID": str(h)},
                    stdout=log, stderr=subprocess.STDOUT), f"vgg host {h}", path))
        walls, t0 = {}, time.perf_counter()

        def lap(name: str) -> None:
            walls[name] = round(time.perf_counter() - t0 - sum(walls.values()), 1)

        try:
            bps.init()
            dev = bps.device()
            err = _check_tiny_conv_on_the_card(dev)
            print(f"conv (k1): ResNetTiny f32, one batch-statistics step on the card within "
                  f"{err:.3g} of the CPU's (logits, loss, parameters, running statistics)",
                  flush=True)
            _train_resnet50(card, dev)
            lap("k1 one process")
            gc.collect()
            torch.cuda.empty_cache()
            launches = _train_kit_bert(card, dev, main_ms)
            bps.shutdown()
            gc.collect()
            torch.cuda.empty_cache()
            lap("k2")
            # the two-rank step and (k3) together: each host has been
            # starting since the phase began, and their runs share nothing
            open(os.path.join(work, "go-k1"), "w").close()
            _mark(work, "go-k3")
            if conv.wait(timeout=PHASE_STALL_S) != 0:
                with open(conv_log) as f:
                    print(f.read()[-6000:], file=sys.stderr)
                fail(f"conv (k1): the two-rank host exited {conv.returncode}")
            _check_conv_ranks(work)
            lap("k1 two ranks")
            for h, proc in enumerate(hosts):
                if proc.wait(timeout=PHASE_STALL_S) != 0:
                    _fleet_tails("vgg (k3)", hosts)
                    fail(f"vgg (k3): host {h} exited {proc.returncode}")
            lap("k3 after the two ranks")
        finally:
            _stop_processes([conv, *hosts])
            _stop_processes(fleet)
        launches.update(_check_vgg(work, _server_report(work)))
        lap("k3 stop")
        print(f"kit (k): walls (s) {walls}", flush=True)
    return launches


def main_path_setup() -> str:
    """The settings every measured run starts from: f32 matmuls in full
    precision.  Prints and returns the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    return card


def main() -> None:
    import torch

    card = main_path_setup()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}", flush=True)

    walls = {}
    last = [time.perf_counter()]
    # a phase that runs past PHASE_STALL_S is hung: every thread's stack, the
    # servers' and schedulers' stacks and the fleet's logs go to stderr, and
    # the script exits non-zero, rather than spend the rest of its time
    # limit waiting
    watchdog = _Watchdog()
    watchdog.arm()

    def mark(name: str) -> None:
        # each phase's wall seconds, for the summary before the kernels line
        now = time.perf_counter()
        walls[name] = round(now - last[0], 1)
        last[0] = now
        watchdog.arm()
        gc.collect()
        torch.cuda.empty_cache()

    phase_build()
    errs = check_kernels()
    perf = time_kernels(BATCH, 16, SEQ, 64, torch.bfloat16, False)
    mark("build, flash checks and times")
    onebit_err = check_onebit()
    onebit_perf = time_onebit()
    check_f1_division()
    check_model()
    mark("onebit, F1, model")
    counts = train_main_path(card)
    mark("main path")
    dist = train_distributed(card)
    mark("distributed")
    train_distributed_native(card, dist["losses"][0])
    mark("native lanes")
    # phase (b)'s fleet and hosts come up while phase (a) runs
    heal_started = start_heal()
    try:
        planes = {"chaos": train_chaos(card, dist)}
        mark("faults (a)")
        planes["heal"] = train_heal(card, started=heal_started)
    finally:
        stop_hosts(heal_started)
    mark("heal (b)")
    planes["elastic"] = train_elastic(card)
    mark("elastic (c)")
    planes["reshard"] = train_reshard(card)
    mark("reshard (d)")
    planes["control"] = train_control(card)
    mark("control plane (e)")
    # phase (h)'s fleet and ranks come up while fusion, (f) and (g) run,
    # phase (g)'s while (f) runs, and phase (l)'s checkpoint is drawn meanwhile
    mp_started = start_model_parallel()
    hf_started = start_hf_gpt2()
    try:
        planes["fusion"] = train_fusion(card)
        mark("fusion")
        g_started = start_tenancy()
        try:
            planes.update(train_data_plane(card))
            mark("data plane (f)")
            planes["tenancy"] = train_tenancy(card, started=g_started)
        finally:
            stop_tenancy(g_started)
        mark("tenancy (g)")
        # phase (l) runs on the card while phase (i)'s host does
        model_parallel = train_model_parallel(
            card, after_h=lambda: mark("model parallel (h)"), started=mp_started,
            beside_i=lambda: train_hf_gpt2(card, started=hf_started))
    finally:
        stop_hf_gpt2(hf_started)
        stop_model_parallel(mp_started)
    mark("moe and generation (i), GPT-2 from HF (l)")
    hf_gpt2 = model_parallel["i"]["beside"]
    planes["observability"] = train_observability(card)
    mark("observability (j)")
    planes["server_opt"] = train_server_opt(card, dist["state_bytes"])
    mark("server optimizer")
    planes["async"] = train_async(card)
    mark("async")
    # the hybrid phase's fleet and hosts come up while the next three run
    hybrid_started = start_hybrid()
    try:
        train_compressed_chain(card, dist["wire_tx_step"])
        mark("compressed chain")
        train_device_codecs(card)
        check_device_codecs()
        mark("device codecs")
        train_randomk_ef(card)
        check_ddp_cross_barrier(card)
        mark("randomk, DDP, CrossBarrier")
        hybrid = train_hybrid(card, started=hybrid_started)
    finally:
        stop_hosts(hybrid_started)
    mark("hybrid")
    check_int8_ring_ops()
    check_step_builders(card)
    mark("int8 ops, step builders")
    planes["kit"] = train_kit(card, MAIN_PATH["step_ms"])
    mark("kit and conv models (k)")
    watchdog.cancel()
    print(f"phase walls (s): {json.dumps(walls)}; total {sum(walls.values()):.1f} s", flush=True)

    b = bounds(BATCH, 16, SEQ, 64, "bfloat16", False)
    replaces = {
        "flash_fwd": "byteps_tpu/ops/flash_attention.py:83",
        "flash_bwd_dq": "byteps_tpu/ops/flash_attention.py:197",
        "flash_bwd_dkv": "byteps_tpu/ops/flash_attention.py:237",
    }
    flops = bounds_flops(BATCH, 16, SEQ, 64, False)
    designs = {
        "flash_fwd": "bf16 dh=64: wgmma (QK^T from shared memory, PV with P from "
                     "registers) fed by TMA, warp-specialized, persistent, 2 blocks "
                     "per SM; bf16 dh=32 and dh=128: WMMA (mma.sync); f32: FMA",
        "flash_bwd_dq": "bf16 dh=64: wgmma (S = Q K^T and dP = dO V^T from shared memory, "
                        "dQ += dS K with dS from registers, K read K-major and MN-major) "
                        "fed by TMA, ring of 3 K/V stages one tile ahead, thread 0 issues, "
                        "128 query rows a block, 2 blocks per SM, a block per tile; bf16 "
                        "dh=32 and dh=128: WMMA (mma.sync); f32: FMA",
        "flash_bwd_dkv": "bf16 dh=64: wgmma (S^T = K Q^T and dP^T = V dO^T from shared "
                         "memory, dV += P^T dO and dK += dS^T Q with P^T and dS^T from "
                         "registers, Q and dO read K-major and MN-major) fed by TMA, "
                         "warp-specialized, 128 keys a block, 1 block per SM, persistent "
                         "when non-causal; bf16 dh=32 and dh=128: WMMA (mma.sync); f32: FMA",
    }
    kernels = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ms, plain_ms = perf["times"][name]
        extra = {}
        if name in designs:
            extra = {"tflops": flops[name] / ms / 1e9, "bound_share": b[name][0] / ms,
                     "design": designs[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "byteps_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[name][0], "bound_by": b[name][1],
            # one PyTorch call computes the forward (SDPA); none computes dQ
            # alone or dK/dV alone, so SDPA's whole backward is given beside
            "library_ms": perf["sdpa_fwd"] if name == "flash_fwd" else None,
            **({"sdpa_bwd_ms": perf["sdpa_bwd"][name]} if name in perf["sdpa_bwd"] else {}),
            "shape": f"B={BATCH} H=16 S={SEQ} dh=64 bf16 non-causal",
            "path": "single-worker main path",
            "hybrid_launches_a_step_per_host": hybrid["launches_a_step"][name],
            "plane_launches_a_step": {k: v[name] for k, v in planes.items()},
            "model_parallel_launches_a_step_per_rank": {
                run: [r[name] for r in ranks] for run, ranks in model_parallel["h"].items()},
            "moe_generation_launches": {
                "i1 a step": model_parallel["i"]["i1"]["launches"][name],
                "i2 a step per rank": [r[name] for r in model_parallel["i"]["i2"]]},
            "hf_gpt2_launches": {"l3 a step": hf_gpt2["l3 a step"][name],
                                 "l4 a generate call": {
                                     k: hf_gpt2[k]["launches"][name]
                                     for k in ("build_generate", "build_generate_cached")}},
            **extra,
        })
    kernels.append({
        "name": "onebit_pack", "route": "cuda",
        "source": "byteps_tpu_torch/ops/csrc/onebit.cu",
        "replaces": "byteps_tpu/ops/onebit_device.py:38",
        "launches": dist["onebit_launches"], "max_abs_err": onebit_err,
        "ms": onebit_perf["ms"], "plain_ms": onebit_perf["plain_ms"],
        "bound_ms": onebit_perf["bound_ms"], "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call packs sign bits
        "bound_share": onebit_perf["bound_ms"] / onebit_perf["ms"],
        "timing": "device time with L2 cold, median of 20 launches",
        "call_ms": onebit_perf["call_ms"], "profiler_ms": onebit_perf["profiler_ms"],
        "kernels_a_call": onebit_perf["kernels_a_call"],
        "shape": f"n={ONEBIT_TIMED_N} float32 (one partition)",
        "path": "distributed path (1 worker, 2 servers, onebit)",
        "hybrid_launches_a_step_per_host": hybrid["launches_a_step"]["onebit_pack"],
        "plane_launches_a_step": {k: v["onebit_pack"] for k, v in planes.items()},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] != [] and sys.argv[1].endswith("-host"):
        # a host under a launcher: a stalled phase asks for its stacks
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    if sys.argv[1:2] == ["--hybrid-host"]:
        hybrid_host(sys.argv[2])  # one host of the hybrid phase, under the launcher
    elif sys.argv[1:2] == ["--async-host"]:
        async_host(sys.argv[2])  # one host of the per-key async phase
    elif sys.argv[1:2] == ["--heal-host"]:
        heal_host(sys.argv[2])  # one host of the one-sided heal
    elif sys.argv[1:2] == ["--elastic-host"]:
        elastic_host(sys.argv[2])  # one host of phase (c), elastic membership
    elif sys.argv[1:2] == ["--control-host"]:
        control_host(sys.argv[2])  # one host of phase (e), the control plane
    elif sys.argv[1:2] == ["--rowsparse-host"]:
        rowsparse_host(sys.argv[2])  # one host of phase (f2), row-sparse
    elif sys.argv[1:2] == ["--tenant-host"]:
        tenant_host(sys.argv[2])  # one host of phase (g), job namespaces
    elif sys.argv[1:2] == ["--mp-host"]:
        mp_host(sys.argv[2])  # one rank of phase (h)'s host, model parallelism
    elif sys.argv[1:2] == ["--conv-host"]:
        conv_host(sys.argv[2])  # one rank of phase (k1)'s two-rank host
    elif sys.argv[1:2] == ["--vgg-host"]:
        vgg_host(sys.argv[2])  # one host of phase (k3), VGG-16 on a shaped link
    else:
        main()
