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
     (BYTEPS_NATIVE_CLIENT=1), 6 timed steps, and each half alone for 3, the
     first step's loss bitwise the Python lanes';
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
     BERT-large at full depth, 16 sequences a host, through
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
 15. one JSON line listing the kernels, then the contract line
     {"ok": true, "device": {...}} last.

`python3 chip_smoke.py --hybrid-host <dir>` is phase 12's host, which the
launcher runs; it is not run by hand.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# main path: BERT-large at seq 512, batch 32
BATCH, SEQ, STEPS, WARMUP = 32, 512, 5, 1
N_LAYERS_FULL = 24
# distributed path: the same model, fewer timed steps (each crosses the servers)
DIST_STEPS, DIST_WARMUP = 3, 1
# the distributed path on the native lanes (both halves C++), and each half alone
NATIVE_STEPS, NATIVE_HALF_STEPS = 6, 3
#: the compressed partitions of BERT-large's gradient (onebit, >= 64 KiB)
#: and the bytes one worker moves a step, from the distributed path's table
DIST_COMPRESSED_PARTS, DIST_D2H_STEP = 495, 46_524_348

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
    print(f"main path: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}: "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"main path: {sps:.2f} samples/s ({dt / STEPS * 1e3:.1f} ms/step over {STEPS} "
          f"steps), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"on {card}", flush=True)
    print(f"main path: launches {counts}", flush=True)
    return counts


def _start_ps_processes(env: dict, log_dir: str, server_env: dict = None) -> tuple:
    """A scheduler and two servers of the port, as `python -m
    byteps_tpu_torch.server` processes (the servers with ``server_env``
    added), each server's stderr in a file of ``log_dir``; returns
    (scheduler port, processes)."""
    procs = []
    sched = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"], cwd=REPO,
        env={**env, "DMLC_ROLE": "scheduler", "DMLC_PS_ROOT_PORT": "0"},
        stdout=subprocess.PIPE, text=True,
    )
    procs.append(sched)
    line = sched.stdout.readline().strip()
    if not line.startswith("BYTEPS_SCHEDULER_PORT="):
        for p in procs:
            p.kill()
        fail(f"the scheduler process did not report its port (got {line!r})")
    port = line.split("=", 1)[1]
    for i in range(2):
        with open(os.path.join(log_dir, f"server{i}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"], cwd=REPO,
                env={**env, **(server_env or {}), "DMLC_ROLE": "server",
                     "DMLC_PS_ROOT_PORT": port},
                stdout=subprocess.DEVNULL, stderr=log,
            ))
    return port, procs


def _stop_processes(procs) -> None:
    """The launcher's stop, with 30 s a process: a server logs its summed
    pushes and rounds and its histograms (``_server_report``) as it stops."""
    from byteps_tpu_torch.launcher.launch import stop_processes

    stop_processes(procs, timeout=30)


@contextlib.contextmanager
def _ps_fleet(label: str, server_env: dict = None, worker_env: dict = None):
    """A scheduler and two server processes (with ``server_env``) for one
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
        fleet = types.SimpleNamespace(log_dir=log_dir, report=None)
        port, procs = _start_ps_processes(env, log_dir, server_env)
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


def _bert(n_layers: int, batch: int = BATCH, **overrides):
    """BERT-large (seq SEQ, bf16, remat, flash, unless ``overrides`` say
    otherwise) at ``n_layers`` on the bound device, with the weights of
    ``init_params(seed=0)``, and the main path's tokens (numpy seed 0) cut
    to ``batch``: (cfg, model, tokens, targets)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import Transformer, bert_large, init_params

    cfg = dataclasses.replace(bert_large(max_seq=SEQ, compute_dtype=torch.bfloat16, remat=True,
                                         use_flash=True), n_layers=n_layers, **overrides)
    if n_layers not in _WEIGHTS:
        _WEIGHTS[n_layers] = params_from_jax(init_params(cfg, seed=0), cfg)
    model = Transformer(cfg)
    model.load_state_dict(_WEIGHTS[n_layers])
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
            for name, h in sorted(hists.items())]


def _server_report(log_dir: str) -> list:
    """Each server's (pushes summed, rounds published, {histogram: (count,
    sum s, p50 s, p99 s)}), from the two lines a server logs when it stops
    (None for a server that logged none)."""
    import re

    found = []
    for i in range(2):
        with open(os.path.join(log_dir, f"server{i}.log")) as f:
            text = f.read()
        m = re.findall(r"summed (\d+) pushes into (\d+) rounds", text)
        hists = {name: tuple(float(v) for v in vals) for name, *vals in re.findall(
            r"(\w+_seconds) count=(\d+) sum=([\d.e+-]+) p50=([\d.e+-]+) p99=([\d.e+-]+)",
            text)}
        found.append((*(int(v) for v in m[-1]), hists) if m else None)
    return found


def _server_lines(report: list) -> list:
    return [f"server {i}: summed {r[0]} pushes into {r[1]} rounds; "
            + "; ".join(f"{name} count {int(c)}, sum {s * 1e3:.1f} ms, p50 {p50 * 1e3:.3f} ms, "
                        f"p99 {p99 * 1e3:.3f} ms" for name, (c, s, p50, p99) in r[2].items())
            for i, r in enumerate(report) if r is not None]


def _run_distributed(card: str, label: str, steps: int, server_native: bool = False,
                     client_native: bool = False) -> dict:
    """BERT-large as on the main path through one worker (this process) and
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
    launches; returns what it measured."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters, metrics
    from byteps_tpu_torch.models.transformer import build_train_step
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    wall = time.perf_counter()
    with _ps_fleet(label, {"BYTEPS_SERVER_NATIVE": "1"} if server_native else None,
                   {"BYTEPS_NATIVE_CLIENT": "1"} if client_native else None) as fleet:
        t0 = time.perf_counter()
        bps.init()
        cfg, model, tok, tgt = _bert(N_LAYERS_FULL)
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
        table = get_state().engine.partition_table()
        tapped = next(r for r in table if r["key"] == tap["key"])
        tap.update(length=tapped["length"],
                   kwargs=dict(get_registry().get(tapped["name"]).kwargs))
        peak = torch.cuda.max_memory_allocated() / 2**30
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
    if len(compressed) != DIST_COMPRESSED_PARTS or want_d2h != DIST_D2H_STEP:
        bad.append(f"the partition table: {len(compressed)} compressed partitions, "
                   f"{want_d2h} bytes a step, expected {DIST_COMPRESSED_PARTS} and "
                   f"{DIST_D2H_STEP}")
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
    print(f"{label}: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}, 1 worker "
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
    return {"losses": losses, "onebit_launches": launches["onebit_pack"],
            "wire_tx_step": stats.get("wire_tx_bytes", 0) // n, "step_ms": dt / steps * 1e3}


def train_distributed(card: str) -> dict:
    """The distributed path on the Python lanes: the servers' data plane
    and the worker's client in Python."""
    return _run_distributed(card, "distributed path", DIST_STEPS)


def train_distributed_native(card: str, python_first_loss: float) -> None:
    """The distributed path on the native lanes: both servers' data plane
    in C++ (BYTEPS_SERVER_NATIVE=1) and the worker's client lanes
    (BYTEPS_NATIVE_CLIENT=1), 6 timed steps; then each half alone, 3
    timed steps each: the C++ servers with the Python client, the Python
    servers with the native client.  The first step's loss (same weights,
    same tokens, no update yet) must be bitwise the Python-lane run's."""
    runs = {}
    for label, steps, server, client in (
            ("native lanes", NATIVE_STEPS, True, True),
            ("native server, Python client", NATIVE_HALF_STEPS, True, False),
            ("Python server, native client", NATIVE_HALF_STEPS, False, True)):
        gc.collect()
        runs[label] = _run_distributed(card, label, steps, server_native=server,
                                       client_native=client)
    bad = {label: r["losses"][0] for label, r in runs.items()
           if r["losses"][0] != python_first_loss}
    if bad:
        fail(f"native lanes: first-step losses {bad} differ from the Python lanes' "
             f"{python_first_loss!r}")
    print("native lanes: first-step loss bitwise the Python lanes' "
          f"({python_first_loss!r}) in all three runs; ms a step: "
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
# six timed steps: with two workers the servers re-sign the sum of two 1-bit
# payloads, so each partition's pull carries the signs of the host whose scale
# is the larger (checked bitwise on one partition: _check_server_rounds), and
# the global loss of the first five steps did not fall yet (10.8149 to 10.8204
# on an NVIDIA H100 80GB HBM3, 700 W)
HYBRID_WARMUP, HYBRID_STEPS = 1, 6
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
    BERT-large at full depth through DistributedOptimizer(AdamW) with bare
    onebit.  Writes what it measured to <dir>/host<h>.json and its onebit
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

    # BERT-large at full depth, this host's 16 of the main path's 32 sequences
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, tok, tgt = _bert(N_LAYERS_FULL)
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


def train_hybrid(card: str) -> dict:
    """The hybrid path: a scheduler and two servers of the port, and two
    hosts, each `python -m byteps_tpu_torch.launcher.launch` at
    BYTEPS_LOCAL_SIZE=1 on this card (NCCL refuses two ranks of one group on
    one GPU, so each host's group is one process), DMLC_NUM_WORKER=2: the
    port's first run with two workers, real sums on the servers.  Checks the
    hosts' one-rank NCCL collectives, the 2-layer equivalence with one
    process on the combined batch, and BERT-large at full depth: falling
    losses, both hosts' parameters bitwise equal, bytes against the
    partition table, K1-K4 launched, two pushes summed into every round."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.transformer import build_train_step

    label = "hybrid"
    wall = time.perf_counter()
    env = {**os.environ, "DMLC_NUM_WORKER": str(HYBRID_HOSTS), "DMLC_NUM_SERVER": "2",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO,
           "BYTEPS_LOCAL_SIZE": "1", "DMLC_ROLE": "worker"}
    env.pop("BYTEPS_FORCE_DISTRIBUTED", None)
    results = []
    with tempfile.TemporaryDirectory() as work:
        port, procs = _start_ps_processes(env, work)
        hosts = []
        try:
            for h in range(HYBRID_HOSTS):
                with open(os.path.join(work, f"host{h}.log"), "w") as log:
                    hosts.append(subprocess.Popen(
                        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--",
                         sys.executable, os.path.join(REPO, "chip_smoke.py"),
                         "--hybrid-host", work],
                        cwd=REPO, env={**env, "DMLC_PS_ROOT_PORT": port,
                                       "DMLC_WORKER_ID": str(h)},
                        stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + 420
            while any(p.poll() is None for p in hosts) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in hosts):
                    break
                time.sleep(0.5)
            rcs = [p.poll() for p in hosts]
        finally:
            _stop_processes(hosts)
            _stop_processes(procs)
        logs = {}
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.log")) as f:
                logs[h] = f.read()
        if rcs != [0] * HYBRID_HOSTS:
            for h, text in logs.items():
                print(f"--- hybrid host {h} (exit {rcs[h]}):\n{text[-6000:]}", file=sys.stderr)
            fail(f"{label}: the hosts exited {rcs}")
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.json")) as f:
                results.append(json.load(f))
        pushes = _server_report(work)
        eq_params = torch.load(os.path.join(work, "eq_params.pt"))
        taps = []
        for h in range(HYBRID_HOSTS):
            with open(os.path.join(work, f"host{h}.rounds.pkl"), "rb") as f:
                taps.append(pickle.load(f))
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
    want_flash = {"flash_fwd": 2 * N_LAYERS_FULL * n, "flash_bwd_dq": N_LAYERS_FULL * n,
                  "flash_bwd_dkv": N_LAYERS_FULL * n}
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
          f"full-depth parameters bitwise equal {a['digest'] == b['digest']}; phase wall "
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
    for r in results:
        h, c = r["host"], r["counters"]
        if r["compressed_parts"] != DIST_COMPRESSED_PARTS or r["want_d2h"] != DIST_D2H_STEP:
            bad.append(f"host {h}'s partition table: {r['compressed_parts']} compressed "
                       f"partitions, {r['want_d2h']} bytes a step, expected "
                       f"{DIST_COMPRESSED_PARTS} and {DIST_D2H_STEP}")
        bad += [f"host {h} {k} {c.get(k, 0) / n:.0f} a step, expected {DIST_D2H_STEP}"
                for k in ("d2h_bytes", "wire_tx_bytes", "wire_rx_bytes")
                if c.get(k, 0) != n * DIST_D2H_STEP]
        if r["launches"]["onebit_pack"] != n * DIST_COMPRESSED_PARTS:
            bad.append(f"host {h} launched K4 {r['launches']['onebit_pack']} times in {n} "
                       f"steps, expected {DIST_COMPRESSED_PARTS} a step")
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

    phase_build()
    errs = check_kernels()
    perf = time_kernels(BATCH, 16, SEQ, 64, torch.bfloat16, False)
    onebit_err = check_onebit()
    onebit_perf = time_onebit()
    check_f1_division()
    check_model()
    counts = train_main_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    dist = train_distributed(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_distributed_native(card, dist["losses"][0])
    gc.collect()
    torch.cuda.empty_cache()
    train_compressed_chain(card, dist["wire_tx_step"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_device_codecs(card)
    check_device_codecs()
    print(f"device codec phases: wall {time.perf_counter() - t0:.1f} s", flush=True)
    train_randomk_ef(card)
    check_ddp_cross_barrier(card)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = train_hybrid(card)
    check_int8_ring_ops()
    check_step_builders(card)

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
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hybrid-host"]:
        hybrid_host(sys.argv[2])  # one host of the hybrid phase, under the launcher
    else:
        main()
