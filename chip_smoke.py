#!/usr/bin/env python3
"""Smoke test of byteps_tpu_torch on one NVIDIA GPU (built for the H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from byteps_tpu_torch/ops/csrc, one compiler process per
     source, all started together: flash attention (K1-K3) and the onebit packer
     (K4) with nvcc, the wire checksum with the host C compiler; print what
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
  5. agreement of a 2-layer BERT-large-width model on the card (kernels) with the
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
     device-to-host bytes and wire bytes are read around it and checked against
     the engine's partition table;
  8. one JSON line listing the kernels, then the contract line
     {"ok": true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# main path: BERT-large at seq 512, batch 32
BATCH, SEQ, STEPS, WARMUP = 32, 512, 5, 1
# distributed path: the same model, fewer timed steps (each crosses the servers)
DIST_STEPS, DIST_WARMUP = 3, 1

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
    from byteps_tpu_torch.comm import transport
    from byteps_tpu_torch.ops import _build, flash_attention, onebit_device

    sources = ("flash_attention", "onebit", "crc32c")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.build, name) for name in sources]:
            fut.result()
    flash_attention._lib()
    onebit_device._lib()
    if transport.crc32c(b"123456789") != 0xE3069283:
        fail("the wire checksum helper gives a wrong CRC32C")
    print(f"build: {', '.join(sources)} in parallel in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.1f} s" for n in sources)
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


def _cold_events_ms(launch, flush, iters: int = 20) -> list:
    """The device time of ``launch`` with the L2 cold, as the engine finds a
    gradient: before each launch a write of ``flush`` evicts the L2 and a
    device-side sleep lets the host enqueue the timed pair; CUDA events around
    the launch alone.  ``iters`` times (ms, sorted) after one warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(iters + 1):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
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
    # the push, encode the merged round for the pull (numpy, one thread)
    from byteps_tpu_torch.compression.impl import OneBitCompressor

    host = x.cpu().numpy()
    codec = OneBitCompressor(n, scaling=True)
    payload = codec.compress(host)
    host_ms = {}
    for label, fn in (("compress", lambda: codec.compress(host)),
                      ("decompress", lambda: codec.decompress(payload, n))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms[label] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"time onebit host codec n={n} (the servers' numpy codec, host CPU): compress "
          f"{host_ms['compress']:.3f} ms, decompress {host_ms['decompress']:.3f} ms",
          flush=True)
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


def profile_step(step, tok, tgt, step_ms: float) -> float:
    """One more step under torch.profiler: device time by kernel family and
    the device's busy share, of the profiled step's wall time and of
    ``step_ms``, the mean step time without the profiler.  Only the device's
    own events are summed (kernels, copies): a CPU operator's row carries
    the device time of the kernels it launched, and a user annotation
    (``Optimizer.step#...``) spans kernels; either would count them twice."""
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
        return loss
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
    return loss


def train_main_path(card: str) -> dict:
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import (
        Transformer, bert_large, build_train_step, init_params,
    )
    from byteps_tpu_torch.ops import flash_attention as fa

    bps.init()
    cfg = bert_large(max_seq=SEQ, compute_dtype=torch.bfloat16, remat=True, use_flash=True)
    t0 = time.perf_counter()
    model = Transformer(cfg)
    model.load_state_dict(params_from_jax(init_params(cfg, seed=0), cfg))
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
    )
    step = build_train_step(model, opt)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    tok = torch.as_tensor(tokens, device=bps.device()).long()
    tgt = torch.as_tensor(np.roll(tokens, -1, axis=1), device=bps.device()).long()
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
    losses.append(profile_step(step, tok, tgt, dt / STEPS * 1e3))
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


def _start_ps_processes(env: dict) -> tuple:
    """A scheduler and two servers of the port, as `python -m
    byteps_tpu_torch.server` processes; returns (scheduler port, processes)."""
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
    for _ in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.server"], cwd=REPO,
            env={**env, "DMLC_ROLE": "server", "DMLC_PS_ROOT_PORT": port},
            stdout=subprocess.DEVNULL,
        ))
    return port, procs


def train_distributed(card: str) -> int:
    """The distributed path: BERT-large as on the main path, one worker (this
    process) and two server processes behind a scheduler process, onebit with
    scaling on every float32 gradient of at least BYTEPS_MIN_COMPRESS_BYTES."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters
    from byteps_tpu_torch.models.convert import params_from_jax
    from byteps_tpu_torch.models.transformer import (
        Transformer, bert_large, build_train_step, init_params,
    )
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import onebit_device as ob

    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "DMLC_PS_ROOT_URI": "127.0.0.1",
           "BYTEPS_WIRE_CHECKSUM": "1", "PYTHONPATH": REPO}
    saved = dict(os.environ)
    port, procs = _start_ps_processes(env)
    try:
        os.environ.update({**env, "DMLC_PS_ROOT_PORT": port})
        t0 = time.perf_counter()
        bps.init()
        cfg = bert_large(max_seq=SEQ, compute_dtype=torch.bfloat16, remat=True,
                         use_flash=True)
        model = Transformer(cfg)
        model.load_state_dict(params_from_jax(init_params(cfg, seed=0), cfg))
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = bps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = build_train_step(model, opt)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
        tok = torch.as_tensor(tokens, device=bps.device()).long()
        tgt = torch.as_tensor(np.roll(tokens, -1, axis=1), device=bps.device()).long()
        print(f"distributed path: setup {time.perf_counter() - t0:.1f} s (scheduler "
              f"port {port}, 2 server processes)", flush=True)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ob.reset_launches()
        counters().reset()
        t0 = time.perf_counter()
        losses = [float(step(tok, tgt)) for _ in range(DIST_WARMUP)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        # the timed steps, split: forward + backward (the hooks submit each
        # gradient as backward produces it), then the wait for the last pulls,
        # then AdamW
        split = {"forward+backward": 0.0, "wait for pulls": 0.0, "optimizer": 0.0}
        t0 = time.perf_counter()
        for _ in range(DIST_STEPS):
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
        dt = time.perf_counter() - t0
        losses.append(profile_step(step, tok, tgt, dt / DIST_STEPS * 1e3))
        torch.cuda.synchronize()
        launches = {**fa.launches, **ob.launches}
        stats = counters().snapshot()
        table = get_state().engine.partition_table()
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
        dead = [p.args for p in procs if p.poll() is not None]
        if dead:
            fail(f"a PS process exited during the distributed path: {dead}")
        bps.shutdown()
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    n = DIST_WARMUP + DIST_STEPS + 1
    if not all(math.isfinite(x) for x in losses):
        fail(f"distributed path: non-finite loss: {losses}")
    # the gradients' partitions (broadcast_parameters also initialized the
    # parameters' own keys, before the counts were reset)
    grads = [r for r in table if r["name"].startswith("Gradient.")]
    compressed = [r for r in grads if r["wire_nbytes"] is not None]
    raw = [r for r in grads if r["wire_nbytes"] is None]
    want_d2h = (sum(r["wire_nbytes"] for r in compressed)
                + sum(r["length"] * r["itemsize"] for r in raw))
    raw_bytes = sum(r["length"] * r["itemsize"] for r in grads)
    if launches["onebit_pack"] != n * len(compressed):
        fail(f"distributed path: K4 launched {launches['onebit_pack']} times in {n} "
             f"steps, expected {len(compressed)} compressed partitions a step")
    want_flash = {"flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
                  "flash_bwd_dkv": cfg.n_layers * n}
    if {k: launches[k] for k in want_flash} != want_flash:
        fail(f"distributed path: flash launches {launches}, expected {want_flash}")
    if stats.get("d2h_bytes", 0) != n * want_d2h:
        fail(f"distributed path: {stats.get('d2h_bytes', 0) / n:.0f} bytes a step crossed "
             f"device to host, expected {want_d2h} (compressed payloads plus raw small "
             "tensors)")
    sps = BATCH * DIST_STEPS / dt
    print(f"distributed path: BERT-large seq {SEQ} bf16 remat flash, batch {BATCH}, 1 "
          f"worker + 2 server processes, onebit (scaling) on {len(compressed)} of "
          f"{len(grads)} gradient partitions: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"distributed path: {sps:.2f} samples/s ({dt / DIST_STEPS * 1e3:.1f} ms/step over "
          f"{DIST_STEPS} steps; first step {first_s:.1f} s with the init barriers), peak "
          f"memory {peak:.2f} GiB, on {card}", flush=True)
    print("distributed path: step split " + ", ".join(
        f"{k} {v / DIST_STEPS * 1e3:.1f} ms" for k, v in split.items())
        + f"; forward+backward with the engine idle {idle_fb * 1e3:.1f} ms; the engine "
        f"alone (every gradient pushed and pulled, no backward beside it) "
        f"{engine_alone * 1e3:.1f} ms", flush=True)
    print(f"distributed path: per step K4 launches {launches['onebit_pack'] // n} "
          f"(= compressed partitions {len(compressed)}), d2h_bytes {want_d2h} "
          f"(raw gradient {raw_bytes}, {raw_bytes / want_d2h:.1f}x more), wire_tx_bytes "
          f"{stats.get('wire_tx_bytes', 0) // n}, wire_rx_bytes "
          f"{stats.get('wire_rx_bytes', 0) // n}", flush=True)
    return launches["onebit_pack"]


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
    check_model()
    counts = train_main_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    onebit_launches = train_distributed(card)

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
            **extra,
        })
    kernels.append({
        "name": "onebit_pack", "route": "cuda",
        "source": "byteps_tpu_torch/ops/csrc/onebit.cu",
        "replaces": "byteps_tpu/ops/onebit_device.py:38",
        "launches": onebit_launches, "max_abs_err": onebit_err,
        "ms": onebit_perf["ms"], "plain_ms": onebit_perf["plain_ms"],
        "bound_ms": onebit_perf["bound_ms"], "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call packs sign bits
        "bound_share": onebit_perf["bound_ms"] / onebit_perf["ms"],
        "timing": "device time with L2 cold, median of 20 launches",
        "call_ms": onebit_perf["call_ms"], "profiler_ms": onebit_perf["profiler_ms"],
        "kernels_a_call": onebit_perf["kernels_a_call"],
        "shape": f"n={ONEBIT_TIMED_N} float32 (one partition)",
        "path": "distributed path (1 worker, 2 servers, onebit)",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
