"""The port's tracer (byteps_tpu_torch.core.tracing) against byteps_tpu's:
the same recorded events give the same files, window after window and at
the buffer's cap; the fused frame's span trailer is the reference's byte
for byte; traced workers of either package against servers of the other
(Python and C++ engines) leave child spans that ``tools/trace_merge.py``
joins with no orphan; a retry, driven on purpose, keeps its span; the
profiler writes the torch trace beside the host's; and F9, the identity
jump map."""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.comm import transport as ref_transport
from byteps_tpu.compression import rng as ref_rng
from byteps_tpu.core import tracing as ref_tracing
from byteps_tpu_torch.comm import transport as port_transport
from byteps_tpu_torch.compression import rng as port_rng
from byteps_tpu_torch.core import tracing as port_tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACERS = {"port": port_tracing, "ref": ref_tracing}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for mod in TRACERS.values():
        mod.set_process_tracer(None)
    yield from kits.reset_runtime(monkeypatch)
    for mod in TRACERS.values():
        mod.set_process_tracer(None)


# --- the tracer's files -------------------------------------------------------


def _record_window(tr, base: float) -> None:
    tr.record("grad.a", "PUSH", base, 0.25, step=3)
    tr.record("grad.a", "PULL", base + 0.5, 0.125, step=30)  # past the window
    tr.record_span("grad.a", "PUSH", base, 0.5,
                   TRACERS["port"].span_args(0x1234, 0x99, key=7, version=3))
    tr.record_span("key7", "sum", base + 0.1, 0.01,
                   TRACERS["port"].span_args(0x1234, 0x77, parent_id=0x99, dedupe=False))
    tr.record_instant("chaos", "chaos_drop", {"fault": "chaos_drop", "injected": True},
                      ts=base + 0.2)


def _windows(mod, out_dir: str) -> list:
    tr = mod.Tracer(enabled=True, start_step=2, end_step=20, trace_dir=out_dir, local_rank=0,
                    process_name="worker0")
    paths = []
    for w in range(2):
        _record_window(tr, 1000.0 + w)
        paths.append(tr.flush())
    assert tr.flush() == ""  # nothing since the last window
    tr.MAX_EVENTS = 3
    for i in range(5):
        tr.record_span("t", "PUSH", 2000.0 + i, 0.5, mod.span_args(5, 6 + i))
    paths.append(tr.flush())
    return [(os.path.relpath(p, out_dir), json.load(open(p))) for p in paths]


def test_tracer_windows_equal_the_reference(tmp_path):
    """Envelopes inside the step window only, spans and instants, the same
    file names window after window (comm.json, comm.2.json, ...) and the
    same drop count past MAX_EVENTS."""
    port = _windows(port_tracing, str(tmp_path / "port"))
    ref = _windows(ref_tracing, str(tmp_path / "ref"))
    assert port == ref
    assert [p for p, _ in port] == ["0/comm.json", "0/comm.2.json", "0/comm.3.json"]
    assert port[2][1]["otherData"] == {"dropped_events": 2}
    assert [e["name"] for e in port[0][1]["traceEvents"]] == ["PUSH", "PUSH", "sum", "chaos_drop"]
    assert port_tracing.Tracer.MAX_EVENTS == ref_tracing.Tracer.MAX_EVENTS


def test_a_disabled_tracer_and_the_spans_gate(tmp_path):
    for mod in TRACERS.values():
        off = mod.Tracer(enabled=False, trace_dir=str(tmp_path))
        _record_window(off, 0.0)
        assert off.pending_events() == 0 and off.flush() == ""
        env_only = mod.Tracer(enabled=True, start_step=0, trace_dir=str(tmp_path),
                              spans_enabled=False)
        _record_window(env_only, 0.0)
        assert env_only.pending_events() == 1  # the envelope inside the window


def test_ids_args_and_the_stage_timer(monkeypatch, tmp_path):
    for _ in range(50):
        tid = port_tracing.new_trace_id()
        assert tid & 1 and 0 < tid < 1 << 63
    assert (port_tracing.span_args(10, 11, 12, key=1)
            == ref_tracing.span_args(10, 11, 12, key=1)
            == {"trace": "a", "span": "b", "parent": "c", "key": 1})
    assert port_tracing.span_args(10, 11) == ref_tracing.span_args(10, 11)
    clock = iter([5.0, 5.5, 5.0, 5.5])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    events = []
    for mod in TRACERS.values():
        tr = mod.Tracer(enabled=True, start_step=0, trace_dir=str(tmp_path))
        with mod.StageTimer(tr, "w", "COPYD2H", 1):
            pass
        events.append(tr._events)
    assert events[0] == events[1] == [{"name": "COPYD2H", "cat": "comm", "ph": "X",
                                       "ts": 5e6, "dur": 5e5, "pid": "w", "tid": "COPYD2H"}]


# --- the fused frame's span trailer -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_frames_with_span_ids_are_the_references(seed):
    rng = np.random.default_rng(seed)
    members = [(int(rng.integers(1, 1 << 40)), int(rng.integers(0, 1 << 20)),
                int(rng.integers(1, 100)), rng.bytes(int(rng.integers(0, 300))))
               for _ in range(int(rng.integers(1, 9)))]
    spans = [int(rng.integers(1, 1 << 62)) * 2 + 1 for _ in members]
    port = port_transport.encode_fused_push(members, span_ids=spans)
    assert port == ref_transport.encode_fused_push(members, span_ids=spans)
    assert port_transport.decode_fused_spans(port) == spans
    assert port_transport.decode_fused_push(port) == ref_transport.decode_fused_push(port)
    bare = port_transport.encode_fused_push(members)
    assert bare == ref_transport.encode_fused_push(members)
    assert port_transport.decode_fused_spans(bare) is None
    for mod in (port_transport, ref_transport):
        with pytest.raises(ValueError):
            mod.encode_fused_push(members, span_ids=spans + [3])


# --- spans across packages ------------------------------------------------------


TRACE_ENV = {"BYTEPS_TRACE_ON": "1", "BYTEPS_TRACE_START_STEP": "0",
             "BYTEPS_TRACE_END_STEP": "100", "BYTEPS_PARTITION_BYTES": "4096",
             "BYTEPS_FUSION_THRESHOLD": "1024"}


def _events(trace_dir: str) -> list:
    out = []
    for path in glob.glob(os.path.join(trace_dir, "**", "comm*.json"), recursive=True):
        out.extend(json.load(open(path))["traceEvents"])
    return out


def _merge(trace_dir: str, tmp_path) -> dict:
    """tools/trace_merge.py run as a tool: its merged file's counts and the
    critical path's engines."""
    merged, attrib = tmp_path / "merged.json", tmp_path / "attrib.json"
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "trace_merge.py"),
                          "-o", str(merged), "--critical-path", str(attrib), trace_dir],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    meta = json.load(open(merged))["otherData"]
    return {**meta, "engines": sorted(json.load(open(attrib))["engines"])}


def _check_spans(events: list) -> None:
    """Every server child shares its parent's trace (a fused member's the
    pack's: the frame carries one trace block); every worker PUSH and PULL
    span and every FUSED_RPC has server children."""
    spans = [e for e in events if e.get("cat") == "span" and e["ph"] == "X"]
    owners = {}
    for e in spans:
        if "parent" not in e["args"]:
            owners.setdefault(e["args"]["span"], set()).add((e["args"]["trace"], e["name"]))
    packs = {e["args"]["trace"] for e in spans if e["name"] == "FUSED_RPC"}
    kids = {}
    for e in spans:
        if "parent" in e["args"]:
            parent = e["args"]["parent"]
            assert parent in owners, e
            traces = packs if e["args"].get("fused") else {t for t, _ in owners[parent]}
            assert e["args"]["trace"] in traces, e
            assert e["pid"].startswith("server"), e
            kids.setdefault(parent, []).append(e)
    for span, names in owners.items():
        if {"PUSH", "PULL", "FUSED_RPC"} & {n for _, n in names}:
            assert kids.get(span), (span, names)
    fused = [e for e in spans if e["name"] == "FUSED_RPC"]
    assert fused, "no fused frame was traced"
    assert any(k.get("args", {}).get("fused") for ks in kids.values() for k in ks)


@pytest.mark.parametrize("worker,server", [("port", "ref"), ("ref", "port"),
                                           ("ref", "port-native")])
def test_spans_join_across_packages(monkeypatch, tmp_path, worker, server):
    """A traced worker of one package, two servers of the other: the
    servers' recv/sum/publish/reply children carry the worker's trace id
    with its span as parent, fused members under their own spans, and the
    merge counts no orphan."""
    trace_dir = str(tmp_path / "trace")
    wk = kits.kit(worker)
    big = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    small = np.arange(64, dtype=np.float32)
    with kits.fleet(monkeypatch, server, **TRACE_ENV, BYTEPS_TRACE_DIR=trace_dir) as nodes:
        kits.init(wk)
        for step in range(2):
            handles = [wk.api.push_pull_async(kits.tensor(wk, big * (step + 1)), name="g.big",
                                              average=False),
                       wk.api.push_pull_async(kits.tensor(wk, small), name="g.small",
                                              average=False)]
            outs = [np.asarray(wk.api.synchronize(h)) for h in handles]
            np.testing.assert_array_equal(outs[0], big * (step + 1))
            np.testing.assert_array_equal(outs[1], small)
        wk.api.shutdown()
        ranks = sorted(n.rank for n in nodes)
    assert ranks == [0, 1]
    events = _events(trace_dir)
    assert {e["pid"] for e in events if e.get("cat") == "span"} == {"worker0", "server0",
                                                                   "server1"}
    _check_spans(events)
    native = [e for e in events if e.get("args", {}).get("engine") == "native"]
    assert bool(native) == server.endswith("native")
    assert all(e["tid"].startswith(("stripe", "key")) for e in native)
    meta = _merge(trace_dir, tmp_path)
    assert meta["orphaned_spans"] == 0 and meta["linked_spans"] > 0
    assert meta["engines"] == (["native"] if server.endswith("native") else ["python"])


def _window_run(pkg: str, monkeypatch, trace_dir: str, spans: str) -> tuple:
    k = kits.kit(pkg)
    with kits.fleet(monkeypatch, pkg, servers=2, **{
            **TRACE_ENV, "BYTEPS_TRACE_START_STEP": "2", "BYTEPS_TRACE_END_STEP": "3",
            "BYTEPS_TRACE_SPANS": spans, "BYTEPS_TRACE_DIR": trace_dir}):
        kits.init(k)
        for step in range(4):
            k.api.push_pull(kits.tensor(k, np.full(3000, step, np.float32)), name="g.w",
                            average=False)
        k.api.shutdown()
    events = _events(trace_dir)
    envelopes = sorted((e["pid"], e["name"]) for e in events if e["cat"] == "comm")
    return envelopes, sum(e["cat"] == "span" for e in events)


@pytest.mark.parametrize("spans", ["1", "0"])
def test_the_step_window_and_the_spans_gate_through_init(monkeypatch, tmp_path, spans):
    """BYTEPS_TRACE_START_STEP=2, _END_STEP=3: a tensor's stage envelopes
    of its second and third push_pulls only, as in the reference;
    BYTEPS_TRACE_SPANS=0 keeps them and drops every span."""
    port = _window_run("port", monkeypatch, str(tmp_path / "port"), spans)
    ref = _window_run("ref", monkeypatch, str(tmp_path / "ref"), spans)
    assert port[0] == ref[0]
    assert len(port[0]) == 2 * 3 * 4  # 2 steps x 3 partitions x 4 stages
    assert (port[1] > 0, ref[1] > 0) == (spans == "1", spans == "1")


@pytest.mark.parametrize("op", ["PUSH", "FUSED"])
def test_a_retried_frame_keeps_its_span(monkeypatch, tmp_path, op):
    """The first PUSH (or FUSED) frame of the process is dropped on purpose
    (the chaos van at probability 1 with a budget of one fault, whatever
    the connections' order); the deadline sends it again under the same
    span, the fault is an instant on that span, and the server sums it
    once, under that span."""
    trace_dir = str(tmp_path / "trace")
    k = kits.kit("port")
    x = np.arange(64, dtype=np.float32)
    extra = {**TRACE_ENV, "BYTEPS_TRACE_DIR": trace_dir, "BYTEPS_VAN": "chaos:tcp",
             "BYTEPS_CHAOS_DROP": "1", "BYTEPS_CHAOS_OPS": op,
             "BYTEPS_CHAOS_FAULT_BUDGET": "1", "BYTEPS_RPC_DEADLINE_S": "0.5"}
    if op == "PUSH":
        extra["BYTEPS_FUSION_THRESHOLD"] = "0"
    with kits.fleet(monkeypatch, "port", servers=1, **extra):
        k.chaos.reset_fault_budget(None)
        k.counters().reset()
        kits.init(k)
        np.testing.assert_array_equal(k.api.push_pull(kits.tensor(k, x), name="g.r",
                                                      average=False).numpy(), x)
        k.api.shutdown()
    assert k.counters().get("chaos_drop") == 1 and k.counters().get("rpc_retry") >= 1
    events = _events(trace_dir)
    drop = [e for e in events if e["name"] == "chaos_drop"]
    assert len(drop) == 1 and drop[0]["args"]["injected"] is True
    span = drop[0]["args"]["span"]
    spans = [e for e in events if e.get("cat") == "span" and e["ph"] == "X"]
    owner = [e for e in spans if e["args"].get("span") == span and "parent" not in e["args"]]
    assert {e["name"] for e in owner} == ({"PUSH", "COPYD2H", "PULL", "COPYH2D"}
                                          if op == "PUSH" else {"FUSED_RPC"})
    kids = [e for e in spans if e["args"].get("parent") == span]
    if op == "PUSH":
        # the push's recv, sum, publish (one worker closes the round) and
        # reply, the pull's recv and reply
        assert sorted(e["name"] for e in kids) == ["publish", "recv", "recv", "reply",
                                                   "reply", "sum"]
        assert [e["args"]["dedupe"] for e in kids if e["name"] == "sum"] == [False]
    else:
        assert [e["name"] for e in kids] == ["recv"]
        sums = [e for e in spans if e["name"] == "sum"]
        assert len(sums) == 1 and sums[0]["args"]["fused"] is True
    assert _merge(trace_dir, tmp_path)["orphaned_spans"] == 0


# --- the profiler -------------------------------------------------------------


def test_the_profiler_writes_both_traces_into_one_directory(monkeypatch, tmp_path):
    """A window under ``profiler.trace(dir)``: the torch profiler's Chrome
    trace and the host tracer's comm.json land in ``dir``; a second
    window takes the next names; ``annotate`` names a region."""
    from byteps_tpu_torch import profiler

    k = kits.kit("port")
    prof_dir = str(tmp_path / "prof")
    with kits.fleet(monkeypatch, "port", servers=1, **TRACE_ENV,
                    BYTEPS_TRACE_DIR=str(tmp_path / "trace")):
        kits.init(k)
        x = kits.tensor(k, np.ones(2000, np.float32))
        k.api.push_pull(x, name="g.p", average=False)
        for _ in range(2):
            with profiler.trace(prof_dir) as prof:
                with profiler.annotate("bps.step"):
                    k.api.push_pull(x, name="g.p", average=False)
            assert any(e.key == "bps.step" for e in prof.key_averages())
        k.api.shutdown()
    assert sorted(os.listdir(prof_dir)) == ["0", "torch_trace.2.json", "torch_trace.json"]
    assert sorted(os.listdir(os.path.join(prof_dir, "0"))) == ["comm.2.json", "comm.json"]
    torch_events = json.load(open(os.path.join(prof_dir, "torch_trace.json")))["traceEvents"]
    assert any(e.get("name") == "bps.step" for e in torch_events)
    host = json.load(open(os.path.join(prof_dir, "0", "comm.json")))["traceEvents"]
    assert {"PUSH", "PULL"} <= {e["name"] for e in host}


# --- F9 -----------------------------------------------------------------------


def test_f9_the_jump_of_zero_steps_is_the_identity():
    """``_jump_map(0)`` is the identity, cached, where the reference returns
    None (the sixteenth deliberate divergence); no draw changes."""
    m = port_rng._jump_map(0)
    assert m is not None and port_rng._jump_map(0) is m
    for s0, s1 in ((1, 2), (0xDEADBEEF, 0x12345678ABCDEF), (port_rng.DEFAULT_S0,
                                                            port_rng.DEFAULT_S1)):
        assert port_rng._apply_map(m, s0, s1) == (s0, s1)
    assert ref_rng._jump_map(0) is None
    for n in (0, 1, 4095, 4096, 9000):
        a = port_rng.XorShift128Plus(11, 22)
        b = ref_rng.XorShift128Plus(11, 22)
        np.testing.assert_array_equal(a.fill(n), b.fill(n))
        assert (int(a.s0), int(a.s1)) == (int(b.s0), int(b.s1))
