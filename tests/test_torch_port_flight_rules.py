"""The port's flight-recorder triggers (byteps_tpu_torch.core.flightrec)
against byteps_tpu's: each of the seven node rules gives the reference's
verdict and evidence on the same synthetic records; the knobs are read as
the reference reads them; a firing writes the reference's bundle, which
``tools/bps_doctor.py`` diagnoses alike; and an uploaded bundle reaches
the scheduler's flight directory in both packages."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.core import flightrec as ref_fr
from byteps_tpu.core import telemetry as ref_tel
from byteps_tpu.core import tracing as ref_tracing
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.core import flightrec as port_fr
from byteps_tpu_torch.core import telemetry as port_tel
from byteps_tpu_torch.core import tracing as port_tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (port_tel, port_fr, port_tracing, PortConfig),
        "ref": (ref_tel, ref_fr, ref_tracing, RefConfig)}
KNOBS = ("BYTEPS_FLIGHT_DIR", "BYTEPS_FLIGHT_BUNDLE_S", "BYTEPS_FLIGHT_STALL_S",
         "BYTEPS_FLIGHT_SLOW_FACTOR", "BYTEPS_FLIGHT_UPLOAD", "BYTEPS_JOB_SLO_S",
         "BYTEPS_FLIGHT_STEPS", "BYTEPS_TRACE_DIR")


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for tel, fr, tr, _cfg in PKGS.values():
        fr.set_process_recorder(None)
        tr.set_process_tracer(None)
        tel.metrics().reset()
        tel.counters().reset()
    yield from kits.reset_runtime(monkeypatch)
    for _tel, fr, tr, _cfg in PKGS.values():
        fr.set_process_recorder(None)
        tr.set_process_tracer(None)


def _recorder(pkg: str, **kw):
    tel, fr, _tr, _cfg = PKGS[pkg]
    reg = tel.MetricsRegistry()
    return fr.FlightRecorder(registry=reg, counter_store=reg.counters, **kw)


# --- the seven rules -----------------------------------------------------------

RPC = {"0": {"n": 3, "s": 0.004, "p99": 0.0012}, "2": {"n": 2, "s": 0.003, "p99": 0.0011}}
STRIPES = {"0": {"n": 5, "s": 0.004, "p99": 0.001}, "1": {"n": 4, "s": 0.005, "p99": 0.002}}

#: rule -> [(durations seen before, record, fires?)]
CASES = {
    "slow_step": [
        ([0.1] * 8, {"dur": 0.9}, True),
        ([0.1] * 8, {"dur": 0.25}, False),
        ([0.1] * 3, {"dur": 5.0}, False),  # too little history
        ([0.1] * 8, {"dur": None}, False),  # a server's beat
        ([0.0] * 8, {"dur": 1.0}, False),
    ],
    "straggler_server": [
        ([], {"rpc": {**RPC, "1": {"n": 3, "s": 0.1, "p99": 0.04, "retry": 2}}}, True),
        ([], {"rpc": {**RPC, "1": {"n": 3, "s": 0.01, "p99": 0.0015}}}, False),
        ([], {"rpc": {"0": RPC["0"], "?": {"n": 9, "s": 1.0, "p99": 5.0}}}, False),
        ([], {"rpc": {**RPC, "1": {"n": 0, "s": 0.0, "p99": 0.0, "giveup": 1}}}, False),
        # loopback noise: the floor at the first bucket keeps it quiet
        ([], {"rpc": {"0": {"n": 1, "s": 1e-5, "p99": 1e-5},
                      "1": {"n": 1, "s": 2e-4, "p99": 2e-4}}}, False),
    ],
    "hot_stripe": [
        ([], {"stripes": {**STRIPES, "2": {"n": 6, "s": 0.08, "p99": 0.05}}}, True),
        ([], {"stripes": {**STRIPES, "2": {"n": 6, "s": 0.006, "p99": 0.05}}}, False),
        ([], {"stripes": {"0": STRIPES["0"]}}, False),
    ],
    "queue_stall": [
        ([], {"stages": {"PUSH": {"n": 2, "s": 9.0, "p99": 6.0},
                         "PULL": {"n": 1, "s": 8.0, "p99": 7.5}}}, True),
        ([], {"stages": {"PUSH": {"n": 2, "s": 1.0, "p99": 4.9}}}, False),
        ([], {"stages": {"PUSH": {"n": 0, "s": 0.0, "p99": 9.0}}}, False),
    ],
    "slo_breach": [
        ([], {"dur": 0.7, "job": 3}, True),
        ([], {"dur": 0.4, "job": 3}, False),
        ([], {"dur": None}, False),
    ],
    "corruption_storm": [
        ([], {"events": {"wire_checksum_fail": 2, "native_checksum_fail": 1,
                         "chaos_payload_corrupt": 3}}, True),
        ([], {"events": {"wire_checksum_fail": 1, "native_checksum_fail": 1}}, False),
        ([], {"events": {"native_checksum_conn_drop": 1}}, True),
        ([], {"events": {}}, False),
    ],
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_gives_the_references_verdict(monkeypatch, rule):
    monkeypatch.setenv("BYTEPS_JOB_SLO_S", "0.5")
    for durs, record, fires in CASES[rule]:
        verdicts = []
        for pkg in PKGS:
            rec = _recorder(pkg, capacity=16)
            rec._durs.extend(durs)
            fn = dict(PKGS[pkg][1]._RULES)[rule]
            verdicts.append(fn(rec, copy.deepcopy(record)))
        assert verdicts[0] == verdicts[1], (rule, record)
        assert (verdicts[0] is not None) == fires, (rule, record, verdicts[0])
    assert [r for r, _ in port_fr._RULES] == [r for r, _ in ref_fr._RULES]


def test_the_degraded_flip_follows_the_references_sequence():
    seq = [1, 0, 1, 1, 0, 0, 1]
    out = {}
    for pkg in PKGS:
        rec = _recorder(pkg, capacity=16)
        fn = dict(PKGS[pkg][1]._RULES)["degraded_flip"]
        out[pkg] = [fn(rec, {"deg": d, "incarnation": i}) for i, d in enumerate(seq)]
    assert out["port"] == out["ref"]
    assert [v is not None for v in out["port"]] == [False, False, True, False, False,
                                                   False, True]


def test_the_slo_rule_is_off_without_the_knob():
    for pkg in PKGS:
        rec = _recorder(pkg, capacity=4)
        assert rec.slo_s == 0.0
        assert dict(PKGS[pkg][1]._RULES)["slo_breach"](rec, {"dur": 99.0}) is None


# --- the knobs -------------------------------------------------------------------


@pytest.mark.parametrize("with_cfg", [False, True])
def test_the_knobs_are_read_as_the_reference_reads_them(monkeypatch, tmp_path, with_cfg):
    """BYTEPS_FLIGHT_DIR (else <BYTEPS_TRACE_DIR>/flight_bundles),
    _BUNDLE_S, _STALL_S, _SLOW_FACTOR, _UPLOAD, _STEPS and BYTEPS_JOB_SLO_S,
    from the environment and from a config snapshot."""
    settings = [{}, {"BYTEPS_FLIGHT_DIR": str(tmp_path / "fd"), "BYTEPS_FLIGHT_BUNDLE_S": "0",
                     "BYTEPS_FLIGHT_STALL_S": "0.25", "BYTEPS_FLIGHT_SLOW_FACTOR": "2",
                     "BYTEPS_FLIGHT_UPLOAD": "yes", "BYTEPS_JOB_SLO_S": "1.5",
                     "BYTEPS_FLIGHT_STEPS": "0"},
                {"BYTEPS_TRACE_DIR": str(tmp_path / "td"), "BYTEPS_FLIGHT_UPLOAD": "off",
                 "BYTEPS_FLIGHT_SLOW_FACTOR": "1.0", "BYTEPS_JOB_SLO_S": "-2"}]
    attrs = ("capacity", "slow_factor", "stall_s", "bundle_dir", "bundle_interval_s",
             "upload", "slo_s", "enabled")
    for env in settings:
        for knob in KNOBS:
            monkeypatch.delenv(knob, raising=False)
        for knob, v in env.items():
            monkeypatch.setenv(knob, v)
        seen = []
        for pkg in PKGS:
            cfg = PKGS[pkg][3].from_env() if with_cfg else None
            rec = PKGS[pkg][1].FlightRecorder(cfg=cfg)
            seen.append({a: getattr(rec, a) for a in attrs})
        assert seen[0] == seen[1], env


# --- bundles ---------------------------------------------------------------------


def _fire(pkg: str, out_dir: str, upload: bool) -> tuple:
    """A recorder of ``pkg`` with a tracer on, through steps that breach a
    0.5 s SLO twice and make server 1 a straggler: (recorder, registry)."""
    tel, fr, tr, cfg_cls = PKGS[pkg]
    reg = tel.MetricsRegistry()
    tracer = tr.Tracer(enabled=True, start_step=0, trace_dir=os.path.join(out_dir, "trace"))
    rec = fr.FlightRecorder(context_fn=lambda: {"epoch": 2, "job": 4}, registry=reg,
                            counter_store=reg.counters, tracer=tracer, capacity=32)
    rec.bundle_dir = os.path.join(out_dir, "bundles")
    rec.slo_s, rec.upload = 0.5, upload
    rng = np.random.default_rng(5)
    for i, dur in enumerate([0.2, 0.3, 0.7, 0.25, 0.9]):
        tracer.record_span("t", "PUSH", 100.0 + i, 0.1, tr.span_args(7, 9 + 2 * i))
        for server, scale in (("0", 0.001), ("1", 0.2 if i == 4 else 0.001), ("2", 0.001)):
            for v in rng.exponential(scale, 5):
                reg.observe("rpc_round_trip_seconds", float(v), labels={"server": server})
        reg.counters.bump("wire_tx_bytes", 1000 * (i + 1))
        rec.record_step(dur)
    return rec, reg


def _strip(obj):
    """Wall times, pids and bundle paths out of a bundle's JSON."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("t", "time", "pid", "bundle", "flushed_to")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _doctor(bundle: str) -> list:
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "bps_doctor.py"), "--json",
                          bundle], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def test_a_firing_writes_the_references_bundle(tmp_path):
    """slo_breach fires twice (the second counted, not written: one bundle
    a rule a BYTEPS_FLIGHT_BUNDLE_S), straggler_server once; each bundle
    holds the reference's five files, equal but for times and paths, and
    bps_doctor draws the same diagnoses from either package's."""
    runs = {pkg: _fire(pkg, str(tmp_path / pkg), upload=False) for pkg in PKGS}
    bundles = {}
    for pkg, (rec, reg) in runs.items():
        assert [os.path.basename(p).split("-")[3] for p in rec.bundles_written] == [
            "slo_breach", "straggler_server"]
        assert reg.snapshot()["counters_labeled"]["flight_trigger"] == {
            '{rule="slo_breach"}': 2, '{rule="straggler_server"}': 1}
        assert reg.counters.snapshot()["flight_bundle"] == 2
        assert rec.take_uploads() == []
        bundles[pkg] = rec.bundles_written
    for port_b, ref_b in zip(bundles["port"], bundles["ref"]):
        assert sorted(os.listdir(port_b)) == sorted(os.listdir(ref_b)) == [
            "config.json", "ledger.jsonl", "metrics.json", "trace_window.json", "trigger.json"]
        for name in ("trigger.json", "metrics.json"):
            assert _strip(json.load(open(os.path.join(port_b, name)))) == _strip(
                json.load(open(os.path.join(ref_b, name)))), name
        ledgers = [[_strip(json.loads(line)) for line in open(os.path.join(b, "ledger.jsonl"))]
                   for b in (port_b, ref_b)]
        assert ledgers[0] == ledgers[1]
        cfgs = [json.load(open(os.path.join(b, "config.json"))) for b in (port_b, ref_b)]
        assert cfgs[0] == cfgs[1]
        flushed = json.load(open(os.path.join(port_b, "trace_window.json")))["flushed_to"]
        assert os.path.basename(flushed).startswith("comm")
        assert _doctor(port_b) == _doctor(ref_b)
    assert {f["rule"] for f in _doctor(bundles["port"][0])} >= {"slo_breach"}
    assert runs["port"][0].snapshot()[-1]["trig"] == ["straggler_server", "slo_breach"]


def test_uploads_are_taken_and_given_back(tmp_path):
    ups = {}
    for pkg in PKGS:
        rec, _reg = _fire(pkg, str(tmp_path / pkg), upload=True)
        first = rec.take_uploads()
        assert rec.take_uploads() == []
        rec.requeue_uploads(first * 5)  # a heartbeat outage: eight kept
        again = rec.take_uploads()
        assert len(first) == 2 and len(again) == 8
        ups[pkg] = _strip(first)
    assert ups["port"] == ups["ref"]
    assert [u["rule"] for u in ups["port"]] == ["slo_breach", "straggler_server"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_an_upload_reaches_the_schedulers_flight_dir(monkeypatch, tmp_path, pkg):
    """BYTEPS_FLIGHT_UPLOAD with BYTEPS_JOB_SLO_S under any step: the
    worker's slo_breach bundle rides a heartbeat to the scheduler, which
    writes it under its BYTEPS_FLIGHT_DIR (``flight_bundle_rx``)."""
    k = kits.kit(pkg)
    flight_dir = str(tmp_path / "flight")
    with kits.fleet(monkeypatch, pkg, servers=1, BYTEPS_HEARTBEAT_INTERVAL="0.1",
                    BYTEPS_FLIGHT_UPLOAD="1", BYTEPS_JOB_SLO_S="0.000001",
                    BYTEPS_FLIGHT_DIR=flight_dir) as nodes:
        PKGS[pkg][1].set_process_recorder(None)  # the worker's, not the server's
        kits.init(k)
        k.api.push_pull(kits.tensor(k, np.ones(256, np.float32)), name="g.u", average=False)
        rx = nodes.sched.metrics_agg.counters
        assert kits.wait(lambda: rx.get("flight_bundle_rx") >= 1)
        k.api.shutdown()
    # an earlier test's series in the process's registry may fire other
    # rules beside: their uploads land too
    stored = [d for d in os.listdir(flight_dir)
              if ("-worker0-" in d or "-server0-" in d) and d.endswith("-slo_breach")]
    assert stored
    trig = json.load(open(os.path.join(flight_dir, stored[0], "trigger.json")))
    assert trig["rule"] == "slo_breach" and trig["evidence"]["slo_s"] == 1e-6
    local = [d for d in os.listdir(flight_dir) if d.endswith(f"-slo_breach-{os.getpid()}")]
    assert local  # the node's own bundle, beside
