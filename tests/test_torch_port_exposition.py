"""The port's Prometheus exposition (byteps_tpu_torch.core.telemetry)
against byteps_tpu's: the same observations render byte-equal text and
equal snapshots; the windowed push/pull speed; the endpoint with its
taken-port fallback, as ``tools/bps_top.py`` reads it; and the endpoints a
worker (``BYTEPS_METRICS_PORT``, ``BYTEPS_TELEMETRY_ON``), a server and the
scheduler's cluster aggregate serve, in both packages."""

import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.core import telemetry as ref_tel
from byteps_tpu_torch.core import telemetry as tel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TELS = {"port": tel, "ref": ref_tel}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for mod in TELS.values():
        mod.metrics().reset()
        mod.counters().reset()
    yield from kits.reset_runtime(monkeypatch)
    for mod in TELS.values():
        mod.metrics().reset()
        mod.counters().reset()


def _observe(reg, seed: int) -> None:
    """Counters flat and labeled, set and sampled gauges, labeled
    histograms over three bucket tables: the same for either package."""
    rng = np.random.default_rng(seed)
    mod = tel if isinstance(reg, tel.MetricsRegistry) else ref_tel
    for name in ("rpc_retry", "wire_tx_bytes", "fused_frames"):
        reg.counters.bump(name, int(rng.integers(1, 1000)))
    for server in ("0", "1", "10"):
        reg.counters.bump("rpc_retry", int(rng.integers(1, 9)), labels={"server": server})
    reg.counters.bump("wire_checksum_fail", 2, labels={"side": "server", "op": "PUSH"})
    reg.gauge_set("control_plane_degraded", 0)
    reg.gauge_set("server_owned_keys", 12, labels={"rank": "1"})
    reg.gauge_set("server_owned_keys", 7, labels={"rank": "0"})
    reg.gauge_fn("pushpull_mbps", lambda: 123.5)
    reg.gauge_fn("broken", lambda: 1 / 0)  # left out, never a failed render
    for stage in ("PUSH", "PULL", "COPYD2H"):
        for v in rng.exponential(0.01, 40):
            reg.observe("stage_dwell_seconds", float(v), labels={"stage": stage})
    for v in rng.exponential(0.003, 30):
        reg.observe("rpc_round_trip_seconds", float(v), labels={"server": "1", "job": "2"})
    for v in rng.integers(1, 300, 20):
        reg.observe("fused_pack_keys", float(v), buckets=mod.COUNT_BUCKETS)
    for v in rng.uniform(0.0, 2.0, 20):
        reg.observe("compression_ratio", float(v), buckets=mod.RATIO_BUCKETS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_exposition_is_byte_equal_to_the_references(seed):
    port, ref = tel.MetricsRegistry(), ref_tel.MetricsRegistry()
    _observe(port, seed)
    _observe(ref, seed)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert port.render_prometheus(prefix="x_") == ref.render_prometheus(prefix="x_")
    assert "byteps_rpc_retry_labeled_total{server=\"10\"}" in text
    assert "byteps_stage_dwell_seconds_bucket{le=\"+Inf\",stage=\"PUSH\"} 40" in text
    assert "broken" not in text
    assert port.snapshot() == ref.snapshot()
    assert tel.MetricsRegistry().render_prometheus() == "\n"


def test_the_push_pull_speed_is_the_references(monkeypatch):
    """The same byte counts at the same instants give the same MB/s, the
    window forgets what is older than 10 s, and an off meter reads 0."""
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    speeds = []
    for mod in TELS.values():
        now[0] = 100.0
        s = mod.PushPullSpeed(enabled=True)
        out = [s.mbps()]
        for nbytes in (4_000_000, 1_000_000, 2_500_000):
            s.record(nbytes)
            now[0] += 0.5
            out.append(s.mbps())
        now[0] += 20.0
        out.append(s.mbps())
        off = mod.PushPullSpeed(enabled=False)
        off.record(10 ** 9)
        out.append(off.mbps())
        speeds.append(out)
    assert speeds[0] == speeds[1]
    assert speeds[0][1] > 0 and speeds[0][-2] == 0.0 and speeds[0][-1] == 0.0
    assert tel.WINDOW_SEC == ref_tel.WINDOW_SEC


def _scrape(port: int) -> str:
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()


def test_the_endpoint_and_its_fallback(caplog):
    """Port 0 binds an ephemeral port; a taken port falls back to one and
    says so; a render that raises answers 500; bps_top parses the text."""
    reg = tel.MetricsRegistry()
    _observe(reg, 3)
    srv = tel.serve_metrics(0, reg.render_prometheus, host="127.0.0.1")
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        assert srv.port > 0 and _scrape(srv.port) == reg.render_prometheus()
        from byteps_tpu_torch.common import logging as bpslog

        bpslog.logger.propagate = True
        try:
            with caplog.at_level("WARNING", logger="byteps_tpu_torch"):
                other = tel.MetricsHTTPServer(taken.getsockname()[1], lambda: "x 1\n",
                                              host="127.0.0.1")
        finally:
            bpslog.logger.propagate = False
        assert other.port not in (0, taken.getsockname()[1])
        assert "in use; serving metrics on" in caplog.text
        assert _scrape(other.port) == "x 1\n"
        other.close()
        bad = tel.MetricsHTTPServer(0, lambda: 1 / 0, host="127.0.0.1")
        with pytest.raises(urllib.error.HTTPError, match="500"):
            _scrape(bad.port)
        bad.close()
        res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "bps_top.py"),
                              "--once", f"127.0.0.1:{srv.port}"],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        assert "unreachable" not in res.stdout and "PUSH" in res.stdout
    finally:
        srv.close()
        taken.close()


def _free_port() -> int:
    """A port that was free a moment ago: a clash only takes the endpoint's
    fallback (the tests read the port it bound)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_fleets_endpoints(monkeypatch, pkg):
    """BYTEPS_METRICS_PORT on the worker, the servers and the scheduler;
    BYTEPS_TELEMETRY_ON on the worker: the worker's text has the round
    trips, the stage dwell and a nonzero push/pull speed, the scheduler's
    aggregate the nodes' series under {role, rank}, each server its sums."""
    k = kits.kit(pkg)
    monkeypatch.setenv("BYTEPS_METRICS_PORT", str(_free_port()))
    with kits.fleet(monkeypatch, pkg, servers=2, BYTEPS_HEARTBEAT_INTERVAL="0.1",
                    BYTEPS_TELEMETRY_ON="1", BYTEPS_PARTITION_BYTES="4096") as nodes:
        kits.init(k)
        st = k.state.get_state()
        x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
        for _ in range(2):
            k.api.push_pull(kits.tensor(k, x), name="g.m", average=False)
        assert k.api.get_pushpull_speed() > 0
        worker = _scrape(st.metrics_http.port)
        servers = [_scrape(n._metrics_http.port) for n in nodes]
        ports = {st.metrics_http.port, *[n._metrics_http.port for n in nodes]}
        sched_port = nodes.sched._metrics_http.port
        assert kits.wait(lambda: 'role="worker"' in _scrape(sched_port))
        agg = _scrape(sched_port)
        text = k.api.get_metrics_text()
        top = subprocess.run([sys.executable, os.path.join(REPO, "tools", "bps_top.py"),
                              "--once", f"127.0.0.1:{st.metrics_http.port}",
                              f"127.0.0.1:{sched_port}"],
                             capture_output=True, text=True, timeout=60)
        k.api.shutdown()
    for body in (worker, text):
        assert "byteps_rpc_round_trip_seconds_bucket" in body
        assert "byteps_stage_dwell_seconds_p99" in body
        assert "byteps_pushpull_mbps" in body
    assert all("byteps_server_sum_seconds_count" in s for s in servers)
    assert 'byteps_wire_tx_bytes_labeled_total{rank="0",role="worker"}' in agg
    assert len(ports) == 3 and sched_port not in ports  # one took the port, the rest fell back
    assert top.returncode == 0 and "unreachable" not in top.stdout, top.stdout + top.stderr


def test_without_the_telemetry_knob_the_speed_reads_zero(monkeypatch):
    k = kits.kit("port")
    with kits.fleet(monkeypatch, "port", servers=1):
        kits.init(k)
        k.api.push_pull(kits.tensor(k, np.ones(100, np.float32)), name="g.z")
        assert k.api.get_pushpull_speed() == 0.0
        assert k.state.get_state().metrics_http is None
        k.api.shutdown()
