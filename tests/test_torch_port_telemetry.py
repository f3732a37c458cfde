"""The port's stage timers (byteps_tpu_torch.core.telemetry) against
byteps_tpu's: ``Histogram``'s buckets and percentiles for the same numpy
observations, the registry's provider seam, and the histograms one
push_pull leaves in each package's registry (names, label sets, counts)
through an in-process fleet of its own package."""

import contextlib
import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.core import telemetry as ref_tel
from byteps_tpu.server.server import PSServer as RefServer
import byteps_tpu_torch as pbps
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core import telemetry as tel
from byteps_tpu_torch.server.server import PSServer as PortServer

PART_BYTES = 4096  # 1024 float32 elements a partition: 3000 elements are 3


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    tel.metrics().reset()
    ref_tel.metrics().reset()
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()
    tel.metrics().reset()
    ref_tel.metrics().reset()


def test_bucket_tables_equal_the_reference():
    for name in ("LATENCY_BUCKETS", "SIZE_BUCKETS", "COUNT_BUCKETS", "RATIO_BUCKETS"):
        assert getattr(tel, name) == getattr(ref_tel, name), name


@pytest.mark.parametrize("buckets", ["LATENCY_BUCKETS", "SIZE_BUCKETS", "COUNT_BUCKETS",
                                     "RATIO_BUCKETS"])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_buckets_and_percentiles_equal_the_reference(buckets, seed):
    """Log-uniform observations over the table's range, values equal to
    the bounds and past the last one included."""
    bounds = getattr(tel, buckets)
    rng = np.random.default_rng(seed)
    lo, hi = np.log(bounds[0] / 4), np.log(bounds[-1] * 4)
    values = list(np.exp(rng.uniform(lo, hi, 500))) + list(bounds) + [0.0]
    port, ref = tel.Histogram("h", bounds), ref_tel.Histogram("h", bounds)
    for v in values:
        port.observe(float(v))
        ref.observe(float(v))
    assert port.snapshot() == ref.snapshot()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port.percentile(q) == ref.percentile(q), q
    assert tel.Histogram("e").percentile(0.5) == ref_tel.Histogram("e").percentile(0.5) == 0.0


def test_registry_snapshot_and_providers_equal_the_reference():
    """Labelled observations, a provider (raw records, as the native lanes
    give them) folded in above its reset baseline, and absorbed."""
    rng = np.random.default_rng(3)
    rec = {"name": "native_rpc_round_trip_seconds", "labels": {},
           "le": list(tel.LATENCY_BUCKETS), "b": [0] * (len(tel.LATENCY_BUCKETS) + 1),
           "sum": 0.0, "count": 0}
    regs = [tel.MetricsRegistry(), ref_tel.MetricsRegistry()]
    feed = [dict(rec, b=list(rec["b"])) for _ in regs]
    providers = [lambda f=f: [f] if f["count"] else [] for f in feed]
    for reg, fn in zip(regs, providers):
        reg.register_hist_provider(fn)

    def observe(values):
        for v in values:
            for reg, f in zip(regs, feed):
                reg.observe("stage_dwell_seconds", v, labels={"stage": "PUSH"})
                i = int(np.searchsorted(tel.LATENCY_BUCKETS, v, side="left"))
                f["b"][i] += 1
                f["sum"] += v
                f["count"] += 1

    observe(rng.exponential(0.01, 50))
    for reg in regs:
        reg.reset()  # local histograms dropped, the provider re-baselined
    observe(rng.exponential(0.01, 70))
    snaps = [r.snapshot()["histograms"] for r in regs]
    assert snaps[0] == snaps[1]
    assert snaps[0]["native_rpc_round_trip_seconds"]["count"] == 70
    for reg, fn in zip(regs, providers):
        reg.absorb_hist_provider(fn)
    assert [r.snapshot()["histograms"] for r in regs] == snaps


@contextlib.contextmanager
def _fleet(monkeypatch, package: str):
    """A scheduler and one server of ``package`` in process, for one
    worker of the same package."""
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_PARTITION_BYTES": str(PART_BYTES)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if package == "port":
        sched = PortScheduler(1, 2, host="127.0.0.1")
    else:
        sched = RefScheduler(num_workers=1, num_servers=2, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    nodes = [PortServer(PortConfig.from_env()) if package == "port"
             else RefServer(RefConfig.from_env()) for _ in range(2)]
    for node in nodes:
        threading.Thread(target=node.start, daemon=True).start()
    try:
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()


def _histograms(package: str, monkeypatch) -> dict:
    """One push_pull of a 3-partition float32 numpy tensor (the host lane
    of both packages) through a fleet of ``package``: {histogram name:
    {label set: count}} of that package's registry."""
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    bps, reg = (pbps, tel.metrics()) if package == "port" else (jbps, ref_tel.metrics())
    with _fleet(monkeypatch, package):
        if package == "port":
            bps.init(device="cpu")
        else:
            bps.init()
        reg.reset()  # the init barriers' requests are not data-plane rounds
        out = bps.push_pull(x, name="t.three", average=False)
        bps.shutdown()
    np.testing.assert_array_equal(np.asarray(out), x)
    out = {}
    for key, st in reg._hist_states().items():
        name, labels = key
        out.setdefault(name, {})[labels] = st[3]
    return out


def test_one_push_pull_leaves_the_references_histograms(monkeypatch):
    """stage_dwell_seconds per stage, rpc_round_trip_seconds per server,
    server_sum_seconds and server_publish_seconds: the same names, label
    sets and counts in both packages (3 partitions: a push and a pull
    each, one summed push and one published round each)."""
    port = _histograms("port", monkeypatch)
    ref = _histograms("ref", monkeypatch)
    assert port == ref
    stages = {dict(k)["stage"] for k in port["stage_dwell_seconds"]}
    assert stages == {"COPYD2H", "PUSH", "PULL", "COPYH2D"}
    assert set(port["stage_dwell_seconds"].values()) == {3}
    assert sum(port["rpc_round_trip_seconds"].values()) == 6
    assert {dict(k)["server"] for k in port["rpc_round_trip_seconds"]} <= {"0", "1"}
    assert port["server_sum_seconds"] == {(): 3}
    assert port["server_publish_seconds"] == {(): 3}
