"""The heartbeat's metric deltas, the scheduler's aggregate, the flight
recorder's ledger and the cluster step matrix of the port, held to
byteps_tpu's (the cases of ``tests/test_observability.py``
``TestSchedulerAggregate`` and ``tests/test_flightrec.py``): the same
operations on a registry of each package give the same deltas, and the
same deltas merged give the same aggregate; the same tails give the same
matrix and straggler.  Every comparison is exact."""

import json

import pytest

import torch_port_kits as kits
from byteps_tpu.core import flightrec as rfr
from byteps_tpu.core import telemetry as rtel
from byteps_tpu_torch.core import flightrec as pfr
from byteps_tpu_torch.core import telemetry as ptel

MODS = {"port": (ptel, pfr), "ref": (rtel, rfr)}
PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _labeled(reg) -> dict:
    c = reg.counters
    raw = c.labeled_raw() if hasattr(c, "labeled_raw") else c.snapshot_labeled()
    return {name: sorted((list(map(list, k)), v) for k, v in per.items())
            for name, per in raw.items()}


def _aggregate(reg) -> str:
    """Counters flat and labeled, histogram raw states and gauges."""
    hists = {f"{name}{json.dumps(lkey)}": [list(st[0]), list(st[1]), st[2], st[3]]
             for (name, lkey), st in reg._hist_states().items()}
    with reg._lock:
        gauges = {f"{n}{json.dumps(lk)}": v for (n, lk), v in reg._gauges.items()}
    return json.dumps({"c": reg.counters.snapshot(), "lc": _labeled(reg), "h": hists,
                       "g": gauges}, sort_keys=True)


def _script(tel, node):
    """A node's beats: the deltas of three heartbeats, one of them failed
    and given back."""
    out = []
    node.counters.bump("rpc_retry", 2, labels={"server": "0"})
    node.counters.bump("compression_auto_off", labels={"codec": "topk"})
    node.observe("rpc_round_trip_seconds", 0.005, labels={"server": "0"})
    node.observe("compression_ratio", 0.023, buckets=tel.RATIO_BUCKETS)
    node.gauge_set("fusion_threshold_bytes", 131072)
    out.append(node.delta_snapshot())
    node.counters.bump("rpc_retry")
    node.observe("stage_dwell_seconds", 0.2, labels={"stage": "PUSH"})
    failed = node.delta_snapshot()
    node.requeue_delta(failed)
    node.counters.bump("wire_bytes_saved", 1000)
    node.gauge_set("fusion_threshold_bytes", 65536)
    node.gauge_set("server_owned_keys", 3, labels={"rank": "1"})
    out.append(node.delta_snapshot())
    node.gauge_remove("server_owned_keys", labels={"rank": "1"})
    out.append(node.delta_snapshot())
    out.append(node.delta_snapshot())  # nothing changed: empty
    return out


def test_equal_operations_give_equal_deltas_and_aggregates():
    deltas = {pkg: _script(MODS[pkg][0], MODS[pkg][0].MetricsRegistry()) for pkg in PKGS}
    assert json.dumps(deltas["port"], sort_keys=True) == json.dumps(deltas["ref"],
                                                                     sort_keys=True)
    assert deltas["port"][-1] == {}
    aggs = {}
    for pkg in PKGS:
        agg = MODS[pkg][0].MetricsRegistry()
        for i, d in enumerate(deltas[pkg]):
            agg.merge_delta(json.loads(json.dumps(d)),
                            labels={"role": "worker", "rank": str(i % 2)})
        aggs[pkg] = _aggregate(agg)
    assert aggs["port"] == aggs["ref"]
    # the wire is one: a port node's deltas merge into byteps_tpu's aggregate
    agg = rtel.MetricsRegistry()
    for i, d in enumerate(deltas["port"]):
        agg.merge_delta(json.loads(json.dumps(d)), labels={"role": "worker", "rank": str(i % 2)})
    assert _aggregate(agg) == aggs["ref"]
    assert agg.counters.get("rpc_retry") == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_reship_rebases_once_per_incarnation(pkg):
    tel = MODS[pkg][0]
    node = tel.MetricsRegistry()
    node.counters.bump("x", 5)
    node.delta_snapshot()
    assert node.delta_snapshot() == {}
    assert node.reship_for(7)
    assert node.delta_snapshot()["c"] == {"x": 5}  # the whole history again
    assert not node.reship_for(7)  # a second loop sharing the registry
    assert node.delta_snapshot() == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_a_malformed_delta_is_dropped(pkg):
    agg = MODS[pkg][0].MetricsRegistry()
    agg.merge_delta({"c": {"ok": 1}, "h": [{"bogus": True}], "g": [{"v": "x"}]})
    assert agg.counters.get("ok") == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_a_gauge_function_is_read_at_snapshot(pkg):
    reg = MODS[pkg][0].MetricsRegistry()
    box = [1.0]
    reg.gauge_fn("cluster_tuning_epoch", lambda: box[0])
    box[0] = 4.0
    assert reg.snapshot()["gauges"]["cluster_tuning_epoch"] == 4.0
    assert reg.delta_snapshot()["g"] == [{"n": "cluster_tuning_epoch", "l": [], "v": 4.0}]


# --- the step matrix ------------------------------------------------------


def _recs(steps, dur):
    return [{"step": s, "k": "step", "dur": dur, "t": 0.0, "deg": 0, "trig": [], "rpc": {},
             "st": {"PUSH": [1, dur / 2]}} for s in steps]


def _matrix_script(pkg):
    tel, fr = MODS[pkg]
    agg = tel.MetricsRegistry()
    cf = fr.ClusterFlight()
    cf.attach(agg)
    out = [cf.merge("worker", 0, _recs(range(1, 6), 0.01)),
           cf.merge("worker", 0, _recs(range(1, 6), 0.01)),  # re-shipped window
           cf.merge("worker", 0, _recs(range(1, 7), 0.01)), cf.straggler_rank]
    out += [cf.merge("worker", 1, _recs([1], 0.9)), cf.straggler_rank]
    out += [cf.merge("server", 0, _recs([1, 2], 0.0)), cf.straggler_rank]
    out += [cf.merge("worker", 1, _recs([2], 0.011)), cf.straggler_rank]
    out += [cf.merge("worker", 1, _recs([3], 0.9)), cf.straggler_rank]
    cf.forget("worker", 1)
    out += [cf.straggler_rank]
    out += [cf.merge("worker", 0, _recs([1, 2, 3], 0.02))]  # a restarted recorder
    out += [cf.matrix(), agg.snapshot()["gauges"], _labeled(agg)]
    return out


def test_equal_tails_give_equal_matrices_and_stragglers():
    port, ref = _matrix_script("port"), _matrix_script("ref")
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port[:4] == [5, 0, 1, -1]
    assert [port[i] for i in (5, 7, 9, 11, 12, 13)] == [1, 1, -1, 1, -1, 3]
    assert [r["step"] for r in port[14]["worker0"]] == [1, 2, 3]
    assert "worker1" not in port[14]


# --- the recorder ---------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_the_recorder_takes_registry_deltas(pkg):
    tel, fr = MODS[pkg]
    reg = tel.MetricsRegistry()
    ctx = {"epoch": 2, "map_epoch": 3, "incarnation": 9, "degraded": 0}
    rec = fr.FlightRecorder(context_fn=lambda: ctx, registry=reg, counter_store=reg.counters,
                            capacity=32)
    reg.counters.bump("wire_tx_bytes", 100)
    reg.counters.bump("rpc_retry", 2, labels={"server": "1"})
    reg.observe("stage_dwell_seconds", 0.05, labels={"stage": "PUSH"})
    reg.observe("rpc_round_trip_seconds", 0.002, labels={"server": "1"})
    r1 = rec.record_step(0.25)
    reg.counters.bump("wire_tx_bytes", 40)
    r2 = rec.record_step()
    assert (r1["k"], r1["dur"], r1["tx"], r1["step"]) == ("step", 0.25, 100, 1)
    assert (r1["epoch"], r1["map_epoch"], r1["incarnation"]) == (2, 3, 9)
    assert r1["stages"]["PUSH"]["n"] == 1 and r1["rpc"]["1"]["retry"] == 2
    assert (r2["k"], r2["tx"], r2["stages"], r2["events"]) == ("beat", 40, {}, {})
    assert reg.snapshot()["gauges"]["node_step_seconds"] == 0.25
    tail = rec.ledger_tail()
    assert [t["step"] for t in tail] == [1, 2]
    assert tail[0]["st"] == {"PUSH": [1, 0.05]} and "st" not in tail[1]
    assert set(tail[1]) == {"step", "k", "t", "dur", "deg", "trig", "job", "rpc"}


def test_the_port_recorder_matches_the_reference_field_for_field():
    recs = {}
    for pkg in PKGS:
        tel, fr = MODS[pkg]
        reg = tel.MetricsRegistry()
        rec = fr.FlightRecorder(context_fn=lambda: {"epoch": 1}, registry=reg,
                                counter_store=reg.counters, capacity=4)
        out = []
        for i in range(6):
            reg.counters.bump("migration_keys_moved", i)
            reg.counters.bump("rpc_giveup", labels={"server": str(i % 2)})
            reg.observe("stage_dwell_seconds", 0.01 * (i + 1), labels={"stage": "COPYD2H"})
            r = rec.record_step(0.1 * (i + 1) if i % 2 else None)
            out.append({k: v for k, v in r.items() if k != "t"})
        tail = [{k: v for k, v in t.items() if k != "t"} for t in rec.ledger_tail(limit=3)]
        recs[pkg] = (out, tail, len(rec.snapshot()))
    assert json.dumps(recs["port"], sort_keys=True) == json.dumps(recs["ref"], sort_keys=True)


def test_the_recorder_belongs_to_the_role_that_made_it():
    from byteps_tpu_torch.core.flightrec import (
        ensure_process_recorder,
        get_process_recorder,
        release_process_recorder,
        set_process_recorder,
    )

    set_process_recorder(None)

    def worker_ctx():
        return {}

    def server_ctx():
        return {}

    rec = ensure_process_recorder(context_fn=worker_ctx)
    assert ensure_process_recorder(context_fn=server_ctx) is rec
    release_process_recorder(server_ctx)  # not the server's: it stays
    assert get_process_recorder() is rec
    release_process_recorder(worker_ctx)
    assert get_process_recorder() is None


def test_the_bundle_upload_raises_naming_its_item(monkeypatch):
    """The bundle upload and the slo trigger are ported and no longer
    raise; neither do the link-shaping knobs, which raised in their place
    until the van's shaping was ported (ROADMAP.md Queue 1 item 10.4): each
    now sets the port's link as it sets the reference's."""
    from byteps_tpu.comm import shaping as ref_shaping
    from byteps_tpu_torch.comm import shaping as port_shaping
    from byteps_tpu_torch.common.config import check_unported_env

    monkeypatch.setenv("BYTEPS_FLIGHT_UPLOAD", "1")
    monkeypatch.setenv("BYTEPS_JOB_SLO_S", "0.5")
    check_unported_env()
    for knob in ("BYTEPS_VAN_DELAY_MS", "BYTEPS_VAN_RATE_MBYTES_S", "BYTEPS_VAN_RATE_MBPS"):
        monkeypatch.setenv(knob, "5")
        check_unported_env()
        assert port_shaping.shaping_enabled() and ref_shaping.shaping_enabled()
        assert port_shaping.shaping_params() == ref_shaping.shaping_params()
        monkeypatch.setenv(knob, "0")
        check_unported_env()
        assert not port_shaping.shaping_enabled()
        monkeypatch.delenv(knob)  # a canonical "0" would win over the alias
