"""Elastic membership across whole fleets, the port against byteps_tpu's:
a server resize 1 -> 2 -> 1 with traffic, the eviction of a server that
crashed mid-traffic under the chaos van, a worker resize 2 -> 1 -> 2 in
fleets that mix the two packages (the control wire is shared), and a
launcher host of two gloo ranks that suspends and resumes as a whole.
Every case runs on each package, or across both, with the same
numpy-seeded inputs and the same exact sums."""

import threading
import time

import numpy as np
import pytest

import torch_port_kits as kits

PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


@pytest.mark.parametrize("pkg", PKGS)
def test_server_scale_up_then_down(monkeypatch, pkg):
    """1 -> 2 -> 1 servers: the resuming worker's registration parks until
    the new server registered, the live worker follows the book (a new
    connection set, server_generation bumped), keys re-home and re-init on
    their new owners, the sums stay exact at each size, and the scale-down
    stops the dropped server."""
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=1, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 2, 1, BYTEPS_HEARTBEAT_INTERVAL="0.1")
    keys = [100, 101, 102, 103]  # they spread over two servers under djb2
    xs = kits.vals(11, 64, 6)
    srv0 = kits.start_server(k)
    srv1 = None

    def rounds(wa, wb, i):
        kits.in_threads(*[lambda key=key: kits.init_key([wa, wb], key) for key in keys])
        for key in keys:
            for out in kits.round_([wa, wb], key, 1, xs[i:i + 2]):
                np.testing.assert_array_equal(out, xs[i] + xs[i + 1])

    try:
        w0 = k.PSClient(k.Config.from_env(), node_uid="w0")
        w1 = k.PSClient(k.Config.from_env(), node_uid="w1")
        kits.in_threads(w0.connect, w1.connect)
        assert w0.num_servers == 1 and len(w0._servers) == 1
        rounds(w0, w1, 0)
        # scale up: w0 resumes with two servers and parks; w1 stays live
        w0.close()
        time.sleep(0.3)
        monkeypatch.setenv("DMLC_NUM_SERVER", "2")
        w0b = k.PSClient(k.Config.from_env(), node_uid="w0")
        tc = threading.Thread(target=w0b.connect, daemon=True)
        tc.start()
        time.sleep(0.5)
        assert tc.is_alive() and sched.num_servers == 2  # parked
        srv1 = kits.start_server(k)
        tc.join(15)
        assert not tc.is_alive() and w0b.num_servers == 2 and len(w0b._servers) == 2
        assert kits.wait(lambda: w1.server_generation == 1)
        assert w1.num_servers == 2 and len(w1._servers) == 2
        assert {w1.server_for(key) for key in keys} == {0, 1}
        rounds(w0b, w1, 2)
        # scale down: w1 resumes with one server; w0b stays live
        w1.close()
        time.sleep(0.3)
        monkeypatch.setenv("DMLC_NUM_SERVER", "1")
        w1b = k.PSClient(k.Config.from_env(), node_uid="w1")
        w1b.connect()
        assert w1b.num_servers == 1 and sched.num_servers == 1
        assert kits.wait(lambda: srv1._stop.is_set()), "the dropped server did not stop"
        assert kits.wait(lambda: w0b.server_generation == 1)
        assert w0b.num_servers == 1 and len(w0b._servers) == 1
        rounds(w0b, w1b, 4)
        w0b.close()
        w1b.close()
    finally:
        srv0.stop()
        if srv1 is not None:
            srv1.stop()
        sched.stop()


@pytest.mark.parametrize("fleet", ["port-sched/ref-server", "ref-sched/port-server",
                                   "ref-sched/port-native"])
def test_worker_resize_in_a_mixed_fleet(monkeypatch, fleet):
    """The control wire is shared: a port scheduler with a byteps_tpu server
    and a port worker beside a byteps_tpu one; a byteps_tpu scheduler with a
    port server (Python, and the C++ engine) and port workers."""
    port, ref = kits.kit("port"), kits.kit("ref")
    if fleet == "port-sched/ref-server":
        kits.worker_resize(monkeypatch, port, ref, [port, ref])
    else:
        kits.worker_resize(monkeypatch, ref, port, [port, port], native=fleet.endswith("native"))


@pytest.mark.parametrize("pkg", PKGS)
def test_server_crash_mid_traffic_evicts_and_heals(monkeypatch, pkg):
    """A server dies mid-training under the chaos van (frames dropped too):
    the scheduler evicts it within BYTEPS_DEAD_NODE_TIMEOUT_S, the worker
    follows the book onto the survivor and re-inits there, and every step's
    sum stays exact (no replay summed twice, no step hung)."""
    k = kits.kit(pkg)
    for key, v in {"BYTEPS_VAN": "chaos:tcp", "BYTEPS_CHAOS_SEED": "77",
                   "BYTEPS_CHAOS_DROP": "0.03", "BYTEPS_RPC_DEADLINE_S": "0.3",
                   "BYTEPS_INIT_DEADLINE_S": "0.5", "BYTEPS_RPC_RETRIES": "3",
                   "BYTEPS_RPC_BACKOFF_S": "0.05", "BYTEPS_CONNECT_RETRY_S": "0.2",
                   "BYTEPS_DEGRADED_STEP_RETRIES": "8", "BYTEPS_HEARTBEAT_INTERVAL": "0.1",
                   "BYTEPS_DEAD_NODE_TIMEOUT_S": "0.5"}.items():
        monkeypatch.setenv(key, v)
    k.counters().reset()
    sched = k.Scheduler(num_workers=1, num_servers=2, host="127.0.0.1")
    sched.start()
    assert sched.dead_node_timeout == 0.5
    kits.env(monkeypatch, sched, 1, 2)
    servers = [kits.start_server(k) for _ in range(2)]
    rng = np.random.default_rng(5)
    steps = [rng.integers(-8, 8, (3, 129)).astype(np.float32) for _ in range(6)]
    failures = {}

    def train():
        try:
            kits.init(k)
            for step, xs in enumerate(steps):
                for name, x in zip(("inv.a", "inv.b", "inv.c"), xs):
                    out = k.api.push_pull(kits.tensor(k, x), name=name, average=False)
                    np.testing.assert_array_equal(np.asarray(out), x)
                if step == 2:
                    servers[1].stop()
        except BaseException as e:  # noqa: BLE001
            failures["err"] = e

    t = threading.Thread(target=train, daemon=True)
    t.start()
    t.join(timeout=60)
    try:
        assert not t.is_alive(), "training hung after the server crash"
        assert "err" not in failures, repr(failures.get("err"))
        assert sched.eviction_totals["server"] == 1 and sched.num_servers == 1
        assert k.api.get_robustness_counters().get("server_evicted", 0) == 1
        client = k.state.get_state().ps_client
        assert client.membership_epoch >= 1 and client.num_servers == 1
    finally:
        k.api.shutdown()
        for srv in servers:
            srv.stop()
        sched.stop()


# --- a launcher host suspends and resumes as a whole -------------------------


def test_host_level_suspend_resume(monkeypatch, tmp_path):
    """Two gloo ranks of one host: every rank suspends and resumes, only the
    root re-registers, keys stay, and the host's push_pull goes on exact
    (the root's PS hop through byteps_tpu's server)."""
    import torch_port_ranks as ranks

    port, ref = kits.kit("port"), kits.kit("ref")
    sched = port.Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 1, 1)
    srv = kits.start_server(ref)
    try:
        procs = ranks.spawn_group("elastic", 2, str(tmp_path))
        res = ranks.collect(procs, "elastic", 2, str(tmp_path), timeout=60)
    finally:
        srv.stop()
        sched.stop()
    want = ranks.member_inputs(70, 2, (ranks.ELASTIC_N,)).sum(0)
    for r in res:
        assert r["keys_before"] == r["keys_after"]
        for got in r["outs"]:
            np.testing.assert_array_equal(got, want)
        assert r["size"] == 1
