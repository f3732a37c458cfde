"""The restartable scheduler of the port against byteps_tpu's: incarnation
fencing, the epochs a restarted scheduler fences above, a crash and
restart with the data plane bitwise through it, barriers across a restart
and a reconnect, the heartbeat through a hiccup, faults on the scheduler
link, and the rejoin grace window (the cases of
``tests/test_sched_recovery.py``; the tuner's successor is in
``test_torch_port_autotune_fleet.py``).  Every case runs on each package with the same inputs and
expects the same exact results.  The books a port scheduler sends after a
scripted sequence (three registers, a resize, an eviction, a restart) equal
a byteps_tpu scheduler's field for field, addresses and incarnation ids
aside."""

import json
import socket
import threading
import time

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu_torch.common import config as port_config

PKGS = ["port", "ref"]

#: the fast-recovery knobs of the end-to-end cases
FAST = {"DMLC_PS_ROOT_URI": "127.0.0.1", "BYTEPS_FORCE_DISTRIBUTED": "1",
        "BYTEPS_HEARTBEAT_INTERVAL": "0.1", "BYTEPS_SCHED_RECONNECT_RETRIES": "80",
        "BYTEPS_SCHED_RECONNECT_BACKOFF_S": "0.05", "BYTEPS_SCHED_REJOIN_WINDOW_S": "5",
        "BYTEPS_CONNECT_RETRY_S": "0.2"}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    from byteps_tpu.comm import chaos as ref_chaos
    from byteps_tpu_torch.comm import chaos as port_chaos

    for k in ("BYTEPS_VAN", "BYTEPS_WIRE_CHECKSUM", "BYTEPS_CHAOS_SCHED"):
        monkeypatch.delenv(k, raising=False)
    port_chaos.reset_conn_indices()
    ref_chaos.reset_conn_indices()
    yield
    port_chaos.reset_fault_budget(None)
    ref_chaos.reset_fault_budget(None)
    port_config.clear_config()


def _fleet_env(monkeypatch, workers: int, servers: int, **extra) -> None:
    for key, v in {**FAST, "DMLC_NUM_WORKER": str(workers), "DMLC_NUM_SERVER": str(servers),
                   **extra}.items():
        monkeypatch.setenv(key, v)


def _wait(cond, timeout: float = 15.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def _pair(k, uids):
    cfg = k.Config.from_env()
    ws = [k.PSClient(cfg, node_uid=u) for u in uids]
    kits.in_threads(*[w.connect for w in ws])
    return ws


# --- the incarnation fence ----------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_client_refuses_older_incarnation_book(pkg):
    k = kits.kit(pkg)
    pc = k.PSClient.__new__(k.PSClient)
    pc.sched_incarnation = 0
    k.counters().reset()
    assert pc._fence_book({"sched_incarnation": 5}) and pc.sched_incarnation == 5
    assert not pc._fence_book({"sched_incarnation": 3}) and pc.sched_incarnation == 5
    assert k.counters().get("sched_stale_book") == 1
    assert pc._fence_book({"sched_incarnation": 5}) and pc._fence_book({})


@pytest.mark.parametrize("pkg", PKGS)
def test_server_refuses_older_incarnation_book(pkg):
    k = kits.kit(pkg)
    srv = k.PSServer.__new__(k.PSServer)
    srv.sched_incarnation = 0
    k.counters().reset()
    assert srv._fence_book({"sched_incarnation": 9}) and srv.sched_incarnation == 9
    assert not srv._fence_book({"sched_incarnation": 8})
    assert k.counters().get("sched_stale_book") == 1
    assert srv._fence_book({"sched_incarnation": 10}) and srv.sched_incarnation == 10


@pytest.mark.parametrize("pkg", PKGS)
def test_resize_book_from_zombie_is_not_applied(pkg):
    k = kits.kit(pkg)
    srv = k.PSServer.__new__(k.PSServer)
    srv.sched_incarnation, srv.membership_epoch, srv._map_epoch = 7, 4, 0
    srv.num_workers = 2
    calls = []
    srv.update_num_workers = calls.append
    book = {"sched_incarnation": 6, "num_workers": 99, "epoch": 9, "worker_ranks": [0]}
    srv._handle_control(None, k.tr.Message(k.tr.Op.ADDRBOOK, seq=k.RESIZE_SEQ,
                                           payload=json.dumps(book).encode()))
    assert calls == [] and srv.num_workers == 2 and srv.membership_epoch == 4


# --- a restarted scheduler ------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_first_book_fences_above_reported_epochs_and_honors_rank(pkg):
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=0, host="127.0.0.1", rejoin_window=30.0)
    sched.start()
    try:
        s1 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        s1.settimeout(10)
        k.tr.send_message(s1, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": "fence-w1", "num_workers": 2,
            "num_servers": 0, "last_rank": 1, "epoch": 3, "map_epoch": 7}).encode()))
        s0, resp0 = kits.register_raw(k, sched.port, {
            "role": "worker", "host": "", "port": 0, "uid": "fence-w0", "num_workers": 2,
            "num_servers": 0, "last_rank": 0, "epoch": 3, "map_epoch": 7}, timeout=10)
        book0, book1 = kits.book_of(resp0), kits.book_of(k.tr.recv_message(s1))
        assert book1["rank"] == 1 and book0["rank"] == 0
        assert book0["map_epoch"] > 7 and book0["epoch"] > 3 and sched.map_epoch > 7
        assert book0["sched_incarnation"] == sched.incarnation and book0["is_recovery"] is True
        s0.close()
        s1.close()
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_restart_full_rejoin_traffic_bitwise(monkeypatch, pkg):
    """A crash of the scheduler and its restart on the same port: the data
    plane trains bitwise through the outage, every node rejoins the new
    incarnation at its rank with no eviction, and heartbeats resume."""
    k = kits.kit(pkg)
    _fleet_env(monkeypatch, 1, 1)
    k.counters().reset()
    sched = k.Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    sched2 = None
    xs = np.random.default_rng(9).standard_normal((3, 64)).astype(np.float32)
    try:
        srv = kits.start_server(k)
        w = k.PSClient(k.Config.from_env(), node_uid="rej-w0")
        w.connect()
        w.init_tensor(5, 64, 0)
        np.testing.assert_array_equal(kits.roundtrip(w, 5, xs[0], 1), xs[0])
        inc0, map0, port = sched.incarnation, sched.map_epoch, sched.port
        sched.crash()
        time.sleep(0.3)
        np.testing.assert_array_equal(kits.roundtrip(w, 5, xs[1], 2), xs[1])
        assert w._sched_dead  # the control plane really was down
        sched2 = k.Scheduler(1, 1, host="127.0.0.1", port=port)
        sched2.start()
        assert _wait(lambda: w.sched_incarnation > inc0 and not w._sched_dead
                     and sched2._addrbook_sent, 20)
        assert sched2.map_epoch > map0
        assert sched2.eviction_totals == {"worker": 0, "server": 0}
        assert w.rank == 0 and srv.rank == 0
        np.testing.assert_array_equal(kits.roundtrip(w, 5, xs[2], 3), xs[2])
        assert _wait(lambda: {0} <= set(w.query_cluster()["server"]), 10)
        assert k.counters().get("sched_rejoin") >= 2  # the worker and the server
        w.close()
        srv.stop()
    finally:
        sched.stop()
        if sched2 is not None:
            sched2.stop()


# --- barriers across a restart and a reconnect ---------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_pending_barrier_rearms_from_reregistration(monkeypatch, pkg):
    k = kits.kit(pkg)
    _fleet_env(monkeypatch, 2, 0)
    sched = k.Scheduler(2, 0, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    sched2 = None
    try:
        w0, w1 = _pair(k, ("bar-w0", "bar-w1"))
        done = [threading.Event(), threading.Event()]

        def bar(i, w):
            w.barrier(k.GROUP_WORKERS)
            done[i].set()

        threading.Thread(target=bar, args=(0, w0), daemon=True).start()
        time.sleep(0.4)
        assert not done[0].is_set()
        port = sched.port
        sched.crash()
        time.sleep(0.2)
        sched2 = k.Scheduler(2, 0, host="127.0.0.1", port=port)
        sched2.start()
        threading.Thread(target=bar, args=(1, w1), daemon=True).start()
        assert done[0].wait(20) and done[1].wait(20)
        w0.close()
        w1.close()
    finally:
        sched.stop()
        if sched2 is not None:
            sched2.stop()


def _hiccup_then_barrier(monkeypatch, k, uids, under_barrier: bool) -> None:
    """w0's control link dies (the scheduler lives), with or without a
    barrier parked on it; after the rejoin w0's barrier must wait for w1."""
    _fleet_env(monkeypatch, 2, 0)
    k.counters().reset()
    sched = k.Scheduler(2, 0, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    try:
        w0, w1 = _pair(k, uids)
        done = [threading.Event(), threading.Event()]
        if under_barrier:
            threading.Thread(target=lambda: (w0.barrier(k.GROUP_WORKERS), done[0].set()),
                             daemon=True).start()
            time.sleep(0.4)
        k.tr.close_socket(w0._sched)
        assert _wait(lambda: k.counters().get("sched_rejoin") >= 1)
        if not under_barrier:
            threading.Thread(target=lambda: (w0.barrier(k.GROUP_WORKERS), done[0].set()),
                             daemon=True).start()
        assert not done[0].wait(0.4), "the rejoined rank's barrier released without its peer"
        threading.Thread(target=lambda: (w1.barrier(k.GROUP_WORKERS), done[1].set()),
                         daemon=True).start()
        assert done[0].wait(10) and done[1].wait(10)
        w0.close()
        w1.close()
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_next_barrier_pairs_after_reconnect_rejoin(monkeypatch, pkg):
    """A reconnect does not arm the barrier bypass."""
    _hiccup_then_barrier(monkeypatch, kits.kit(pkg), ("byp-w0", "byp-w1"), False)


@pytest.mark.parametrize("pkg", PKGS)
def test_parked_barrier_does_not_double_count_after_reconnect(monkeypatch, pkg):
    """The dead link's parked waiter is scrubbed at the re-register."""
    _hiccup_then_barrier(monkeypatch, kits.kit(pkg), ("scrub-w0", "scrub-w1"), True)


@pytest.mark.parametrize("pkg", PKGS)
def test_same_uid_reregister_during_fill_replaces_not_appends(pkg):
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=0, host="127.0.0.1", rejoin_window=30.0)
    sched.start()
    try:
        p1 = {"role": "worker", "host": "", "port": 0, "uid": "dup-w1", "num_workers": 2,
              "num_servers": 0, "last_rank": 1, "epoch": 1, "map_epoch": 1}
        s1 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        k.tr.send_message(s1, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps(p1).encode()))
        time.sleep(0.3)
        s1.close()
        s2 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        s2.settimeout(10)
        k.tr.send_message(s2, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps(p1).encode()))
        time.sleep(0.3)
        with sched._lock:
            assert len(sched._nodes["worker"]) == 1
        s0, resp0 = kits.register_raw(k, sched.port, {
            "role": "worker", "host": "", "port": 0, "uid": "dup-w0", "num_workers": 2,
            "num_servers": 0, "last_rank": 0, "epoch": 1, "map_epoch": 1}, timeout=10)
        book1, book0 = kits.book_of(k.tr.recv_message(s2)), kits.book_of(resp0)
        assert book1["rank"] == 1 and book0["rank"] == 0 and book0["num_workers"] == 2
        s0.close()
        s2.close()
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_transient_link_loss_hands_off_to_reconnect(monkeypatch, pkg):
    """One lost link does not end the heartbeats: the node re-registers with
    the same live scheduler and beats again."""
    k = kits.kit(pkg)
    _fleet_env(monkeypatch, 1, 1)
    k.counters().reset()
    sched = k.Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    try:
        srv = kits.start_server(k)
        w = k.PSClient(k.Config.from_env(), node_uid="hic-w0")
        w.connect()
        inc0 = w.sched_incarnation
        k.tr.close_socket(w._sched)
        assert _wait(lambda: k.counters().get("sched_rejoin") >= 1)
        assert _wait(lambda: not w._sched_dead, 5)
        assert w.sched_incarnation == inc0 and w.rank == 0
        assert _wait(lambda: w.query_cluster()["worker"].get(0, 99) < 1.0, 10)
        w.close()
        srv.stop()
    finally:
        sched.stop()


# --- faults on the scheduler link ----------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_dropped_ping_costs_one_beat_not_the_loop(monkeypatch, pkg):
    k = kits.kit(pkg)
    _fleet_env(monkeypatch, 1, 1, BYTEPS_VAN="chaos:tcp", BYTEPS_CHAOS_SCHED="1",
               BYTEPS_CHAOS_OPS="PING", BYTEPS_CHAOS_DROP="1.0", BYTEPS_CHAOS_SEED="5",
               BYTEPS_HEARTBEAT_INTERVAL="0.2")
    k.counters().reset()
    sched = k.Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    monkeypatch.setenv("BYTEPS_CHAOS_TARGET_PORT", str(sched.port))
    k.chaos.reset_fault_budget(2)
    try:
        srv = kits.start_server(k)
        w = k.PSClient(k.Config.from_env(), node_uid="chaos-hb-w0")
        w.connect()
        assert _wait(lambda: k.counters().get("chaos_drop") >= 2
                     and sched.liveness()["worker"].get(0, 99) < 1.0, 20)
        assert not w._sched_dead  # drops only: the link never died
        w.close()
        srv.stop()
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_addrbook_drop_injectable_on_scheduler_side(monkeypatch, pkg):
    k = kits.kit(pkg)
    for key, v in {"BYTEPS_VAN": "chaos:tcp", "BYTEPS_CHAOS_SCHED": "1",
                   "BYTEPS_CHAOS_OPS": "ADDRBOOK", "BYTEPS_CHAOS_DROP": "1.0",
                   "BYTEPS_CHAOS_SEED": "5", "BYTEPS_CHAOS_TARGET_PORT": "0"}.items():
        monkeypatch.setenv(key, v)
    k.counters().reset()
    k.chaos.reset_fault_budget(1)
    sched = k.Scheduler(1, 0, host="127.0.0.1")
    sched.start()
    try:
        payload = {"role": "worker", "host": "", "port": 0, "uid": "book-drop-w0",
                   "num_workers": 1, "num_servers": 0}
        s1 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        s1.settimeout(0.5)
        k.tr.send_message(s1, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps(payload).encode()))
        with pytest.raises(OSError):  # the book was dropped
            k.tr.recv_message(s1)
        assert k.counters().get("chaos_drop") == 1
        s2, resp = kits.register_raw(k, sched.port, payload)
        book = kits.book_of(resp)
        assert book["rank"] == 0 and book["is_recovery"] is True
        s1.close()
        s2.close()
    finally:
        sched.stop()


# --- the rejoin grace window ------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_partial_population_adopted_after_window(pkg):
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=0, host="127.0.0.1", rejoin_window=0.6)
    sched.start()
    try:
        s1 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        s1.settimeout(10)
        t0 = time.monotonic()
        k.tr.send_message(s1, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": "grace-w1", "num_workers": 2,
            "num_servers": 0, "last_rank": 1, "epoch": 2, "map_epoch": 3}).encode()))
        book = kits.book_of(k.tr.recv_message(s1))
        assert time.monotonic() - t0 >= 0.5
        assert book["rank"] == 1 and book["num_workers"] == 1
        assert book["map_epoch"] > 3 and book["epoch"] > 2
        assert sched.num_workers == 1 and sched.eviction_totals == {"worker": 0, "server": 0}
        s0, resp = kits.register_raw(k, sched.port, {
            "role": "worker", "host": "", "port": 0, "uid": "grace-w0", "num_workers": 2,
            "num_servers": 0, "last_rank": 0, "epoch": 2, "map_epoch": 3})
        late = kits.book_of(resp)
        assert late["rank"] == 0 and late["is_recovery"] is True and sched.num_workers == 2
        s0.close()
        s1.close()
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_fresh_first_boot_never_arms_the_window(pkg):
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=0, host="127.0.0.1", rejoin_window=0.3)
    sched.start()
    try:
        s1 = socket.create_connection(("127.0.0.1", sched.port), timeout=5)
        s1.settimeout(0.5)
        k.tr.send_message(s1, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": "boot-w0", "num_workers": 2,
            "num_servers": 0}).encode()))
        with pytest.raises(OSError):  # no book: the population is short
            k.tr.recv_message(s1)
        assert sched._grace_thread is None and not sched._addrbook_sent
        s1.close()
    finally:
        sched.stop()


# --- the books, field for field ----------------------------------------------------


def _scripted_books(pkg: str) -> dict:
    """Three registers, a resize by a live worker, the eviction of the
    server, a restart with the survivors' rejoin: every book each node
    received."""
    k = kits.kit(pkg)
    w = lambda uid, **kw: {"role": "worker", "host": "", "port": 0, "uid": uid,  # noqa: E731
                           "num_workers": 2, "num_servers": 1, "job": 0, "job_priority": 1,
                           "job_quota_mbps": 0.0, **kw}
    srv_payload = {"role": "server", "host": "127.0.0.1", "port": 1, "uid": "s0"}
    sched = k.Scheduler(2, 1, host="127.0.0.1", dead_node_timeout=0.5, incarnation=1)
    sched.start()
    got = {}
    try:
        s0 = kits.RawNode(k, sched.port, srv_payload)
        w0 = kits.RawNode(k, sched.port, w("w0"))
        time.sleep(0.2)
        w1 = kits.RawNode(k, sched.port, w("w1"))
        assert _wait(lambda: s0.books and w0.books and w1.books, 5)
        w1.close()  # w1 leaves; w0 resizes the job to one worker
        time.sleep(0.2)
        w0.send(k.tr.Message(k.tr.Op.REGISTER, seq=7,
                             payload=json.dumps(w("w0", num_workers=1)).encode()))
        assert _wait(lambda: len(w0.books) == 2 and len(s0.books) == 2, 5)
        s0.beating = False  # the server goes silent: evicted
        assert _wait(lambda: sched.eviction_totals["server"] == 1 and len(w0.books) == 3, 5)
        time.sleep(0.2)
        port = sched.port
        sched.crash()
        try:
            # byteps_tpu's crash closes its listener without a shutdown: a
            # dial wakes the accept that still holds the port
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
        except OSError:
            pass
        time.sleep(0.2)
        sched = k.Scheduler(1, 1, host="127.0.0.1", port=port, incarnation=2, rejoin_window=5)
        sched.start()
        last = w0.books[-1][1]
        w0b = kits.RawNode(k, port, w("w0", num_workers=1, num_servers=1, last_rank=0,
                               epoch=last["epoch"], map_epoch=last["map_epoch"],
                               reconnect=True))
        s0b = kits.RawNode(k, port, {**srv_payload, "last_rank": 0, "epoch": last["epoch"],
                              "map_epoch": last["map_epoch"], "reconnect": True})
        assert _wait(lambda: w0b.books and s0b.books, 5)
        got = {"s0": s0.books, "w0": w0.books, "w1": w1.books, "w0b": w0b.books,
               "s0b": s0b.books, "evictions": dict(sched.eviction_totals)}
        for n in (s0, w0, w0b, s0b):
            n.close()
    finally:
        sched.stop()
    return got


def test_books_match_the_reference_field_for_field():
    port, ref = _scripted_books("port"), _scripted_books("ref")
    assert port == ref
    assert [b["epoch"] for _, b in port["w0"]] == [0, 1, 2]
    assert port["w0"][2][1]["evictions"] == {"worker": 0, "server": 1}
    assert port["w0b"][0][1]["epoch"] > 2 and port["w0b"][0][1]["is_recovery"] is True
