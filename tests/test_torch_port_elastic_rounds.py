"""Rounds across a resize, the port against byteps_tpu: a round in flight
when a worker dies completes once the scheduler evicted it, and the
survivor's average divides by the live worker count (read when the round
finalizes), bitwise as a byteps_tpu worker's in the same sequence; and a
server resize through the port's C++ client lanes.  The inputs are small
integers from a numpy seed: every sum and quotient is exact."""

import threading
import time

import numpy as np
import pytest

import torch_port_kits as kits

PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _in_flight_across_an_eviction(monkeypatch, pkg: str) -> list:
    """An api worker of ``pkg`` and a raw peer push a 2-worker round; the
    peer dies; the api worker's next round completes after the eviction,
    averaged over the one live worker.  Returns the api worker's pulls."""
    k = kits.kit(pkg)
    monkeypatch.setenv("BYTEPS_HEARTBEAT_INTERVAL", "0.1")
    sched = k.Scheduler(num_workers=2, num_servers=1, host="127.0.0.1", dead_node_timeout=0.5)
    sched.start()
    kits.env(monkeypatch, sched, 2, 1)
    srv = kits.start_server(k)
    shrink = srv.update_num_workers

    def after_the_worker(n: int) -> None:
        # the scheduler sends the eviction's book to the workers before the
        # servers; on a loaded host the api worker's control thread may
        # still adopt it after the server completed the round, and the
        # average then reads the old count: keep the books' order
        if n == 1:
            kits.wait(lambda: getattr(k.state.get_state().ps_client, "num_workers", 1) == 1, 5)
        shrink(n)

    srv.update_num_workers = after_the_worker
    xa, xb, xa2 = kits.vals(21, 96, 3)
    outs = []
    try:
        peer = k.PSClient(k.Config.from_env(), node_uid="peer")
        errs = []

        def api_worker():
            try:
                kits.init(k)
                key = k.api.declare_tensor("flight.g") << 16  # one partition
                box["key"] = key
                ready.set()
                outs.append(np.asarray(k.api.push_pull(kits.tensor(k, xa), name="flight.g")))
                peer_gone.wait(10)
                outs.append(np.asarray(k.api.push_pull(kits.tensor(k, xa2), name="flight.g")))
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        box, ready, peer_gone = {}, threading.Event(), threading.Event()
        t = threading.Thread(target=api_worker, daemon=True)
        t.start()
        peer.connect()
        assert ready.wait(10)
        peer.init_tensor(box["key"], 96, 0)
        np.testing.assert_array_equal(kits.roundtrip(peer, box["key"], xb, 1), xa + xb)
        peer.close()  # dies: no more beats
        peer_gone.set()
        t.join(20)
        assert not t.is_alive() and not errs, errs
        assert sched.eviction_totals["worker"] == 1
        assert k.state.get_state().ps_client.num_workers == 1
        k.api.shutdown()
    finally:
        srv.stop()
        sched.stop()
    return outs


def test_a_round_in_flight_across_an_eviction_averages_over_the_live_count(monkeypatch):
    got = {pkg: _in_flight_across_an_eviction(monkeypatch, pkg) for pkg in PKGS}
    xa, xb, xa2 = kits.vals(21, 96, 3)
    for pkg, outs in got.items():
        np.testing.assert_array_equal(outs[0], (xa + xb) / np.float32(2))
        np.testing.assert_array_equal(outs[1], xa2)
    assert [o.tobytes() for o in got["port"]] == [o.tobytes() for o in got["ref"]]


@pytest.mark.parametrize("pkg", PKGS)
def test_update_num_workers_completes_a_partial_round_and_init_barrier(pkg):
    """A server whose worker count drops to the pushes and INITs a round
    already holds publishes the round, answers its parked pull, and
    releases the init barrier, as byteps_tpu's does."""
    import socket
    import struct

    k = kits.kit(pkg)
    cfg = k.Config.from_env()
    cfg.num_worker = 2
    srv = k.PSServer(cfg)
    srv.num_workers = 2
    a, b = socket.socketpair()
    lock = threading.Lock()
    x = kits.vals(5, 8, 1)[0]
    try:
        init = k.tr.Message(k.tr.Op.INIT, key=9, seq=1, flags=1, version=7,
                            payload=struct.pack("!QI", 8, 0))
        srv._handle_init(init, a, lock)
        srv.update_num_workers(1)  # the barrier now holds every INIT
        assert k.tr.recv_message(b).op == k.tr.Op.INIT
        srv.num_workers = 2
        srv._handle_push(k.tr.Message(k.tr.Op.PUSH, key=9, seq=2, flags=1, version=1,
                                      payload=x.tobytes()), a, lock)
        assert k.tr.recv_message(b).op == k.tr.Op.PUSH
        srv._handle_pull(k.tr.Message(k.tr.Op.PULL, key=9, seq=3, version=1), a, lock)
        b.settimeout(0.3)
        with pytest.raises(OSError):  # parked: the round lacks a push
            k.tr.recv_message(b)
        b.settimeout(5)
        srv.update_num_workers(1)
        reply = k.tr.recv_message(b)
        assert reply.op == k.tr.Op.PULL and reply.seq == 3
        np.testing.assert_array_equal(np.frombuffer(reply.payload, np.float32), x)
    finally:
        a.close()
        b.close()
        srv.stop()


def test_server_resize_through_the_native_client_lanes(monkeypatch):
    """A live worker on the C++ client lanes follows a server scale-up:
    it dials the new set on those lanes, bumps its generation, and the
    re-initialized keys sum exactly on their new owners."""
    k = kits.kit("port")
    monkeypatch.setenv("BYTEPS_NATIVE_CLIENT", "1")
    sched = k.Scheduler(num_workers=1, num_servers=1, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 1, 1, BYTEPS_HEARTBEAT_INTERVAL="0.1")
    servers = [kits.start_server(k)]
    xs = kits.vals(31, 64, 8)
    keys = [100, 101, 102, 103]
    try:
        w = k.PSClient(k.Config.from_env(), node_uid="native-w")
        w.connect()
        for key, x in zip(keys, xs):
            w.init_tensor(key, 64, 0)
            np.testing.assert_array_equal(kits.roundtrip(w, key, x, 1), x)
        t = threading.Thread(target=lambda: w.request_resize(num_servers=2), daemon=True)
        t.start()
        time.sleep(0.3)
        servers.append(kits.start_server(k))
        t.join(15)
        assert not t.is_alive() and w.server_generation == 1 and len(w._servers) == 2
        assert type(w._servers[1]).__name__ == "_NativeServerConn"
        assert {w.server_for(key) for key in keys} == {0, 1}
        for key, x in zip(keys, xs[4:]):
            w.init_tensor(key, 64, 0)
            np.testing.assert_array_equal(kits.roundtrip(w, key, x, 1), x)
        w.close()
    finally:
        for s in servers:
            s.stop()
        sched.stop()
