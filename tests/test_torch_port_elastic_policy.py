"""Two membership cases where the scheduler's or the worker's policy
decides the outcome, each run on the port and on byteps_tpu with the same
inputs: a resuming worker whose registration is parked on a server
scale-up is evicted once the timeout passes, by either scheduler, with the
same books; and under mixed hashing, where the worker count is an input of
``server_for``, a live worker that follows a 2 -> 1 -> 2 worker resize
re-homes the same keys in both packages, and the port bumps
``server_generation`` at each change (a deliberate divergence, ROADMAP.md
Queue 3: byteps_tpu's client does not), so that its keys run their init
barriers at their new owners and every round's sum is exact."""

import time

import numpy as np
import pytest

import torch_port_kits as kits

PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _parked_past_the_timeout(pkg: str) -> dict:
    """One server and one worker; the worker suspends and resumes asking
    for two servers, and no second server comes: its registration parks
    and it cannot beat.  What each node received, and the evictions."""
    k = kits.kit(pkg)
    worker = {"role": "worker", "host": "", "port": 0, "uid": "w0", "num_workers": 1,
              "num_servers": 1, "job": 0, "job_priority": 1, "job_quota_mbps": 0.0}
    sched = k.Scheduler(1, 1, host="127.0.0.1", dead_node_timeout=0.5, incarnation=1)
    sched.start()
    try:
        s0 = kits.RawNode(k, sched.port, {"role": "server", "host": "127.0.0.1", "port": 1,
                                          "uid": "s0"})
        w0 = kits.RawNode(k, sched.port, worker)
        assert kits.wait(lambda: s0.books and w0.books, 5)
        w0.close()  # the suspend
        parked = kits.RawNode(k, sched.port, {**worker, "num_servers": 2}, beat=False)
        t0 = time.monotonic()
        assert kits.wait(lambda: sched.eviction_totals["worker"] == 1, 5)
        waited = time.monotonic() - t0
        assert parked.ended.wait(5)  # the eviction closed its connection
        assert kits.wait(lambda: len(s0.books) == 2, 5)
        got = {"server": s0.books, "parked": parked.books,
               "evictions": dict(sched.eviction_totals), "num_workers": sched.num_workers}
        s0.close()
    finally:
        sched.stop()
    assert waited >= 0.4, f"evicted after {waited:.2f} s, before the timeout"
    return got


@pytest.mark.parametrize("pkg", PKGS)
def test_a_parked_registration_is_evicted_after_the_timeout(pkg):
    got = _parked_past_the_timeout(pkg)
    assert got["parked"] == [] and got["num_workers"] == 0
    assert got["evictions"] == {"worker": 1, "server": 0}
    resize, book = got["server"][1]
    assert resize is True and book["num_workers"] == 0
    assert book["evictions"] == {"worker": 1, "server": 0}


def test_a_parked_eviction_sends_the_reference_books():
    assert _parked_past_the_timeout("port") == _parked_past_the_timeout("ref")


def _homes(client, keys) -> dict:
    return {key: client.server_for(key) for key in keys}


@pytest.mark.parametrize("pkg", PKGS)
def test_a_worker_resize_under_mixed_hashing(monkeypatch, pkg):
    """Three servers, workers 2 -> 1 (w1 evicted) -> 2 (w0 resizes live, a
    new worker joins), under ``BYTEPS_ENABLE_MIXED_MODE``: the same keys
    re-home in both packages.  The port's w0 bumps its generation at each
    change and, re-running the init barriers as its engine does on a bump,
    reads every round's exact sum; byteps_tpu's keeps its generation."""
    k = kits.kit(pkg)
    sched = k.Scheduler(num_workers=2, num_servers=3, host="127.0.0.1", dead_node_timeout=0.5)
    sched.start()
    kits.env(monkeypatch, sched, 2, 3, BYTEPS_HEARTBEAT_INTERVAL="0.1",
             BYTEPS_ENABLE_MIXED_MODE="1")
    srvs = [kits.start_server(k) for _ in range(3)]
    keys = list(range(300, 316))
    xs = kits.vals(13, 64, 6)
    port = pkg == "port"
    try:
        w0 = k.PSClient(k.Config.from_env(), node_uid="w0")
        w1 = k.PSClient(k.Config.from_env(), node_uid="w1")
        kits.in_threads(w0.connect, w1.connect)
        at2 = _homes(w0, keys)
        assert sorted(set(at2.values())) == [0, 1, 2]
        for key in keys:
            kits.init_key([w0, w1], key)
            for out in kits.round_([w0, w1], key, 1, xs[:2]):
                np.testing.assert_array_equal(out, xs[0] + xs[1])
        # 2 -> 1: w1 goes silent and is evicted; w0 follows the book live
        w1.close()
        assert kits.wait(lambda: w0.num_workers == 1, 10)
        at1 = _homes(w0, keys)
        assert at1 == {key: 2 for key in keys}  # one worker: every key on the last server
        assert w0.server_generation == (1 if port else 0)
        if port:
            assert kits.wait(lambda: all(s.num_workers == 1 for s in srvs))
            for key in keys:
                kits.init_key([w0], key)
                np.testing.assert_array_equal(kits.roundtrip(w0, key, xs[2], 1), xs[2])
        # 1 -> 2: w0 asks for two workers (its job's map still lists one),
        # a new worker takes the rank w1 left and w0 follows that book live
        w0.request_resize(num_workers=2)
        w2 = k.PSClient(k.Config.from_env(), node_uid="w2-new")
        w2.connect()
        assert w2.rank == 1 - w0.rank and kits.wait(lambda: w0.num_workers == 2, 10)
        assert _homes(w0, keys) == at2
        assert w0.server_generation == (2 if port else 0)
        if port:
            assert kits.wait(lambda: all(s.num_workers == 2 for s in srvs))
            for key in keys:
                kits.init_key([w0, w2], key)
                for out in kits.round_([w0, w2], key, 1, xs[3:5]):
                    np.testing.assert_array_equal(out, xs[3] + xs[4])
        w2.close()
        w0.close()
    finally:
        for s in srvs:
            s.stop()
        sched.stop()
