"""The autotuner in live fleets with the port's scheduler: with the tuner
off, the books and the heartbeat replies are what they were before it; with
it on, the books equal byte_tpu's scheduler's field for field after a
scripted sequence; a forced move lands through the migration plane with
pulls bitwise; a forced fusion threshold reaches the engine and its
canary rolls it back; codec consensus flips a port worker and a
byteps_tpu worker together; and a restarted scheduler keeps the fleet's
tuning, or with no tuner reverts it.  Every comparison is exact."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import torch_port_kits as kits
from byteps_tpu_torch.common.hashing import HashRing

PKGS = ["port", "ref"]
FAST = {"BYTEPS_HEARTBEAT_INTERVAL": "0.1", "BYTEPS_SCHED_RECONNECT_BACKOFF_S": "0.05",
        "BYTEPS_SCHED_RECONNECT_RETRIES": "60", "BYTEPS_CONNECT_RETRY_S": "0.2",
        "BYTEPS_SCHED_REJOIN_WINDOW_S": "10"}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_AUTOTUNE_FORCE", "BYTEPS_AUTOTUNE", "BYTEPS_FLIGHT_DIR"):
        monkeypatch.delenv(k, raising=False)
    yield from kits.reset_runtime(monkeypatch)


def _key_on(rank: int, ranks=(0, 1), skip: int = 0) -> int:
    ring = HashRing(list(ranks))
    return [k << 16 for k in range(1, 1 << 12) if ring.owner(k << 16) == rank][skip]


def _book_frame(sched) -> bytes:
    a, b = socket.socketpair()
    try:
        sched._send_addrbook_to(a, threading.Lock(), "worker", 0, 0)
        b.settimeout(5)
        from byteps_tpu_torch.comm.transport import recv_message

        return bytes(recv_message(b).payload)
    finally:
        a.close()
        b.close()


def test_with_the_tuner_off_a_book_is_byte_for_byte_the_parents(monkeypatch):
    from byteps_tpu_torch.comm.rendezvous import Scheduler

    sched = Scheduler(num_workers=1, num_servers=1, host="127.0.0.1")
    try:
        assert sched.tuner is None
        legacy = {"role": "worker", "rank": 0, "num_workers": 1, "num_servers": 1,
                  "servers": [], "is_recovery": False, "epoch": 0,
                  "evictions": {"worker": 0, "server": 0}, "worker_ranks": [],
                  "server_ranks": [], "map_epoch": 0, "sched_incarnation": sched.incarnation,
                  "jobs": {}}
        assert _book_frame(sched) == json.dumps(legacy).encode()
    finally:
        sched.stop()


@pytest.mark.parametrize("tuner", [False, True], ids=["tuner_off", "tuner_on"])
def test_a_heartbeat_delta_is_aggregated_and_the_reply_stays_empty(monkeypatch, tuner):
    k = kits.kit("port")
    if tuner:
        monkeypatch.setenv("BYTEPS_AUTOTUNE", "1")
    sched = k.Scheduler(num_workers=1, num_servers=0, host="127.0.0.1")
    sched.start()
    sock = None
    try:
        sock, reply = kits.register_raw(k, sched.port, {"role": "worker", "host": "",
                                                        "port": 0, "uid": "hb-w0"})
        assert ("tuning" in kits.book_of(reply)) == tuner
        delta = {"c": {"rpc_retry": 3}, "lc": {"compression_auto_off": {
            json.dumps([["codec", "topk"]]): 1}},
            "fr": [{"step": 1, "k": "step", "dur": 0.5, "t": 0, "deg": 0, "trig": [],
                    "rpc": {}}]}
        k.tr.send_message(sock, k.tr.Message(k.tr.Op.PING, seq=7,
                                             payload=json.dumps(delta).encode()))
        ack = k.tr.recv_message(sock)
        assert (ack.op, ack.seq, ack.status, ack.flags, ack.key, bytes(ack.payload)) == (
            k.tr.Op.PING, 7, 0, 0, 0, b"")
        agg = sched.metrics_agg.counters
        assert agg.get("rpc_retry") == 3
        assert agg.labeled_raw()["compression_auto_off"] == {
            (("codec", "topk"), ("rank", "0"), ("role", "worker")): 1}
        assert [r["dur"] for r in sched.flight.matrix()["worker0"]] == [0.5]
    finally:
        if sock is not None:
            sock.close()
        sched.stop()


def _scripted_books(k, monkeypatch, key: int) -> list:
    """One worker and two servers register (raw nodes), the tuner sweeps
    once (a forced move of ``key`` to rank 1), and the books each node got."""
    monkeypatch.setenv("BYTEPS_AUTOTUNE", "1")
    monkeypatch.setenv("BYTEPS_ELASTIC_RESHARD", "1")
    monkeypatch.setenv("BYTEPS_AUTOTUNE_INTERVAL_S", "3600")
    monkeypatch.setenv("BYTEPS_AUTOTUNE_FORCE", f"move={key}:1")
    sched = k.Scheduler(num_workers=1, num_servers=2, host="127.0.0.1")
    sched.start()
    nodes = []
    try:
        for i in range(2):
            nodes.append(kits.RawNode(k, sched.port, {"role": "server", "host": "127.0.0.1",
                                                      "port": 1000 + i, "uid": f"s{i}"}))
            assert kits.wait(lambda i=i: len(sched._nodes["server"]) == i + 1)
        nodes.append(kits.RawNode(k, sched.port, {"role": "worker", "host": "", "port": 0,
                                                  "uid": "w0", "num_workers": 1,
                                                  "num_servers": 2}))
        assert kits.wait(lambda: all(n.books for n in nodes))
        sched._tuner_sweep_once()
        assert kits.wait(lambda: all(len(n.books) == 2 for n in nodes))
        return [n.books for n in nodes]
    finally:
        for n in nodes:
            n.close()
        sched.stop()


def test_with_the_tuner_on_the_books_equal_the_references(monkeypatch):
    key = _key_on(0)
    port = _scripted_books(kits.kit("port"), monkeypatch, key)
    ref = _scripted_books(kits.kit("ref"), monkeypatch, key)
    assert port == ref
    first, moved = port[2][0][1], port[2][1]
    assert first["tuning"] == {"epoch": 0} and "ring_overrides" not in first
    assert moved[0] is True and moved[1]["tuning"] == {"epoch": 1}
    assert moved[1]["ring_overrides"] == {str(key): 1}
    assert moved[1]["map_epoch"] == first["map_epoch"] + 1


# --- live fleets ------------------------------------------------------------


def _fleet(monkeypatch, workers: int = 1, server_beats: bool = True, **extra):
    k = kits.kit("port")
    for name, v in {**FAST, "BYTEPS_AUTOTUNE": "1", "BYTEPS_ELASTIC_RESHARD": "1",
                    "BYTEPS_AUTOTUNE_INTERVAL_S": "0.2", **extra}.items():
        monkeypatch.setenv(name, v)
    sched = k.Scheduler(num_workers=workers, num_servers=2, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, workers, 2, **FAST)
    servers = []
    for _ in range(2):
        cfg = k.Config.from_env()
        if not server_beats:
            # the servers share the port worker's registry in process: with
            # no beats of theirs, its deltas go out under its own rank
            cfg.heartbeat_interval = 0.0
        servers.append(kits.start_server(k, cfg))
    return k, sched, servers


def _moved(k) -> int:
    return k.counters().get("migration_keys_moved")


def test_a_forced_move_lands_with_pulls_bitwise(monkeypatch):
    key = _key_on(0)
    # the test sweeps by hand once every key's INIT has answered: a forced
    # move fires on the first sweep, and a sweep of the scheduler's own loop
    # could come before the INITs, when no server holds the key yet
    k, sched, servers = _fleet(monkeypatch, BYTEPS_AUTOTUNE_FORCE=f"move={key}:1",
                               BYTEPS_RPC_RETRIES="4", BYTEPS_AUTOTUNE_INTERVAL_S="3600")
    pc = k.PSClient(k.Config.from_env())
    keys = [key, _key_on(0, skip=1), _key_on(1)]
    xs = {kk: kits.vals(60 + i, 256, 12) for i, kk in enumerate(keys)}
    moved0 = _moved(k)
    try:
        pc.connect()
        for kk in keys:
            pc.init_tensor(kk, 256, 0)
        sched._tuner_sweep_once()
        ver = 0
        while ver < 10 and not (sched.tuner.state.overrides and _moved(k) > moved0):
            ver += 1
            for kk in keys:
                np.testing.assert_array_equal(kits.roundtrip(pc, kk, xs[kk][ver - 1], ver),
                                              xs[kk][ver - 1])
            time.sleep(0.1)
        assert sched.tuner.state.overrides == {key: 1}, "the forced move never came"
        assert kits.wait(lambda: _moved(k) > moved0)
        for v in (ver + 1, ver + 2):
            for kk in keys:
                np.testing.assert_array_equal(kits.roundtrip(pc, kk, xs[kk][v - 1], v),
                                              xs[kk][v - 1])
        owner = next(s for s in servers if s.rank == 1)
        assert owner._keys[key].store is not None and owner._keys[key].migrated_to is None
        assert pc.server_generation == 0 and pc.map_epoch >= 2
        assert pc._routing[2].owner(key) == 1
        assert sched.tuner.actions[0]["rule"] == "hot_key_rebalance"
    finally:
        pc.close()
        for s in servers:
            s.stop()
        sched.stop()


def test_a_forced_fusion_threshold_reaches_the_engine_and_its_canary_rolls_it_back(
        monkeypatch, tmp_path):
    import byteps_tpu_torch as pbps
    from byteps_tpu_torch.core.state import get_state

    k, sched, servers = _fleet(monkeypatch, BYTEPS_AUTOTUNE_INTERVAL_S="3600",
                               BYTEPS_AUTOTUNE_FORCE="fusion_threshold=4096",
                               BYTEPS_AUTOTUNE_CANARY_SWEEPS="1",
                               BYTEPS_FLIGHT_DIR=str(tmp_path),
                               BYTEPS_FUSION_THRESHOLD="256", BYTEPS_PARTITION_BYTES="1024")
    rng = np.random.default_rng(5)
    xs = [rng.integers(-8, 8, 700).astype(np.float32) for _ in range(6)]
    try:
        pbps.init(device="cpu")
        eng = get_state().engine

        def step(i):
            x = torch.from_numpy(xs[i].copy())
            assert torch.equal(pbps.push_pull(x, name="fz.w", average=False), x)

        step(0)
        step(1)
        assert kits.wait(lambda: any(r.get("k") == "step"
                                     for r in sched.flight.matrix().get("worker0", [])))
        assert kits.wait(lambda: sched._tuner_view()["fusion"]["threshold"] == 256)
        res = sched._tuner_sweep_once()
        assert [a["rule"] for a in res["actions"]] == ["fusion_threshold"]
        assert sched.tuner.state.fusion_threshold == 4096
        assert kits.wait(lambda: eng.cfg.fusion_threshold == 4096)
        step(2)
        real_view = sched._tuner_view
        monkeypatch.setattr(sched, "_tuner_view", lambda: {
            **real_view(), "steps": {"worker0": 1e3}})
        res = sched._tuner_sweep_once()
        assert [c["rule"] for c in res["rollbacks"]] == ["fusion_threshold"]
        assert sched.tuner.state.fusion_threshold == 256  # the concrete value before
        assert kits.wait(lambda: eng.cfg.fusion_threshold == 256)
        step(3)
        assert sum(sched.metrics_agg.counters.labeled_raw()["tune_rollback"].values()) == 1
        assert len(list(tmp_path.glob("*-tune-*-fusion_threshold-*/decision.json"))) == 2
        pbps.shutdown()
    finally:
        pbps.shutdown()
        for s in servers:
            s.stop()
        sched.stop()


def test_codec_consensus_flips_a_port_and_a_reference_worker_together(monkeypatch):
    """Each worker's static verdict turns topk's 100-float tail partition
    raw and votes ``compression_auto_off{codec="topk"}``; the tuner turns
    topk off fleet-wide, both workers' full partition pushes raw from the
    next round, and each round's pulls are bitwise the same on both and
    the sum of the decoded pushes."""
    import byteps_tpu as rbps
    import byteps_tpu_torch as pbps
    from byteps_tpu.compression.impl import TopKCompressor
    from byteps_tpu.core.state import get_state as ref_state
    from byteps_tpu_torch.core.state import get_state as port_state

    # the votes are the processes' registries: an earlier test in this
    # process (another file's, under xdist) may have left a verdict of
    # another codec there, which the first heartbeat to this scheduler
    # would ship as votes
    for tel in ("byteps_tpu.core.telemetry", "byteps_tpu_torch.core.telemetry"):
        mod = __import__(tel, fromlist=["counters"])
        mod.counters().reset()
        mod.metrics().reset()
    k, sched, servers = _fleet(monkeypatch, workers=2, server_beats=False,
                               BYTEPS_COMPRESSION_AUTO="1", BYTEPS_PARTITION_BYTES="4096",
                               BYTEPS_MIN_COMPRESS_BYTES="0")
    kw = {"byteps_compressor_type": "topk", "byteps_compressor_k": "100"}
    rng = np.random.default_rng(12)
    grads = [[rng.standard_normal(1124).astype(np.float32) for _ in range(2)]
             for _ in range(3)]
    out = {"port": [], "ref": []}
    engines = {}
    # the rounds start together, the test's thread the third party: round
    # 1 waits until both workers adopted the flip (no mixed round here)
    go = [threading.Barrier(3) for _ in range(4)]

    def worker(pkg, api, w):
        if pkg == "port":
            api.init(device="cpu")
        else:
            api.init()
        api.declare_tensor("cc.w", **kw)
        engines[pkg] = (port_state if pkg == "port" else ref_state)().engine
        for r in range(3):
            go[r].wait(30)
            g = grads[r][w]
            src = torch.from_numpy(g.copy()) if pkg == "port" else g.copy()
            out[pkg].append(np.asarray(api.push_pull(src, name="cc.w", average=False)))
        go[3].wait(30)
        api.shutdown()

    threads = [threading.Thread(target=worker, args=("port", pbps, 0), daemon=True),
               threading.Thread(target=worker, args=("ref", rbps, 1), daemon=True)]
    try:
        for t in threads:
            t.start()
        go[0].wait(30)
        assert kits.wait(lambda: len(out["port"]) == len(out["ref"]) == 1, 30)
        assert kits.wait(lambda: all("topk" in e._fleet_codec_off for e in engines.values()),
                         15), "codec consensus never reached both workers"
        assert all(len(e._fleet_codec_off["topk"]) == 1 for e in engines.values())
        for b in go[1:]:
            b.wait(30)
        assert kits.wait(lambda: all(len(o) == 3 for o in out.values()), 30)
        for t in threads:
            t.join(30)
        head = 1024

        def topk_rt(x):
            c = TopKCompressor(x.size, 100)
            return c.decompress(c.compress(x), x.size)

        for r in range(3):
            a, b = grads[r]
            want = a + b
            if r == 0:  # the full partition compressed before the flip
                want[:head] = topk_rt(topk_rt(a[:head]) + topk_rt(b[:head]))
            assert out["port"][r].tobytes() == out["ref"][r].tobytes(), r
            assert out["port"][r].tobytes() == want.tobytes(), r
        acts = sched.tuner.actions
        assert [a["rule"] for a in acts] == ["codec_consensus"]
        assert acts[0]["evidence"]["codec"] == "topk"
        assert k.counters().snapshot_labeled()["tune_codec_off"]['{codec="topk"}'] >= 1
    finally:
        for s in servers:
            s.stop()
        sched.stop()


@pytest.mark.parametrize("successor", ["tuner", "tunerless"])
def test_a_restarted_scheduler_and_the_fleets_tuning(monkeypatch, successor):
    """A successor with a tuner takes up the fleet's tuning from the
    rejoin reports: the same tuning epoch and overrides, and no key
    migrates home.  A successor without one sends books with no section:
    the override goes, the key migrates home, and the rounds stay bitwise
    throughout."""
    key = _key_on(0)
    k, sched, servers = _fleet(monkeypatch, BYTEPS_AUTOTUNE_FORCE=f"move={key}:1",
                               BYTEPS_RPC_RETRIES="4")
    pc = k.PSClient(k.Config.from_env())
    xs = kits.vals(70, 128, 12)
    sched2 = None
    try:
        pc.connect()
        pc.init_tensor(key, 128, 0)
        ver = 0

        def rnd():
            nonlocal ver
            ver += 1
            np.testing.assert_array_equal(kits.roundtrip(pc, key, xs[ver - 1], ver),
                                          xs[ver - 1])

        rnd()
        assert kits.wait(lambda: pc._routing[2] is not None and pc._routing[2].owner(key) == 1)
        rnd()
        assert kits.wait(lambda: all(s._seen_ring_overrides == {str(key): 1} for s in servers))
        before = dict(pc.tuning)
        moved = _moved(k)
        inc, port = sched.incarnation, sched.port
        sched.crash()
        rnd()
        monkeypatch.delenv("BYTEPS_AUTOTUNE_FORCE")
        if successor == "tunerless":
            monkeypatch.delenv("BYTEPS_AUTOTUNE")
        sched2 = k.Scheduler(1, 2, host="127.0.0.1", port=port)
        sched2.start()
        assert kits.wait(lambda: pc.sched_incarnation > inc and sched2._addrbook_sent
                         and pc.map_epoch > 2, 20)
        if successor == "tuner":
            assert kits.wait(lambda: pc.tuning == before)
            assert sched2.tuner.state.overrides == {key: 1}
            assert pc._routing[2].owner(key) == 1
            rnd()
            rnd()
            assert _moved(k) == moved
        else:
            assert kits.wait(lambda: pc.tuning is None)
            assert kits.wait(lambda: pc._routing[2].owner(key) == 0)
            rnd()
            assert kits.wait(lambda: _moved(k) > moved)
            rnd()
        assert pc.server_generation == 0
    finally:
        pc.close()
        for s in servers:
            s.stop()
        sched.stop()
        if sched2 is not None:
            sched2.stop()
