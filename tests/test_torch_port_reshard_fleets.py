"""Online resharding through the port's scheduler (the fleet cases of
``tests/test_reshard.py``): a live scale-up then a drain back, with pulls
bitwise throughout, ``server_generation`` 0, the migration counted and the
drained server stopping by itself; the same through the engine, with
push_pull and with the server-side Adam bitwise a fleet that never
resizes; and a worker resize under mixed hashing, which must not re-init
the keys while the ownership map routes.  Inputs come from numpy seeds;
every comparison is exact."""

import threading

import numpy as np
import pytest
import torch

import torch_port_kits as kits
from byteps_tpu_torch.common.hashing import HashRing

PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _fleet(monkeypatch, servers: int = 2, **extra):
    """The port's scheduler and ``servers`` port servers, all with
    resharding on; the environment is a one-worker job's."""
    k = kits.kit("port")
    monkeypatch.setenv("BYTEPS_ELASTIC_RESHARD", "1")
    sched = k.Scheduler(num_workers=1, num_servers=servers, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 1, servers, BYTEPS_HEARTBEAT_INTERVAL="0.1", **extra)
    return sched, [kits.start_server(k) for _ in range(servers)]


def _join(monkeypatch, pkg: str):
    """A server of ``pkg`` that registers with the scheduler now."""
    k = kits.kit(pkg)
    monkeypatch.setenv("DMLC_NUM_SERVER", "3")
    return kits.start_server(k, k.Config.from_env())


@pytest.mark.parametrize("joiner", PKGS)
def test_scale_up_then_drain_keeps_every_key(monkeypatch, joiner):
    """One worker, two servers; a scale-up to three (the joiner of either
    package) and a drain back to two, rounds bitwise before, between and
    after, no re-init, and the joiner stops by itself once drained."""
    from byteps_tpu_torch.comm.ps_client import PSClient
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core.telemetry import counters

    sched, fleet = _fleet(monkeypatch, rpc_retries="4")
    k = kits.kit(joiner)
    pc = PSClient(Config.from_env())
    extra = None
    moved0 = counters().get("migration_keys_moved") + k.counters().get("migration_keys_moved")
    keys = [i << 16 for i in range(12)]
    xs = {key: kits.vals(40 + i, 16, 3) for i, key in enumerate(keys)}

    def rounds(version: int) -> None:
        for key in keys:
            out = kits.roundtrip(pc, key, xs[key][version - 1], version, timeout=15)
            np.testing.assert_array_equal(out, xs[key][version - 1])

    try:
        pc.connect()
        for key in keys:
            pc.init_tensor(key, 16, 0)
        rounds(1)
        resize = threading.Thread(target=pc.request_resize, kwargs={"num_servers": 3},
                                  daemon=True)
        resize.start()
        assert kits.wait(lambda: sched.num_servers == 3)
        extra = _join(monkeypatch, joiner)
        resize.join(20)
        assert not resize.is_alive(), "the scale-up never answered"
        ring = HashRing([0, 1, 2])
        homed = [key for key in keys if ring.owner(key) == 2]
        assert homed and kits.wait(lambda: all(
            extra._keys.get(key) is not None and extra._keys[key].store is not None
            for key in homed)), "the joiner never received its keys"
        rounds(2)
        assert pc.server_generation == 0 and pc.map_epoch >= 2 and len(pc._servers) == 3
        pc.request_resize(num_servers=2)
        assert kits.wait(lambda: extra._stop.is_set(), 15), "the drained server never stopped"
        rounds(3)
        assert pc.server_generation == 0
        def moved() -> int:
            # an old owner counts a key moved once it has read the ack
            return (counters().get("migration_keys_moved")
                    + k.counters().get("migration_keys_moved") - moved0)

        assert kits.wait(lambda: moved() >= 2 * len(homed)), moved()
    finally:
        pc.close()
        for s in fleet + ([extra] if extra is not None else []):
            s.stop()
        sched.stop()


def _train(monkeypatch, resize: bool, server_side: bool):
    """Six steps of one worker through the engine (``bps.init``), with a
    live scale-up after step 2 and a drain after step 4 when ``resize``:
    the push_pull outputs (or, with ``server_side``, the parameters the
    servers' Adam computes), and the counters the resize moved."""
    import byteps_tpu_torch as pbps
    from byteps_tpu_torch.common.config import clear_config
    from byteps_tpu_torch.common.registry import reset_registry
    from byteps_tpu_torch.core.state import get_state

    sched, fleet = _fleet(monkeypatch, BYTEPS_PARTITION_BYTES="256",
                          BYTEPS_FUSION_THRESHOLD="64")
    extra = None
    rng = np.random.default_rng(9)
    shapes = {"w0": (48,), "w1": (8, 12), "b0": (6,), "b1": (130,)}
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(6)]
    out = []
    try:
        pbps.init(device="cpu")
        if server_side:
            params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                      for n, v in init.items()}
            opt = pbps.DistributedOptimizer(None, named_parameters=list(params.items()),
                                            server_side=True, server_rule="adam",
                                            server_hp={"lr": 0.01})
        for step, g in enumerate(grads):
            if resize and step in (2, 4):
                if step == 2:
                    t = threading.Thread(target=pbps.resume, kwargs={"num_servers": 3},
                                         daemon=True)
                    t.start()
                    assert kits.wait(lambda: sched.num_servers == 3)
                    extra = _join(monkeypatch, "port")
                    t.join(20)
                    assert not t.is_alive()
                else:
                    pbps.resume(num_servers=2)  # the steps go on while it drains
            if server_side:
                for n, p in params.items():
                    p.grad = torch.from_numpy(g[n].copy())
                opt.step()
                assert opt.state == {}
                out.append({n: p.detach().numpy().copy() for n, p in params.items()})
            else:
                hs = {n: pbps.push_pull_async(torch.from_numpy(v), name=n, average=True)
                      for n, v in g.items()}
                out.append({n: pbps.synchronize(h).numpy().copy() for n, h in hs.items()})
        client = get_state().ps_client
        gen = client.server_generation
        pbps.shutdown()
        assert extra is None or kits.wait(lambda: extra._stop.is_set(), 15)
        return out, gen, extra
    finally:
        pbps.shutdown()
        for s in fleet + ([extra] if extra is not None else []):
            s.stop()
        sched.stop()
        reset_registry()
        clear_config()


@pytest.mark.parametrize("server_side", [False, True], ids=["push_pull", "server_adam"])
def test_the_engine_trains_through_a_scale_up_and_a_drain(monkeypatch, server_side):
    """Through ``bps.resume(num_servers=)`` on a live worker: every step
    bitwise the run on a fleet that never resizes, no re-init, and keys
    shipped both ways."""
    from byteps_tpu_torch.core.telemetry import counters

    still, gen0, _ = _train(monkeypatch, resize=False, server_side=server_side)
    moved0 = counters().get("migration_keys_moved")
    moved, gen1, extra = _train(monkeypatch, resize=True, server_side=server_side)
    assert gen0 == gen1 == 0
    assert counters().get("migration_keys_moved") > moved0
    assert extra is not None and extra._stop.is_set() and extra.owned_keys() == 0
    for a, b in zip(still, moved):
        for n in a:
            assert a[n].tobytes() == b[n].tobytes()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_worker_resize_under_mixed_hashing_keeps_the_generation(monkeypatch, pkg):
    """Mixed hashing routes by the worker count, the ownership map does
    not: with resharding on, a worker-count book re-homes nothing, so the
    live worker runs no re-init (the port's sixth divergence stays off the
    map's path), and its rounds go on bitwise."""
    k = kits.kit(pkg)
    sched, fleet = _fleet(monkeypatch, servers=3, BYTEPS_ENABLE_MIXED_MODE="1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    sched.num_workers = 2
    x = kits.vals(3, 64, 4)
    try:
        cfg = k.Config.from_env()
        w0, w1 = k.PSClient(cfg, node_uid="w0"), k.PSClient(cfg, node_uid="w1")
        kits.in_threads(w0.connect, w1.connect)
        kits.init_key([w0, w1], 7 << 16)
        for out in kits.round_([w0, w1], 7 << 16, 1, x[:2]):
            np.testing.assert_array_equal(out, x[0] + x[1])
        w1.close()
        assert kits.wait(lambda: [r for r, _ in sched._conn_ids.values()].count("worker") == 1)
        w0.request_resize(num_workers=1)
        assert w0.num_workers == 1 and w0.server_generation == 0
        assert kits.wait(lambda: all(s.num_workers == 1 for s in fleet))
        np.testing.assert_array_equal(kits.roundtrip(w0, 7 << 16, x[2], 2), x[2])
        w0.close()
    finally:
        for s in fleet:
            s.stop()
        sched.stop()


def test_pushes_racing_a_migration_are_summed_exactly_once(monkeypatch):
    """Sixteen threads push async keys (each push adds 1 to its key's
    cumulative store) from before a scale-up until after the drain back,
    with the interpreter switching threads every 10 us: every key's store
    is its pushes' count exactly, whether a push landed before its key's
    snapshot, was redirected after it, or was sent again over a torn
    connection (the migrated ledger dedupes it)."""
    import sys

    from byteps_tpu_torch.comm.ps_client import PSClient
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core.telemetry import counters

    sched, fleet = _fleet(monkeypatch, BYTEPS_RPC_RETRIES="6")
    pc = PSClient(Config.from_env())
    extra = None
    keys = [i << 16 for i in range(16)]
    n = 8
    stop = threading.Event()
    sent = {key: 0 for key in keys}
    errors: list = []
    switch = sys.getswitchinterval()

    def pushes(key: int) -> None:
        while not stop.is_set():
            done = threading.Event()
            pc.push(key, np.ones(n, np.float32).tobytes(), 0, sent[key] + 1, cb=done.set,
                    on_error=lambda why: (errors.append(why), done.set()))
            assert done.wait(30), f"push {sent[key] + 1} of key {key} hung"
            sent[key] += 1

    workers = [threading.Thread(target=pushes, args=(k,), daemon=True) for k in keys]
    try:
        pc.connect()
        for key in keys:
            pc.init_tensor(key, n, 0, async_profile=True)
        moved0 = counters().get("migration_keys_moved")
        sys.setswitchinterval(1e-5)
        for t in workers:
            t.start()
        assert kits.wait(lambda: min(sent.values()) >= 5)
        resize = threading.Thread(target=pc.request_resize, kwargs={"num_servers": 3})
        resize.start()
        assert kits.wait(lambda: sched.num_servers == 3)
        extra = _join(monkeypatch, "port")
        resize.join(30)
        assert not resize.is_alive()
        mark = dict(sent)
        assert kits.wait(lambda: all(sent[k] >= mark[k] + 5 for k in keys))
        pc.request_resize(num_servers=2)
        mark = dict(sent)
        assert kits.wait(lambda: all(sent[k] >= mark[k] + 5 for k in keys))
        stop.set()
        for t in workers:
            t.join(60)
        assert not any(t.is_alive() for t in workers)
        sys.setswitchinterval(switch)
        assert not errors, errors[:3]
        assert kits.wait(lambda: extra._stop.is_set(), 15)
        assert counters().get("migration_keys_moved") - moved0 >= 2
        for key in keys:
            got, box = threading.Event(), []
            pc.pull(key, sent[key], lambda p: (box.append(bytes(p)), got.set()),
                    on_error=lambda why: got.set())
            assert got.wait(15) and box
            np.testing.assert_array_equal(np.frombuffer(box[0], np.float32),
                                          np.full(n, sent[key], np.float32))
        assert pc.server_generation == 0
    finally:
        stop.set()
        sys.setswitchinterval(switch)
        pc.close()
        for s in fleet + ([extra] if extra is not None else []):
            s.stop()
        sched.stop()
