"""The port's recovery plane against byteps_tpu's: the round journal, the
RESYNC frames, the servers' answers, and the heals.

- ``comm/journal.py``: the same record / evict / watermark / clear
  sequence leaves the same entries and stats in both packages.
- The RESYNC codecs are byte for byte the reference's, and a port server's
  RESYNC answer after the same pushes equals a byteps_tpu server's (the
  port's C++ engine answers it too); a malformed query drops the
  connection (``tests/test_torch_port_ps.py``).
- A one-sided give-up heals in place: a port worker whose pushes to its
  server die past its retries resyncs, replays the journaled round and
  goes on, with no init barrier, against the port's Python and C++
  server engines, alone and beside a byteps_tpu worker that never
  blocks; every pull of both workers is bitwise the fault-free run's.
- An INIT whose ack was lost after its barrier released is acked from
  the barrier's token record.

``DegradedError`` and the degraded-step heal are in
``tests/test_torch_port_degraded.py``.

Exact throughout: entries, bytes, answers and pulls are compared for
equality.
"""

import contextlib
import struct
import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.comm import chaos as rchaos
from byteps_tpu.comm import journal as rjournal
from byteps_tpu.comm import transport as rtr
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.core.telemetry import counters as ref_counters
from byteps_tpu.server.server import PSServer as RefServer
from byteps_tpu_torch.comm import chaos as pchaos
from byteps_tpu_torch.comm import journal as pjournal
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.telemetry import counters
from byteps_tpu_torch.server.native import NativePSServer as PortNativeServer
from byteps_tpu_torch.server.server import PSServer as PortServer

CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, int(DataType.FLOAT32))
#: the heal's knobs: a push and its two retries die (the budget), then the
#: wire is clean
VICTIM = {"BYTEPS_CHAOS_SEED": "5", "BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "11",
          "BYTEPS_CHAOS_FAULT_BUDGET": "3", "BYTEPS_RPC_DEADLINE_S": "0.2",
          "BYTEPS_RPC_RETRIES": "2", "BYTEPS_RPC_BACKOFF_S": "0.02",
          "BYTEPS_INIT_DEADLINE_S": "1.0", "BYTEPS_CONNECT_RETRY_S": "0.2"}


def _reset_chaos() -> None:
    for mod in (pchaos, rchaos):
        mod.reset_conn_indices()
        mod.reset_fault_budget()


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_VAN", "BYTEPS_WIRE_CHECKSUM", "BYTEPS_NATIVE_CLIENT",
              "BYTEPS_DEGRADED_STEP_RETRIES"):
        monkeypatch.delenv(k, raising=False)
    _reset_chaos()
    counters().reset()
    ref_counters().reset()
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()
    _reset_chaos()


# --- the journal --------------------------------------------------------------


def _journal_ops(seed: int) -> list:
    """A seeded sequence of records (replacing some rounds), watermark
    reads and key clears over a few keys."""
    rng = np.random.default_rng(seed)
    ops = []
    versions = {}
    for _ in range(200):
        key = int(rng.integers(0, 6))
        roll = rng.random()
        if roll < 0.75:
            v = versions.get(key, 0) + (0 if rng.random() < 0.1 else 1)
            versions[key] = v
            n = int(rng.integers(0, 300))
            ops.append(("record", key, v, int(rng.integers(0, 1 << 20)),
                        rng.integers(0, 256, n, dtype=np.uint8).tobytes(), bool(rng.random() < 0.3)))
        elif roll < 0.95:
            ops.append(("after", key, int(rng.integers(0, versions.get(key, 0) + 1))))
        else:
            ops.append(("clear", key))
    return ops


def _replay(mod, max_rounds: int, max_bytes: int, ops: list) -> list:
    j = mod.RoundJournal(max_rounds, max_bytes)
    seen = []
    for op in ops:
        if op[0] == "record":
            j.record(op[1], op[2], op[3], memoryview(op[4]), fused=op[5])
        elif op[0] == "after":
            seen.append([(e.version, e.cmd, e.payload, e.fused)
                         for e in j.entries_after(op[1], op[2])])
        else:
            j.clear_key(op[1])
    full = {k: [(e.version, e.cmd, e.payload, e.fused) for e in j.entries_after(k, 0)]
            for k in sorted(j.keys())}
    return [seen, full, j.stats()]


@pytest.mark.parametrize("max_rounds,max_bytes,seed", [
    (2, 64 << 20, 0), (1, 1000, 1), (3, 2500, 2), (5, 300, 3)])
def test_the_journal_equals_the_reference(max_rounds, max_bytes, seed):
    ops = _journal_ops(seed)
    assert _replay(pjournal, max_rounds, max_bytes, ops) == _replay(
        rjournal, max_rounds, max_bytes, ops)


def test_the_journal_copies_the_payload_and_configure_starts_anew():
    buf = bytearray(b"abcd")
    j = pjournal.configure_journal(2, 100)
    j.record(1, 1, 7, memoryview(buf))
    buf[0] = ord("z")
    assert pjournal.get_journal() is j and j.entries_after(1, 0)[0].payload == b"abcd"
    assert pjournal.configure_journal(2, 100) is not j
    assert pjournal.get_journal().keys() == []
    assert pjournal.configure_journal(0, 100) is None and pjournal.get_journal() is None


# --- the frames and the servers' answer ---------------------------------------


@pytest.mark.parametrize("keys", [[], [5], [1, 2, 1 << 40]])
def test_resync_codecs_equal_the_reference(keys):
    assert ptr.encode_resync_query(3, keys) == rtr.encode_resync_query(3, keys)
    assert ptr.decode_resync_query(rtr.encode_resync_query(3, keys)) == (3, keys)
    states = {k: {"store_version": i, "seen": i - 1, "recv_count": 0, "init": True}
              for i, k in enumerate(keys, 1)}
    body = ptr.encode_resync_state(states)
    assert body == rtr.encode_resync_state(states)
    assert ptr.decode_resync_state(body) == rtr.decode_resync_state(body) == states
    for bad in (b"[1]", b'{"keys": [1]}'):
        with pytest.raises(ValueError):
            (ptr.decode_resync_query if bad == b"[1]" else ptr.decode_resync_state)(bad)


def _ledger_answer(make_server, query_keys) -> dict:
    """Two workers push two keys over two rounds (worker 2 skips key 8's
    second round), then worker 1 and worker 2 ask: the decoded answers."""
    srv = make_server()
    srv.start(register=False)
    tr = ptr
    socks = [tr.connect(srv.host if not srv.host.startswith("chaos+") else "127.0.0.1",
                        srv.port) for _ in range(2)]
    try:
        seq = 0
        for key in (7, 8):
            for w, sock in enumerate(socks, 1):
                tr.send_message(sock, tr.Message(tr.Op.INIT, key=key, seq=seq, flags=w,
                                                 payload=struct.pack("!QI", 4, int(DataType.FLOAT32))))
                seq += 1
        for sock in socks:
            for _ in range(2):
                assert tr.recv_message(sock).op == tr.Op.INIT
        x = np.arange(4, dtype=np.float32).tobytes()
        for version in (1, 2):
            for key in (7, 8):
                for w, sock in enumerate(socks, 1):
                    if (w, key, version) == (2, 8, 2):
                        continue
                    tr.send_message(sock, tr.Message(tr.Op.PUSH, key=key, seq=seq, flags=w,
                                                     cmd=CMD_F32, version=version, payload=x))
                    seq += 1
                    assert tr.recv_message(sock).op == tr.Op.PUSH
        out = {}
        for w, sock in enumerate(socks, 1):
            tr.send_message(sock, tr.Message(tr.Op.RESYNC_QUERY, key=7, seq=seq, flags=w,
                                             payload=tr.encode_resync_query(w, query_keys)))
            reply = tr.recv_message(sock)
            assert (reply.op, reply.seq, reply.key, reply.status) == (
                tr.Op.RESYNC_STATE, seq, 7, 0)
            out[w] = tr.decode_resync_state(reply.payload)
            seq += 1
        return out
    finally:
        for sock in socks:
            tr.close_socket(sock)
        srv.stop()


@pytest.mark.parametrize("server", ["port", "port-native"])
@pytest.mark.parametrize("query_keys", [[7, 8, 99], []])
def test_a_port_servers_resync_answer_equals_the_reference(server, query_keys):
    """A well-formed query: per key, the store's version, the asking
    worker's newest summed push (``seen``) and the round's pushes so far;
    a key the server does not hold is left out."""
    cfg = dict(num_worker=2, num_server=1)
    make = (lambda: PortServer(PortConfig(**cfg))) if server == "port" else (
        lambda: PortNativeServer(PortConfig(**cfg)))
    got = _ledger_answer(make, query_keys)
    want = _ledger_answer(lambda: RefServer(RefConfig(**cfg)), query_keys)
    assert got == want
    assert got[2][8] == {"store_version": 1, "seen": 1, "recv_count": 1, "init": True}


# --- heals, end to end --------------------------------------------------------


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, workers: int = 1):
    """A port scheduler and one server (Python or C++ engine) under the
    chaos van with no faults of its own."""
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": str(workers),
           "DMLC_NUM_SERVER": "1", "BYTEPS_FORCE_DISTRIBUTED": "1",
           "BYTEPS_VAN": "chaos:tcp", "BYTEPS_WIRE_CHECKSUM": "1", "BYTEPS_CHAOS_DROP": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sched = PortScheduler(workers, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    srv = (PortServer if server == "port" else PortNativeServer)(PortConfig.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        yield srv
    finally:
        srv.stop()
        sched.stop()


def _dedupes(srv) -> int:
    return (counters().get("push_dedup") if isinstance(srv, PortServer)
            else srv.native_counters().get("native_push_dedup", 0))


@pytest.mark.parametrize("server", ["port", "port-native"])
def test_a_one_sided_giveup_heals_in_place(monkeypatch, server):
    """tests/test_resync.py::test_one_sided_giveup_heals_in_place on the
    port: the first push's three attempts die, the client heals (a resync,
    one replayed round) and the push's fresh attempt dedupes; the step
    never fails and nothing is initialized again."""
    with _fleet(monkeypatch, server) as srv:
        for k, v in VICTIM.items():
            monkeypatch.setenv(k, v)
        pbps.init(device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(3):
            x = rng.standard_normal(129).astype(np.float32)
            out = pbps.push_pull(torch.from_numpy(x), name="resync.heal", average=False)
            assert out.numpy().tobytes() == x.tobytes()  # a double sum would be 2x
        snap = pbps.get_robustness_counters()
        dedupes = _dedupes(srv)
        resync_queries = (srv.native_counters().get("native_resync_query", 0)
                          if server == "port-native" else None)
        pbps.shutdown()
    assert snap.get("chaos_drop") == 3, snap
    assert snap.get("resync_attempt") == 1 and snap.get("resync_replayed_rounds") == 1, snap
    assert dedupes >= 1
    assert resync_queries in (None, 1)
    for name in ("resync_giveup", "rpc_giveup", "degraded_jobs"):
        assert snap.get(name, 0) == 0, snap
    assert counters().snapshot_labeled()["resync_attempt"] == {'{server="0"}': 1}


@pytest.mark.parametrize("server", ["port", "port-native"])
def test_the_victim_heals_while_its_peer_never_blocks(monkeypatch, server):
    """tests/test_resync.py's two-worker demo, a port victim beside a
    byteps_tpu peer: the peer dials with no faults and no deadlines, the
    victim's first three pushes die and it heals in place; both pull the
    fault-free sums bit for bit and neither runs an init barrier again."""
    n, steps = 64, 3

    def grads(rank: int, step: int) -> np.ndarray:
        return (np.arange(n, dtype=np.float32) + step) * (rank + 1)

    want = [(grads(0, s) + grads(1, s)).tobytes() for s in range(steps)]
    got, errors = {}, []

    def peer() -> None:
        try:
            from byteps_tpu.core.state import get_state

            jbps.init()
            # the scheduler's rank (the reference's rank() reads the
            # environment, ROADMAP.md Queue 3)
            got["peer_rank"] = rank = get_state().ps_client.rank
            got["peer"] = [np.asarray(jbps.push_pull(grads(rank, s), name="demo.g",
                                                     average=False)).tobytes()
                           for s in range(steps)]
            jbps.shutdown()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    # the peer's config has no deadline, and its package's fault budget is
    # spent before it starts: its side of the wire stays clean
    from byteps_tpu.core import state as ref_state

    configured = threading.Event()
    real_reset = ref_state.reset_config
    monkeypatch.setattr(ref_state, "reset_config",
                        lambda: (real_reset(), configured.set())[0])
    rchaos.reset_fault_budget(0)
    with _fleet(monkeypatch, server, workers=2):
        for k in ("BYTEPS_CHAOS_DROP", "BYTEPS_CHAOS_OPS", "BYTEPS_CHAOS_FAULT_BUDGET"):
            monkeypatch.setenv(k, VICTIM[k])
        t = threading.Thread(target=peer, daemon=True)
        t.start()
        assert configured.wait(20)
        for k, v in VICTIM.items():
            monkeypatch.setenv(k, v)
        pbps.init(device="cpu")
        rank = pbps.rank()
        got["victim"] = [pbps.push_pull(torch.from_numpy(grads(rank, s)), name="demo.g",
                                        average=False).numpy().tobytes() for s in range(steps)]
        snap = pbps.get_robustness_counters()
        reinit = sorted(port_state.get_state().engine._reinit_names)
        pbps.shutdown()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert {rank, got["peer_rank"]} == {0, 1}
    assert got["victim"] == got["peer"] == want
    assert snap.get("chaos_drop") == 3 and snap.get("resync_attempt", 0) >= 1, snap
    for name in ("resync_giveup", "rpc_giveup", "degraded_jobs"):
        assert snap.get(name, 0) == 0, snap
    assert reinit == [] and ref_counters().get("rpc_giveup") == 0


@pytest.mark.parametrize("worker,server", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_an_init_whose_ack_was_lost_is_acked_from_its_token(monkeypatch, worker, server):
    """The server drops its first INIT ack after the barrier released; the
    worker's INIT deadline sends it again under the same token, and the
    server acks it from the barrier's record instead of parking it."""
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_VAN": "chaos:tcp",
           "BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "INIT",
           "BYTEPS_CHAOS_FAULT_BUDGET": "1", "BYTEPS_INIT_DEADLINE_S": "0.3",
           "BYTEPS_RPC_BACKOFF_S": "0.02"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sched = PortScheduler(1, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    srv = PortServer(PortConfig.from_env()) if server == "port" else RefServer(
        RefConfig.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        monkeypatch.setenv("BYTEPS_CHAOS_DROP", "0")  # the worker's side is clean
        x = np.arange(33, dtype=np.float32)
        if worker == "port":
            pbps.init(device="cpu")
            out = pbps.push_pull(torch.from_numpy(x), name="init.ack", average=False).numpy()
            pbps.shutdown()
        else:
            jbps.init()
            out = np.asarray(jbps.push_pull(x, name="init.ack", average=False))
            jbps.shutdown()
    finally:
        srv.stop()
        sched.stop()
    assert out.tobytes() == x.tobytes()
    sc = counters if server == "port" else ref_counters
    wc = counters if worker == "port" else ref_counters
    assert sc().get("chaos_drop") == 1 and sc().get("init_replay_ack") == 1
    assert wc().get("rpc_retry") >= 1 and wc().get("rpc_giveup") == 0
