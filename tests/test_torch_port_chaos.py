"""The port's chaos van and per-RPC retries against byteps_tpu's.

- ``comm/retry.py``: the backoff delays equal the reference's under the
  same seeded ``random.Random``.
- ``comm/chaos.py``: frame by frame, the port's fault decisions (which
  frame is dropped, delayed, torn down, cut where, which bit flips) equal
  the reference's for several (seed, connection index) pairs and mixes;
  a corrupt frame is rejected by the peer's framing, a truncate or a
  disconnect tears the connection down, a payload flip is caught by the
  CRC32C of ``BYTEPS_WIRE_CHECKSUM=1``, in both packages.
- End to end under ``BYTEPS_VAN=chaos:tcp`` with seeded faults of every
  kind (drop, delay, disconnect, truncate, corrupt, payload corrupt): a
  port worker's pulls over several rounds are bitwise the fault-free
  run's against {port, port native, byteps_tpu, byteps_tpu native}
  servers, and a byteps_tpu worker's against a port server; every fault
  kind, retries, revivals and server-side dedupes fired.
- ``BYTEPS_NATIVE_CLIENT=1`` refuses a ``chaos+`` address (the port never
  falls back to its Python lanes; ROADMAP.md Queue 3).
- With no deadline armed, a frame that fails its CRC32C still heals: its
  attempt fails at once (ROADMAP.md Queue 3).

Exact throughout: decisions and bytes are compared for equality, and the
one-worker pulls are the pushed arrays bit for bit.  Deadlines are 0.1 s
but in the last case, which runs without one.
"""

import contextlib
import random
import socket
import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.comm import chaos as rchaos
from byteps_tpu.comm import retry as rretry
from byteps_tpu.comm import transport as rtr
from byteps_tpu.comm import van as rvan
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.core.telemetry import counters as ref_counters
from byteps_tpu.server.server import NativePSServer as RefNativeServer
from byteps_tpu.server.server import PSServer as RefServer
from byteps_tpu_torch.comm import chaos as pchaos
from byteps_tpu_torch.comm import retry as pretry
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm import van as pvan
from byteps_tpu_torch.comm.ps_client import PSClient
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.telemetry import counters
from byteps_tpu_torch.server.native import NativePSServer as PortNativeServer
from byteps_tpu_torch.server.server import PSServer as PortServer

KINDS = ("drop", "delay", "disconnect", "truncate", "corrupt", "payload_corrupt")


def _reset_chaos() -> None:
    for mod in (pchaos, rchaos):
        mod.reset_conn_indices()
        mod.reset_fault_budget()


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_VAN", "BYTEPS_WIRE_CHECKSUM", "BYTEPS_NATIVE_CLIENT"):
        monkeypatch.delenv(k, raising=False)
    _reset_chaos()
    counters().reset()
    ref_counters().reset()
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()
    _reset_chaos()


# --- backoff ------------------------------------------------------------------


@pytest.mark.parametrize("base,cap,seed", [(0.1, 2.0, 0), (0.05, 1.0, 7), (1e-6, 2.0, 3)])
def test_backoff_delays_equal_the_reference(base, cap, seed):
    port = pretry.Backoff(base=base, cap=cap, rng=random.Random(seed))
    ref = rretry.Backoff(base=base, cap=cap, rng=random.Random(seed))
    got = [port.next_delay() for _ in range(12)]
    assert got == [ref.next_delay() for _ in range(12)]
    assert all(0 < d <= cap for d in got)
    port.reset()
    assert port.attempt == 0


# --- the fault schedule -------------------------------------------------------


class _Recorder:
    """A fake socket that records what a ChaosSocket does to each frame."""

    def __init__(self) -> None:
        self.events = []

    def sendall(self, data) -> None:
        self.events.append(("send", bytes(data)))

    def shutdown(self, how) -> None:
        self.events.append(("shutdown", None))


def _frames(rng: np.random.Generator, n: int) -> list:
    """Frames of the wire (header and payload) with assorted ops and sizes,
    a few header-only."""
    out = []
    for i in range(n):
        op = [ptr.Op.PUSH, ptr.Op.PULL, ptr.Op.INIT, ptr.Op.FUSED][i % 4]
        size = 0 if i % 7 == 3 else int(rng.integers(1, 300))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        out.append(ptr.Message(op, key=i, seq=i, payload=payload).encode())
    return out


def _trace(mod, params_kw: dict, conn_index: int, frames: list) -> list:
    rec = _Recorder()
    sock = mod.ChaosSocket(rec, mod.ChaosParams(**params_kw), conn_index)
    trace = []
    for f in frames:
        try:
            sock.sendall(f)
            trace.append(("ok", rec.events[:]))
        except ConnectionError as e:
            trace.append(("died", str(e), rec.events[:]))
        rec.events.clear()
    return trace


_MIXES = [
    dict(seed=1, drop=0.1, disconnect=0.05, truncate=0.05, corrupt=0.05,
         payload_corrupt=0.1, delay=0.2, delay_ms=0.05),
    dict(seed=42, drop=0.3, payload_corrupt=0.3),
    dict(seed=7, truncate=0.2, corrupt=0.2, delay=0.5, delay_ms=0.05,
         ops=frozenset({11, 12})),
]


@pytest.mark.parametrize("mix", range(len(_MIXES)))
@pytest.mark.parametrize("conn_index", [0, 3, 1000])
def test_fault_schedule_equals_the_reference_frame_by_frame(mix, conn_index):
    """The same params and connection index give the same decision for
    every frame (counted too), in both packages."""
    frames = _frames(np.random.default_rng(mix), 120)
    port = _trace(pchaos, _MIXES[mix], conn_index, frames)
    ref = _trace(rchaos, _MIXES[mix], conn_index, frames)
    assert port == ref
    faulted = sum(t[0] == "died" or t[1] != [("send", f)] for t, f in zip(port, frames))
    assert faulted > 5  # the schedule really faulted frames
    got = {k: v for k, v in counters().snapshot().items() if k.startswith("chaos_")}
    want = {k: v for k, v in ref_counters().snapshot().items() if k.startswith("chaos_")}
    assert got == want and got


def test_targeting_and_the_fault_budget_equal_the_reference(monkeypatch):
    """Only frames of the named ops, on the targeted port, are faulted,
    and no more than the budget; untargeted frames use no roll."""
    frames = _frames(np.random.default_rng(5), 60)
    monkeypatch.setenv("BYTEPS_CHAOS_FAULT_BUDGET", "4")
    traces = []
    for mod in (pchaos, rchaos):
        mod.reset_fault_budget()
        rec = _Recorder()
        params = mod.ChaosParams(seed=3, drop=1.0, ops=frozenset({11}), target_port=777)
        other = mod.ChaosSocket(_Recorder(), params, 0, peer_port=778)
        sock = mod.ChaosSocket(rec, params, 1, peer_port=777)
        out = []
        for f in frames:
            other.sendall(f)
            sock.sendall(f)
            out.append(rec.events[:])
            rec.events.clear()
        traces.append(out)
    assert traces[0] == traces[1]
    dropped = [f for f, ev in zip(frames, traces[0]) if not ev]
    assert len(dropped) == 4 and all(f[1] == 11 for f in dropped)
    assert pchaos.ChaosParams.from_env().ops == frozenset()
    monkeypatch.setenv("BYTEPS_CHAOS_OPS", "push, 12")
    assert pchaos.ChaosParams.from_env().ops == rchaos.ChaosParams.from_env().ops == {11, 12}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_corrupt_flips_the_magic_and_the_peer_rejects(pkg):
    mod, tr = (pchaos, ptr) if pkg == "port" else (rchaos, rtr)
    a, b = socket.socketpair()
    chaos = mod.ChaosSocket(a, mod.ChaosParams(seed=1, corrupt=1.0), 0)
    tr.send_message(chaos, tr.Message(tr.Op.PUSH, key=3, seq=1, payload=b"p" * 64))
    b.settimeout(5)
    with pytest.raises(ConnectionError, match="bad magic"):
        ptr.recv_message(b)
    a.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("kind", ["truncate", "disconnect"])
def test_truncate_and_disconnect_tear_the_connection_down(pkg, kind):
    mod, tr = (pchaos, ptr) if pkg == "port" else (rchaos, rtr)
    a, b = socket.socketpair()
    chaos = mod.ChaosSocket(a, mod.ChaosParams(seed=4, **{kind: 1.0}), 0)
    with pytest.raises(ConnectionError, match="chaos"):
        tr.send_message(chaos, tr.Message(tr.Op.PUSH, key=1, seq=1, payload=b"q" * 256))
    b.settimeout(5)
    with pytest.raises(ConnectionError):  # a short frame, then EOF: no garbage
        ptr.recv_message(b)
    a.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_payload_flip_is_caught_by_the_checksum(monkeypatch, pkg):
    """With BYTEPS_WIRE_CHECKSUM=1 the receiver rejects the frame, after
    consuming it; without, the flip goes through unseen."""
    mod, tr = (pchaos, ptr) if pkg == "port" else (rchaos, rtr)
    payload = bytes(range(200))
    for checksum in (True, False):
        a, b = socket.socketpair()
        chaos = mod.ChaosSocket(a, mod.ChaosParams(seed=9, payload_corrupt=1.0), 0)
        tr.send_message(chaos, tr.Message(tr.Op.PUSH, key=1, seq=1, payload=payload,
                                          checksum=checksum))
        tr.send_message(a, tr.Message(tr.Op.PING, seq=2))
        b.settimeout(5)
        if checksum:
            with pytest.raises(ptr.ChecksumError):
                ptr.recv_message(b)
            assert ptr.recv_message(b).op == ptr.Op.PING  # still framed
        else:
            got = ptr.recv_message(b)
            assert got.payload != payload and len(got.payload) == len(payload)
        a.close()
        b.close()


def test_the_native_client_refuses_a_chaos_address(monkeypatch):
    """The C++ lanes would bypass the fault layer, and the port does not
    fall back to its Python lanes: the dial raises with the reason (the
    reference keeps its native client off, silently)."""
    monkeypatch.setenv("BYTEPS_NATIVE_CLIENT", "1")
    monkeypatch.setenv("BYTEPS_VAN", "chaos:tcp")
    lsock, host, port = pvan.get_van().listen("127.0.0.1")
    ref_lsock, ref_host, _ = rvan.get_van().listen("127.0.0.1")
    try:
        assert host == ref_host == "chaos+127.0.0.1"  # the same published address
        client = PSClient(PortConfig.from_env())
        with pytest.raises(RuntimeError, match="bypass the chaos van"):
            client._new_conn(host, port, "0")
    finally:
        lsock.close()
        ref_lsock.close()


# --- end to end ---------------------------------------------------------------

#: the mix of the matrix: every kind at once, on both sides of the wire
_FAULTS = {"BYTEPS_CHAOS_DROP": "0.01", "BYTEPS_CHAOS_DISCONNECT": "0.01",
           "BYTEPS_CHAOS_TRUNCATE": "0.01", "BYTEPS_CHAOS_CORRUPT": "0.01",
           "BYTEPS_CHAOS_PAYLOAD_CORRUPT": "0.01", "BYTEPS_CHAOS_DELAY": "0.05",
           "BYTEPS_CHAOS_DELAY_MS": "1"}
_HEAL = {"BYTEPS_RPC_DEADLINE_S": "0.1", "BYTEPS_INIT_DEADLINE_S": "0.15",
         "BYTEPS_RPC_RETRIES": "8", "BYTEPS_RPC_BACKOFF_S": "0.01",
         "BYTEPS_CONNECT_RETRY_S": "0.2"}
ROUNDS = 2


def _tensors(seed: int) -> list:
    """ROUNDS rounds of two tensors, started together: float32 over 80
    partitions and int32 in one."""
    rng = np.random.default_rng(seed)
    return [[("e2e.f", rng.standard_normal(20000).astype(np.float32)),
             ("e2e.i", rng.integers(-1000, 1000, 200).astype(np.int32))]
            for _ in range(ROUNDS)]


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, chaos: bool, **faults):
    """A scheduler and two servers in process, with the chaos van and its
    faults (``faults`` over the default mix) when ``chaos``: the servers
    fault their replies too, but for the C++ engines, whose listener
    stays plain."""
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
           "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_PARTITION_BYTES": "1024",
           "BYTEPS_WIRE_CHECKSUM": "1", **_HEAL}
    if chaos:
        env.update({"BYTEPS_VAN": "chaos:tcp", "BYTEPS_CHAOS_SEED": "11", **_FAULTS, **faults})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kind = server.split("-")[0]
    sched = (PortScheduler(1, 2, host="127.0.0.1") if kind == "port"
             else RefScheduler(num_workers=1, num_servers=2, host="127.0.0.1"))
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    make = {"port": lambda: PortServer(PortConfig.from_env()),
            "port-native": lambda: PortNativeServer(PortConfig.from_env()),
            "ref": lambda: RefServer(RefConfig.from_env()),
            "ref-native": lambda: RefNativeServer(RefConfig.from_env())}[server]
    nodes = [make() for _ in range(2)]
    for node in nodes:
        threading.Thread(target=node.start, daemon=True).start()
    try:
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()


def _port_worker(rounds) -> list:
    pbps.init(device="cpu")
    try:
        out = []
        for r in rounds:
            hs = [pbps.push_pull_async(torch.from_numpy(x.copy()), name=n, average=False)
                  for n, x in r]
            out += [pbps.synchronize(h).numpy().tobytes() for h in hs]
        return out
    finally:
        pbps.shutdown()


def _ref_worker(rounds) -> list:
    jbps.init()
    try:
        out = []
        for r in rounds:
            hs = [jbps.push_pull_async(x.copy(), name=n, average=False) for n, x in r]
            out += [np.asarray(jbps.synchronize(h)).tobytes() for h in hs]
        return out
    finally:
        jbps.shutdown()


def _run(monkeypatch, server: str, worker, chaos: bool, **faults) -> list:
    if server == "ref-native":
        from conftest import have_native_parity_server

        if not have_native_parity_server():
            pytest.skip("the reference's native server library is not built")
    _reset_chaos()
    with _fleet(monkeypatch, server, chaos, **faults):
        return worker(_tensors(seed=4))


@pytest.mark.parametrize("worker,server", [
    ("port", "port"), ("port", "port-native"), ("port", "ref"), ("port", "ref-native"),
    ("ref", "port"),
])
def test_pulls_under_seeded_faults_equal_the_fault_free_run(monkeypatch, worker, server):
    """Every fault kind at once, both ways over the wire (a C++ server's
    listener stays plain, so there the worker's side only, with more
    drops): the pulls are bitwise the fault-free run's, and the worker's
    package retried and revived connections."""
    run = _port_worker if worker == "port" else _ref_worker
    # the fault-free run of one worker pulls what it pushed, bit for bit
    # (tests/test_torch_port_ps.py and _native.py hold every server to it)
    want = [x.tobytes() for r in _tensors(seed=4) for _, x in r]
    faults = {"BYTEPS_CHAOS_DROP": "0.03"} if server.endswith("native") else {}
    got = _run(monkeypatch, server, run, chaos=True, **faults)
    assert got == want
    fired = {k: counters().get(f"chaos_{k}") + ref_counters().get(f"chaos_{k}") for k in KINDS}
    assert sum(fired.values()) > 0, fired
    snap = (counters() if worker == "port" else ref_counters()).snapshot()
    for name in ("rpc_retry", "conn_revive"):
        assert snap.get(name, 0) > 0, (name, snap)
    if worker == "port":
        # per server, as the reference labels them; the flat total is
        # their sum
        labeled = counters().snapshot_labeled()
        for name in ("rpc_retry", "conn_revive"):
            per = labeled.get(name, {})
            assert per and set(per) <= {'{server="0"}', '{server="1"}'}, labeled
            assert sum(per.values()) == snap[name]
        assert pbps.get_robustness_counters() == counters().snapshot()


#: what each kind leaves in the counters of a port worker and server
_HEALED_BY = {"drop": "rpc_deadline_expired", "delay": None, "disconnect": "conn_revive",
              "truncate": "conn_revive", "corrupt": "conn_revive",
              "payload_corrupt": "wire_checksum_fail"}


@pytest.mark.parametrize("kind", KINDS)
def test_each_fault_kind_fires_and_heals(monkeypatch, kind):
    """One kind alone at 10% of the pushes and pulls on both sides of a
    port fleet: it fires, its heal fires (the deadline, a revival, the checksum's drop),
    and the pulls are bitwise the fault-free run's."""
    only = {k: "0" for k in _FAULTS if k != "BYTEPS_CHAOS_DELAY_MS"}
    # pushes and pulls: the 80 init barriers run one after another
    only.update({f"BYTEPS_CHAOS_{kind.upper()}": "0.1", "BYTEPS_CHAOS_OPS": "push,pull"})
    rounds = [[(n, x[:10000]) for n, x in _tensors(seed=8)[0]]]  # 40 partitions
    _reset_chaos()
    with _fleet(monkeypatch, "port", chaos=True, **only):
        got = _port_worker(rounds)
    assert got == [x.tobytes() for r in rounds for _, x in r]
    assert counters().get(f"chaos_{kind}") > 0
    if _HEALED_BY[kind]:
        assert counters().get(_HEALED_BY[kind]) > 0, counters().snapshot()


@pytest.mark.parametrize("worker,server", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_a_lost_push_ack_is_deduped_on_the_resend(monkeypatch, worker, server):
    """The server's first push ack is dropped (its listener faults only
    PUSH frames, one in all): the worker's deadline sends the push again,
    and the server acks it from its replay ledger without a second sum."""
    _reset_chaos()
    only = {k: "0" for k in _FAULTS}
    with _fleet(monkeypatch, server, chaos=True, **{
            **only, "BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "push",
            "BYTEPS_CHAOS_FAULT_BUDGET": "1"}):
        # the servers are up with their faults; the worker dials with none
        monkeypatch.setenv("BYTEPS_CHAOS_DROP", "0")
        rounds = _tensors(seed=6)[:2]
        got = (_port_worker if worker == "port" else _ref_worker)(rounds)
    assert got == [x.tobytes() for r in rounds for _, x in r]
    sc, wc = (counters if server == "port" else ref_counters), (
        counters if worker == "port" else ref_counters)
    # a slow CPU's spurious deadline may dedupe another resend: at least one
    assert sc().get("chaos_drop") == 1 and sc().get("push_dedup") >= 1
    assert wc().get("rpc_retry") >= 1 and wc().get("rpc_giveup") == 0
    assert wc().get("rpc_deadline_expired") >= 1


@pytest.mark.parametrize("server,op", [("port", "pull"), ("port", "push"),
                                       ("port-native", "push")])
def test_a_checksum_failure_heals_without_a_deadline(monkeypatch, server, op):
    """With BYTEPS_RPC_DEADLINE_S=0, the default, one payload flip (a pull
    reply, or a push, which a C++ server's plain listener only receives)
    fails its attempt at once: the worker retries a reply it rejects, a
    server closes the connection of a request it rejects.  The C++ server,
    the reference's byte for byte, drops a rejected request unanswered
    until BYTEPS_CHECKSUM_CONN_LIMIT of them: at 1 it closes at once.  The
    pulls are bitwise the pushed arrays within seconds, with no deadline
    expired."""
    _reset_chaos()
    only = {k: "0" for k in _FAULTS}
    if server == "port-native":
        monkeypatch.setenv("BYTEPS_CHECKSUM_CONN_LIMIT", "1")
    with _fleet(monkeypatch, server, chaos=True, **{
            **only, "BYTEPS_CHAOS_PAYLOAD_CORRUPT": "1.0", "BYTEPS_CHAOS_OPS": op,
            "BYTEPS_CHAOS_FAULT_BUDGET": "1", "BYTEPS_RPC_DEADLINE_S": "0",
            "BYTEPS_INIT_DEADLINE_S": "0"}):
        rounds = _tensors(seed=5)[:1]
        box = []
        t = threading.Thread(target=lambda: box.append(_port_worker(rounds)), daemon=True)
        t.start()
        t.join(timeout=15.0)
        assert not t.is_alive(), "a checksum failure left its request pending"
    assert box == [[x.tobytes() for r in rounds for _, x in r]]
    assert counters().get("chaos_payload_corrupt") == 1
    assert counters().get("rpc_retry") >= 1 and counters().get("rpc_giveup") == 0
    assert counters().get("rpc_deadline_expired") == 0
    if server == "port":
        assert counters().get("wire_checksum_fail") == 1
    if op == "push":  # the server closed the connection: the worker dialed again
        assert counters().get("conn_revive") >= 1
