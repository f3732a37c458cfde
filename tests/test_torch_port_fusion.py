"""The port's small-tensor fusion (Op.FUSED) against byteps_tpu's.

- Fused push and reply frames equal byteps_tpu's ``encode_fused_*`` byte for
  byte, span trailer included, and a truncated frame is rejected.
- Pulls with BYTEPS_FUSION_THRESHOLD on are bitwise the expected sums (one
  worker: a copy; onebit: the codec's round trip through the server) across
  {port worker, byteps_tpu worker} x {Python lanes, native client lanes} x
  {port server, port native server, byteps_tpu server, byteps_tpu native
  server}, with raw and onebit members in the frames.
- Scheduling: a pack's group task passes the round gate its members passed
  and carries their highest priority; a frame that fails falls back to
  per-key pushes and pulls; a resent frame never sums a member twice.

Every listener binds port 0.  Onebit inputs are +-2^-k, so each scale is
exact whatever the order of its sum."""

import contextlib
import struct
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.common import partition as ref_partition
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm import transport as rtr
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.compression.impl import OneBitCompressor as RefOneBit
from byteps_tpu.server.server import NativePSServer as RefNativeServer
from byteps_tpu.server.server import PSServer as RefServer
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import (
    DataType,
    QueueType,
    RequestType,
    TensorTableEntry,
    get_command_type,
)
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.engine import _Fuser
from byteps_tpu_torch.core.ready_table import ReadyTable
from byteps_tpu_torch.core.scheduler import ScheduledQueue
from byteps_tpu_torch.core.telemetry import counters, metrics
from byteps_tpu_torch.server.native import NativePSServer
from byteps_tpu_torch.server.server import PSServer as PortServer

PART_BYTES = 65536  # 16384 float32 elements a partition
THRESHOLD = 16384  # every onebit payload (2052 bytes) and the small tensors fuse


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_NATIVE_CLIENT", "BYTEPS_SERVER_NATIVE",
              "BYTEPS_VAN", "BYTEPS_FUSION_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


# --- the frames -----------------------------------------------------------------

_MEMBERS = [
    [(7, 3, 1, b"abc")],
    [(7, 3, 1, b"abc"), (1 << 40, 0, 9, b""), (2, 11, 2, bytes(range(256)))],
    [(k, get_command_type(RequestType.COMPRESSED_PUSH_PULL, int(DataType.FLOAT32)), 5,
      np.arange(k * 3, dtype=np.uint8).tobytes()) for k in range(1, 9)],
]


@pytest.mark.parametrize("members", _MEMBERS, ids=["one", "three", "eight-compressed"])
@pytest.mark.parametrize("spans", [False, True])
def test_fused_frames_equal_the_reference(members, spans):
    body = ptr.encode_fused_push(members)
    assert body == rtr.encode_fused_push(members)
    # a traced reference worker appends a span trailer: the port reads past it
    sent = rtr.encode_fused_push(
        members, span_ids=[1000 + i for i in range(len(members))] if spans else None)
    assert ptr.decode_fused_push(sent) == rtr.decode_fused_push(sent) == members
    reply = [(k, v, p) for k, _, v, p in members]
    rbody = ptr.encode_fused_reply(reply)
    assert rbody == rtr.encode_fused_reply(reply)
    assert ptr.decode_fused_reply(rbody) == reply
    # a member payload handed over as a numpy view frames the same bytes
    views = [(k, c, v, np.frombuffer(p, np.uint8)) for k, c, v, p in members]
    assert ptr.encode_fused_push(views) == rtr.encode_fused_push(members)


@pytest.mark.parametrize("cut", [1, 3, 10])
def test_truncated_fused_frames_are_rejected(cut):
    body = ptr.encode_fused_push([(1, 0, 1, b"payload"), (2, 0, 1, b"xy")])
    with pytest.raises(ValueError, match="truncated"):
        ptr.decode_fused_push(body[:-cut])
    reply = ptr.encode_fused_reply([(1, 1, b"payload")])
    with pytest.raises(ValueError, match="truncated"):
        ptr.decode_fused_reply(reply[:-cut])


# --- fleets ---------------------------------------------------------------------

SERVERS = ["port", "port-native", "ref", "ref-native"]


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, **env):
    """A scheduler and two servers in-process for one worker."""
    kind, native = server.split("-")[0], server.endswith("native")
    if kind == "ref" and native:
        from conftest import have_native_parity_server

        if not have_native_parity_server():
            pytest.skip("the reference's native server library is not built")
    base = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "2",
            "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_PARTITION_BYTES": str(PART_BYTES),
            "BYTEPS_WIRE_CHECKSUM": "1"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    sched = (PortScheduler(1, 2, host="127.0.0.1") if kind == "port"
             else RefScheduler(num_workers=1, num_servers=2, host="127.0.0.1"))
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    make = {("port", False): lambda: PortServer(PortConfig.from_env()),
            ("port", True): lambda: NativePSServer(PortConfig.from_env()),
            ("ref", False): lambda: RefServer(RefConfig.from_env()),
            ("ref", True): lambda: RefNativeServer(RefConfig.from_env())}[kind, native]
    nodes = [make() for _ in range(2)]
    for node in nodes:
        threading.Thread(target=node.start, daemon=True).start()
    try:
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()


def _signs(rng, n: int, k: int) -> np.ndarray:
    return (rng.choice([-1.0, 1.0], size=n) * 2.0 ** -k).astype(np.float32)


def _rounds() -> list:
    """Two rounds of (name, array, onebit): small float32 and int32 tensors
    that fuse, a float32 tensor of five partitions none of which fuses (its
    tail is 17,856 bytes), and a onebit tensor of three partitions whose
    payloads all fuse: 10 fused partitions a round."""
    rng = np.random.default_rng(12)
    return [[
        *[(f"s.{i}", rng.standard_normal(200 + 57 * i).astype(np.float32), False)
          for i in range(6)],
        ("s.i32", rng.integers(-1000, 1000, 700).astype(np.int32), False),
        ("big", rng.standard_normal(70000).astype(np.float32), False),
        ("ob", _signs(rng, 40000, 2 + r), True),
    ] for r in range(2)]


def _onebit_round_trip(x: np.ndarray) -> np.ndarray:
    """The server's decode and re-encode of one worker's onebit push, as
    the worker decodes it: decode(encode(decode(encode(x)))) per partition."""
    out = np.empty_like(x)
    for off, ln in ref_partition.partition_elements(x.size, 4, PART_BYTES):
        codec = RefOneBit(ln, scaling=True)
        once = codec.decompress(codec.compress(x[off: off + ln]), ln)
        out[off: off + ln] = codec.decompress(codec.compress(once), ln)
    return out


def _declare(api) -> None:
    api.declare_tensor("ob", byteps_compressor_type="onebit",
                       byteps_compressor_onebit_scaling="True")


def _port_worker(rounds) -> list:
    pbps.init(device="cpu")
    _declare(pbps)
    out = []
    for tensors in rounds:
        handles = [pbps.push_pull_async(torch.from_numpy(a.copy()), name=n, average=False)
                   for n, a, _ in tensors]
        out += [np.asarray(pbps.synchronize(h)).tobytes() for h in handles]
    pbps.shutdown()
    return out


def _ref_worker(rounds) -> list:
    jbps.init()
    _declare(jbps)
    out = []
    for tensors in rounds:
        handles = [jbps.push_pull_async(jnp.asarray(a) if a.dtype == np.float32 else a,
                                        name=n, average=False) for n, a, _ in tensors]
        out += [np.asarray(jbps.synchronize(h)).tobytes() for h in handles]
    jbps.shutdown()
    return out


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("lane", ["python", "native"])
@pytest.mark.parametrize("worker", ["port", "ref"])
def test_fused_pulls_are_the_unfused_sums_across_workers_lanes_and_servers(
        monkeypatch, worker, lane, server):
    rounds = _rounds()
    want = [(_onebit_round_trip(a) if ob else a).tobytes() for t in rounds for _, a, ob in t]
    env = {"BYTEPS_FUSION_THRESHOLD": str(THRESHOLD)}
    if lane == "native":
        env["BYTEPS_NATIVE_CLIENT"] = "1"
        if worker == "ref":
            from conftest import have_native_parity_server

            if not have_native_parity_server():
                pytest.skip("the reference's native client library is not built")
    counters().reset()
    with _fleet(monkeypatch, server, **env):
        got = (_port_worker if worker == "port" else _ref_worker)(rounds)
    assert got == want
    if worker == "port":
        snap = counters().snapshot()
        assert snap.get("fused_keys") == 2 * 10, snap
        assert 1 <= snap.get("fused_frames", 0) <= 2 * 10


def test_the_engine_reports_its_threshold(monkeypatch):
    with _fleet(monkeypatch, "port", BYTEPS_FUSION_THRESHOLD=str(THRESHOLD)):
        pbps.init(device="cpu")
        assert metrics().snapshot()["gauges"]["fusion_threshold_bytes"] == THRESHOLD
        pbps.shutdown()


# --- scheduling -----------------------------------------------------------------


def test_a_pack_passes_the_round_gate_its_members_passed():
    table = ReadyTable()
    q = ScheduledQueue(QueueType.PUSH, ready_table=table)
    gated = TensorTableEntry(tensor_name="t", key=1, version=5)
    q.add_task(gated)
    assert q.get_task(timeout=0.05) is None  # allowance 0 < round 5
    group = TensorTableEntry(tensor_name="<fused>", key=1, version=5, gate_exempt=True)
    q.add_task(group)
    assert q.get_task(timeout=1.0) is group
    assert q.pending() == 1


def test_a_pack_carries_its_members_highest_priority():
    """Fusion never defeats priority scheduling: the pack of a low and a
    high priority member outranks everything below the high one."""
    stop = threading.Event()
    stub = types.SimpleNamespace(
        cfg=PortConfig(fusion_bytes=1 << 30, fusion_cycle_ms=1000.0),
        client=types.SimpleNamespace(server_for=lambda key: 0), _stop=stop,
        queues={QueueType.PUSH: ScheduledQueue(QueueType.PUSH)},
    )
    fuser = _Fuser(stub)
    fuser.add(TensorTableEntry(tensor_name="a", key=1, priority=-9, length=4), b"x" * 16)
    fuser.add(TensorTableEntry(tensor_name="b", key=2, priority=3, length=4), b"y" * 16)
    stub.queues[QueueType.PUSH].add_task(TensorTableEntry(tensor_name="c", key=3, priority=2))
    fuser.drain_idle()
    stop.set()  # ends the cycle thread
    group = stub.queues[QueueType.PUSH].get_task(timeout=1.0)
    assert group.gate_exempt and group.priority == 3 and group.length == 8
    assert [t.key for t, _ in group.context.members] == [1, 2]


def test_a_full_buffer_flushes_at_fusion_bytes():
    stop = threading.Event()
    stub = types.SimpleNamespace(
        cfg=PortConfig(fusion_bytes=40, fusion_cycle_ms=1000.0),
        client=types.SimpleNamespace(server_for=lambda key: key % 2), _stop=stop,
        queues={QueueType.PUSH: ScheduledQueue(QueueType.PUSH)},
    )
    counters().reset()
    fuser = _Fuser(stub)
    for key in range(6):
        fuser.add(TensorTableEntry(tensor_name="t", key=key, length=4), b"z" * 16)
    stop.set()
    q = stub.queues[QueueType.PUSH]
    packs = [q.get_task(timeout=1.0) for _ in range(2)]
    assert sorted([t.key for t, _ in p.context.members] for p in packs) == [[0, 2, 4], [1, 3, 5]]
    assert counters().get("fusion_flush_full") == 2


def test_a_failed_frame_falls_back_to_unfused_pushes(monkeypatch):
    """A pack whose fused RPC fails goes out again as per-key pushes and
    pulls, and the step completes with the same result."""
    with _fleet(monkeypatch, "port", BYTEPS_FUSION_THRESHOLD=str(THRESHOLD)):
        pbps.init(device="cpu")
        x0 = torch.arange(128, dtype=torch.float32)
        assert torch.equal(pbps.push_pull(x0, name="fb.a", average=False), x0)
        client = port_state.get_state().ps_client
        monkeypatch.setattr(client, "push_fused",
                            lambda members, cb, on_error, **_: on_error("the frame was lost"))
        counters().reset()
        out = pbps.push_pull(x0 * 5, name="fb.a", average=False)
        assert torch.equal(out, x0 * 5)
        assert counters().get("fused_fallback") >= 1 and counters().get("fused_frames") >= 1
        pbps.shutdown()


def test_priorities_complete_under_fusion(monkeypatch):
    with _fleet(monkeypatch, "port", BYTEPS_FUSION_THRESHOLD=str(THRESHOLD)):
        pbps.init(device="cpu")
        xs = [torch.full((64,), float(i)) for i in range(8)]
        hs = [pbps.push_pull_async(x, name=f"prio.{i}", priority=-i, average=False)
              for i, x in enumerate(xs)]
        for x, h in zip(xs, hs):
            assert torch.equal(pbps.synchronize(h), x)
        pbps.shutdown()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_resent_fused_frame_never_sums_twice(server):
    """Worker 1 sends one fused frame twice (a retry); worker 2 completes
    the rounds with plain pushes: both replies carry one contribution per
    worker and key."""
    cfg = (PortConfig if server == "port" else RefConfig)(num_worker=2, num_server=1)
    srv = (PortServer if server == "port" else RefServer)(cfg)
    srv.start(register=False)
    key_a, key_b, n = 101, 202, 64
    cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, int(DataType.FLOAT32))
    a1, b1 = np.arange(n, dtype=np.float32), np.full(n, 2.5, np.float32)
    a2, b2 = np.full(n, 10.0, np.float32), np.full(n, -3.0, np.float32)
    w1, w2 = ptr.connect(srv.host, srv.port), ptr.connect(srv.host, srv.port)
    try:
        init = struct.pack("!QI", n, int(DataType.FLOAT32))
        for key in (key_a, key_b):
            ptr.send_message(w1, ptr.Message(ptr.Op.INIT, key=key, seq=key, flags=1,
                                             payload=init))
            ptr.send_message(w2, ptr.Message(ptr.Op.INIT, key=key, seq=key, flags=2,
                                             payload=init))
        for sock in (w1, w2):
            for _ in range(2):
                assert ptr.recv_message(sock).op == ptr.Op.INIT
        frame = ptr.encode_fused_push([(key_a, cmd, 1, a1.tobytes()),
                                       (key_b, cmd, 1, b1.tobytes())])
        for seq in (11, 12):
            ptr.send_message(w1, ptr.Message(ptr.Op.FUSED, key=key_a, seq=seq, flags=1,
                                             cmd=2, payload=frame))
        for key, arr, seq in ((key_a, a2, 21), (key_b, b2, 22)):
            ptr.send_message(w2, ptr.Message(ptr.Op.PUSH, key=key, seq=seq, flags=2, cmd=cmd,
                                             version=1, payload=arr.tobytes()))
        for _ in range(2):
            assert ptr.recv_message(w2).op == ptr.Op.PUSH
        sums = {key_a: a1 + a2, key_b: b1 + b2}
        for seq in (11, 12):
            msg = ptr.recv_message(w1)
            assert msg.op == ptr.Op.FUSED and msg.seq in (11, 12)
            reply = ptr.decode_fused_reply(msg.payload)
            assert [k for k, _, _ in reply] == [key_a, key_b]
            for k, ver, payload in reply:
                assert ver == 1 and payload == sums[k].tobytes()
    finally:
        ptr.close_socket(w1)
        ptr.close_socket(w2)
        srv.stop()
