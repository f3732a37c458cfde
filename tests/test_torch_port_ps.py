"""The port's PS plane against byteps_tpu's: the wire (golden frames,
CRC32C), the key->server map and the partitioner, and whole fleets mixing
the two packages.  The same seeded pushes from {port worker, byteps_tpu
worker} x {port server, byteps_tpu PSServer, byteps_tpu NativePSServer}
give the same pulls bit for bit; a tiny model trains through port and
reference servers to the same losses; every unported plane raises.

Every listener binds port 0.  Onebit inputs are +-2^-k, so each scale
(a mean of |x|) is exact whatever the order or width of its sum, and the
pulls can be compared bitwise across servers that sum differently."""

import contextlib
import hashlib
import socket
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.common import hashing as ref_hashing
from byteps_tpu.common import partition as ref_partition
from byteps_tpu.common import types as ref_types
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm import transport as rtr
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.compression.impl import OneBitCompressor as RefOneBit
from byteps_tpu.server.server import NativePSServer, PSServer as RefServer
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import hashing, partition
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common import types as ptypes
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.ps_client import PSClient
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.telemetry import counters
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax
from byteps_tpu_torch.server.server import PSServer as PortServer

PART_BYTES = 65536  # 16384 float32 elements: the large tensors split over both servers


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    """The port's runtime; byteps_tpu's is reset by conftest's
    ``_clean_runtime``."""
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_WIRE_LOSSLESS", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


# --- the wire ---------------------------------------------------------------

#: tests/test_wire_golden.py GOLDEN_SHA256: the reference's fixture stream
#: as frozen when its wire format shipped
GOLDEN_SHA256 = "29ef1635893fd36ae7520635c170429cca14e201d34710f955ed0fb6950de145"


def _golden_frames(tr) -> bytes:
    """The fixture stream of tests/test_wire_golden.py, framed by ``tr``.
    The FUSED and RESYNC_STATE bodies are the reference's encoders' (those
    planes are not ported); their frames are the port's."""
    fused = rtr.encode_fused_reply([(101, 1, b"wxyz"), (202, 2, b"")])
    state = rtr.encode_resync_state({
        5: {"store_version": 4, "seen": 3, "recv_count": 1, "init": True},
        9: {"store_version": 0, "seen": 0, "recv_count": 0, "init": True},
    })
    frames = [
        tr.Message(tr.Op.PUSH, key=42, payload=bytes(range(8)), seq=7, cmd=6,
                   version=3, flags=1),
        tr.Message(tr.Op.PUSH, key=42, payload=bytes(range(8)), seq=7, cmd=6,
                   version=3, flags=1, trace=(0x1122334455667788, 0x99AABBCCDDEEFF00)),
        tr.Message(tr.Op.PULL, key=42, seq=8, cmd=6, version=3),
        tr.Message(tr.Op.INIT, key=43, seq=9, flags=2, version=0xA0001,
                   payload=struct.pack("!QI", 32, 0)),
        tr.Message(tr.Op.FUSED, key=101, seq=10, payload=fused),
        tr.Message(tr.Op.RESYNC_STATE, key=5, seq=11, payload=state),
    ]
    return b"".join(m.encode() for m in frames)


def test_golden_frames_match_the_reference_and_the_frozen_digest():
    port = _golden_frames(ptr)
    assert port == _golden_frames(rtr)
    assert hashlib.sha256(port).hexdigest() == GOLDEN_SHA256


def test_checksummed_frames_match_the_reference(monkeypatch):
    """BYTEPS_WIRE_CHECKSUM=1 stamps data-plane frames only; the port's C
    helper gives the reference's CRC32C block."""
    monkeypatch.setenv("BYTEPS_WIRE_CHECKSUM", "1")
    payload = np.random.default_rng(0).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    for tr_args in [
        dict(op="PUSH", key=7, payload=payload, seq=3, cmd=6, version=2, flags=1),
        dict(op="PUSH", key=7, payload=payload, trace=(1, 2)),
        dict(op="PULL", key=9, seq=4, cmd=6, version=2),
        dict(op="BARRIER", flags=3, seq=1),
    ]:
        frames = []
        for tr in (ptr, rtr):
            kw = dict(tr_args)
            frames.append(tr.Message(tr.Op[kw.pop("op")], **kw).encode())
        assert frames[0] == frames[1]
        assert bool(frames[0][2] & ptr.CHECKSUM_FLAG) == (tr_args["op"] != "BARRIER")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 65537])
def test_crc32c_matches_the_reference_chained(n):
    """The C helper and the plain table loop against the reference, on
    random buffers, chained over two halves."""
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    want = rtr.crc32c(buf)
    assert ptr.crc32c(buf) == ptr.crc32c_plain(buf) == want
    h = n // 3
    assert ptr.crc32c(buf[h:], ptr.crc32c(buf[:h])) == want
    assert ptr.crc32c_plain(buf[h:], ptr.crc32c_plain(buf[:h])) == want
    assert ptr.crc32c(b"123456789") == 0xE3069283


def test_received_frames_the_port_does_not_serve_fail_loudly():
    """A lossless container raises after the frame is consumed, so the
    stream stays framed; a corrupt checksum raises ChecksumError."""
    a, b = socket.socketpair()
    try:
        ptr.send_message(a, ptr.Message(ptr.Op.PULL, payload=b"xyz", status=ptr.LOSSLESS_FLAG))
        ptr.send_message(a, ptr.Message(ptr.Op.PUSH, key=5, payload=b"ok", checksum=True))
        with pytest.raises(ptr.UnsupportedFrameError, match="lossless"):
            ptr.recv_message(b)
        assert ptr.recv_message(b).payload == b"ok"
        frame = bytearray(ptr.Message(ptr.Op.PUSH, payload=b"abcd", checksum=True).encode())
        frame[-1] ^= 1
        a.sendall(bytes(frame))
        with pytest.raises(ptr.ChecksumError):
            ptr.recv_message(b)
    finally:
        a.close()
        b.close()


# --- keys, partitions, commands -----------------------------------------------


@pytest.mark.parametrize("fn", ["naive", "built_in", "djb2", "sdbm", "mixed"])
def test_key_to_server_map_equals_the_reference(fn):
    keys = [(d << 16) | p for d in range(40) for p in range(6)] + [(3 << 48) | 17]
    for servers in (3, 5):
        # mixed mode: one dedicated server beside the colocated ones
        kw = dict(fn=fn, coef=3, num_workers=servers - 1 if fn == "mixed" else 1)
        got = [hashing.assign_server(k, servers, **kw) for k in keys]
        assert got == [ref_hashing.assign_server(k, servers, **kw) for k in keys]
        assert set(got) == set(range(servers))


@pytest.mark.parametrize("n,itemsize,pbytes", [
    (0, 4, 4096), (1, 4, 4096), (1000, 4, 4096), (70000, 4, 65536),
    (5001, 2, 1000), (333, 8, 100), (10, 1, 3),
])
def test_partitions_equal_the_reference(n, itemsize, pbytes):
    assert (partition.partition_elements(n, itemsize, pbytes)
            == ref_partition.partition_elements(n, itemsize, pbytes))


def test_command_types_equal_the_reference():
    for rt in ptypes.RequestType:
        for dt in ptypes.DataType:
            cmd = ptypes.get_command_type(rt, int(dt))
            assert cmd == ref_types.get_command_type(ref_types.RequestType(int(rt)), int(dt))
            assert ptypes.decode_command_type(cmd) == (rt, int(dt))


# --- fleets -----------------------------------------------------------------


@contextlib.contextmanager
def _cluster(monkeypatch, server: str, workers: int = 1, servers: int = 2, **env):
    """A scheduler and ``servers`` servers in-process, of the port
    (``server="port"``) or of byteps_tpu (``"ref"``, ``"native"``)."""
    if server == "native":
        from conftest import have_native_parity_server

        if not have_native_parity_server():
            pytest.skip("the reference's native server library is not built")
    base = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": str(workers),
            "DMLC_NUM_SERVER": str(servers), "BYTEPS_FORCE_DISTRIBUTED": "1",
            "BYTEPS_PARTITION_BYTES": str(PART_BYTES), "BYTEPS_WIRE_CHECKSUM": "1"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    if server == "port":
        sched = PortScheduler(workers, servers, host="127.0.0.1")
    else:
        sched = RefScheduler(num_workers=workers, num_servers=servers, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    nodes = []
    try:
        for _ in range(servers):
            node = {"port": lambda: PortServer(PortConfig.from_env()),
                    "ref": lambda: RefServer(RefConfig.from_env()),
                    "native": lambda: NativePSServer(RefConfig.from_env())}[server]()
            nodes.append(node)
            threading.Thread(target=node.start, daemon=True).start()
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()


def _signs(rng, n: int, k: int) -> np.ndarray:
    return (rng.choice([-1.0, 1.0], size=n) * 2.0 ** -k).astype(np.float32)


def _rounds(seed: int) -> list:
    """Two rounds of (name, array, average, onebit) pushes: a float32 tensor
    of five partitions, ints, float64, and two onebit tensors that split
    over both servers."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(2):
        out.append([
            ("raw.f32", rng.standard_normal(70000).astype(np.float32), True, False),
            ("raw.i32", rng.integers(-1000, 1000, 3000).astype(np.int32), True, False),
            ("raw.f64", rng.standard_normal(5000), False, False),
            ("ob.avg", _signs(rng, 50000, 2 + r + seed % 2), True, True),
            ("ob.sum", _signs(rng, 40000, 3 + seed % 2), False, True),
        ])
    return out


def _declare(api) -> None:
    for name in ("ob.avg", "ob.sum"):
        api.declare_tensor(name, byteps_compressor_type="onebit",
                           byteps_compressor_onebit_scaling="True")


def _port_worker(rounds, out: list) -> None:
    """The port's worker: torch tensors (its device lane; the plain onebit
    version on the CPU) and one numpy tensor (its host lane)."""
    pbps.init(device="cpu")
    _declare(pbps)
    for tensors in rounds:
        for name, arr, avg, _ in tensors:
            src = arr.copy() if name == "raw.f64" else torch.from_numpy(arr.copy())
            res = pbps.push_pull(src, name=name, average=avg)
            out.append(np.asarray(res).tobytes())
    pbps.shutdown()


def _ref_worker(rounds, out: list) -> None:
    """byteps_tpu's worker: jax arrays for float32 (its device lane, onebit
    packed by ``onebit_compress_device``), numpy for the rest (its host
    lane; jax holds no float64 without x64)."""
    jbps.init()
    _declare(jbps)
    for tensors in rounds:
        for name, arr, avg, _ in tensors:
            src = jnp.asarray(arr) if arr.dtype == np.float32 else arr
            res = jbps.push_pull(src, name=name, average=avg)
            out.append(np.asarray(res).tobytes())
    jbps.shutdown()


def _onebit_round_trip(x: np.ndarray, part_bytes: int = PART_BYTES) -> np.ndarray:
    """decode(encode(x)) per partition, with the reference's host codec."""
    out = np.empty_like(x)
    for off, ln in ref_partition.partition_elements(x.size, 4, part_bytes):
        codec = RefOneBit(ln, scaling=True)
        out[off: off + ln] = codec.decompress(codec.compress(x[off: off + ln]), ln)
    return out


def _expected(rounds_per_worker: list) -> list:
    """What every worker pulls: the sum (for onebit: of the decoded pushes,
    then encoded and decoded once more by the server), divided by the
    worker count for floating tensors pushed with average."""
    w = len(rounds_per_worker)
    out = []
    for items in zip(*[sum(r, []) for r in rounds_per_worker]):
        name, arr, avg, onebit = items[0]
        if onebit:
            total = _onebit_round_trip(sum(_onebit_round_trip(it[1]) for it in items))
        else:
            total = items[0][1].copy()
            for it in items[1:]:
                total += it[1]
        if avg and arr.dtype.kind == "f":
            total = total / arr.dtype.type(w)
        out.append(total.tobytes())
    return out


@pytest.mark.parametrize("server", ["port", "ref", "native"])
def test_pulls_are_bitwise_equal_across_workers_and_servers(monkeypatch, server):
    """{port worker, byteps_tpu worker} against one server kind: the same
    pulls as each other and as the expected sums, bit for bit."""
    rounds = _rounds(seed=1)
    want = _expected([rounds])
    for worker in (_port_worker, _ref_worker):
        got: list = []
        with _cluster(monkeypatch, server):
            worker(rounds, got)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (worker.__name__, server, i)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_one_fleet_serves_a_port_worker_and_a_reference_worker(monkeypatch, server):
    """Two workers, one of each package, push different tensors at the
    same time: both pull the same averaged (or summed) result."""
    rounds = [_rounds(seed=2), _rounds(seed=3)]
    want = _expected(rounds)
    got: list = [[], []]
    with _cluster(monkeypatch, server, workers=2):
        threads = [threading.Thread(target=_port_worker, args=(rounds[0], got[0])),
                   threading.Thread(target=_ref_worker, args=(rounds[1], got[1]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert got[0] == got[1] == want


@pytest.mark.parametrize("server", ["port", "ref"])
def test_two_init_shutdown_cycles_reuse_a_name_against_fresh_clusters(monkeypatch, server):
    """The registry outlives shutdown(); the servers' stores do not, so the
    second engine re-runs the tensor's init barrier."""
    rng = np.random.default_rng(4)
    for cycle in range(2):
        x = torch.from_numpy(rng.standard_normal(40000).astype(np.float32))
        with _cluster(monkeypatch, server):
            pbps.init(device="cpu")
            for _ in range(2):
                assert torch.equal(pbps.push_pull(x, name="cycle.grad"), x)
            assert (pbps.rank(), pbps.size()) == (0, 1)
            pbps.shutdown()


def test_counters_and_partition_table(monkeypatch):
    """d2h_bytes counts what a device-lane tensor hands to the host: the
    wire payload for a onebit partition.  wire_tx/rx count payload bytes."""
    with _cluster(monkeypatch, "port"):
        pbps.init(device="cpu")
        _declare(pbps)
        counters().reset()
        x = torch.from_numpy(_signs(np.random.default_rng(5), 50000, 2))
        pbps.push_pull(x, name="ob.avg")
        table = port_state.get_state().engine.partition_table()
        assert [r["length"] for r in table] == [16384, 16384, 16384, 848]
        wire = sum(r["wire_nbytes"] for r in table)
        assert wire == sum(4 + 4 * ((r["length"] + 31) // 32) for r in table)
        assert counters().get("wire_tx_bytes") == counters().get("wire_rx_bytes") == wire
        pbps.shutdown()


# --- the slice as a whole ---------------------------------------------------

LR, WD, MIN_COMPRESS = 1e-2, 1e-4, 1024


def _tiny():
    cfg = tt.tiny_test()
    sd = params_from_jax(tt.init_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, cfg.max_seq)))
    return cfg, sd, tok, torch.roll(tok, -1, 1)


def _train_through(monkeypatch, server: str) -> list:
    cfg, sd, tok, tgt = _tiny()
    with _cluster(monkeypatch, server, BYTEPS_PARTITION_BYTES="2048",
                  BYTEPS_MIN_COMPRESS_BYTES=str(MIN_COMPRESS)):
        pbps.init(device="cpu")
        model = tt.Transformer(cfg, device="cpu")
        model.load_state_dict(sd)
        pbps.broadcast_parameters(model.state_dict())
        opt = pbps.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
            named_parameters=model.named_parameters(),
            compression_params={"compressor": "onebit", "scaling": True},
        )
        step = tt.build_train_step(model, opt)
        losses = [float(step(tok, tgt)) for _ in range(3)]
        table = port_state.get_state().engine.partition_table()
        pbps.shutdown()
    assert sum(r["wire_nbytes"] is not None for r in table) >= 4
    return losses


def test_tiny_model_trains_the_same_through_port_and_reference_servers(monkeypatch):
    """Three AdamW steps of tiny_test, onebit (scaling) on every gradient of
    at least 1 KiB: through the port's scheduler and servers, and through
    byteps_tpu's, the losses are bitwise equal.  A local run that applies
    the plain onebit decode(encode()) to each gradient partition gives the
    same losses within rtol 1e-6 (it repeats the same float operations; the
    tolerance only allows for a different summation order in AdamW)."""
    port = _train_through(monkeypatch, "port")
    ref = _train_through(monkeypatch, "ref")
    assert port == ref

    cfg, sd, tok, tgt = _tiny()
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    local = []
    for _ in range(3):
        opt.zero_grad()
        loss = model.loss(tok, tgt)
        loss.backward()
        local.append(float(loss.detach()))
        with torch.no_grad():
            for p in model.parameters():
                g = p.grad.reshape(-1).numpy()
                if g.nbytes >= MIN_COMPRESS:
                    p.grad.copy_(torch.from_numpy(
                        _onebit_round_trip(g, 2048)).view_as(p.grad))
        opt.step()
    np.testing.assert_allclose(port, local, rtol=1e-6)
    assert port[2] < port[0]


# --- planes that are not ported ---------------------------------------------


@pytest.mark.parametrize("knob", [
    "BYTEPS_FUSION_THRESHOLD=4096", "BYTEPS_ASYNC=1", "BYTEPS_ENABLE_ASYNC=1",
    "BYTEPS_VAN=shm",
    "BYTEPS_VAN=uds", "BYTEPS_WIRE_LOSSLESS=1", "BYTEPS_ELASTIC_RESHARD=1",
    "BYTEPS_DEAD_NODE_TIMEOUT_S=5", "BYTEPS_AUTOTUNE=1", "BYTEPS_RPC_RETRIES=3",
    "BYTEPS_RPC_DEADLINE_S=5", "BYTEPS_COMPRESSION_AUTO=1",
])
def test_unported_environment_planes_raise(monkeypatch, knob):
    """At init() of a distributed worker, before it dials anything, and at
    the construction of a port server."""
    name, value = knob.split("=")
    monkeypatch.setenv(name, value)
    monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1b"):
        pbps.init(device="cpu")
    assert not port_state.get_state().initialized
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1b"):
        PortServer(PortConfig.from_env())


@pytest.mark.parametrize("kwargs", [
    {"byteps_server_opt": "sgd"},
])
def test_unported_codecs_and_the_server_optimizer_raise_at_declare(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1b"):
        pbps.declare_tensor("t", **kwargs)


def test_unported_entry_points_raise():
    pbps.init(device="cpu")
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(NotImplementedError, match="server-side optimizer"):
        pbps.DistributedOptimizer(torch.optim.SGD([p], lr=1.0), server_side=True)
    with pytest.raises(NotImplementedError, match="row-sparse"):
        pbps.push_pull_rowsparse(np.array([0]), np.ones((1, 2), np.float32), "e", 4)


def _fake_server(reply_op):
    """A listener that answers the first request on it with ``reply_op``."""
    srv, port = ptr.listen("127.0.0.1", 0)

    def serve():
        conn, _ = srv.accept()
        msg = ptr.recv_message(conn)
        ptr.send_message(conn, ptr.Message(reply_op, key=msg.key, seq=msg.seq))
        conn.recv(1)  # hold the connection until the client closes it
        conn.close()
        srv.close()

    threading.Thread(target=serve, daemon=True).start()
    return port


@pytest.mark.parametrize("op", ["FUSED", "RESYNC_STATE", "MIGRATE_STATE", "WRONG_OWNER"])
def test_a_reply_of_an_unported_plane_fails_its_request(op):
    """The PS client fails the request (never drops it) when a server
    answers with a fused, resync or migration frame."""
    client = PSClient(PortConfig(num_server=1))
    client.num_servers = 1
    client._servers.append(client._new_conn("127.0.0.1", _fake_server(ptr.Op[op]), "0"))
    done, errors = threading.Event(), []
    client.push(5, b"\0" * 8, int(ptypes.DataType.FLOAT32), 1, cb=done.set,
                on_error=lambda reason: (errors.append(reason), done.set()))
    assert done.wait(10)
    assert errors and "not ported" in errors[0] and op in errors[0]
    client._stop.set()
    for sc in client._servers:
        ptr.close_socket(sc.sock)


def test_the_port_server_drops_a_connection_that_sends_an_unported_op(monkeypatch):
    with _cluster(monkeypatch, "port", servers=1) as nodes:
        sock = ptr.connect("127.0.0.1", nodes[0].port)
        ptr.send_message(sock, ptr.Message(ptr.Op.FUSED, key=1, payload=b"xx"))
        sock.settimeout(10)
        assert sock.recv(1) == b""  # closed, with no reply
        sock.close()
