"""The uds and shm vans of the port (``comm/van.py``, ``comm/shm_ring.py``,
the C++ engine's Unix listener) against byteps_tpu's.

- ``ShmRing`` between the two packages in one process, in both
  directions: wrap-around, interleaving, close, torn writes, the wait
  callback (the cases of ``tests/test_shm_ring.py``); the ring file's
  header is the reference's byte for byte.
- A van connection of one package talks to a listener of the other; a
  failed handshake drops that connection alone; no ring file outlives an
  attached connection.
- Fleets on ``uds``, ``shm``, ``chaos:uds`` and ``chaos:shm`` of the
  port's Python and C++ servers (and the reference's on uds and shm) serve
  a port worker and a reference worker at once, bitwise as on tcp, and
  leave no socket or ring file behind.
- The native client dials ``unix://`` and refuses ``shm+unix://``.
"""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import torch_port_kits as kits
from byteps_tpu.comm import shm_ring as rring
from byteps_tpu.comm import transport as rtr
from byteps_tpu.comm import van as rvan
from byteps_tpu_torch.comm import shm_ring as pring
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm import van as pvan

RINGS = {"port": pring, "ref": rring}
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("BYTEPS_WIRE_LOSSLESS", raising=False)
    yield from kits.reset_runtime(monkeypatch)


@pytest.fixture(params=PAIRS, ids=["port-to-ref", "ref-to-port", "port-to-port"])
def ring_pair(request):
    """A 1 KiB ring: producer of the first package, consumer of the second."""
    prod_pkg, cons_pkg = request.param
    path = RINGS[prod_pkg].create_ring_file(1024, tag="test_")
    prod = RINGS[prod_pkg].ShmRing(path, "producer")
    cons = RINGS[cons_pkg].ShmRing(path, "consumer", unlink=True)
    yield prod, cons
    prod.close()
    cons.close()
    assert not os.path.exists(path)


def _read_exact(ring, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = ring.recv_into(view[got:], n - got)
        assert r > 0
        got += r
    return bytes(buf)


class _RingSock:
    """The transport's view of a ring's consumer side."""

    def __init__(self, ring) -> None:
        self.ring = ring

    def recv_into(self, buf, nbytes=0):
        return self.ring.recv_into(buf, nbytes)


def test_the_ring_file_layout_is_the_reference(monkeypatch):
    for pkg in ("port", "ref"):
        path = RINGS[pkg].create_ring_file(256, tag="layout_")
        try:
            assert os.path.getsize(path) == 64 + 256
            assert os.path.basename(path).startswith(f"byteps_ring_layout_{os.getpid()}_")
            ring = RINGS[pkg].ShmRing(path, "producer")
            ring.write(b"abc")
            ring.mark_closed()
            ring.close()
            with open(path, "rb") as f:
                head = f.read(67)
            assert struct.unpack_from("<QQ", head) == (3, 0) and head[16] == 1
            assert head[64:67] == b"abc"
        finally:
            os.unlink(path)
    assert pring._HDR == rring._HDR and pring._PARK_S == rring._PARK_S


def test_a_ring_streams_through_wraparound(ring_pair):
    prod, cons = ring_pair
    prod.write(b"hello world")
    assert _read_exact(cons, 11) == b"hello world"
    data = np.random.default_rng(0).integers(0, 256, size=10_000, dtype=np.uint8).tobytes()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("d", _read_exact(cons, len(data))))
    t.start()
    prod.write(data)
    t.join(10)
    assert out["d"] == data


def test_a_ring_keeps_interleaved_messages_apart(ring_pair):
    prod, cons = ring_pair
    chunks = [bytes([i]) * (37 * (i + 1)) for i in range(20)]
    t = threading.Thread(target=lambda: [prod.write(c) for c in chunks])
    t.start()
    for c in chunks:
        assert _read_exact(cons, len(c)) == c
    t.join(10)


def test_close_unblocks_the_reader_and_fails_the_writer(ring_pair):
    prod, cons = ring_pair
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("n", cons.recv_into(bytearray(8))))
    t.start()
    time.sleep(0.05)
    prod.mark_closed()
    t.join(5)
    assert result["n"] == 0
    cons.mark_closed()
    with pytest.raises(ConnectionError):
        prod.write(b"x" * 5000)


def test_a_torn_write_is_a_connection_error_never_garbage(ring_pair):
    prod, cons = ring_pair
    frame = rtr.Message(rtr.Op.PUSH, key=9, seq=1, payload=b"z" * 300).encode()
    prod.write(frame[: ptr.HEADER_SIZE + 150])
    prod.mark_closed()
    with pytest.raises(ConnectionError, match="peer closed"):
        ptr.recv_message(_RingSock(cons))


def test_a_desynced_continuation_is_rejected_by_the_magic(ring_pair):
    prod, cons = ring_pair
    good = ptr.Message(ptr.Op.PUSH, key=1, seq=1, payload=b"a" * 64).encode()
    prod.write(good[: ptr.HEADER_SIZE + 32])
    prod.write(b"\x00" * (ptr.HEADER_SIZE + 32))
    sock = _RingSock(cons)
    ptr.recv_message(sock)
    with pytest.raises(ConnectionError, match="bad magic"):
        ptr.recv_header_ex(sock)
    prod.mark_closed()


def test_the_wait_callback_breaks_a_stall(ring_pair):
    prod, cons = ring_pair
    assert cons.recv_into(bytearray(4), wait=lambda t: False) == 0
    with pytest.raises(ConnectionError):
        prod.write(b"x" * 2000, wait=lambda t: False)


VANS = {"port": (pvan, ptr), "ref": (rvan, rtr)}


@pytest.mark.parametrize("listener,dialer", PAIRS)
@pytest.mark.parametrize("van", ["uds", "shm"])
def test_a_connection_crosses_the_packages(monkeypatch, tmp_path, van, listener, dialer):
    """A frame of 400 KB (under the 512 KiB ring, over one socket write)
    and its doubled reply; the listener's side then drops the connection,
    and the dialer's next read fails rather than spins."""
    import tempfile

    monkeypatch.setenv("BYTEPS_SOCKET_PATH", tempfile.mkdtemp(dir="/tmp"))
    lvan, ltr = VANS[listener]
    dvan, dtr = VANS[dialer]
    lsock, host, port = lvan.get_van(van).listen("127.0.0.1")
    assert host.startswith({"uds": "unix://", "shm": "shm+unix://"}[van])
    accepted = {}

    def serve():
        conn, _ = lsock.accept()
        accepted["conn"] = conn
        msg = ltr.recv_message(conn)
        ltr.send_message(conn, ltr.Message(ltr.Op.PULL, key=msg.key, payload=msg.payload * 2,
                                           seq=msg.seq))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = dvan.van_for_address(host).connect(host, port)
    payload = np.arange(100_000, dtype=np.float32).tobytes()
    dtr.send_message(client, dtr.Message(dtr.Op.PUSH, key=7, payload=payload, seq=3))
    resp = dtr.recv_message(client)
    assert (resp.key, resp.seq, resp.payload) == (7, 3, payload * 2)
    t.join(10)
    ltr.close_socket(accepted["conn"])
    with pytest.raises(ConnectionError):
        dtr.recv_message(client)
    dtr.close_socket(client)
    lsock.close()
    pvan.unlink_published(host)
    kits.assert_no_leftovers(os.environ["BYTEPS_SOCKET_PATH"])


def test_a_failed_handshake_drops_that_connection_alone(monkeypatch):
    import tempfile

    monkeypatch.setenv("BYTEPS_SOCKET_PATH", tempfile.mkdtemp(dir="/tmp"))
    listener, host, _ = pvan.get_van("shm").listen("127.0.0.1")
    path = host[len(pvan.SHM_PREFIX):]
    results = []

    def serve_one():
        conn, _ = listener.accept()
        try:
            msg = ptr.recv_message(conn)
            ptr.send_message(conn, ptr.Message(ptr.Op.PING, seq=msg.seq))
            results.append("ok")
        except ConnectionError:
            results.append("dropped")
            ptr.close_socket(conn)

    threads = [threading.Thread(target=serve_one, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    s1 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s1.connect(path)
    s1.close()  # dies before it names its rings
    s2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s2.connect(path)
    bogus = b"/dev/shm/byteps_ring_nonexistent"
    s2.sendall((struct.pack("!H", len(bogus)) + bogus) * 2)  # rings that do not exist
    s2.close()
    client = rvan.get_van("shm").connect(host, 0)  # the reference's dialer
    rtr.send_message(client, rtr.Message(rtr.Op.PING, seq=9))
    assert rtr.recv_message(client).seq == 9
    for t in threads:
        t.join(15)
    assert sorted(results) == ["dropped", "dropped", "ok"]
    rtr.close_socket(client)
    listener.close()
    kits.assert_no_leftovers(os.environ["BYTEPS_SOCKET_PATH"])


def test_no_ring_file_outlives_the_attach(monkeypatch):
    import tempfile

    monkeypatch.setenv("BYTEPS_SOCKET_PATH", tempfile.mkdtemp(dir="/tmp"))
    listener, host, _ = pvan.get_van("shm").listen("127.0.0.1")
    got = {}

    def serve():
        conn, _ = listener.accept()
        got["c"] = conn
        got["msg"] = ptr.recv_message(conn)  # completes the handshake

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = pvan.get_van("shm").connect(host, 0)
    ptr.send_message(client, ptr.Message(ptr.Op.PING, seq=1))
    t.join(10)
    assert got["msg"].seq == 1
    mine = [f for f in os.listdir("/dev/shm") if f"_{os.getpid()}_" in f
            and f.startswith("byteps_ring_")]
    assert not mine  # unlinked once attached, while the connection lives
    ptr.close_socket(client)
    ptr.close_socket(got["c"])
    listener.close()
    kits.assert_no_leftovers(os.environ["BYTEPS_SOCKET_PATH"])


def test_the_van_selection_and_dispatch_are_the_reference():
    for name in ("tcp", "uds", "shm", "chaos:tcp", "chaos:uds", "chaos:shm"):
        assert pvan.get_van(name).name == rvan.get_van(name).name
    for bad in ("chaos:", "chaos:chaos:tcp", "rdma"):
        with pytest.raises(ValueError):
            pvan.get_van(bad)
        with pytest.raises(ValueError):
            rvan.get_van(bad)
    for host in ("127.0.0.1", "unix:///a", "shm+unix:///a", "chaos+unix:///a",
                 "chaos+shm+unix:///a", "chaos+127.0.0.1"):
        assert pvan.van_for_address(host).name == rvan.van_for_address(host).name
        assert pvan.strip_chaos(host) == rvan.strip_chaos(host)


# --- fleets -----------------------------------------------------------------

FLEETS = ([(van, srv) for van in ("uds", "shm", "chaos:uds", "chaos:shm")
           for srv in ("port", "port-native")]
          + [(van, srv) for van in ("uds", "shm") for srv in ("ref", "ref-native")])


@pytest.mark.parametrize("van,server", FLEETS)
def test_a_fleet_on_the_van_serves_both_packages_bitwise(monkeypatch, van, server):
    """A port worker and a reference worker push different tensors at
    once (raw float32 of five partitions, ints, float64, onebit); both
    pull the same result, the one they pull on tcp."""
    import test_torch_port_ps as tps

    if server == "ref-native":
        from conftest import have_native_parity_server

        if not have_native_parity_server():
            pytest.skip("the reference's native server library is not built")
    rounds = [tps._rounds(seed=6), tps._rounds(seed=7)]
    want = tps._expected(rounds)
    got: list = [[], []]
    with kits.fleet(monkeypatch, server, workers=2, BYTEPS_VAN=van,
                    BYTEPS_PARTITION_BYTES=str(tps.PART_BYTES),
                    BYTEPS_WIRE_CHECKSUM="1") as nodes:
        scheme = {"uds": "unix://", "shm": "shm+unix://"}[van.split(":")[-1]]
        assert all(n.host.startswith(("chaos+" if "chaos" in van else "") + scheme)
                   for n in nodes)
        kits.in_threads(lambda: tps._port_worker(rounds[0], got[0]),
                        lambda: tps._ref_worker(rounds[1], got[1]), timeout=90)
    assert got[0] == got[1] == want


@pytest.mark.parametrize("server", ["port", "port-native"])
def test_the_native_client_dials_unix_and_refuses_shm(monkeypatch, server):
    import byteps_tpu_torch as pbps
    from byteps_tpu_torch.core import state as port_state

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(70000).astype(np.float32))
    with kits.fleet(monkeypatch, server, BYTEPS_VAN="uds", BYTEPS_NATIVE_CLIENT="1",
                    BYTEPS_PARTITION_BYTES="65536"):
        pbps.init(device="cpu")
        from byteps_tpu_torch.comm.ps_client import _NativeServerConn

        assert all(isinstance(sc, _NativeServerConn)
                   for sc in port_state.get_state().ps_client._servers)
        for _ in range(2):
            assert torch.equal(pbps.push_pull(x, name="native.uds", average=False), x)
        idx = torch.tensor([5, 1, 5])
        rows = torch.ones(3, 4)
        out = pbps.push_pull_rowsparse(idx, rows, "native.uds.rs", 8, average=False)
        assert torch.equal(out, torch.tensor([[2.0] * 4, [1.0] * 4, [2.0] * 4]))
        pbps.shutdown()
    with kits.fleet(monkeypatch, server, BYTEPS_VAN="shm", BYTEPS_NATIVE_CLIENT="1"):
        with pytest.raises(RuntimeError, match="cannot dial the shm address"):
            pbps.init(device="cpu")
        assert not port_state.get_state().initialized
