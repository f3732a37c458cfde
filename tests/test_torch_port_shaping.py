"""The port's link shaping (``byteps_tpu_torch/comm/shaping.py``) against
byteps_tpu's (``tests/test_shaping.py``):

- each ShapedSocket case of the reference on both packages' sockets: the
  rate, the pipelined delay, FIFO order, backpressure at the buffer, the
  rate (not buffer over delay) governing throughput, a delivery error, the
  identity when off, the knobs and the deprecated alias;
- the time model itself, ``arrival = max(enqueue, wire_free) + bytes/rate +
  delay``, on a fake clock: every message's serialization and delivery time
  equal to the reference's, bitwise;
- a push_pull through a shaped port worker against byteps_tpu's servers,
  and through byteps_tpu's worker against the port's servers: the results
  exact and a round trip at least its two delays (the native-client knob
  bypassed with the reference's warning, the servers' replies shaped).

Timing asserts are lower bounds (what shaping must at least add), as in
the reference's file, apart from its two upper bounds with their slack.
Every listener is bound to port 0."""

import socket
import threading
import time
import types

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.comm import shaping as ref_shaping
from byteps_tpu_torch.comm import shaping as port_shaping

SHAPING = {"port": port_shaping, "ref": ref_shaping}
KNOBS = ("BYTEPS_VAN_DELAY_MS", "BYTEPS_VAN_RATE_MBYTES_S", "BYTEPS_VAN_RATE_MBPS",
         "BYTEPS_VAN_SHAPE_BUF_KB", "BYTEPS_NATIVE_CLIENT")


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield from kits.reset_runtime(monkeypatch)


def _recv_all(b: socket.socket, n: int, into: bytearray) -> None:
    b.settimeout(10)
    while len(into) < n:
        chunk = b.recv(1 << 20)
        if not chunk:
            return
        into.extend(chunk)


# --- the socket, case by case on both packages ---------------------------------


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_the_rate_limits_throughput(pkg):
    a, b = socket.socketpair()
    # 2 MB at 100 MB/s: at least 20 ms of serialization
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=0.0, rate_bps=100e6, buf_bytes=1 << 22)
    payload, got = b"x" * (2 << 20), bytearray()
    t = threading.Thread(target=_recv_all, args=(b, len(payload), got), daemon=True)
    t.start()
    t0 = time.monotonic()
    shaped.sendall(payload)
    t.join(timeout=10)
    assert bytes(got) == payload
    assert time.monotonic() - t0 >= 0.016  # 80% of the serialization time
    shaped.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_the_delay_is_pipelined_not_blocking(pkg):
    a, b = socket.socketpair()
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=1.0, rate_bps=0.0, buf_bytes=1 << 20)
    t0 = time.monotonic()
    shaped.sendall(b"ping")
    # the reference's one upper bound: an enqueue against a 1 s delay, 0.5 s
    # of slack for contention
    assert time.monotonic() - t0 < 0.5
    b.settimeout(10)
    assert b.recv(16) == b"ping"
    assert time.monotonic() - t0 >= 0.8  # 80% of the propagation delay
    shaped.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_fifo_order_is_preserved(pkg):
    a, b = socket.socketpair()
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=0.005, rate_bps=500e6, buf_bytes=1 << 22)
    msgs = [bytes([i]) * (1 + (i * 37) % 1000) for i in range(32)]
    for m in msgs:
        shaped.sendall(m)
    want, got = b"".join(msgs), bytearray()
    _recv_all(b, len(want), got)
    assert bytes(got) == want
    shaped.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_backpressure_blocks_at_the_buffer_limit(pkg):
    a, b = socket.socketpair()
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=0.0, rate_bps=10e6, buf_bytes=64 << 10)
    drained = bytearray()
    t = threading.Thread(target=_recv_all, args=(b, 1 << 20, drained), daemon=True)
    t.start()
    t0 = time.monotonic()
    for _ in range(16):  # 1 MB at 10 MB/s: ~100 ms serialized
        shaped.sendall(b"z" * (64 << 10))
    # all but the last buffer's worth waited for the wire
    assert time.monotonic() - t0 >= 0.07
    t.join(timeout=10)
    assert len(drained) == 1 << 20
    shaped.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_throughput_is_the_rate_not_buffer_over_delay(pkg):
    """2 MB at 50 MB/s behind a 100 ms delay and a 256 KB buffer takes
    ~40 ms of serialization; were buffered bytes held until delivery, the
    sender would be capped at buf/delay (2.56 MB/s, > 0.8 s)."""
    a, b = socket.socketpair()
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=0.1, rate_bps=50e6, buf_bytes=256 << 10)
    total, got = 2 << 20, bytearray()
    t = threading.Thread(target=_recv_all, args=(b, total, got), daemon=True)
    t.start()
    t0 = time.monotonic()
    for _ in range(32):
        shaped.sendall(b"q" * (64 << 10))
    sender_done = time.monotonic() - t0
    t.join(timeout=10)
    assert len(got) == total
    # the reference's second upper bound, 4x slack against the bug's 0.9 s
    assert sender_done < 0.6, sender_done
    shaped.close()
    b.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_delivery_error_surfaces_to_the_sender(pkg):
    a, b = socket.socketpair()
    shaped = SHAPING[pkg].ShapedSocket(a, delay_s=0.01, rate_bps=0.0, buf_bytes=1 << 20)
    b.close()
    shaped.sendall(b"doomed " * 100000)  # delivery fails in the thread
    with pytest.raises(ConnectionError):
        for _ in range(200):
            shaped.sendall(b"next")
            time.sleep(0.005)
    shaped.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_maybe_shape_off_is_the_identity_and_on_wraps(pkg, monkeypatch):
    a, b = socket.socketpair()
    assert not SHAPING[pkg].shaping_enabled()
    assert SHAPING[pkg].maybe_shape(a) is a
    monkeypatch.setenv("BYTEPS_VAN_DELAY_MS", "1")
    shaped = SHAPING[pkg].maybe_shape(a)
    assert isinstance(shaped, SHAPING[pkg].ShapedSocket)
    shaped.close()
    b.close()


@pytest.mark.parametrize("env", [
    {"BYTEPS_VAN_DELAY_MS": "2.5", "BYTEPS_VAN_RATE_MBPS": "100"},
    {"BYTEPS_VAN_RATE_MBYTES_S": "25"},
    {"BYTEPS_VAN_RATE_MBPS": "10"},
    {"BYTEPS_VAN_RATE_MBYTES_S": "40", "BYTEPS_VAN_RATE_MBPS": "10"},
    {"BYTEPS_VAN_RATE_MBYTES_S": "0", "BYTEPS_VAN_RATE_MBPS": "10"},
    {"BYTEPS_VAN_DELAY_MS": "", "BYTEPS_VAN_SHAPE_BUF_KB": "0.0001"},
    {"BYTEPS_VAN_SHAPE_BUF_KB": "64"},
])
def test_the_knobs_and_the_alias_read_as_the_reference(env, monkeypatch):
    """(delay s, rate B/s, buffer bytes) equal to the reference's: the
    canonical MB/s name wins over the deprecated alias when both are set
    (a canonical "0" too), the alias alone means the same MB/s."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_shaping.shaping_params() == ref_shaping.shaping_params()
    assert port_shaping.shaping_enabled() == ref_shaping.shaping_enabled()


def test_the_alias_warns_once(monkeypatch, capsys):
    monkeypatch.setattr(port_shaping, "_warned_legacy_rate", False)
    monkeypatch.setenv("BYTEPS_VAN_RATE_MBPS", "10")
    for _ in range(3):
        assert port_shaping.shaping_params()[1] == 10e6
    assert capsys.readouterr().err.count("BYTEPS_VAN_RATE_MBPS is deprecated") == 1


def test_the_time_model_is_the_reference_s_on_a_fake_clock(monkeypatch):
    """Thirty sends of ragged sizes at given enqueue times: each message's
    delivery time and the virtual wire after each send are the reference's
    bitwise, and they are ``max(enqueue, wire_free) + bytes/rate + delay``.
    The delivery thread is stopped first, so the sender alone reads the
    fake clock (once a send: the buffer never fills)."""
    sizes = [1 + (i * 7919) % 40000 for i in range(30)]
    enqueue = np.cumsum(np.random.default_rng(3).exponential(2e-4, 30)).tolist()
    seen = {}
    for pkg, mod in SHAPING.items():
        clock = iter(enqueue)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda c=clock: next(c),
                                                               sleep=time.sleep))
        a, b = socket.socketpair()
        shaped = mod.ShapedSocket(a, delay_s=0.003, rate_bps=80e6, buf_bytes=1 << 30)
        with shaped._lock:  # the delivery thread leaves once it sees the close
            shaped._closed = True
            shaped._can_deliver.notify_all()
        shaped._thread.join(timeout=5)
        assert not shaped._thread.is_alive()
        shaped._closed = False
        deliver, walls = [], []
        shaped._queue = _RecordingQueue(deliver)
        for n in sizes:
            shaped.sendall(b"m" * n)
            walls.append(shaped._wire_free)
        seen[pkg] = (deliver, walls)
        shaped.close()
        b.close()
    assert seen["port"] == seen["ref"]
    wire = 0.0
    for n, t, w, d in zip(sizes, enqueue, *reversed(seen["port"])):
        wire = max(t, wire) + n / 80e6
        assert w == wire and d == wire + 0.003


class _RecordingQueue(list):
    """The send queue of a ShapedSocket whose delivery thread has left: it
    keeps each message's delivery time and no data."""

    def __init__(self, deliver: list) -> None:
        super().__init__()
        self._deliver = deliver

    def append(self, item) -> None:
        self._deliver.append(item[1])


# --- the data plane, across the packages ----------------------------------------


@pytest.mark.parametrize("worker, server", [("port", "ref"), ("ref", "port")])
def test_a_shaped_push_pull_is_exact_and_takes_its_two_delays(worker, server, monkeypatch):
    """The reference's shaped-cluster case with the worker of one package
    and the servers of the other: results exact, a round trip at least push
    (40 ms) + reply (40 ms) less 20%, with ``BYTEPS_NATIVE_CLIENT=1`` set
    (shaping takes the Python lanes, warned, or the floor would fail), and
    every connection the servers accepted shaped."""
    shaped = {"BYTEPS_VAN_DELAY_MS": "40", "BYTEPS_VAN_RATE_MBYTES_S": "500",
              "BYTEPS_NATIVE_CLIENT": "1"}
    with kits.fleet(monkeypatch, server, workers=1, servers=1, **shaped) as nodes:
        bps = kits.kit(worker).api
        bps.init(**({"device": "cpu"} if worker == "port" else {}))
        x = np.arange(256, dtype=np.float32)
        as_in = (lambda v: __import__("torch").from_numpy(v)) if worker == "port" else (lambda v: v)
        out = bps.push_pull(as_in(x), name="shaped.t")  # the init round too
        np.testing.assert_array_equal(np.asarray(out), x)
        t0 = time.monotonic()
        out = bps.push_pull(as_in(x + 1), name="shaped.t")
        rtt = time.monotonic() - t0
        np.testing.assert_array_equal(np.asarray(out), x + 1)
        assert rtt >= 0.064, rtt
        if server == "port":
            assert nodes[0]._conns and all(isinstance(c, port_shaping.ShapedSocket)
                                           for c in nodes[0]._conns)
        else:
            client = kits.kit("port").state.get_state().ps_client
            assert client._servers and all(isinstance(sc.sock, port_shaping.ShapedSocket)
                                           for sc in client._servers)
        bps.shutdown()
