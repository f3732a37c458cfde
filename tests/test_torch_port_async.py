"""The port's async and bounded-staleness profiles against byteps_tpu's.

- Per key (the INIT profile's bit 0), on raw sockets through the port's
  server: pushes apply at once to a cumulative store, a replayed push
  applies once, a pull past the staleness bound parks until a peer's push
  opens it, a lag within the bound does not park, an unbounded pull never
  parks, and a re-init without the extension returns the key to rounds.
  byteps_tpu's server answers the same frames with the same bytes.
- The port's C++ engine refuses the per-key profile with status 1 and
  counts it, and a worker against it raises.
- Server-wide (BYTEPS_ENABLE_ASYNC=1): through the engine, with a codec,
  on the port's and byteps_tpu's servers and the port's C++ engine; one
  worker's weight-delta loop trains like the bare optimizer.

Keys carry no job bits here (job namespaces: ``test_torch_port_tenancy.py``)."""

import contextlib
import struct
import threading

import numpy as np
import pytest
import torch

import byteps_tpu_torch as pbps
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.server.server import PSServer as RefServer
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.server.native import NativePSServer
from byteps_tpu_torch.server.server import PSServer as PortServer

CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, int(DataType.FLOAT32))


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_ASYNC", "BYTEPS_ENABLE_ASYNC",
              "BYTEPS_STALENESS_BOUND", "BYTEPS_SERVER_NATIVE", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


# --- per key, on raw sockets --------------------------------------------------


@contextlib.contextmanager
def _wire(server: str, workers: int):
    cfg = (PortConfig if server == "port" else RefConfig)(num_worker=workers, num_server=1)
    srv = (PortServer if server == "port" else RefServer)(cfg)
    srv.start(register=False)
    socks = [ptr.connect(srv.host, srv.port) for _ in range(workers)]
    for s in socks:
        s.settimeout(15)
    try:
        yield srv, socks
    finally:
        for s in socks:
            ptr.close_socket(s)
        srv.stop()


def _init(socks, key, n, async_profile=False, staleness=-1, token=1):
    payload = ptr.encode_init(n, int(DataType.FLOAT32),
                              ptr.PROFILE_ASYNC if async_profile else 0, staleness)
    for i, sock in enumerate(socks):
        ptr.send_message(sock, ptr.Message(ptr.Op.INIT, key=key, seq=900 + i, flags=i + 1,
                                           version=token + i, payload=payload))
    for sock in socks:
        msg = ptr.recv_message(sock)
        assert msg.op == ptr.Op.INIT and msg.status == 0


def _push(sock, key, version, arr, flag):
    ptr.send_message(sock, ptr.Message(ptr.Op.PUSH, key=key, seq=1000 + version, flags=flag,
                                       version=version, cmd=CMD_F32, payload=arr.tobytes()))
    msg = ptr.recv_message(sock)
    assert msg.op == ptr.Op.PUSH and msg.status == 0


def _pull(sock, key, version):
    ptr.send_message(sock, ptr.Message(ptr.Op.PULL, key=key, seq=2000 + version,
                                       version=version, cmd=CMD_F32))
    msg = ptr.recv_message(sock)
    assert msg.op == ptr.Op.PULL
    return np.frombuffer(msg.payload, dtype=np.float32), msg.version


@pytest.mark.parametrize("server", ["port", "ref"])
def test_async_pushes_apply_at_once_to_a_cumulative_store(server):
    with _wire(server, 1) as (srv, (w,)):
        _init([w], 41, 16, async_profile=True)
        if server == "port":
            ks = srv._keys[41]
            assert ks.async_mode and ks.staleness == -1
        g1, g2 = np.arange(16, dtype=np.float32), np.full(16, 2.0, np.float32)
        _push(w, 41, 1, g1, flag=1)
        assert [a.tobytes() for a in [_pull(w, 41, 1)[0]]] == [g1.tobytes()]
        _push(w, 41, 2, g2, flag=1)
        out, ver = _pull(w, 41, 2)
        assert out.tobytes() == (g1 + g2).tobytes() and ver == 2


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_replayed_async_push_applies_once(server):
    with _wire(server, 1) as (srv, (w,)):
        _init([w], 42, 8, async_profile=True)
        g = np.ones(8, np.float32)
        _push(w, 42, 1, g, flag=1)
        _push(w, 42, 1, g, flag=1)  # a retransmit
        out, ver = _pull(w, 42, 1)
        assert out.tobytes() == g.tobytes() and ver == 1


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_stale_pull_parks_and_a_peer_push_releases_it(server):
    """Bound 0 (sequential consistency): worker 1's pull of round 1 waits
    for worker 2's round-1 push."""
    with _wire(server, 2) as (srv, (w1, w2)):
        _init([w1, w2], 43, 8, async_profile=True, staleness=0)
        g1, g2 = np.ones(8, np.float32), np.full(8, 3.0, np.float32)
        _push(w1, 43, 1, g1, flag=1)
        box = {}
        t = threading.Thread(target=lambda: box.update(out=_pull(w1, 43, 1)), daemon=True)
        t.start()
        t.join(timeout=0.4)
        assert t.is_alive(), "a pull was answered past the staleness bound"
        _push(w2, 43, 1, g2, flag=2)
        t.join(timeout=5)
        assert not t.is_alive(), "the peer's push did not release the pull"
        assert box["out"][0].tobytes() == (g1 + g2).tobytes()
        if server == "port":
            assert srv.stats.get("pulls_parked") == 1


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_lag_within_the_bound_does_not_park(server):
    with _wire(server, 2) as (srv, (w1, w2)):
        _init([w1, w2], 44, 4, async_profile=True, staleness=1)
        g = np.ones(4, np.float32)
        _push(w2, 44, 1, g, flag=2)
        _push(w1, 44, 1, g, flag=1)
        _push(w1, 44, 2, g, flag=1)
        out, _ = _pull(w1, 44, 2)  # the slowest applied 1 >= 2 - 1
        assert out.tobytes() == (3 * g).tobytes()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_an_unbounded_pull_never_parks(server):
    with _wire(server, 2) as (srv, (w1, w2)):
        _init([w1, w2], 45, 4, async_profile=True, staleness=-1)
        g = np.ones(4, np.float32)
        _push(w1, 45, 1, g, flag=1)
        _push(w1, 45, 2, g, flag=1)  # the peer never pushed
        out, _ = _pull(w1, 45, 5)
        assert out.tobytes() == (2 * g).tobytes()


def test_a_reinit_without_the_extension_returns_the_key_to_rounds():
    with _wire("port", 1) as (srv, (w,)):
        _init([w], 46, 4, async_profile=True, staleness=2)
        ks = srv._keys[46]
        assert ks.async_mode and ks.staleness == 2
        _init([w], 46, 4, token=77)
        assert not ks.async_mode and ks.staleness == -1


def test_the_native_engine_refuses_the_per_key_profile_and_counts_it():
    srv = NativePSServer(PortConfig(num_worker=1, num_server=1))
    try:
        s = ptr.connect("127.0.0.1", srv.port)
        payload = struct.pack("!QI", 8, 0) + struct.pack("!Bi", 1, 2)
        ptr.send_message(s, ptr.Message(ptr.Op.INIT, key=5, seq=1, flags=1, version=7,
                                        payload=payload))
        r = ptr.recv_message(s)
        assert r.op == ptr.Op.INIT and r.status != 0
        assert srv.native_counters().get("native_async_reject", 0) >= 1
        ptr.close_socket(s)
    finally:
        srv.stop()


# --- through the engine -----------------------------------------------------------


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, **env):
    base = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_MIN_COMPRESS_BYTES": "0"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    sched = (PortScheduler(1, 1, host="127.0.0.1") if server != "ref"
             else RefScheduler(num_workers=1, num_servers=1, host="127.0.0.1"))
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    node = {"port": lambda: PortServer(PortConfig.from_env()),
            "port-native": lambda: NativePSServer(PortConfig.from_env()),
            "ref": lambda: RefServer(RefConfig.from_env())}[server]()
    threading.Thread(target=node.start, daemon=True).start()
    try:
        yield node
    finally:
        node.stop()
        sched.stop()


def test_a_worker_against_native_servers_raises_for_a_per_key_profile(monkeypatch):
    with _fleet(monkeypatch, "port-native", BYTEPS_ASYNC="1"):
        pbps.init(device="cpu")
        with pytest.raises(RuntimeError, match="per-key async profile needs Python-engine"):
            pbps.push_pull(torch.ones(8), name="async.n")
        pbps.shutdown()


@pytest.mark.parametrize("server", ["port", "ref", "port-native"])
def test_server_wide_async_with_a_codec(monkeypatch, server):
    """The store accumulates every push, and each pull comes back in the
    format the puller asked for (topk with k = n is lossless)."""
    with _fleet(monkeypatch, server, BYTEPS_ENABLE_ASYNC="1"):
        pbps.init(device="cpu")
        n = 128
        pbps.declare_tensor("c.async", byteps_compressor_type="topk",
                            byteps_compressor_k=str(n))
        x = np.random.default_rng(4).normal(size=n).astype(np.float32)
        out1 = pbps.push_pull(x, name="c.async", average=False)
        out2 = pbps.push_pull(x, name="c.async", average=False)
        pbps.shutdown()
    assert out1.tobytes() == x.tobytes()
    assert out2.tobytes() == (x + x).tobytes()


def test_per_key_async_through_the_engine_with_a_bound(monkeypatch):
    """BYTEPS_ASYNC with BYTEPS_STALENESS_BOUND: the engine declares the
    profile at INIT and pulls the cumulative store."""
    with _fleet(monkeypatch, "port", BYTEPS_ASYNC="1", BYTEPS_STALENESS_BOUND="1") as srv:
        pbps.init(device="cpu")
        pbps.declare_tensor("async.off", byteps_async="0")
        x = torch.linspace(-1, 1, 50)
        assert torch.equal(pbps.push_pull(x, name="async.k", average=False), x)
        assert torch.equal(pbps.push_pull(x, name="async.k", average=False), x + x)
        assert torch.equal(pbps.push_pull(x, name="async.off", average=False), x)
        assert torch.equal(pbps.push_pull(x, name="async.off", average=False), x)
        pbps.shutdown()
    states = list(srv._keys.values())
    assert sorted((ks.async_mode, ks.staleness) for ks in states) == [(False, -1), (True, 1)]


def test_one_workers_delta_loop_trains_like_the_bare_optimizer(monkeypatch):
    """BYTEPS_ENABLE_ASYNC: the optimizer steps locally, the worker pushes
    each parameter's change since the store it adopted and adopts the
    pulled store (byteps_tpu/tensorflow/__init__.py:219-230).  With one
    worker the store is the sum of its deltas, so training matches the bare
    optimizer step for step (the TF plugin's test holds rtol 1e-5, atol
    1e-6)."""
    torch.manual_seed(5)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    bare = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
    bare.load_state_dict(model.state_dict())
    x = torch.randn(32, 8, generator=torch.Generator().manual_seed(1))
    y = torch.randn(32, 1, generator=torch.Generator().manual_seed(2))
    opt, opt_bare = torch.optim.SGD(model.parameters(), 0.05), torch.optim.SGD(bare.parameters(), 0.05)
    with _fleet(monkeypatch, "port", BYTEPS_ENABLE_ASYNC="1"):
        pbps.init(device="cpu")
        prev = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        for _ in range(4):
            for m, o in ((model, opt), (bare, opt_bare)):
                o.zero_grad()
                ((m(x) - y) ** 2).mean().backward()
                o.step()
            with torch.no_grad():
                for n, p in model.named_parameters():
                    new = pbps.push_pull(p - prev[n], name=f"AsyncParam.{n}", average=False)
                    p.copy_(new)
                    prev[n] = new
        pbps.shutdown()
    for p, q in zip(model.parameters(), bare.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)
