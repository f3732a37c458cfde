"""The PS control plane of either package behind one surface, for the
membership tests (``test_torch_port_elastic*.py``,
``test_torch_port_sched_recovery.py``): each case runs once on the port
and once on ``byteps_tpu`` with the same inputs, made from a numpy seed,
and holds both to the same exact results."""

from __future__ import annotations

import contextlib
import glob
import importlib
import io
import json
import os
import re
import runpy
import socket
import sys
import tempfile
import threading
import time
import types

import numpy as np


def kit(pkg: str) -> types.SimpleNamespace:
    """Scheduler, PSServer, PSClient, Config, counters, the api module and
    the rendezvous constants of ``pkg`` ("port" or "ref")."""
    if pkg == "port":
        import byteps_tpu_torch as api
        from byteps_tpu_torch.comm import chaos, rendezvous, transport
        from byteps_tpu_torch.comm.ps_client import PSClient
        from byteps_tpu_torch.common.config import Config
        from byteps_tpu_torch.core import state
        from byteps_tpu_torch.core.engine import PipelineEngine
        from byteps_tpu_torch.core.telemetry import counters
        from byteps_tpu_torch.server.server import PSServer, _KeyState
    else:
        import byteps_tpu as api
        from byteps_tpu.comm import chaos, rendezvous, transport
        from byteps_tpu.comm.ps_client import PSClient
        from byteps_tpu.common.config import Config
        from byteps_tpu.core import state
        from byteps_tpu.core.engine import PipelineEngine
        from byteps_tpu.core.telemetry import counters
        from byteps_tpu.server.server import PSServer, _KeyState
    return types.SimpleNamespace(
        pkg=pkg, api=api, Scheduler=rendezvous.Scheduler, PSServer=PSServer,
        PSClient=PSClient, Config=Config, counters=counters, state=state,
        PipelineEngine=PipelineEngine, KeyState=_KeyState, chaos=chaos, tr=transport,
        RESIZE_SEQ=rendezvous.RESIZE_SEQ, GROUP_WORKERS=rendezvous.GROUP_WORKERS)


def init(k) -> None:
    """``init()`` of the package's api on the CPU."""
    if k.pkg == "port":
        k.api.init(device="cpu")
    else:
        k.api.init()


def tensor(k, arr: np.ndarray):
    """A push_pull input of the package: a CPU torch tensor for the port,
    the numpy array for byteps_tpu (its host lane)."""
    if k.pkg == "port":
        import torch

        return torch.from_numpy(arr.copy())
    return arr.copy()


def start_server(k, cfg=None):
    srv = k.PSServer(cfg or k.Config.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    return srv


def roundtrip(client, key: int, arr: np.ndarray, version: int, timeout: float = 10.0):
    """Push ``arr`` as round ``version`` of ``key`` and pull the round."""
    done, got, box = threading.Event(), threading.Event(), []
    client.push(key, arr.tobytes(), 0, version, cb=done.set, on_error=lambda *a: done.set())
    assert done.wait(timeout)
    client.pull(key, version, lambda p: (box.append(bytes(p)), got.set()),
                on_error=lambda *a: got.set())
    assert got.wait(timeout) and box, f"pull of key {key} round {version} failed"
    return np.frombuffer(box[0], np.float32)


def in_threads(*fns, timeout: float = 20.0) -> list:
    """Run the functions at once; their results, in order."""
    out = [None] * len(fns)
    errs = []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i, fn), daemon=True) for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a thread hung"
    if errs:
        raise errs[0]
    return out


def register_raw(k, port: int, payload: dict, timeout: float = 5.0):
    """One raw REGISTER: (socket, reply).  The caller keeps the socket
    open (closing it tells the scheduler the node died)."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    sock.settimeout(timeout)
    k.tr.send_message(sock, k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps(payload).encode()))
    return sock, k.tr.recv_message(sock)


def book_of(msg) -> dict:
    return json.loads(msg.payload.decode())


def reset_runtime(monkeypatch):
    """The body of each test file's autouse fixture: both packages' chaos
    index streams start at 0, and the port's runtime (its node uid too) is
    reset after the test (byteps_tpu's by conftest's ``_clean_runtime``)."""
    from byteps_tpu.comm import chaos as ref_chaos
    from byteps_tpu_torch.comm import chaos as port_chaos

    for k in ("BYTEPS_VAN", "BYTEPS_WIRE_CHECKSUM", "BYTEPS_NODE_UID"):
        monkeypatch.delenv(k, raising=False)
    port_chaos.reset_conn_indices()
    ref_chaos.reset_conn_indices()
    yield
    from byteps_tpu_torch.common import config as port_config
    from byteps_tpu_torch.common import registry as port_registry
    from byteps_tpu_torch.core import state as port_state

    port_state.shutdown_state()
    port_state.get_state().node_uid = None
    port_registry.reset_registry()
    port_config.clear_config()
    port_chaos.reset_fault_budget(None)
    ref_chaos.reset_fault_budget(None)


@contextlib.contextmanager
def ref_hybrids_from_zero():
    """The reference's HybridDataParallel numbers its instances per process
    (``Hybrid.<i>``) while a port rank is a fresh process that starts at 0:
    count the reference's from 0 too, whatever built one earlier in this
    process, and put the count back after."""
    from byteps_tpu.parallel.hybrid import HybridDataParallel

    saved = HybridDataParallel._instances
    HybridDataParallel._instances = 0
    try:
        yield
    finally:
        HybridDataParallel._instances = saved


def env(monkeypatch, sched, workers: int, servers: int, **extra) -> None:
    for key, v in {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
                   "DMLC_NUM_WORKER": str(workers), "DMLC_NUM_SERVER": str(servers),
                   "BYTEPS_FORCE_DISTRIBUTED": "1", **extra}.items():
        monkeypatch.setenv(key, v)


def vals(seed: int, n: int = 64, k: int = 4) -> list:
    """``k`` float32 vectors of small integers: their sums are exact."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-8, 8, n).astype(np.float32) for _ in range(k)]


def init_key(clients, key: int, n: int = 64) -> None:
    in_threads(*[lambda c=c: c.init_tensor(key, n, 0) for c in clients])


def round_(clients, key: int, version: int, xs) -> list:
    """Every client pushes its vector as round ``version``; each pull."""
    return in_threads(*[lambda c=c, x=x: roundtrip(c, key, x, version)
                        for c, x in zip(clients, xs)])


def wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def worker_resize(monkeypatch, sched_kit, server_kit, worker_kits, native: bool = False):
    """2 -> 1 -> 2 workers against a live scheduler: the scheduler's book
    and the server follow each size, keys and ranks are stable, and every
    round's pulls are the exact sum of its members' pushes."""
    sched = sched_kit.Scheduler(num_workers=2, num_servers=1, host="127.0.0.1")
    sched.start()
    env(monkeypatch, sched, 2, 1, BYTEPS_HEARTBEAT_INTERVAL="0.1")
    if native:
        monkeypatch.setenv("BYTEPS_SERVER_NATIVE", "1")
        from byteps_tpu_torch.server.native import NativePSServer

        srv = NativePSServer(server_kit.Config.from_env())
        threading.Thread(target=srv.start, daemon=True).start()
    else:
        srv = start_server(server_kit)
    xs = vals(7, 64, 6)
    try:
        cfg = [wk.Config.from_env() for wk in worker_kits]
        w0 = worker_kits[0].PSClient(cfg[0], node_uid="w0")
        w1 = worker_kits[1].PSClient(cfg[1], node_uid="w1")
        in_threads(w0.connect, w1.connect)
        assert wait(lambda: srv.num_workers == 2)
        init_key([w0, w1], 101)
        for out in round_([w0, w1], 101, 1, xs[:2]):
            np.testing.assert_array_equal(out, xs[0] + xs[1])
        # scale down: w1 leaves, w0 resumes at one worker
        w1.close()
        w0.close()
        time.sleep(0.3)
        monkeypatch.setenv("DMLC_NUM_WORKER", "1")
        w0b = worker_kits[0].PSClient(worker_kits[0].Config.from_env(), node_uid="w0")
        w0b.connect()
        assert w0b.is_recovery and w0b.rank == 0 and w0b.num_workers == 1
        assert sched.num_workers == 1
        assert wait(lambda: srv.num_workers == 1)
        np.testing.assert_array_equal(roundtrip(w0b, 101, xs[2], 2), xs[2])
        # scale up: w0 resumes at two workers, a new member joins
        w0b.close()
        time.sleep(0.3)
        monkeypatch.setenv("DMLC_NUM_WORKER", "2")
        w0c = worker_kits[0].PSClient(worker_kits[0].Config.from_env(), node_uid="w0")
        w0c.connect()
        assert w0c.rank == 0 and sched.num_workers == 2
        w2 = worker_kits[1].PSClient(worker_kits[1].Config.from_env(), node_uid="w2-new")
        w2.connect()
        assert w2.rank == 1  # the lowest free rank, not a stolen one
        assert wait(lambda: srv.num_workers == 2)
        for out in round_([w0c, w2], 101, 3, xs[3:5]):
            np.testing.assert_array_equal(out, xs[3] + xs[4])
        w0c.close()
        w2.close()
    finally:
        srv.stop()
        sched.stop()


class RawNode:
    """A raw control connection that REGISTERs with ``payload``, keeps
    every book it receives (addresses and the incarnation aside, so that
    two packages' books compare), sets ``ended`` when the scheduler closes
    it and, while ``beating``, heartbeats."""

    def __init__(self, k, port: int, payload: dict, beat: bool = True) -> None:
        self.k = k
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.books: list = []
        self.beating = beat
        self.ended = threading.Event()
        self.lock = threading.Lock()
        self.send(k.tr.Message(k.tr.Op.REGISTER, payload=json.dumps(payload).encode()))
        threading.Thread(target=self._read, daemon=True).start()
        threading.Thread(target=self._beat, daemon=True).start()

    def send(self, msg) -> None:
        self.k.tr.send_message(self.sock, msg, self.lock)

    def _read(self) -> None:
        try:
            while True:
                msg = self.k.tr.recv_message(self.sock)
                if msg.op == self.k.tr.Op.ADDRBOOK:
                    book = book_of(msg)
                    book.pop("sched_incarnation", None)
                    book["servers"] = len(book["servers"])
                    self.books.append((msg.seq == self.k.RESIZE_SEQ, book))
                elif msg.op == self.k.tr.Op.SHUTDOWN:
                    self.books.append(("SHUTDOWN", None))
        except (ConnectionError, OSError, ValueError):
            self.ended.set()

    def _beat(self) -> None:
        while self.beating:
            try:
                self.send(self.k.tr.Message(self.k.tr.Op.PING))
            except OSError:
                return
            time.sleep(0.05)

    def close(self) -> None:
        self.beating = False
        self.k.tr.close_socket(self.sock)


class _Nodes(list):
    """A fleet's servers, with its scheduler as ``sched``."""

    sched = None


@contextlib.contextmanager
def fleet(monkeypatch, server: str, workers: int = 1, servers: int = 2, **extra):
    """A scheduler and ``servers`` servers in-process, yielded as the server
    list: ``server`` is "port", "port-native", "ref" or "ref-native" (the
    scheduler is of the servers' package).  Every socket file goes under a
    fresh short directory (``BYTEPS_SOCKET_PATH``: an AF_UNIX path has at
    most 107 bytes); when the fleet stops, :func:`assert_no_leftovers`
    holds it to leaving neither a socket file nor a ring behind.  The list
    carries the scheduler as ``sched``."""
    pkg, native = server.split("-")[0], server.endswith("-native")
    k = kit(pkg)
    sock_dir = tempfile.mkdtemp(dir="/tmp", prefix="bps")
    monkeypatch.setenv("BYTEPS_SOCKET_PATH", sock_dir)
    sched = k.Scheduler(num_workers=workers, num_servers=servers, host="127.0.0.1")
    sched.start()
    env(monkeypatch, sched, workers, servers, **extra)
    nodes = _Nodes()
    nodes.sched = sched
    try:
        for _ in range(servers):
            if native and pkg == "port":
                from byteps_tpu_torch.server.native import NativePSServer
            elif native:
                from byteps_tpu.server.server import NativePSServer
            node = (NativePSServer if native else k.PSServer)(k.Config.from_env())
            nodes.append(node)
            threading.Thread(target=node.start, daemon=True).start()
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()
    assert_no_leftovers(sock_dir)


def assert_no_leftovers(sock_dir: str) -> None:
    """No socket file left in ``sock_dir``, and no ring file of this
    process in /dev/shm."""
    assert wait(lambda: not os.listdir(sock_dir), 5.0), os.listdir(sock_dir)
    rings = lambda: glob.glob(f"/dev/shm/byteps_ring_*_{os.getpid()}_*")  # noqa: E731
    assert wait(lambda: not rings(), 5.0), rings()
    os.rmdir(sock_dir)


# --- the examples ---------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a printed number: its digits after the point say the print's resolution
NUMBER = re.compile(r"-?\d+(?:\.(\d+))?(?:e[-+]\d+)?")


def run_example(pkg: str, name: str, argv: list, monkeypatch) -> list:
    """Run an example in this process with ``argv``: the JAX package's
    ``examples/<name>.py`` as ``__main__`` (``pkg`` "ref") or the port's
    ``byteps_tpu_torch.examples.<name>``'s ``main()`` on the CPU ("port").
    Returns the lines it printed."""
    out = io.StringIO()
    if pkg == "ref":
        path = os.path.join(REPO, "examples", f"{name}.py")
        monkeypatch.setattr(sys, "argv", [path, *argv])
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    else:
        monkeypatch.setattr(sys, "argv", [name, *argv, "--device", "cpu"])
        with contextlib.redirect_stdout(out):
            importlib.import_module(f"byteps_tpu_torch.examples.{name}").main()
    return out.getvalue().splitlines()


def assert_lines_close(got: list, want: list, rtol: float) -> None:
    """The same lines, every number within ``rtol`` of the reference's plus
    one unit of its last printed digit, the words equal."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for mg, mw in zip(NUMBER.finditer(g), NUMBER.finditer(w)):
            a, b = float(mg.group()), float(mw.group())
            unit = 10.0 ** -len(mw.group(1) or "") if "e" not in mw.group() else 0.0
            assert abs(a - b) <= rtol * abs(b) + unit, (g, w)
