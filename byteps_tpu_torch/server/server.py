"""CPU parameter server (byteps/server/server.cc; SURVEY §2.3), on the wire
of ``byteps_tpu.server.server.PSServer``.

- one serve thread per connection feeds ``BYTEPS_SERVER_ENGINE_THREAD``
  engine threads; each key is pinned to the least-loaded engine thread at
  its first request (server.h:154-178), so its requests stay in order;
- INIT allocates the key and doubles as the cross-worker barrier: the
  replies go out when every worker's INIT arrived (server.cc:266-295);
- PUSH: the round's first arrival is copied (COPY_FIRST), later ones are
  summed (SUM_RECV); a compressed push is decompressed, then summed
  (server.cc:92-118).  When every worker pushed, the round is published and
  the pulls parked on it are answered (server.cc:296-375).  A push that
  repeats a (worker, version) already summed is acked without summing;
- PULL of round v is answered once the key's published round reaches v,
  raw or codec-compressed as the puller asks (``_KeyState.wire_payload``);
- REGISTER_COMPRESSOR builds the key's codec chain from its ``key=value``
  config (error feedback included, momentum skipped), or with flag bit 0
  sets the learning rate of every error-feedback chain.

Sums and codecs run in the port's C++ (``native.cpu_reducer``,
``compression/impl.py``), as the reference's Python server's do.
Each push's sum is observed as ``server_sum_seconds`` and the publish of
the round it closed as ``server_publish_seconds``; a server process logs
its pushes, rounds and those histograms when it stops
(:func:`stop_report`).  ``BYTEPS_SERVER_NATIVE=1`` serves the data plane
in C++ instead (``server/native.py``).  The planes of the reference's server that are not ported
(fusion, resync, migration, async and bounded staleness, the server-side
optimizer, row-sparse, multi-tenant QoS, lossless frames) are refused
loudly: the request's connection is closed, or its INIT is answered with a
non-zero status, and the reason goes to stderr.
"""

from __future__ import annotations

import json
import signal
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from byteps_tpu_torch.common.config import UNPORTED, Config, check_unported_env
from byteps_tpu_torch.common.registry import JOB_SHIFT
from byteps_tpu_torch.common.types import (
    DataType,
    RequestType,
    decode_command_type,
    storage_numpy_dtype,
)
from byteps_tpu_torch.comm.rendezvous import GROUP_ALL, RESIZE_SEQ, Scheduler
from byteps_tpu_torch.comm.transport import (
    UNPORTED_OPS,
    ChecksumError,
    Message,
    Op,
    UnsupportedFrameError,
    close_socket,
    connect,
    recv_message,
    send_message,
)
from byteps_tpu_torch.comm.van import get_van
from byteps_tpu_torch.core.telemetry import Counters, _state_percentile, metrics
from byteps_tpu_torch.native import cpu_reducer

#: the histograms a server's stop report summarizes
SERVER_HISTOGRAMS = ("server_sum_seconds", "server_publish_seconds")


def _log(msg: str) -> None:
    print(f"byteps_tpu_torch server: {msg}", file=sys.stderr, flush=True)


class _KeyState:
    __slots__ = (
        "store", "accum", "dtype_id", "recv_count", "store_version",
        "pending_pulls", "init_waiters", "push_seen", "compressor",
        "pull_payload", "pull_version", "raw_payload", "raw_version", "lock",
    )

    def __init__(self) -> None:
        self.store: Optional[np.ndarray] = None
        self.accum: Optional[np.ndarray] = None
        self.dtype_id = 0
        self.recv_count = 0
        self.store_version = 0
        #: parked pulls: (version, conn, send_lock, seq, wants_compressed)
        self.pending_pulls: List[tuple] = []
        #: (worker_flag, conn, send_lock, seq)
        self.init_waiters: List[tuple] = []
        #: worker flag -> newest summed push version (exactly-once sums)
        self.push_seen: Dict[int, int] = {}
        self.compressor = None
        self.pull_payload: Optional[bytes] = None
        self.pull_version = -1
        self.raw_payload: Optional[bytes] = None
        self.raw_version = -1
        self.lock = threading.Lock()

    def wire_payload(self, compressed: bool) -> bytes:
        """What a puller of the published round receives, in the format it
        asked for: the codec-compressed merged result or the raw bytes,
        each built once per round and served to every puller."""
        if compressed:
            if self.pull_version != self.store_version:
                self.pull_payload = self.compressor.compress(self.store)
                self.pull_version = self.store_version
            return self.pull_payload
        if self.raw_version != self.store_version:
            self.raw_payload = self.store.tobytes()
            self.raw_version = self.store_version
        return self.raw_payload


class _EngineQueue:
    """FIFO of one engine thread."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._items: List[tuple] = []

    def put(self, item: tuple) -> None:
        with self._cv:
            self._items.append(item)
            self._cv.notify()

    def get(self, timeout: float):
        with self._cv:
            self._cv.wait_for(lambda: self._items, timeout)
            return self._items.pop(0) if self._items else None


class PSServer:
    def __init__(self, cfg: Config, host: str = "127.0.0.1") -> None:
        import uuid

        check_unported_env()
        self.cfg = cfg
        self._sock, self.host, self.port = get_van().listen(host)
        self._keys: Dict[int, _KeyState] = {}
        self._keys_lock = threading.Lock()
        self._stop = threading.Event()
        nthreads = max(1, cfg.server_engine_threads)
        self._queues = [_EngineQueue() for _ in range(nthreads)]
        self._tid_cache: Dict[int, int] = {}
        self._tid_load = [0] * nthreads
        self._tid_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self.rank: Optional[int] = None
        self.num_workers = cfg.num_worker
        self._sched_conn: Optional[socket.socket] = None
        self.node_uid = uuid.uuid4().hex
        #: set when the server stopped for a reason a user must see
        self.error: Optional[str] = None
        #: the learning rate of error-feedback chains (REGISTER_COMPRESSOR
        #: with flag bit 0); chains registered later start with it
        self._ef_lr = 1.0
        #: ``pushes_summed`` (worker pushes merged into a round) and
        #: ``rounds_published``, logged when the process stops
        self.stats = Counters()

    # --- lifecycle -------------------------------------------------------

    def start(self, register: bool = True) -> None:
        for i, q in enumerate(self._queues):
            self._spawn(self._engine_loop, (q,), f"ps-engine-{i}")
        self._spawn(self._accept_loop, (), "ps-accept")
        if register:
            try:
                self._register_with_scheduler()
            except (ConnectionError, OSError):
                if not self._stop.is_set():
                    raise  # stopped during bring-up: nothing to report

    def _spawn(self, target, args, name) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def pushes_and_rounds(self) -> tuple:
        counts = self.stats.snapshot()
        return counts.get("pushes_summed", 0), counts.get("rounds_published", 0)

    def histograms(self) -> Dict[str, dict]:
        """The summed pushes' and published rounds' histograms, from the
        process's registry."""
        hists = metrics().snapshot()["histograms"]
        return {name: hists[name] for name in SERVER_HISTOGRAMS if name in hists}

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            close_socket(conn)
        close_socket(self._sched_conn)

    def _register_with_scheduler(self) -> None:
        """REGISTER, adopt the book, and pass the bring-up barrier
        (ps::StartPS, server.cc:500-509)."""
        conn = connect(self.cfg.ps_root_uri, self.cfg.ps_root_port)
        send_message(conn, Message(Op.REGISTER, payload=json.dumps({
            "role": "server", "host": self.host, "port": self.port,
            "uid": self.node_uid,
        }).encode()))
        resp = recv_message(conn)
        if resp.status != 0:
            err = json.loads(resp.payload.decode()).get("error", "register refused")
            raise RuntimeError(f"scheduler refused registration: {err}")
        book = json.loads(resp.payload.decode())
        self._sched_conn = conn
        self.rank = book["rank"]
        self.num_workers = book["num_workers"]
        send_message(conn, Message(Op.BARRIER, flags=GROUP_ALL))
        recv_message(conn)
        self._spawn(self._control_loop, (conn,), "ps-control")

    def _control_loop(self, conn) -> None:
        """Unsolicited control messages: a resize book cannot be followed
        (elastic membership is not ported), so the server stops and says
        why; SHUTDOWN stops it."""
        try:
            while not self._stop.is_set():
                msg = recv_message(conn)
                if msg.op == Op.ADDRBOOK and msg.seq == RESIZE_SEQ:
                    self._fail_stop(f"the scheduler resized the cluster: "
                                    f"{UNPORTED['elastic']}")
                    return
                if msg.op == Op.SHUTDOWN:
                    self.stop()
                    return
        except (ConnectionError, OSError, ValueError):
            return

    def _fail_stop(self, reason: str) -> None:
        self.error = reason
        _log(f"rank {self.rank} stops: {reason}")
        self.stop()

    # --- serve plane -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            self._spawn(self._serve_conn, (conn,), "ps-serve")

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                msg = recv_message(conn)
                if msg.op in (Op.PUSH, Op.PULL, Op.INIT):
                    self._enqueue(msg, conn, send_lock)
                elif msg.op == Op.REGISTER_COMPRESSOR:
                    self._handle_register_compressor(msg, conn, send_lock)
                elif msg.op == Op.PING:
                    send_message(conn, Message(Op.PING, seq=msg.seq), send_lock)
                elif msg.op == Op.SHUTDOWN:
                    send_message(conn, Message(Op.SHUTDOWN, seq=msg.seq), send_lock)
                    return
                elif msg.op in UNPORTED_OPS:
                    raise UnsupportedFrameError(
                        f"{msg.op.name} request: {UNPORTED[UNPORTED_OPS[msg.op]]}"
                    )
                else:
                    raise UnsupportedFrameError(f"unexpected {msg.op.name} request")
        except (ChecksumError, UnsupportedFrameError) as e:
            # the reference drops a corrupt frame and lets the worker's
            # retry heal it; the port's workers do not retry, so the
            # connection goes, and with it the worker's pending requests
            _log(f"closing a worker connection: {e}")
        except (ConnectionError, OSError):
            pass
        finally:
            close_socket(conn)
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle_register_compressor(self, msg: Message, conn, send_lock) -> None:
        """A key's codec chain from its ``key=value`` config (momentum
        skipped, compressor_registry.cc:44), or with flag bit 0 the learning
        rate of every error-feedback chain: a big-endian f64, applied to the
        chains there are and kept for chains registered later
        (``byteps_tpu/server/server.py:1829-1845``).  An lr frame of another
        size is acked and ignored, as the reference's engines do."""
        from byteps_tpu_torch.compression.registry import apply_lr_to_chain, create_compressor

        if msg.flags & 1:
            if len(msg.payload) == 8:
                (self._ef_lr,) = struct.unpack("!d", msg.payload)
                with self._keys_lock:
                    states = list(self._keys.values())
                for ks in states:
                    with ks.lock:
                        apply_lr_to_chain(ks.compressor, self._ef_lr)
                _log(f"error-feedback lr {self._ef_lr!r} applied to the chains of "
                     f"{sum(ks.compressor is not None for ks in states)} keys; chains "
                     "registered later start with it")
            send_message(conn, Message(Op.REGISTER_COMPRESSOR, seq=msg.seq), send_lock)
            return
        kwargs = dict(
            ln.split("=", 1) for ln in msg.payload.decode().splitlines() if "=" in ln
        )
        ks = self._key_state(msg.key)
        with ks.lock:
            size = ks.store.size if ks.store is not None else 0
            try:
                ks.compressor = create_compressor(kwargs, size, server=True)
            except ValueError as e:
                raise UnsupportedFrameError(f"key {msg.key}: {e}") from None
            apply_lr_to_chain(ks.compressor, self._ef_lr)
        send_message(conn, Message(Op.REGISTER_COMPRESSOR, seq=msg.seq), send_lock)

    def _key_state(self, key: int) -> _KeyState:
        with self._keys_lock:
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState()
            return ks

    def _enqueue(self, msg: Message, conn, send_lock) -> None:
        with self._tid_lock:
            tid = self._tid_cache.get(msg.key)
            if tid is None:
                tid = self._tid_cache[msg.key] = int(np.argmin(self._tid_load))
            self._tid_load[tid] += len(msg.payload)
        self._queues[tid].put((msg, conn, send_lock))

    # --- engine plane ----------------------------------------------------

    def _engine_loop(self, q: _EngineQueue) -> None:
        while not self._stop.is_set():
            item = q.get(timeout=0.2)
            if item is None:
                continue
            msg, conn, send_lock = item
            try:
                if msg.op == Op.INIT:
                    self._handle_init(msg, conn, send_lock)
                elif msg.op == Op.PUSH:
                    self._handle_push(msg, conn, send_lock)
                else:
                    self._handle_pull(msg, conn, send_lock)
            except (ConnectionError, OSError):
                continue
            except Exception as e:  # noqa: BLE001 - the engine thread serves every key pinned to it
                # a malformed or unsupported request: drop its connection
                # so the worker errors out instead of waiting on a reply
                _log(f"dropping a connection after {msg.op.name} key={msg.key}: {e!r}")
                close_socket(conn)

    def _handle_init(self, msg: Message, conn, send_lock) -> None:
        """Allocate the key and hold the INIT until every worker's arrived.
        Payload: u64 elements + u32 dtype (network order).  A longer
        payload declares the async or server-optimizer profile, and a key
        with job bits a tenant namespace: the port refuses them with
        status 1, as the reference's C++ engine does."""
        n, dtype_id = struct.unpack_from("!QI", msg.payload, 0)
        refuse = None
        if len(msg.payload) > 12:
            refuse = "an async or server-optimizer profile (" + UNPORTED["async"] + ")"
        elif msg.key >> JOB_SHIFT:
            refuse = "a job-namespaced key (" + UNPORTED["tenancy"] + ")"
        if refuse is not None:
            _log(f"refusing INIT of key {msg.key}: {refuse}")
            send_message(conn, Message(Op.INIT, key=msg.key, seq=msg.seq, status=1),
                         send_lock)
            return
        ks = self._key_state(msg.key)
        with ks.lock:
            if ks.store is None:
                dt = storage_numpy_dtype(DataType(dtype_id))
                ks.dtype_id = dtype_id
                ks.store = np.zeros(n, dtype=dt)
                ks.accum = np.zeros(n, dtype=dt)
            wid = msg.flags
            entry = (wid, conn, send_lock, msg.seq)
            # a replayed INIT of one worker replaces its waiter
            for i, w in enumerate(ks.init_waiters):
                if wid and w[0] == wid:
                    ks.init_waiters[i] = entry
                    break
            else:
                ks.init_waiters.append(entry)
            if len(ks.init_waiters) < self.num_workers:
                return
            waiters, ks.init_waiters = ks.init_waiters, []
            # a completed barrier restarts the key's rounds: every worker
            # re-inits and counts versions from 1 again (store contents stay)
            ks.store_version = 0
            ks.recv_count = 0
            ks.pending_pulls = []
            ks.push_seen = {}
            ks.pull_payload = ks.raw_payload = None
            ks.pull_version = ks.raw_version = -1
        for _, wconn, wlock, wseq in waiters:
            try:
                send_message(wconn, Message(Op.INIT, key=msg.key, seq=wseq), wlock)
            except (ConnectionError, OSError):
                continue

    def _handle_push(self, msg: Message, conn, send_lock) -> None:
        t_start = time.time()
        published = 0.0
        rtype, dtype_id = decode_command_type(msg.cmd)
        if rtype == RequestType.ROW_SPARSE_PUSH_PULL:
            raise NotImplementedError(f"row-sparse push: {UNPORTED['rowsparse']}")
        ks = self._key_state(msg.key)
        flush: List[tuple] = []
        with ks.lock:
            if ks.store is None:
                raise RuntimeError(f"push for uninitialized key {msg.key}")
            compressed = rtype == RequestType.COMPRESSED_PUSH_PULL
            if compressed and ks.compressor is None:
                raise RuntimeError(f"compressed push for key {msg.key}, which has "
                                   "no registered compressor")
            wid = msg.flags
            if wid and msg.version > 0 and msg.version <= ks.push_seen.get(wid, 0):
                pass  # a replay of a push already summed: ack only
            else:
                if compressed:
                    if ks.recv_count == 0:
                        ks.accum[:] = ks.compressor.decompress(msg.payload, ks.accum.size)
                    else:
                        ks.compressor.sum_into(msg.payload, ks.accum)
                else:
                    arr = np.frombuffer(msg.payload, dtype=ks.store.dtype)
                    if ks.recv_count == 0:
                        ks.accum[: len(arr)] = arr  # COPY_FIRST
                    else:
                        cpu_reducer.sum_into(ks.accum, arr, ks.dtype_id)  # SUM_RECV
                ks.recv_count += 1
                self.stats.bump("pushes_summed")
                if wid and msg.version > 0:
                    ks.push_seen[wid] = msg.version
                if ks.recv_count >= self.num_workers:
                    p0 = time.time()
                    flush = self._publish_round_locked(ks)
                    published = time.time() - p0
        # the push's sum, less the publish of the round it closed
        metrics().observe("server_sum_seconds", max(0.0, time.time() - t_start - published))
        if published:
            metrics().observe("server_publish_seconds", published)
        send_message(conn, Message(Op.PUSH, key=msg.key, seq=msg.seq,
                                   version=msg.version), send_lock)
        self._flush_pulls(msg.key, flush)

    def _publish_round_locked(self, ks: _KeyState) -> List[tuple]:
        """Every worker pushed: publish the round and collect the pulls it
        answers (server.cc:348-375).  Caller holds ``ks.lock``; the
        payloads are built under it, before a next round can swap the
        buffers."""
        ks.store, ks.accum = ks.accum, ks.store
        ks.store_version += 1
        self.stats.bump("rounds_published")
        ks.recv_count = 0
        flush, keep = [], []
        for p in ks.pending_pulls:
            (flush if p[0] <= ks.store_version else keep).append(p)
        ks.pending_pulls = keep
        return [(pconn, plock, pseq, ks.wire_payload(wants), ks.store_version)
                for _, pconn, plock, pseq, wants in flush]

    def _flush_pulls(self, key: int, flush: List[tuple]) -> None:
        for pconn, plock, pseq, payload, ver in flush:
            try:
                send_message(pconn, Message(Op.PULL, key=key, payload=payload,
                                            seq=pseq, version=ver), plock)
            except (ConnectionError, OSError):
                continue

    def _handle_pull(self, msg: Message, conn, send_lock) -> None:
        rtype, _ = decode_command_type(msg.cmd)
        if rtype == RequestType.ROW_SPARSE_PUSH_PULL:
            raise NotImplementedError(f"row-sparse pull: {UNPORTED['rowsparse']}")
        wants = rtype == RequestType.COMPRESSED_PUSH_PULL
        ks = self._key_state(msg.key)
        with ks.lock:
            if ks.store is None:
                raise RuntimeError(f"pull for uninitialized key {msg.key}")
            if wants and ks.compressor is None:
                raise RuntimeError(f"compressed pull for key {msg.key}, which has "
                                   "no registered compressor")
            if msg.version > ks.store_version:
                ks.pending_pulls.append((msg.version, conn, send_lock, msg.seq, wants))
                return
            payload = ks.wire_payload(wants)
            ver = ks.store_version
        send_message(conn, Message(Op.PULL, key=msg.key, payload=payload,
                                   seq=msg.seq, version=ver), send_lock)


def summarize_histograms(recs_by_name: Dict[str, list]) -> Dict[str, dict]:
    """Provider records (``core/telemetry.py``) merged over their labels,
    one summary per name: count, sum, p50, p99."""
    out = {}
    for name, recs in recs_by_name.items():
        if not recs:
            continue
        bounds = tuple(recs[0]["le"])
        counts = [0] * (len(bounds) + 1)
        vsum, count = 0.0, 0
        for r in recs:
            counts = [a + int(b) for a, b in zip(counts, r["b"])]
            vsum += float(r["sum"])
            count += int(r["count"])
        out[name] = {"count": count, "sum": vsum,
                     "p50": _state_percentile(bounds, counts, 0.50),
                     "p99": _state_percentile(bounds, counts, 0.99)}
    return out


def stop_report(node) -> List[str]:
    """A stopped server's two log lines: the pushes it summed into rounds,
    and each histogram's count, sum, p50 and p99 (seconds)."""
    pushes, rounds = node.pushes_and_rounds()
    hists = node.histograms()
    return [
        f"rank {node.rank} summed {pushes} pushes into {rounds} rounds",
        f"rank {node.rank} histograms " + ("; ".join(
            f"{name} count={h['count']} sum={h['sum']:.6f} p50={h['p50']:.6g} "
            f"p99={h['p99']:.6g}" for name, h in hists.items()) or "none"),
    ]


def _serve_until_signaled(node) -> None:
    """Park the main thread until SIGTERM or SIGINT, then stop the node (a
    server logs its :func:`stop_report`)."""
    done = threading.Event()

    def _graceful(_signum, _frame):
        node.stop()
        if hasattr(node, "pushes_and_rounds"):
            for line in stop_report(node):
                _log(line)
        done.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)
    while not done.wait(0.5):
        if getattr(node, "error", None):
            sys.exit(1)


def run_server() -> None:
    """Process entry: become the scheduler or a server per DMLC_ROLE."""
    cfg = Config.from_env()
    check_unported_env()
    if cfg.role == "scheduler":
        node = Scheduler(cfg.num_worker, cfg.num_server, port=cfg.ps_root_port)
        node.start()
        # with DMLC_PS_ROOT_PORT=0 the port is the kernel's choice: a
        # launcher reads it here
        print(f"BYTEPS_SCHEDULER_PORT={node.port}", flush=True)
    elif cfg.role == "server":
        if cfg.server_native:
            from byteps_tpu_torch.server.native import NativePSServer

            node = NativePSServer(cfg, host=cfg.node_host or "127.0.0.1")
        else:
            node = PSServer(cfg, host=cfg.node_host or "127.0.0.1")
        node.start()
    else:
        raise SystemExit(f"run_server: unsupported role {cfg.role!r}")
    _serve_until_signaled(node)
