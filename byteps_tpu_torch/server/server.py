"""CPU parameter server (byteps/server/server.cc; SURVEY §2.3), on the wire
of ``byteps_tpu.server.server.PSServer``.

- one serve thread per connection feeds ``BYTEPS_SERVER_ENGINE_THREAD``
  engine threads; each key is pinned to the least-loaded engine thread at
  its first request (server.h:154-178), so its requests stay in order;
- INIT allocates the key and doubles as the cross-worker barrier: the
  replies go out when every worker's INIT arrived (server.cc:266-295).  Its
  profile extension declares the key async (with a staleness bound) or
  gives it a server-side update rule (``server/update_rules.py``);
- PUSH: the round's first arrival is copied (COPY_FIRST), later ones are
  summed (SUM_RECV); a compressed push is decompressed, then summed
  (server.cc:92-118).  When every worker pushed, the round is published and
  the pulls parked on it are answered (server.cc:296-375); a key with an
  update rule publishes parameters instead: its seed round adopts the
  first push as it is, and every later round applies the rule once to the
  raw sum.  A push that repeats a (worker, version) already summed is
  acked without summing;
- async keys (the INIT profile, or ``BYTEPS_ENABLE_ASYNC`` for the whole
  server) apply each push at once to a cumulative store, and a pull is
  answered from it when every worker's applied push is within the key's
  staleness bound of the pull's round, else parked until a peer's push
  opens the bound;
- PULL of round v is answered once the key's published round reaches v,
  raw or codec-compressed as the puller asks (``_KeyState.wire_payload``);
- FUSED: a multi-key frame of small pushes, each member through the same
  path as a PUSH, answered with one multi-key reply once every member's
  round is published (``_FusedReply``);
- REGISTER_COMPRESSOR builds the key's codec chain from its ``key=value``
  config (error feedback included, momentum skipped), or with flag bit 0
  sets the learning rate of every error-feedback chain;
- RESYNC_QUERY (the recovery plane) is answered from the replay ledger:
  per key, the store's version, the newest version of the asking
  worker's pushes summed (``seen``), the round's pushes so far, so that a
  worker that gave up on this server replays exactly the rounds it lost.
  A replayed INIT whose barrier already released (its ack was lost) is
  acked from the barrier's token record (``init_replay_ack``); a replayed
  push is acked without a sum (``push_dedup``).  A frame that fails its
  CRC32C is dropped without a reply (``wire_checksum_fail``), so the
  worker's deadline sends it again; ``BYTEPS_CHECKSUM_CONN_LIMIT`` of
  them close the connection.

The control half follows the job's membership (docs/elasticity.md,
docs/robustness.md): the server heartbeats to the scheduler; a resize or
eviction book sets its worker count (an init barrier or a round that now
holds enough arrivals completes at once) and its zombie fence (a push from
a worker rank the book does not list is refused, its connection dropped);
SHUTDOWN from a scale-down stops it; books of an older scheduler
incarnation are refused; a lost scheduler link is redialed with bounded
backoff while the data plane serves on.

Sums and codecs run in the port's C++ (``native.cpu_reducer``,
``compression/impl.py``), as the reference's Python server's do.
Each push's sum is observed as ``server_sum_seconds`` and the publish of
the round it closed as ``server_publish_seconds``; a server process logs
its pushes, rounds, parked pulls and those histograms when it stops
(:func:`stop_report`).  ``BYTEPS_SERVER_NATIVE=1`` serves the data plane
in C++ instead (``server/native.py``).  The planes of the reference's
server that are not ported (migration, row-sparse, multi-tenant job
namespaces, lossless frames) are refused loudly: the request's
connection is closed, or its INIT is answered with a non-zero status, and
the reason goes to stderr.
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

from byteps_tpu_torch.common.config import (
    UNPORTED,
    Config,
    check_unported_env,
    resolve_node_uid,
)
from byteps_tpu_torch.common.registry import JOB_SHIFT
from byteps_tpu_torch.common.types import (
    DataType,
    RequestType,
    decode_command_type,
    storage_numpy_dtype,
)
from byteps_tpu_torch.comm.rendezvous import GROUP_ALL, RESIZE_SEQ, Scheduler
from byteps_tpu_torch.comm.transport import (
    PROFILE_ASYNC,
    PROFILE_SERVER_OPT,
    RULE_BLOCK_OFFSET,
    UNPORTED_OPS,
    ChecksumError,
    Message,
    Op,
    UnsupportedFrameError,
    close_socket,
    decode_fused_push,
    decode_init_profile,
    decode_resync_query,
    decode_server_opt_block,
    encode_fused_reply,
    encode_resync_state,
    recv_message,
    send_message,
)
from byteps_tpu_torch.comm.van import get_van
from byteps_tpu_torch.core.telemetry import Counters, _state_percentile, counters, metrics
from byteps_tpu_torch.native import cpu_reducer
from byteps_tpu_torch.server import update_rules

#: the histograms a server's stop report summarizes
SERVER_HISTOGRAMS = ("server_sum_seconds", "server_publish_seconds")


def _log(msg: str) -> None:
    print(f"byteps_tpu_torch server: {msg}", file=sys.stderr, flush=True)


class _KeyState:
    __slots__ = (
        "store", "accum", "dtype_id", "recv_count", "store_version",
        "pending_pulls", "fused_waiters", "init_waiters", "init_done", "push_seen",
        "compressor",
        "pull_payload", "pull_version", "raw_payload", "raw_version",
        "async_mode", "staleness", "opt_rule", "opt_step", "opt_seeded", "lock",
    )

    def __init__(self) -> None:
        self.store: Optional[np.ndarray] = None
        self.accum: Optional[np.ndarray] = None
        self.dtype_id = 0
        self.recv_count = 0
        self.store_version = 0
        #: parked pulls: (version, conn, send_lock, seq, wants_compressed)
        self.pending_pulls: List[tuple] = []
        #: parked halves of fused frames: (version, _FusedReply, slot,
        #: wants_compressed), filled when their round publishes
        self.fused_waiters: List[tuple] = []
        #: (worker_flag, conn, send_lock, seq, init token)
        self.init_waiters: List[tuple] = []
        #: worker flag -> the init token of the last barrier it completed
        self.init_done: Dict[int, int] = {}
        #: worker flag -> newest summed push version (exactly-once sums)
        self.push_seen: Dict[int, int] = {}
        self.compressor = None
        self.pull_payload: Optional[bytes] = None
        self.pull_version = -1
        self.raw_payload: Optional[bytes] = None
        self.raw_version = -1
        #: the INIT profile: async (pushes applied at once, pulls gated by
        #: the staleness bound, -1 unbounded) ...
        self.async_mode = False
        self.staleness = -1
        #: ... and the server-side update rule, with its completed rounds
        #: (0: the seed round has not published) and, under async, the
        #: workers whose seed push was taken
        self.opt_rule: Optional[update_rules.UpdateRule] = None
        self.opt_step = 0
        self.opt_seeded: set = set()
        self.lock = threading.Lock()

    def wire_payload(self, compressed: bool, async_mode: bool = False) -> bytes:
        """What a puller receives, in the format it asked for: the
        codec-compressed store or its raw bytes, each built once per round
        and served to every puller.  An async store changes with every
        push, so both formats are built on demand."""
        if compressed:
            if async_mode:
                return self.compressor.compress(self.store)
            if self.pull_version != self.store_version:
                self.pull_payload = self.compressor.compress(self.store)
                self.pull_version = self.store_version
            return self.pull_payload
        if async_mode:
            return self.store.tobytes()
        if self.raw_version != self.store_version:
            self.raw_payload = self.store.tobytes()
            self.raw_version = self.store_version
        return self.raw_payload

    def clear_rule(self) -> None:
        self.opt_rule = None
        self.opt_step = 0
        self.opt_seeded = set()


class _FusedReply:
    """The multi-key reply of one FUSED frame.  Its members' rounds
    complete independently, possibly on other engine threads; each fills
    its slot, and the fill that completes the frame (exactly one) makes it
    sendable, as one frame on the request's seq."""

    __slots__ = ("conn", "send_lock", "seq", "route_key", "keys", "slots",
                 "versions", "remaining", "lock")

    def __init__(self, conn, send_lock, seq: int, route_key: int, keys: List[int]) -> None:
        self.conn = conn
        self.send_lock = send_lock
        self.seq = seq
        self.route_key = route_key
        self.keys = keys
        self.slots: List[Optional[bytes]] = [None] * len(keys)
        self.versions = [0] * len(keys)
        self.remaining = len(keys)
        self.lock = threading.Lock()

    def fill(self, slot: int, payload: bytes, version: int) -> bool:
        """Record one member's payload; True once, when it completed the
        frame."""
        with self.lock:
            if self.slots[slot] is not None:
                return False
            self.slots[slot] = payload
            self.versions[slot] = version
            self.remaining -= 1
            return self.remaining == 0

    def send(self) -> None:
        body = encode_fused_reply(list(zip(self.keys, self.versions, self.slots)))
        send_message(self.conn, Message(Op.FUSED, key=self.route_key, seq=self.seq,
                                        payload=body), self.send_lock)


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
        self.node_uid = resolve_node_uid()
        #: the zombie fence: worker flags (rank + 1) the last book lists as
        #: live (None: no book with ranks yet, the fence is off)
        self._live_worker_flags: Optional[set] = None
        #: the newest scheduler incarnation and epochs seen in a book, and
        #: whether the scheduler ordered this server to stop
        self.sched_incarnation = 0
        self.membership_epoch = 0
        self._map_epoch = 0
        self._sched_shutdown = False
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
        close_socket(self._sock)  # shutdown wakes the accept loop
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            close_socket(conn)
        close_socket(self._sched_conn)

    def _register_with_scheduler(self) -> None:
        """REGISTER, adopt the book, and pass the bring-up barrier
        (ps::StartPS, server.cc:500-509); then one thread owns the
        scheduler link: heartbeats, books and SHUTDOWN."""
        conn = self._sched_register_once(initial=True)
        metrics().gauge_set("control_plane_degraded", 0)
        send_message(conn, Message(Op.BARRIER, flags=GROUP_ALL))
        recv_message(conn)
        self._spawn(self._control_plane_loop, (conn,), "ps-control")

    def _sched_register_once(self, initial: bool = True):
        """Dial the scheduler, REGISTER and adopt the book; returns the
        socket.  A rejoin (``initial=False``) reports the last rank and both
        epochs, and that the runtime is live (no barrier follows)."""
        from byteps_tpu_torch.comm.transport import connect_control

        conn = connect_control(self.cfg.ps_root_uri, self.cfg.ps_root_port)
        try:
            payload = {"role": "server", "host": self.host, "port": self.port,
                       "uid": self.node_uid}
            if not initial:
                payload.update({"last_rank": self.rank, "epoch": self.membership_epoch,
                                "map_epoch": self._map_epoch, "reconnect": True})
            send_message(conn, Message(Op.REGISTER, payload=json.dumps(payload).encode()))
            resp = recv_message(conn)
            if resp.status != 0:
                err = json.loads(resp.payload.decode()).get("error", "register refused")
                raise RuntimeError(f"scheduler refused registration: {err}")
            book = json.loads(resp.payload.decode())
            if not self._fence_book(book):
                raise ConnectionError("book from a stale scheduler incarnation")
        except BaseException:
            close_socket(conn)
            raise
        if self._sched_conn is not None and self._sched_conn is not conn:
            close_socket(self._sched_conn)
        self._sched_conn = conn
        self.rank = book["rank"]
        if initial:
            self.num_workers = book["num_workers"]
        else:
            # a rejoin: a changed worker count completes rounds and
            # barriers as a resize book does
            self.update_num_workers(book["num_workers"])
        self._adopt_worker_ranks(book)
        self._note_book(book)
        return conn

    def _fence_book(self, book: dict) -> bool:
        """The incarnation fence: refuse a book of an older scheduler
        incarnation than one acted on (``sched_stale_book``); adopt a newer
        one.  A book with no stamp passes."""
        inc = int(book.get("sched_incarnation", 0) or 0)
        if inc and self.sched_incarnation and inc < self.sched_incarnation:
            counters().bump("sched_stale_book")
            return False
        self.sched_incarnation = max(self.sched_incarnation, inc)
        return True

    def _note_book(self, book: dict) -> None:
        """Track the newest membership and map epochs, reported back on a
        rejoin so that a restarted scheduler fences above them."""
        epoch = book.get("epoch")
        if epoch is not None and int(epoch) > self.membership_epoch:
            self.membership_epoch = int(epoch)
        me = book.get("map_epoch")
        if me is not None and int(me) >= self._map_epoch:
            self._map_epoch = int(me)

    def _adopt_worker_ranks(self, book: dict) -> None:
        """The zombie fence from a book's live worker ranks; a book with no
        rank list turns it off."""
        ranks = book.get("worker_ranks")
        self._live_worker_flags = ({r + 1 for r in ranks if 0 <= r < 255}
                                   if ranks is not None else None)

    def _handle_control(self, conn, msg: Message) -> None:
        """One unsolicited control frame: a RESIZE_SEQ book (fenced, then
        the worker count and the live ranks adopted), or SHUTDOWN (a
        scale-down dropped this server: it stops).  PING replies are
        drained."""
        if msg.op == Op.ADDRBOOK and msg.seq == RESIZE_SEQ:
            book = json.loads(msg.payload.decode())
            if not self._fence_book(book):
                return
            self._note_book(book)
            self.update_num_workers(book["num_workers"])
            self._adopt_worker_ranks(book)
            return
        if msg.op == Op.SHUTDOWN:
            self._sched_shutdown = True  # a deliberate exit, not a lost link
            threading.Thread(target=self.stop, daemon=True).start()
            raise ConnectionError("the scheduler requested shutdown")

    def _control_plane_loop(self, conn) -> None:
        """Heartbeats (with ``BYTEPS_HEARTBEAT_INTERVAL`` > 0) and the
        scheduler's control frames on one thread: select() waits for a
        frame between beats, so a book applies within 0.3 s.  A lost link
        goes to :meth:`_sched_reconnect`; the data plane serves on."""
        import select

        hb = self.cfg.heartbeat_interval
        while not self._stop.is_set():
            next_beat = time.monotonic() + hb if hb > 0 else None
            try:
                while not self._stop.is_set():
                    now = time.monotonic()
                    if next_beat is not None and now >= next_beat:
                        send_message(conn, Message(Op.PING))
                        next_beat = now + hb
                    readable, _, _ = select.select([conn], [], [], 0.3)
                    if readable:
                        self._handle_control(conn, recv_message(conn))
            except (ConnectionError, OSError, ValueError):
                if self._stop.is_set() or self._sched_shutdown:
                    return
                conn = self._sched_reconnect()
                if conn is None:
                    return

    def _sched_reconnect(self):
        """Redial and re-REGISTER with bounded backoff
        (``BYTEPS_SCHED_RECONNECT_RETRIES``, ``_BACKOFF_S``); the new
        socket, or None once the budget is spent (the data plane serves
        on with the last book)."""
        from byteps_tpu_torch.comm.retry import Backoff

        metrics().gauge_set("control_plane_degraded", 1)
        if self.cfg.sched_reconnect_retries <= 0:
            return None
        backoff = Backoff(base=max(0.05, self.cfg.sched_reconnect_backoff_s), cap=10.0)
        for _ in range(self.cfg.sched_reconnect_retries):
            if self._stop.is_set():
                return None
            counters().bump("sched_reconnect")
            try:
                conn = self._sched_register_once(initial=False)
            except (ConnectionError, OSError, RuntimeError, ValueError):
                if self._stop.wait(backoff.next_delay()):
                    return None
                continue
            counters().bump("sched_rejoin")
            metrics().gauge_set("control_plane_degraded", 0)
            return conn
        _log(f"rank {self.rank}: the scheduler reconnect gave up after "
             f"{self.cfg.sched_reconnect_retries} attempts; serving on with the last book")
        return None

    def update_num_workers(self, n: int) -> None:
        """Adopt a resized worker count.  An init barrier or a round that
        already holds ``n`` arrivals completes now: on a scale-down the
        departed workers' INITs and pushes never come."""
        self.num_workers = n
        with self._keys_lock:
            items = list(self._keys.items())
        for key, ks in items:
            with ks.lock:
                waiters = self._complete_init_barrier_locked(ks)
            if waiters:
                self._release_init_waiters(key, waiters)
        for key, ks in items:
            flush: List = []
            with ks.lock:
                if ks.store is None:
                    pass
                elif self._async_ks(ks):
                    # the departed worker no longer holds the bound back
                    flush = self._drain_waiters_locked(
                        ks, lambda v, _ks=ks: self._staleness_ready_locked(_ks, v),
                        async_mode=True)
                elif 0 < self.num_workers <= ks.recv_count:
                    flush = self._publish_round_locked(ks)
            self._flush_pulls(key, flush)

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
                try:
                    msg = recv_message(conn)
                except ChecksumError as e:
                    # the connection goes, which fails the worker's pending
                    # requests into its retry path at once: a request
                    # dropped unanswered would wait for a deadline the
                    # worker may not arm
                    counters().bump("wire_checksum_fail", labels={
                        "side": "server", "op": getattr(e.op, "name", str(e.op))})
                    counters().bump("wire_checksum_conn_drop")
                    raise
                if msg.op in (Op.PUSH, Op.PULL, Op.INIT, Op.FUSED, Op.RESYNC_QUERY):
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

    _HANDLERS = {Op.INIT: "_handle_init", Op.PUSH: "_handle_push", Op.PULL: "_handle_pull",
                 Op.FUSED: "_handle_fused", Op.RESYNC_QUERY: "_handle_resync"}

    def _engine_loop(self, q: _EngineQueue) -> None:
        while not self._stop.is_set():
            item = q.get(timeout=0.2)
            if item is None:
                continue
            msg, conn, send_lock = item
            try:
                getattr(self, self._HANDLERS[msg.op])(msg, conn, send_lock)
            except (ConnectionError, OSError):
                continue
            except Exception as e:  # noqa: BLE001 - the engine thread serves every key pinned to it
                # a malformed or unsupported request: drop its connection
                # so the worker errors out instead of waiting on a reply
                _log(f"dropping a connection after {msg.op.name} key={msg.key}: {e!r}")
                close_socket(conn)

    def _handle_init(self, msg: Message, conn, send_lock) -> None:
        """Allocate the key and hold the INIT until every worker's arrived.
        Payload: u64 elements + u32 dtype (network order), and optionally
        the profile extension (``transport.encode_init``): async with its
        staleness bound, and a server-side update rule.  Every INIT sets
        the key's profile, so a re-init without the extension returns it to
        summing.  A rule this server cannot run (unknown, a non-floating
        store, a malformed block) and a key with job bits (a tenant
        namespace, not ported) are refused with status 1."""
        n, dtype_id = struct.unpack_from("!QI", msg.payload, 0)
        profile, staleness = decode_init_profile(msg.payload)
        rule = None
        if msg.key >> JOB_SHIFT:
            why = "a job-namespaced key (" + UNPORTED["tenancy"] + ")"
            _log(f"refusing INIT of key {msg.key}: {why}")
            send_message(conn, Message(Op.INIT, key=msg.key, seq=msg.seq, status=1),
                         send_lock)
            return
        if profile & PROFILE_SERVER_OPT:
            try:
                name, hp_raw = decode_server_opt_block(msg.payload, RULE_BLOCK_OFFSET)
                rule = (name, update_rules.parse_hp(hp_raw))
            except ValueError as e:
                self._reject_server_opt(msg, conn, send_lock, e)
                return
        ks = self._key_state(msg.key)
        with ks.lock:
            ks.async_mode = bool(profile & PROFILE_ASYNC)
            ks.staleness = max(-1, int(staleness)) if ks.async_mode else -1
            if ks.store is None:
                dt = storage_numpy_dtype(DataType(dtype_id))
                ks.dtype_id = dtype_id
                ks.store = np.zeros(n, dtype=dt)
                ks.accum = np.zeros(n, dtype=dt)
            if rule is None:
                ks.clear_rule()
            elif not update_rules.same_config(ks.opt_rule, *rule):
                # the same rule and hyperparameters keep their slots and
                # step count across a re-init; another config starts anew
                ks.clear_rule()
                try:
                    ks.opt_rule = update_rules.make_rule(rule[0], rule[1], ks.store.size,
                                                         ks.store.dtype)
                except ValueError as e:
                    self._reject_server_opt(msg, conn, send_lock, e)
                    return
            wid, token = msg.flags, msg.version
            waiters = None
            replay_ack = bool(wid and token and ks.init_done.get(wid) == token)
            if not replay_ack:
                entry = (wid, conn, send_lock, msg.seq, token)
                # a replayed INIT of one worker replaces its waiter
                for i, w in enumerate(ks.init_waiters):
                    if wid and w[0] == wid:
                        ks.init_waiters[i] = entry
                        break
                else:
                    ks.init_waiters.append(entry)
                waiters = self._complete_init_barrier_locked(ks)
        if replay_ack:
            # the barrier released and this worker's ack was lost: its
            # peers will not init the key again, so the token record acks
            # the retry instead of parking it
            counters().bump("init_replay_ack")
            send_message(conn, Message(Op.INIT, key=msg.key, seq=msg.seq), send_lock)
            return
        if waiters:
            self._release_init_waiters(msg.key, waiters)

    def _complete_init_barrier_locked(self, ks: _KeyState) -> Optional[List[tuple]]:
        """When the key's init barrier holds every worker's INIT, consume it
        and restart the key's rounds; the waiters to release, or None.
        Caller holds ``ks.lock``."""
        if not 0 < self.num_workers <= len(ks.init_waiters):
            return None
        waiters, ks.init_waiters = ks.init_waiters, []
        # each waiter's token: its INIT retried after this release is acked
        # from the record; an older generation's tokens go
        ks.init_done = {w[0]: w[4] for w in waiters if w[0] and w[4]}
        # a completed barrier restarts the key's rounds: every worker
        # re-inits and counts versions from 1 again (store contents and an
        # unchanged rule's state stay)
        ks.store_version = 0
        ks.recv_count = 0
        ks.pending_pulls = []
        ks.fused_waiters = []
        ks.push_seen = {}
        ks.pull_payload = ks.raw_payload = None
        ks.pull_version = ks.raw_version = -1
        return waiters

    @staticmethod
    def _release_init_waiters(key: int, waiters) -> None:
        for _, wconn, wlock, wseq, _ in waiters:
            try:
                send_message(wconn, Message(Op.INIT, key=key, seq=wseq), wlock)
            except (ConnectionError, OSError):
                continue  # a dead waiter must not hold up the others

    def _reject_server_opt(self, msg: Message, conn, send_lock, why) -> None:
        """Refuse an INIT whose update rule this server cannot run, with
        status 1 and the reason on stderr: never a silent sum."""
        counters().bump("server_opt_reject")
        _log(f"refusing the server-side optimizer INIT of key {msg.key}: {why}")
        try:
            send_message(conn, Message(Op.INIT, key=msg.key, seq=msg.seq, status=1),
                         send_lock)
        except (ConnectionError, OSError):
            pass

    # --- pushes ----------------------------------------------------------

    def _async_ks(self, ks: _KeyState) -> bool:
        """The key's INIT declared it async, or the whole server runs
        async (``BYTEPS_ENABLE_ASYNC``)."""
        return ks.async_mode or self.cfg.enable_async

    def _min_applied_locked(self, ks: _KeyState) -> int:
        """The slowest worker's newest applied push version of an async key
        (a worker that never pushed counts 0).  Caller holds ``ks.lock``."""
        n = self.num_workers
        if n <= 0:
            return 0
        vals = sorted(ks.push_seen.values(), reverse=True)[:n]
        return min(vals + [0] * (n - len(vals)))

    def _staleness_ready_locked(self, ks: _KeyState, version: int) -> bool:
        """A pull of round ``version`` of an async key may be answered when
        every worker's applied push is within the key's bound of it (-1:
        always; 0: sequential consistency).  Caller holds ``ks.lock``."""
        return ks.staleness < 0 or self._min_applied_locked(ks) >= version - ks.staleness

    def _sum_push_locked(self, ks: _KeyState, msg: Message, compressed: bool, arr) -> None:
        """One push (or fused member) under ``ks.lock``: into the async
        store, or the round's accumulator (the seed round of an update rule
        keeps the first push as it is).  Records the push in the replay
        ledger after the sum succeeded."""
        if self._async_ks(ks):
            grad = ks.compressor.decompress(msg.payload, ks.store.size) if compressed else arr
            if ks.opt_rule is not None:
                # the rule fires per push; each worker's first push is its
                # initial parameters, the first of them adopted as they are
                if msg.flags not in ks.opt_seeded:
                    if not ks.opt_seeded:
                        ks.store[:] = grad
                    ks.opt_seeded.add(msg.flags)
                else:
                    ks.opt_step += 1
                    ks.opt_rule.apply(ks.store, grad, 1, ks.opt_step)
                    self._count_update()
            elif compressed:
                ks.compressor.sum_into(msg.payload, ks.store)
            else:
                cpu_reducer.sum_into(ks.store, arr, ks.dtype_id)
            ks.store_version += 1
        elif ks.opt_rule is not None and ks.opt_step == 0:
            # the seed round: every worker pushes the same parameters, and
            # the first copy is kept (an average of identical copies is not
            # bitwise the original)
            if ks.recv_count == 0:
                if compressed:
                    ks.accum[:] = ks.compressor.decompress(msg.payload, ks.accum.size)
                else:
                    ks.accum[: len(arr)] = arr
            ks.recv_count += 1
        elif compressed:
            if ks.recv_count == 0:
                ks.accum[:] = ks.compressor.decompress(msg.payload, ks.accum.size)
            else:
                ks.compressor.sum_into(msg.payload, ks.accum)
            ks.recv_count += 1
        elif ks.recv_count == 0:
            ks.accum[: len(arr)] = arr  # COPY_FIRST
            ks.recv_count += 1
        else:
            cpu_reducer.sum_into(ks.accum, arr, ks.dtype_id)  # SUM_RECV
            ks.recv_count += 1
        self.stats.bump("pushes_summed")

    def _is_replayed_push_locked(self, ks: _KeyState, msg: Message) -> bool:
        """True for a push whose (worker, version) the ledger holds: it was
        summed, so it is acked only.  A push from a worker rank the last
        book does not list (an evicted one) raises, and the engine loop
        drops its connection: the zombie fence.  The ledger records a push
        after its sum (:meth:`_record_push_locked`), so a replay of a push
        whose sum raised is summed.  Caller holds ``ks.lock``."""
        wid = msg.flags
        if not wid or msg.version <= 0:
            return False
        live = self._live_worker_flags
        if live is not None and wid not in live:
            raise RuntimeError(f"push from evicted worker (flag {wid}, key {msg.key})")
        if msg.version <= ks.push_seen.get(wid, 0):
            counters().bump("push_dedup")
            return True
        return False

    @staticmethod
    def _record_push_locked(ks: _KeyState, msg: Message) -> None:
        if msg.flags and msg.version > 0:
            ks.push_seen[msg.flags] = msg.version

    def _count_update(self) -> None:
        counters().bump("server_opt_updates")
        self.stats.bump("server_opt_updates")

    def _apply_push_locked(self, ks: _KeyState, msg: Message, compressed: bool, arr,
                           flush: List) -> float:
        """Sum a push unless it replays one already summed, and collect the
        answers it releases into ``flush``; returns the seconds spent
        publishing the round it closed.  Caller holds ``ks.lock``."""
        if self._is_replayed_push_locked(ks, msg):
            return 0.0  # a replay of a push already summed: ack only
        self._sum_push_locked(ks, msg, compressed, arr)
        self._record_push_locked(ks, msg)
        if self._async_ks(ks):
            # this push may be the one a parked pull waits on
            flush.extend(self._drain_waiters_locked(
                ks, lambda v: self._staleness_ready_locked(ks, v), async_mode=True))
            return 0.0
        if ks.recv_count < self.num_workers:
            return 0.0
        p0 = time.time()
        flush.extend(self._publish_round_locked(ks))
        return time.time() - p0

    def _push_args(self, ks: _KeyState, msg: Message) -> tuple:
        """(compressed, raw array or None) of a push to ``ks``."""
        rtype, dtype_id = decode_command_type(msg.cmd)
        if rtype == RequestType.ROW_SPARSE_PUSH_PULL:
            raise NotImplementedError(f"row-sparse push: {UNPORTED['rowsparse']}")
        if ks.store is None:
            raise RuntimeError(f"push for uninitialized key {msg.key}")
        compressed = rtype == RequestType.COMPRESSED_PUSH_PULL
        if compressed and ks.compressor is None:
            raise RuntimeError(f"compressed push for key {msg.key}, which has "
                               "no registered compressor")
        return compressed, None if compressed else np.frombuffer(msg.payload,
                                                                 dtype=ks.store.dtype)

    def _observe_push(self, t_start: float, published: float) -> None:
        # the push's sum, less the publish of the round it closed
        metrics().observe("server_sum_seconds", max(0.0, time.time() - t_start - published))
        if published:
            metrics().observe("server_publish_seconds", published)

    def _handle_push(self, msg: Message, conn, send_lock) -> None:
        t_start = time.time()
        ks = self._key_state(msg.key)
        flush: List = []
        with ks.lock:
            compressed, arr = self._push_args(ks, msg)
            published = self._apply_push_locked(ks, msg, compressed, arr, flush)
        self._observe_push(t_start, published)
        send_message(conn, Message(Op.PUSH, key=msg.key, seq=msg.seq,
                                   version=msg.version), send_lock)
        self._flush_pulls(msg.key, flush)

    def _handle_fused(self, msg: Message, conn, send_lock) -> None:
        """A FUSED frame: every member goes through the push path under its
        key's lock (the same replay ledger, publish and rule), and its pull
        half is answered into the frame's one reply at once when its round
        is out (async: when within the staleness bound), or parked on the
        key until then."""
        members = decode_fused_push(msg.payload)
        if not members:
            raise RuntimeError("empty fused frame")
        reply = _FusedReply(conn, send_lock, msg.seq, msg.key, [m[0] for m in members])
        for slot, (key, cmd, version, payload) in enumerate(members):
            t_start = time.time()
            sub = Message(Op.PUSH, key=key, payload=payload, cmd=cmd, version=version,
                          flags=msg.flags)
            ks = self._key_state(key)
            flush: List = []
            with ks.lock:
                compressed, arr = self._push_args(ks, sub)
                published = self._apply_push_locked(ks, sub, compressed, arr, flush)
                is_async = self._async_ks(ks)
                if (self._staleness_ready_locked(ks, version) if is_async
                        else version <= ks.store_version):
                    if reply.fill(slot, ks.wire_payload(compressed, is_async),
                                  ks.store_version):
                        flush.append(reply)
                else:
                    ks.fused_waiters.append((version, reply, slot, compressed))
                    if is_async:
                        self.stats.bump("pulls_parked")
            self._observe_push(t_start, published)
            self._flush_pulls(key, flush)

    def _publish_round_locked(self, ks: _KeyState) -> List:
        """Every worker pushed: publish the round and collect the answers it
        releases (server.cc:348-375).  A key with an update rule publishes
        parameters: its seed round adopts the pushed ones, every later round
        applies the rule once to the raw sum.  Caller holds ``ks.lock``; the
        payloads are built under it, before a next round can swap the
        buffers."""
        if ks.opt_rule is not None and ks.opt_step > 0:
            ks.opt_rule.apply(ks.store, ks.accum, self.num_workers, ks.opt_step)
            self._count_update()
        else:
            ks.store, ks.accum = ks.accum, ks.store
        if ks.opt_rule is not None:
            ks.opt_step += 1
        ks.store_version += 1
        self.stats.bump("rounds_published")
        ks.recv_count = 0
        return self._drain_waiters_locked(ks, lambda v: v <= ks.store_version,
                                          async_mode=False)

    def _drain_waiters_locked(self, ks: _KeyState, ready, async_mode: bool) -> List:
        """The parked pulls and fused halves that ``ready(version)`` now
        admits, as the flush list of :meth:`_flush_pulls`: (conn, lock, seq,
        payload, version) for a pull, a completed :class:`_FusedReply` for a
        frame.  Caller holds ``ks.lock``."""
        flush: List = []
        keep = []
        for entry in ks.pending_pulls:
            version, pconn, plock, pseq, wants = entry
            if ready(version):
                flush.append((pconn, plock, pseq, ks.wire_payload(wants, async_mode),
                              ks.store_version))
            else:
                keep.append(entry)
        ks.pending_pulls = keep
        keep = []
        for entry in ks.fused_waiters:
            version, reply, slot, wants = entry
            if not ready(version):
                keep.append(entry)
            elif reply.fill(slot, ks.wire_payload(wants, async_mode), ks.store_version):
                flush.append(reply)
        ks.fused_waiters = keep
        return flush

    def _flush_pulls(self, key: int, flush: List) -> None:
        for entry in flush:
            try:
                if isinstance(entry, _FusedReply):
                    entry.send()
                    continue
                pconn, plock, pseq, payload, ver = entry
                send_message(pconn, Message(Op.PULL, key=key, payload=payload,
                                            seq=pseq, version=ver), plock)
            except (ConnectionError, OSError):
                continue

    def _handle_resync(self, msg: Message, conn, send_lock) -> None:
        """Op.RESYNC_QUERY: per key asked (every key when none), the store's
        version, the newest version of the asking worker's pushes the
        replay ledger holds (``seen``), the round's pushes so far.  A read:
        the worker's replayed pushes take the ordinary PUSH path.  A body
        that does not decode drops the connection (the engine loop)."""
        wid, keys = decode_resync_query(msg.payload)
        if not keys:
            with self._keys_lock:
                keys = list(self._keys)
        out = {}
        for key in keys:
            with self._keys_lock:
                ks = self._keys.get(key)
            if ks is None:
                continue
            with ks.lock:
                if ks.store is None:
                    continue
                out[key] = {"store_version": ks.store_version,
                            "seen": ks.push_seen.get(wid, 0) if wid else 0,
                            "recv_count": ks.recv_count, "init": True}
        send_message(conn, Message(Op.RESYNC_STATE, key=msg.key, seq=msg.seq,
                                   payload=encode_resync_state(out)), send_lock)

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
            is_async = self._async_ks(ks)
            if not (self._staleness_ready_locked(ks, msg.version) if is_async
                    else msg.version <= ks.store_version):
                ks.pending_pulls.append((msg.version, conn, send_lock, msg.seq, wants))
                if is_async:
                    self.stats.bump("pulls_parked")
                return
            payload = ks.wire_payload(wants, is_async)
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


#: the recovery plane's counters a server's stop report carries: a Python
#: server's (its process's), and the C++ engine's own
RECOVERY_COUNTERS = ("push_dedup", "init_replay_ack", "wire_checksum_fail",
                     "wire_checksum_conn_drop", "chaos_drop", "chaos_delay",
                     "chaos_disconnect", "chaos_truncate", "chaos_corrupt",
                     "chaos_payload_corrupt", "native_push_dedup", "native_init_replay_ack",
                     "native_resync_query", "native_checksum_fail", "sched_reconnect",
                     "sched_rejoin", "sched_stale_book")


def stop_report(node) -> List[str]:
    """A stopped server's three log lines: the pushes it summed into rounds
    (the Python engine adds the async pulls it parked and the update rules
    it applied), each histogram's count, sum, p50 and p99 (seconds), and
    its recovery counters that are not 0."""
    pushes, rounds = node.pushes_and_rounds()
    hists = node.histograms()
    extra = ""
    if isinstance(node, PSServer):
        counts = node.stats.snapshot()
        extra = (f", parked {counts.get('pulls_parked', 0)} async pulls, applied "
                 f"{counts.get('server_opt_updates', 0)} server-side updates")
        recovery = counters().snapshot()
    else:
        recovery = node.final_counters()
    return [
        f"rank {node.rank} summed {pushes} pushes into {rounds} rounds{extra}",
        f"rank {node.rank} histograms " + ("; ".join(
            f"{name} count={h['count']} sum={h['sum']:.6f} p50={h['p50']:.6g} "
            f"p99={h['p99']:.6g}" for name, h in hists.items()) or "none"),
        f"rank {node.rank} recovery " + (" ".join(
            f"{name}={recovery[name]}" for name in RECOVERY_COUNTERS
            if recovery.get(name)) or "none"),
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
        if getattr(node, "_sched_shutdown", False):
            # a scale-down dropped this server: it stopped, and exits
            _graceful(None, None)


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
        # the port the kernel chose, for a launcher that targets one server
        # (the chaos van's BYTEPS_CHAOS_TARGET_PORT)
        print(f"BYTEPS_SERVER_PORT={node.port}", flush=True)
        node.start()
    else:
        raise SystemExit(f"run_server: unsupported role {cfg.role!r}")
    _serve_until_signaled(node)
