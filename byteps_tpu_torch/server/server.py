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
    PROFILE_ASYNC,
    PROFILE_SERVER_OPT,
    RULE_BLOCK_OFFSET,
    UNPORTED_OPS,
    ChecksumError,
    Message,
    Op,
    UnsupportedFrameError,
    close_socket,
    connect,
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
        close_socket(self._sock)  # shutdown wakes the accept loop
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
                if len(ks.init_waiters) >= self.num_workers:
                    waiters, ks.init_waiters = ks.init_waiters, []
                    # each waiter's token: its INIT retried after this
                    # release is acked from the record; an older
                    # generation's tokens go
                    ks.init_done = {w[0]: w[4] for w in waiters if w[0] and w[4]}
                    # a completed barrier restarts the key's rounds: every
                    # worker re-inits and counts versions from 1 again
                    # (store contents and an unchanged rule's state stay)
                    ks.store_version = 0
                    ks.recv_count = 0
                    ks.pending_pulls = []
                    ks.fused_waiters = []
                    ks.push_seen = {}
                    ks.pull_payload = ks.raw_payload = None
                    ks.pull_version = ks.raw_version = -1
        if replay_ack:
            # the barrier released and this worker's ack was lost: its
            # peers will not init the key again, so the token record acks
            # the retry instead of parking it
            counters().bump("init_replay_ack")
            send_message(conn, Message(Op.INIT, key=msg.key, seq=msg.seq), send_lock)
            return
        if waiters is None:
            return
        for _, wconn, wlock, wseq, _ in waiters:
            try:
                send_message(wconn, Message(Op.INIT, key=msg.key, seq=wseq), wlock)
            except (ConnectionError, OSError):
                continue

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
        wid = msg.flags
        if wid and msg.version > 0 and msg.version <= ks.push_seen.get(wid, 0):
            counters().bump("push_dedup")
            return 0.0  # a replay of a push already summed: ack only
        self._sum_push_locked(ks, msg, compressed, arr)
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
                     "native_resync_query", "native_checksum_fail")


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
        # the port the kernel chose, for a launcher that targets one server
        # (the chaos van's BYTEPS_CHAOS_TARGET_PORT)
        print(f"BYTEPS_SERVER_PORT={node.port}", flush=True)
        node.start()
    else:
        raise SystemExit(f"run_server: unsupported role {cfg.role!r}")
    _serve_until_signaled(node)
