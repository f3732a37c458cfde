"""Worker-side PS client (ps-lite's KVWorker), on the wire of
``byteps_tpu.comm.ps_client``.

``connect()`` REGISTERs with the scheduler, adopts the address book (rank,
worker count, server addresses), dials every server and passes the
bring-up barrier.

The control half follows the job's membership (docs/elasticity.md,
docs/robustness.md "Control-plane recovery"): a heartbeat every
``BYTEPS_HEARTBEAT_INTERVAL`` s; the unsolicited books of a resize or an
eviction (the worker count adopted at once, a new server set dialed off the
control thread, which bumps ``server_generation`` so the engine re-runs
the keys' init barriers against their new owners; under mixed hashing a
new worker count re-homes keys and bumps it too, which the reference's
client does not do); books of an older
scheduler incarnation are refused.  When the scheduler link dies, the
worker trains on its last book (``control_plane_degraded`` = 1) while a
reconnect machine redials and re-REGISTERs with its uid, rank, topology
and epochs, and a barrier caught by the loss is sent again after the
rejoin.  Data-plane requests are asynchronous: each request
registers a callback under a fresh ``seq`` on its server's connection, and
one receive loop per server hands every reply to its callback.  A pull may
pass a ``sink``, a caller-owned buffer the reply's payload is received
into with no copy (ZPull into the caller's buffer).

The data plane heals itself (docs/robustness.md):

- every request (init, compressor registration, push, fused push, pull)
  is sent again after a connection failure, up to ``BYTEPS_RPC_RETRIES``
  times, with full-jitter backoff (``comm/retry.py``); a retry first
  revives its server's connection if it died (a fresh dial to the same
  address; the server's state is per key, so a revived link resumes);
- ``BYTEPS_RPC_DEADLINE_S`` arms a deadline on each attempt: a server
  that neither answers nor closes is taken for hung, and its connection
  is torn down, which fails every request pending on it into the retry
  path.  Teardown before a retry also keeps a late reply out of a retried
  pull's sink.  The init barrier is exempt (its ack waits for every peer)
  and has ``BYTEPS_INIT_DEADLINE_S``.  One thread times the deadlines and
  the retries' backoff; a small pool runs the resends;
- once a request's job is abandoned (``abort_check``), its pending
  retries stop: a resend after the re-init barrier cleared the server's
  ledger would sum that worker twice;
- when the retries run out, the in-place heal runs once: re-dial the
  server, ask it which of this worker's rounds it absorbed
  (Op.RESYNC_QUERY), replay the journaled rounds above them
  (``comm/journal.py``) through the ordinary push path, and give the
  request one fresh attempt.  Fused frames skip it: their failure falls
  back to per-key requests, which carry their own.

A reply that fails its CRC32C is dropped, its request left pending for
the deadline to send again; ``BYTEPS_CHECKSUM_CONN_LIMIT`` of them give
the connection up.  A reply with another op than its request's
(WRONG_OWNER aside) fails its request at once, with the reason and no
retry.

Online resharding (``BYTEPS_ELASTIC_RESHARD=1``, docs/robustness.md
"migration flow"): the books' ownership map (``common.hashing.
OwnershipMap``, from ``server_ranks`` and ``map_epoch``) routes each key,
installed with the book's connections as one snapshot.  A resize keeps
``server_generation`` (the servers migrate every re-homed key's state, so
no init barrier runs again); a WRONG_OWNER reply waits, bounded, for the
book of its map epoch and the request goes to the new owner, whose
migrated ledger dedupes what the old owner summed (at most ``_max_chases``
chases, which spend no retry; a fused frame fails instead, into the
engine's unfused fallback).

``init_tensor`` carries the INIT profile extension: an async key with its
staleness bound, and a server-side update rule with its hyperparameters;
a server that refuses the profile (the C++ engine refuses both) makes it
raise with the reason.  Its ``version`` is the init-idempotency token, the
same over one init's retries, so a server whose barrier already released
acks a retry from its record.  ``push_fused`` sends small partitions of
one server as one Op.FUSED frame and hands back the decoded multi-key
reply.

Under ``BYTEPS_NATIVE_CLIENT=1`` each server's connection is
:class:`_NativeServerConn`: framing, the CRC32C, the seq demux and the
payload receive (into the caller's sink for a pull) run on the C++ lanes
of ``native/csrc/ps_client.cc`` with no interpreter lock, and Python
drains their completions in batches.  The lanes dial tcp and ``unix://``
addresses.  They would bypass the chaos van's fault layer, and they do not
speak the shm van's rings, so a ``chaos+`` or ``shm+unix://`` address
refuses the native client (the port never falls back to the Python lanes;
the reference's client takes them quietly there).

A server's address carries its van (``comm/van.py``): tcp, ``unix://``
(uds) or ``shm+unix://`` (shm), each possibly under ``chaos+``.  A reply
that carries a lossless container is decoded after its CRC32C passed, on
either lane; one that does not decode counts ``wire_lossless_fail`` and
fails its attempt into the retry path, as a CRC32C mismatch does.  A push
may ask for the container (``lossless=True``: the lossless arm of
adaptive compression); the native lanes send it raw, as the reference's
do.  A row-sparse pull's request carries the header and indices of the
rows it gathers (``pull(..., payload=...)``).  Each push's and
pull's round trip, send to reply, is observed as
``rpc_round_trip_seconds{server}``.

Each heartbeat carries this process's metric delta and its flight ledger
tail (``fr``) to the scheduler's aggregate; the first beat to a new
scheduler incarnation carries the whole history.  A book's ``tuning``
section (the autotuner's decisions) is adopted when its tuning epoch is
newer than the one applied, and handed to the listeners
(:meth:`PSClient.add_tuning_listener`: the engine); a new scheduler
incarnation re-arms that fence at -1, and a book without a section after
one with it hands the listeners an empty one (a successor with no tuner:
launch values again).  A rejoin REGISTER reports the last section adopted
and the ring overrides last seen, so that a restarted scheduler's tuner
takes them up.
"""

from __future__ import annotations

import ctypes
import heapq
import itertools
import json
import queue
import random
import struct
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.hashing import OwnershipMap, assign_server
from byteps_tpu_torch.common.types import RequestType, get_command_type, job_of_key
from byteps_tpu_torch.comm.chaos import CHAOS_PREFIX
from byteps_tpu_torch.comm.van import SHM_PREFIX, UNIX_PREFIX
from byteps_tpu_torch.compression.lossless import LosslessError, decompress_frame
from byteps_tpu_torch.comm.rendezvous import GROUP_ALL, GROUP_WORKERS, RESIZE_SEQ
from byteps_tpu_torch.comm.retry import Backoff
from byteps_tpu_torch.comm.shaping import maybe_shape, shaping_enabled, warn_native_bypass_once
from byteps_tpu_torch.comm.transport import (
    PROFILE_ASYNC,
    PROFILE_SERVER_OPT,
    Message,
    Op,
    checksum_conn_limit,
    close_socket,
    connect,
    decode_fused_reply,
    decode_resync_state,
    encode_fused_push,
    encode_init,
    encode_resync_query,
    encode_server_opt_block,
    frame_checksum,
    recv_header_ex,
    recv_into,
    recv_message,
    send_message,
)
from byteps_tpu_torch.core.telemetry import counters, job_labels, metrics
from byteps_tpu_torch.core.tracing import get_process_tracer, new_trace_id, span_args
from byteps_tpu_torch.server.update_rules import canonical_hp

#: pull callbacks receive this instead of bytes when the reply landed in
#: the caller's sink
ZERO_COPIED = object()


class RequestFailed(ConnectionError):
    """A request whose reply could not be used: the server answered it
    with another op than the request's."""


class _ServerConn:
    """One server: its socket, send lock and the pending requests."""

    def __init__(self, host: str, port: int, label: str, dial_timeout: float = 30.0) -> None:
        # data-plane link: shaped when BYTEPS_VAN_DELAY_MS /
        # BYTEPS_VAN_RATE_MBYTES_S emulate a DCN link (comm/shaping.py)
        self.sock = maybe_shape(connect(host, port, timeout=dial_timeout))
        self.send_lock = threading.Lock()
        self.label = label
        self.cb_lock = threading.Lock()
        #: seq -> (on_reply(Message), on_error(reason))
        self.callbacks: Dict[int, tuple] = {}
        self.sinks: Dict[int, memoryview] = {}
        self.next_seq = 0
        self.dead = False
        self.thread: Optional[threading.Thread] = None
        #: replies dropped on a CRC32C mismatch
        self.checksum_fails = 0

    def alloc_seq(self, on_reply, on_error, sink=None) -> int:
        """Register a request's callbacks; -1 (after ``on_error``) when the
        connection is already dead."""
        with self.cb_lock:
            if not self.dead:
                seq = self.next_seq
                self.next_seq = (self.next_seq + 1) & 0xFFFFFFFF
                self.callbacks[seq] = (on_reply, on_error)
                if sink is not None:
                    self.sinks[seq] = sink
                return seq
        on_error(f"server {self.label} connection is down")
        return -1

    def pop(self, seq: int) -> Optional[tuple]:
        with self.cb_lock:
            self.sinks.pop(seq, None)
            return self.callbacks.pop(seq, None)

    def peek_sink(self, seq: int) -> Optional[memoryview]:
        with self.cb_lock:
            return self.sinks.get(seq)

    def mark_dead(self) -> List[tuple]:
        with self.cb_lock:
            self.dead = True
            cbs = list(self.callbacks.values())
            self.callbacks.clear()
            self.sinks.clear()
            return cbs

    def send(self, msg: Message) -> None:
        send_message(self.sock, msg, self.send_lock)

    def close_all(self) -> None:
        """Tear the connection down; the receive loop then fails every
        pending request.  Never blocks."""
        close_socket(self.sock)

    def close(self) -> None:
        self.close_all()
        if self.thread is not None and self.thread is not threading.current_thread():
            self.thread.join(timeout=5.0)


class _NativeServerConn:
    """One server over the C++ lanes (``native/csrc/ps_client.cc``), with
    :class:`_ServerConn`'s surface.  A pull's reply lands in its sink on a
    lane thread; completions queue in C++ and ring a doorbell when the
    queue goes non-empty, and the doorbell drains them in one batch
    (``bpsc_drain``).  ``alloc_seq`` registers the callbacks under
    ``cb_lock`` in the same critical section as the native alloc, and the
    drain pops under it, so no completion can miss its callbacks.  Raises
    (never falls back to the Python lanes) when the library is missing."""

    def __init__(self, host: str, port: int, label: str) -> None:
        from byteps_tpu_torch.native import (
            BPSC_CALLBACK,
            DRAIN_REC_DTYPE,
            get_lib,
            native_client_histograms,
        )

        self._lib = get_lib()
        self.label = label
        self.cb_lock = threading.Lock()
        #: seq -> (on_reply, on_error, sink and its ctypes export)
        self.callbacks: Dict[int, tuple] = {}
        self.dead = False
        #: replies the lanes dropped on a CRC32C mismatch; the lanes give
        #: the connection up at the same limit
        self.checksum_fails = 0
        self._ck_limit = checksum_conn_limit()
        kind = 1 if host.startswith(UNIX_PREFIX) else 0
        addr = host[len(UNIX_PREFIX):] if kind else host
        h = self._lib.bpsc_create(addr.encode(), port, kind, 1)
        if h < 0:
            raise ConnectionError(f"native client could not connect to {host}:{port}")
        self._h: Optional[int] = h
        self._drain_lock = threading.Lock()
        self._recs = np.zeros(512, dtype=DRAIN_REC_DTYPE)
        self._arena = np.zeros(1 << 20, dtype=np.uint8)
        self._hist_provider = lambda: native_client_histograms(h)
        metrics().register_hist_provider(self._hist_provider)
        # the trampoline must outlive the lanes that call it
        self._c_cb = BPSC_CALLBACK(self._on_doorbell)
        self._lib.bpsc_set_cb(h, self._c_cb, None)

    def alloc_seq(self, on_reply, on_error, sink=None) -> int:
        ptr, length, keep = None, 0, None
        if sink is not None:
            keep = (ctypes.c_ubyte * len(sink)).from_buffer(sink)
            ptr, length = ctypes.addressof(keep), len(sink)
        with self.cb_lock:
            if not self.dead and self._h is not None:
                seq = self._lib.bpsc_alloc_seq(self._h, ptr, length)
                if seq >= 0:
                    self.callbacks[seq] = (on_reply, on_error, sink, keep)
                    return seq
        on_error(f"server {self.label} connection is down")
        return -1

    def pop(self, seq: int) -> Optional[tuple]:
        with self.cb_lock:
            entry = self.callbacks.pop(seq, None)
        return entry[:2] if entry is not None else None

    def peek_sink(self, seq: int) -> Optional[memoryview]:
        with self.cb_lock:
            entry = self.callbacks.get(seq)
        return entry[2] if entry is not None else None

    def mark_dead(self) -> List[tuple]:
        with self.cb_lock:
            self.dead = True
            cbs = [e[:2] for e in self.callbacks.values()]
            self.callbacks.clear()
            return cbs

    def send(self, msg: Message) -> None:
        payload = msg.payload
        n = memoryview(payload).nbytes if payload is not None else 0
        # a pointer to the caller's bytes, kept alive through the
        # (synchronous) native send
        arr = np.frombuffer(payload, dtype=np.uint8) if n else None
        with self.cb_lock:
            h = self._h
        if h is None:
            raise ConnectionError(f"server {self.label} connection is closed")
        ptr = arr.ctypes.data if n else None
        # the trace block as the Python transport writes it, so the server's
        # children join the worker's spans on either client; (0, 0) is none
        rc = self._lib.bpsc_send2(h, int(msg.op), msg.seq, msg.key, msg.cmd, msg.version,
                                  msg.flags, ptr, n, *(msg.trace or (0, 0)))
        if rc != 0:
            raise ConnectionError(f"server {self.label} connection lost (native send)")

    def close(self) -> None:
        # fold the lanes' final histograms in while the handle resolves
        metrics().absorb_hist_provider(self._hist_provider)
        with self.cb_lock:
            h, self._h = self._h, None
        if h is not None:
            # joins the lanes; pending requests come back as op = -1
            self._lib.bpsc_close(h)
        for _, on_error in self.mark_dead():
            on_error(f"server {self.label} connection closed")

    close_all = close

    # --- completions -----------------------------------------------------

    def _on_doorbell(self, _ctx, op, status, flags, seq, key, cmd, version,
                     payload, length, zero_copied) -> None:
        """op = -2: the completion queue went non-empty, drain it.  Any
        other op is one record of ``bpsc_close``'s final flush."""
        try:
            if op != -2:
                body = (ctypes.string_at(payload, length)
                        if op >= 0 and not zero_copied and length else b"")
                self._dispatch(op, status, flags, seq, key, cmd, version,
                               body, zero_copied)
                return
            with self._drain_lock:
                while self._drain_once():
                    pass
        except Exception:  # noqa: BLE001 - never unwind into a C thread
            # the doorbell rings only on empty -> non-empty: a failed drain
            # would strand every later completion, so fail them all now
            for _, on_error in self.mark_dead():
                on_error(f"server {self.label}: the native completion drain failed")

    def _drain_once(self) -> bool:
        n = self._lib.bpsc_drain(self._h, self._recs.ctypes.data, len(self._recs),
                                 self._arena.ctypes.data, self._arena.nbytes)
        if n == 0:
            return False
        if n < 0:  # the first payload does not fit the arena: grow it
            self._arena = np.zeros(max(-int(n), 2 * self._arena.nbytes), dtype=np.uint8)
            return True
        r = self._recs[:n]
        cols = [r[f].tolist() for f in ("op", "status", "flags", "seq", "key", "cmd",
                                        "version", "off", "len", "zc")]
        for op, status, flags, seq, key, cmd, version, off, ln, zc in zip(*cols):
            body = self._arena[off: off + ln].tobytes() if ln and not zc else b""
            try:
                self._dispatch(op, status, flags, seq, key, cmd, version, body, zc)
            except Exception:  # noqa: BLE001 - the rest of the batch still goes
                pass
        return True

    def _dispatch(self, op, status, flags, seq, key, cmd, version, body, zc) -> None:
        """One completion: op >= 0 a reply; -1 the connection died with the
        request pending; -3 the lanes dropped a reply that failed its
        CRC32C (its op in ``cmd``): the attempt fails at once into the
        retry path.  The lanes keep the request's entry until the
        connection closes, and no second reply can match it."""
        if op == -3:
            # the lanes dropped a reply that failed its CRC32C (status 0)
            # or whose lossless container did not decode (status 1)
            name = Op(cmd).name if cmd in Op._value2member_map_ else str(cmd)
            counters().bump("wire_lossless_fail" if status == 1 else "wire_checksum_fail",
                            labels={"side": "client", "op": name, "server": self.label})
            self.checksum_fails += 1
            if self._ck_limit and self.checksum_fails == self._ck_limit:
                counters().bump("wire_checksum_conn_drop")
        with self.cb_lock:
            if op == -1:
                self.dead = True
            entry = self.callbacks.pop(seq, None)
        if entry is None:
            return
        on_reply, on_error = entry[:2]
        if op == -1:
            on_error(f"server {self.label} connection lost")
        elif op == -3:
            on_error(f"{name} reply from server {self.label} failed its "
                     + ("lossless decode" if status == 1 else "CRC32C"))
        else:
            on_reply(Message(Op(op), key=key, payload=ZERO_COPIED if zc else body,
                             seq=seq, cmd=cmd, version=version, status=status,
                             flags=flags))


class PSClient:
    def __init__(self, cfg: Config, node_uid: Optional[str] = None) -> None:
        import uuid

        self.cfg = cfg
        self.node_uid = node_uid or uuid.uuid4().hex
        self.rank: Optional[int] = None
        self.num_workers = cfg.num_worker
        #: the newest book's job map ({job: {"workers", "priority",
        #: "quota_mbps"[, "quota_mbps_total"]}})
        self.jobs: Dict[str, dict] = {}
        self.num_servers = cfg.num_server
        #: the last book was a recovery book (a rejoin)
        self.is_recovery = False
        self._sched = None
        self._sched_lock = threading.Lock()
        self._sched_cbs: Dict[int, tuple] = {}
        self._sched_cb_lock = threading.Lock()
        self._sched_seq = 0
        self._sched_dead = False
        # the control plane's recovery (docs/robustness.md "Control-plane
        # recovery"): set while the scheduler link is up; the reconnect
        # machine owns the link while it redials; terminal once it gave up
        self._sched_up = threading.Event()
        self._sched_reconnecting = False
        self._sched_terminal = False
        self._reconnect_token = 0
        #: the newest scheduler incarnation, membership epoch and map epoch
        #: seen in a book (reported back on a rejoin)
        self.sched_incarnation = 0
        self.membership_epoch = 0
        self._seen_map_epoch = 0
        #: bumped when a book re-homes keys (the server set changed, or the
        #: worker count under mixed hashing): the engine re-runs each key's
        #: init barrier against its new owner before its next use
        self.server_generation = 0
        self._gen_lock = threading.Lock()
        #: books in arrival order, and the newest one applied to the
        #: server set: a rebuild of an older book never wins
        self._book_token = 0
        self._applied_token = 0
        self._servers: list = []
        #: (host, port) of each server, what a revival dials
        self._server_addrs: List[tuple] = []
        #: serializes the swap of a revived connection
        self._rebuild_lock = threading.Lock()
        self._stop = threading.Event()
        # init-idempotency tokens (INIT ``version``): a per-key sequence
        # under a per-client random salt, as the reference mints them
        self._init_seq_lock = threading.Lock()
        self._init_seqs: Dict[int, int] = {}
        self._init_salt = random.SystemRandom().getrandbits(16)
        # deadlines and the retry timer wheel: token -> (conn, expiry,
        # server label) of each attempt in flight, and a heap of (due,
        # tiebreak, fn) resends, both timed by one thread that starts at
        # the first use; due resends run on a small pool of threads (a
        # resend may block in a dial, and only the timing thread's
        # teardown of a hung connection can unblock it)
        self._rpc_tokens = itertools.count()
        self._outstanding: Dict[int, tuple] = {}
        self._outstanding_lock = threading.Lock()
        self._scan_cv = threading.Condition(self._outstanding_lock)
        self._timers: list = []
        self._deadline_thread: Optional[threading.Thread] = None
        self._retry_q: "queue.Queue" = queue.Queue()
        self._retry_threads: List[threading.Thread] = []
        self._retry_pool_cap = 4
        # the in-place heal, serialized per server: give-ups against one
        # server while a heal runs ride it (the generation tells them)
        self._heal_meta_lock = threading.Lock()
        self._heal_locks: Dict[str, threading.Lock] = {}
        self._heal_gen: Dict[str, int] = {}
        # online resharding (docs/robustness.md "migration flow"): the
        # books' ownership map routes, swapped with the connection list as
        # one snapshot; a WRONG_OWNER reply waits (bounded) for the book of
        # its map epoch, and the request is routed and sent again
        self.reshard = cfg.elastic_reshard
        #: the newest ownership map epoch adopted; _map_cv wakes chases
        self.map_epoch = 0
        self._map_cv = threading.Condition()
        self._ownership: Optional[OwnershipMap] = None
        #: (server connections, their ranks, the ownership map)
        self._routing: tuple = ([], [], None)
        #: WRONG_OWNER chases of one request before it fails
        self._max_chases = 8
        #: called with no argument when a book grows the server set or
        #: moves the ownership map, after the new connections are in place
        #: and before the map routes (the engine sends the error-feedback
        #: lr again: a server that joined since never got it)
        self._server_set_listeners: List[Callable[[], None]] = []
        #: the fleet tuning adopted (a book's ``tuning`` section, None with
        #: no tuner), its epoch, and its consumers
        self.tuning: Optional[dict] = None
        self._tuning_epoch = 0
        self._tuning_listeners: List[Callable[[dict], None]] = []
        #: the newest book's placement overrides, reported on a rejoin
        self._seen_ring_overrides: Dict[str, int] = {}

    # --- rendezvous ------------------------------------------------------

    def connect(self) -> None:
        """Register with the scheduler, dial every server, and pass the
        bring-up barrier (GetOrInitPS, global.cc:283-297).  A worker that
        resumes carries its topology: the scheduler resizes the job to it.
        On a rejoin the scheduler releases the barrier at once."""
        from byteps_tpu_torch.comm.transport import connect_control

        self._sched = connect_control(self.cfg.ps_root_uri, self.cfg.ps_root_port)
        send_message(self._sched, Message(Op.REGISTER, payload=json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": self.node_uid,
            "num_workers": self.cfg.num_worker,
            "num_servers": self.cfg.num_server,
            **self._job_fields(),
        }).encode()))
        resp = recv_message(self._sched)
        if resp.status != 0:
            err = json.loads(resp.payload.decode()).get("error", "register refused")
            raise RuntimeError(f"scheduler refused registration: {err}")
        book = json.loads(resp.payload.decode())
        self.rank = book["rank"]
        self.num_workers = self._book_num_workers(book)
        self.num_servers = book["num_servers"]
        self.is_recovery = bool(book.get("is_recovery", False))
        self._fence_book(book)
        self._note_membership(book)
        self._sched_up.set()
        metrics().gauge_set("control_plane_degraded", 0)
        for i, (host, port) in enumerate(book["servers"]):
            self._server_addrs.append((host, port))
            self._servers.append(self._new_conn(host, port, str(i)))
        self._install_routing(self._servers, book.get("server_ranks"),
                              self._ownership_from_book(book))
        threading.Thread(target=self._sched_recv_loop, name="bps-sched-recv",
                         daemon=True).start()
        if self.cfg.heartbeat_interval > 0:
            threading.Thread(target=self._heartbeat_loop, args=(self.cfg.heartbeat_interval,),
                             name="bps-heartbeat", daemon=True).start()
        self.barrier(GROUP_ALL)

    def _job_fields(self) -> dict:
        """The job and its declared share, in a REGISTER: the scheduler
        builds the books' job map from them (weights and quotas)."""
        return {"job": self.cfg.job_id, "job_priority": self.cfg.job_priority,
                "job_quota_mbps": self.cfg.job_quota_mbps}

    def _book_num_workers(self, book: dict) -> int:
        """The worker count this worker averages over: its job's workers
        when the book carries a job map, else the fleet's.  Keeps the map
        (``jobs``)."""
        self.jobs = dict(book.get("jobs") or {})
        mine = self.jobs.get(str(self.cfg.job_id))
        if mine and mine.get("workers"):
            return len(mine["workers"])
        return book["num_workers"]

    def job_rank(self) -> Optional[int]:
        """This worker's rank within its job: for a tenant (a job other
        than 0) its place among the job's ranks in the book, so that a
        job's ranks run from 0 to its size whatever the fleet's are (a
        broadcast from root 0 has a root in every job); job 0's is the
        scheduler's rank."""
        mine = self.jobs.get(str(self.cfg.job_id)) or {}
        ranks = sorted(int(r) for r in mine.get("workers") or ())
        if self.cfg.job_id and self.rank in ranks:
            return ranks.index(self.rank)
        return self.rank

    def _adopt_worker_count(self, book: dict) -> None:
        """A later book's worker count.  Under mixed hashing the count is an
        input of ``server_for``: a change re-homes keys with the server set
        unchanged, so it bumps ``server_generation`` too (after the count,
        so that a re-init goes to the new owner).  Not when an ownership
        map routes: the map, not the hash, places the keys then."""
        n = self._book_num_workers(book)
        moved = (n != self.num_workers and self._ownership is None
                 and (self.cfg.enable_mixed_mode or self.cfg.key_hash_fn == "mixed"))
        self.num_workers = n
        if moved:
            with self._gen_lock:
                self.server_generation += 1

    def close(self) -> None:
        self._stop.set()
        with self._scan_cv:
            self._scan_cv.notify_all()
        with self._rebuild_lock:
            servers, self._servers = self._servers, []
        for sc in servers:
            sc.close()
        close_socket(self._sched)

    def _fence_book(self, book: dict) -> bool:
        """The incarnation fence: refuse a book of an older scheduler
        incarnation than one this node acted on (a zombie scheduler racing
        its successor), counted as ``sched_stale_book``; adopt a newer one.
        A book with no stamp passes."""
        inc = int(book.get("sched_incarnation", 0) or 0)
        if inc and self.sched_incarnation and inc < self.sched_incarnation:
            counters().bump("sched_stale_book")
            return False
        if inc > self.sched_incarnation and self.sched_incarnation:
            # a successor numbers its tuning from its own start: the
            # monotone fence re-arms (-1, so that its epoch-0 section too
            # is adopted)
            self._tuning_epoch = -1
        self.sched_incarnation = max(self.sched_incarnation, inc)
        return True

    def _note_membership(self, book: dict) -> None:
        """Track the book's membership and map epochs, and mirror its
        cumulative evictions into ``worker_evicted`` / ``server_evicted``."""
        epoch = book.get("epoch")
        if epoch is not None and epoch > self.membership_epoch:
            self.membership_epoch = epoch
        me = book.get("map_epoch")
        if me is not None and int(me) >= self._seen_map_epoch:
            self._seen_map_epoch = int(me)
            self._seen_ring_overrides = dict(book.get("ring_overrides") or {})
        ev = book.get("evictions") or {}
        for role, name in (("worker", "worker_evicted"), ("server", "server_evicted")):
            if ev.get(role):
                counters().set_floor(name, int(ev[role]))
        self._adopt_tuning(book)

    def _adopt_tuning(self, book: dict) -> None:
        """Adopt a book's ``tuning`` section if its epoch is newer than the
        applied one (a repeated or stale book never rolls a decision
        back), and hand it to the listeners; a book without one, after a
        section, hands them ``{}`` once.  Runs on the scheduler link's
        thread, never on a server connection's."""
        t = book.get("tuning")
        if not isinstance(t, dict):
            if self.tuning is not None:
                self.tuning = None
                self._tuning_epoch = 0
                self._call_tuning_listeners({})
            return
        try:
            epoch = int(t.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            return
        if self.tuning is not None and epoch <= self._tuning_epoch:
            return
        self._tuning_epoch = epoch
        self.tuning = dict(t)
        self._call_tuning_listeners(self.tuning)

    def _call_tuning_listeners(self, section: dict, listeners=None) -> None:
        for cb in tuple(self._tuning_listeners if listeners is None else listeners):
            try:
                cb(section)
            except Exception as e:  # noqa: BLE001 - a listener must not stop a book
                print(f"byteps_tpu_torch: a tuning listener failed: {e!r}",
                      file=sys.stderr, flush=True)

    def add_tuning_listener(self, cb: Callable[[dict], None]) -> None:
        """Register a consumer of the fleet tuning; it gets the current
        section at once (the first book came before the engine)."""
        self._tuning_listeners.append(cb)
        if self.tuning is not None:
            self._call_tuning_listeners(self.tuning, [cb])

    def _tuning_report(self) -> Optional[dict]:
        """The tuning this node last adopted, with the ring overrides it
        last saw: what a rejoin REGISTER reports.  None with no tuner."""
        if self.tuning is None:
            return None
        rep = dict(self.tuning)
        if self._seen_ring_overrides:
            rep["ring_overrides"] = dict(self._seen_ring_overrides)
        return rep

    def _ownership_from_book(self, book: Optional[dict]) -> Optional[OwnershipMap]:
        """The book's ownership map; None with resharding off, or for a book
        that carries none."""
        if not self.reshard or not book:
            return None
        ranks, epoch = book.get("server_ranks"), book.get("map_epoch")
        if not ranks or epoch is None:
            return None
        return OwnershipMap(ranks, epoch=int(epoch), vnodes=self.cfg.ring_vnodes,
                            overrides=book.get("ring_overrides"))

    def _install_routing(self, servers, ranks, omap: Optional[OwnershipMap]) -> None:
        """Swap the (connections, ranks, map) snapshot as one reference, and
        wake the chases waiting for the map epoch it carries."""
        self._routing = (servers, list(ranks or []), omap)
        with self._map_cv:
            self._ownership = omap
            if omap is not None and omap.epoch > self.map_epoch:
                self.map_epoch = omap.epoch
            self._map_cv.notify_all()

    def _wait_map_epoch(self, epoch: int, timeout: float) -> bool:
        """Wait until the adopted map epoch reaches ``epoch`` (a redirect's),
        or ``timeout``: a chase before its book would route as before."""
        with self._map_cv:
            return self._map_cv.wait_for(
                lambda: self.map_epoch >= epoch or self._stop.is_set(), timeout)

    def _sched_request(self, msg: Message, timeout: Optional[float] = None) -> Message:
        """A scheduler request and its reply (matched by seq).
        ConnectionError when the link is or goes down, or with ``timeout``
        when no reply comes in time (a dropped control frame must not park
        the caller on a healthy link)."""
        with self._sched_cb_lock:
            if self._sched_dead:
                raise ConnectionError("scheduler connection lost")
            seq = self._sched_seq
            self._sched_seq += 1
            ev, box = threading.Event(), []
            self._sched_cbs[seq] = (ev, box)
            sock = self._sched
        msg.seq = seq
        try:
            send_message(sock, msg, self._sched_lock)
        except OSError as e:
            with self._sched_cb_lock:
                self._sched_cbs.pop(seq, None)
            raise ConnectionError(f"scheduler send failed: {e!r}") from None
        if not ev.wait(timeout):
            with self._sched_cb_lock:
                self._sched_cbs.pop(seq, None)
            raise ConnectionError("scheduler request timed out")
        if not box:
            raise ConnectionError("scheduler connection lost")
        return box[0]

    def request_resize(self, num_workers: Optional[int] = None,
                       num_servers: Optional[int] = None) -> dict:
        """Ask the scheduler, from this live worker, to take a new topology
        (what ``resume(num_servers=...)`` sends, with no teardown): blocks
        until it answers (a scale-up answers once the new server
        registered), adopts the book and returns it."""
        payload = json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": self.node_uid,
            "num_workers": int(num_workers or self.num_workers),
            "num_servers": int(num_servers or self.num_servers),
        }).encode()
        resp = self._sched_request(Message(Op.REGISTER, payload=payload))
        if resp.status != 0:
            err = json.loads(resp.payload.decode()).get("error", "refused")
            raise RuntimeError(f"scheduler refused resize: {err}")
        book = json.loads(resp.payload.decode())
        if not self._fence_book(book):
            raise ConnectionError("resize book from a stale scheduler incarnation")
        self._adopt_worker_count(book)
        self._note_membership(book)
        with self._sched_cb_lock:
            self._book_token += 1
            token = self._book_token
        self._rebuild_servers(book["num_servers"], [tuple(a) for a in book["servers"]], token,
                              book=book)
        return book

    def barrier(self, group: int = GROUP_WORKERS) -> None:
        """Scheduler barrier over ``group`` (Postoffice::Barrier).  A wait
        broken by the loss of the link is sent again once the reconnect
        machine rejoined (a restarted scheduler's barrier table starts
        empty, and every waiting peer sends again); ConnectionError only
        when the machine gave up."""
        while True:
            try:
                self._sched_request(Message(Op.BARRIER, flags=group))
                return
            except ConnectionError:
                if self._stop.is_set() or not self._await_control_plane():
                    raise

    def _await_control_plane(self, poll: float = 0.25) -> bool:
        """Wait until the scheduler link is up again (True), or the
        reconnect machine gave up or the client closed (False)."""
        while not self._stop.is_set():
            if self._sched_up.wait(poll):
                return True
            with self._sched_cb_lock:
                if self._sched_terminal and not self._sched_reconnecting:
                    return False
        return False

    def query_cluster(self) -> dict:
        """Each node's heartbeat age, from the scheduler (Op.QUERY)."""
        from byteps_tpu_torch.comm.transport import decode_liveness

        return decode_liveness(self._sched_request(Message(Op.QUERY)).payload)

    def _heartbeat_loop(self, interval: float) -> None:
        """A PING every ``interval`` s, with the metric delta and the flight
        ledger tail.  A beat lost with the link, or
        dropped on a healthy one (its reply waits at most 4 intervals),
        costs one beat; while the reconnect machine owns the link the loop
        keeps ticking."""
        from byteps_tpu_torch.core.flightrec import get_process_recorder

        beat_incarnation = None
        while not self._stop.wait(interval):
            with self._sched_cb_lock:
                if self._sched_dead:
                    continue
            inc = self.sched_incarnation
            if inc != beat_incarnation:
                # a new scheduler's aggregate starts empty: ship it all
                metrics().reship_for(inc)
                beat_incarnation = inc
            delta = metrics().delta_snapshot()
            rec = get_process_recorder()
            ups = None
            if rec is not None and rec.enabled:
                tail = rec.ledger_tail()
                if tail:
                    delta["fr"] = tail
                # bundles for the scheduler's flight directory
                # (BYTEPS_FLIGHT_UPLOAD), taken: a failed beat gives them back
                ups = rec.take_uploads()
                if ups:
                    delta["fb"] = ups
            try:
                self._sched_request(Message(Op.PING, payload=json.dumps(delta).encode()
                                            if delta else b""),
                                    timeout=max(2.0, 4 * interval))
            except (ConnectionError, OSError):
                # the next beat carries it (a beat whose request landed
                # but timed out counts twice: delivery is at least once)
                metrics().requeue_delta(delta)
                if ups:
                    rec.requeue_uploads(ups)
                continue

    def _sched_recv_loop(self) -> None:
        """Replies to scheduler requests, and the unsolicited books of a
        topology change: the worker count is adopted at once (the average
        reads it live), the server set off this thread.  When the link
        dies, the reconnect machine takes over (``control_plane_degraded``
        is 1 meanwhile; the data plane trains on the last book)."""
        sock = self._sched
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_message(sock)
                except (ConnectionError, OSError, ValueError):
                    return
                if msg.op == Op.ADDRBOOK and msg.seq == RESIZE_SEQ:
                    book = json.loads(msg.payload.decode())
                    if not self._fence_book(book):
                        continue  # a zombie scheduler's book
                    self._adopt_worker_count(book)
                    self._note_membership(book)
                    # every book spawns a rebuild, one matching the live set
                    # too (it cancels an older book's pending retry); the
                    # token orders them
                    with self._sched_cb_lock:
                        self._book_token += 1
                        token = self._book_token
                    threading.Thread(
                        target=self._rebuild_servers,
                        args=(book["num_servers"], [tuple(a) for a in book["servers"]], token),
                        kwargs={"book": book}, name="bps-rebuild", daemon=True).start()
                    continue
                with self._sched_cb_lock:
                    entry = self._sched_cbs.pop(msg.seq, None)
                if entry is not None:
                    entry[1].append(msg)
                    entry[0].set()
        finally:
            with self._sched_cb_lock:
                if self._sched is not sock:
                    return  # a rejoin replaced this link already
                self._sched_dead = True
                self._sched_up.clear()
                pending = list(self._sched_cbs.values())
                self._sched_cbs.clear()
                spawn = not self._stop.is_set() and not self._sched_reconnecting
                latch = False
                token = 0
                if spawn:
                    if self.cfg.sched_reconnect_retries > 0:
                        self._sched_reconnecting = True
                        self._reconnect_token += 1
                        token = self._reconnect_token
                    else:
                        self._sched_terminal = latch = True
                        spawn = False
            for ev, _ in pending:
                ev.set()
            if latch or spawn:
                metrics().gauge_set("control_plane_degraded", 1)
            if spawn:
                threading.Thread(target=self._sched_reconnect_loop, args=(token,),
                                 name="bps-sched-reconnect", daemon=True).start()

    # --- the control plane's reconnect machine --------------------------

    def _sched_reconnect_loop(self, token: int) -> None:
        """Redial the scheduler's address with bounded backoff
        (``BYTEPS_SCHED_RECONNECT_RETRIES``, ``_BACKOFF_S``), each attempt
        counted as ``sched_reconnect``, and re-REGISTER; a book of an older
        incarnation is refused and the address dialed again."""
        backoff = Backoff(base=max(0.05, self.cfg.sched_reconnect_backoff_s), cap=10.0)
        attempts = 0
        try:
            while not self._stop.is_set():
                if attempts >= self.cfg.sched_reconnect_retries:
                    print(f"byteps_tpu_torch: the scheduler reconnect gave up after "
                          f"{attempts} attempts; the data plane goes on with the last book",
                          file=sys.stderr, flush=True)
                    return
                attempts += 1
                counters().bump("sched_reconnect")
                try:
                    sock, book = self._sched_re_register()
                except (ConnectionError, OSError, RuntimeError, ValueError):
                    if self._stop.wait(backoff.next_delay()):
                        return
                    continue
                if book is None:
                    close_socket(sock)
                    if self._stop.wait(backoff.next_delay()):
                        return
                    continue
                self._adopt_rejoin(sock, book)
                return
        finally:
            latch = False
            with self._sched_cb_lock:
                if self._reconnect_token == token and self._sched_reconnecting:
                    # the loop ends without a rejoin: barrier retries fail
                    self._sched_reconnecting = False
                    if self._sched_dead:
                        self._sched_terminal = latch = True
            if latch:
                metrics().gauge_set("control_plane_degraded", 1)

    def _sched_re_register(self):
        """One redial and re-REGISTER: (socket, book), the book None when an
        older incarnation answered.  Reports the live topology, the last
        rank and both epochs, so that a restarted scheduler rebuilds its
        table and fences above them; ``reconnect`` says the runtime is live
        (no barrier bypass).  Waits for the reply: a restarted scheduler
        parks it until its population is back or its window expired."""
        from byteps_tpu_torch.comm.transport import connect_control

        sock = connect_control(self.cfg.ps_root_uri, self.cfg.ps_root_port)
        try:
            payload = json.dumps({
                "role": "worker", "host": "", "port": 0, "uid": self.node_uid,
                "num_workers": self.num_workers, "num_servers": self.num_servers,
                "last_rank": self.rank, "epoch": self.membership_epoch,
                "map_epoch": self._seen_map_epoch, "reconnect": True,
                **self._job_fields(),
                # a restarted scheduler's tuner takes up what the fleet runs
                **({"tuning": rep} if (rep := self._tuning_report()) is not None else {}),
            }).encode()
            send_message(sock, Message(Op.REGISTER, payload=payload))
            resp = recv_message(sock)
            if resp.status != 0:
                err = json.loads(resp.payload.decode()).get("error", "register refused")
                raise RuntimeError(f"scheduler refused rejoin: {err}")
            book = json.loads(resp.payload.decode())
            return sock, (book if self._fence_book(book) else None)
        except BaseException:
            close_socket(sock)
            raise

    def _adopt_rejoin(self, sock, book: dict) -> None:
        """Install a rejoin: the new link, the book (the rank is the one the
        scheduler honoured), a new receive loop, and the book's server set;
        an unchanged set is a no-op (no generation bump: the rounds go on
        bitwise).  Counted as ``sched_rejoin``."""
        self.rank = book["rank"]
        self._adopt_worker_count(book)
        self.is_recovery = True
        self._note_membership(book)
        counters().bump("sched_rejoin")
        with self._sched_cb_lock:
            old, self._sched = self._sched, sock
            self._sched_dead = False
            # the next loss of this link starts a new machine
            self._sched_reconnecting = False
            self._book_token += 1
            token = self._book_token
        close_socket(old)
        threading.Thread(target=self._sched_recv_loop, name="bps-sched-recv",
                         daemon=True).start()
        self._rebuild_servers(book["num_servers"], [tuple(a) for a in book["servers"]], token,
                              book=book)
        with self._sched_cb_lock:
            alive = not self._sched_dead
            if alive:
                self._sched_up.set()
        if alive:
            metrics().gauge_set("control_plane_degraded", 0)

    def _rebuild_servers(self, num_servers: int, new_addrs: List[tuple],
                         token: int = 1 << 62, retry_delay: float = 2.0,
                         book: Optional[dict] = None) -> None:
        """Adopt a book's server set: dial the new set, swap it in with the
        book's ownership map, then close the old connections (their pending
        requests fail into the retry path).  With no map, bump
        ``server_generation`` (keys re-home onto empty stores, and the
        engine re-runs their init barriers); under a map the servers
        migrate each key's state, so the rounds go on with no re-init.
        Serialized; a book that arrived before the applied one is skipped by its token, and a book
        that matches the live set is marked applied with no churn (so a
        rollback cancels an older book's pending retry).  A set that cannot
        be dialed keeps the old one and is tried again after
        ``retry_delay`` s, unless a newer book came."""
        with self._rebuild_lock:
            if token <= self._applied_token or self._stop.is_set() or token < self._book_token:
                return
            if new_addrs == self._server_addrs:
                self.num_servers = num_servers
                omap = self._ownership_from_book(book)
                if omap is not None:
                    if omap.epoch > self.map_epoch:
                        self._notify_server_set()
                    # the same addresses may carry other ranks
                    self._install_routing(self._servers, book.get("server_ranks"), omap)
                self._applied_token = token
                return
            fresh: list = []
            for attempt in range(3):
                if token < self._book_token:
                    for sc in fresh:
                        sc.close_all()
                    return
                try:
                    for host, port in new_addrs[len(fresh):]:
                        fresh.append(self._new_conn(host, port, str(len(fresh))))
                    break
                except OSError as e:
                    if attempt == 2:
                        print(f"byteps_tpu_torch: the server set of a resize could not be "
                              f"dialed ({e!r}); trying again in {retry_delay:.0f} s",
                              file=sys.stderr, flush=True)
                        for sc in fresh:
                            sc.close_all()

                        def retry() -> None:
                            if not self._stop.wait(retry_delay):
                                self._rebuild_servers(num_servers, new_addrs, token,
                                                      min(retry_delay * 2, 30.0), book)

                        threading.Thread(target=retry, name="bps-rebuild-retry",
                                         daemon=True).start()
                        return
                    self._stop.wait(0.3 * (attempt + 1))
            if token < self._book_token:
                for sc in fresh:
                    sc.close_all()
                return
            grew = len(fresh) > len(self._servers)
            old, self._servers = self._servers, fresh
            self._server_addrs = list(new_addrs)
            self.num_servers = num_servers
            omap = self._ownership_from_book(book)
            if grew or (omap is not None and omap.epoch > self.map_epoch):
                self._notify_server_set()
            self._install_routing(fresh, (book or {}).get("server_ranks"), omap)
            if omap is None:
                with self._gen_lock:
                    self.server_generation += 1
            self._applied_token = token
        for sc in old:
            sc.close_all()

    def add_server_set_listener(self, cb: Callable[[], None]) -> None:
        self._server_set_listeners.append(cb)

    def _notify_server_set(self) -> None:
        """Run the server-set listeners; one that fails is logged and the
        book is adopted all the same."""
        for cb in tuple(self._server_set_listeners):
            try:
                cb()
            except Exception as e:  # noqa: BLE001
                print(f"byteps_tpu_torch: a server-set listener failed: {e!r}",
                      file=sys.stderr, flush=True)

    # --- connections -----------------------------------------------------

    def _new_conn(self, host: str, port: int, label: str, dial_timeout: float = 30.0):
        shaped = shaping_enabled()
        if shaped and self.cfg.native_client:
            # the C++ lanes (the only striped ones) would skip the shaper and
            # report an unshaped link as shaped: the reference takes the
            # Python lanes, one connection a server, warned
            warn_native_bypass_once("ignoring BYTEPS_NATIVE_CLIENT=1")
        if self.cfg.native_client and not shaped:
            if host.startswith(CHAOS_PREFIX):
                raise RuntimeError(
                    f"BYTEPS_NATIVE_CLIENT=1 cannot dial the chaos address {host!r}: the "
                    "C++ lanes would bypass the chaos van's fault layer, and the port "
                    "never falls back to its Python lanes (ROADMAP.md Queue 3); unset "
                    "one of BYTEPS_NATIVE_CLIENT and the servers' BYTEPS_VAN=chaos:*")
            if host.startswith(SHM_PREFIX):
                raise RuntimeError(
                    f"BYTEPS_NATIVE_CLIENT=1 cannot dial the shm address {host!r}: the "
                    "C++ lanes speak tcp and uds, not the shm rings, and the port never "
                    "falls back to its Python lanes (ROADMAP.md Queue 3); unset one of "
                    "BYTEPS_NATIVE_CLIENT and the servers' BYTEPS_VAN=shm")
            return _NativeServerConn(host, port, label)
        sc = _ServerConn(host, port, label, dial_timeout)
        sc.thread = threading.Thread(target=self._recv_loop, args=(sc,),
                                     name=f"bps-recv-{label}", daemon=True)
        sc.thread.start()
        return sc

    def _recv_loop(self, sc: _ServerConn) -> None:
        ck_limit = checksum_conn_limit()
        try:
            while not self._stop.is_set():
                try:
                    (op, status, flags, seq, key, cmd, version, length,
                     trace, crc, lossless) = recv_header_ex(sc.sock)
                    # the callback stays registered until the payload is
                    # in: a connection dying mid-payload still fails it
                    sink = sc.peek_sink(seq)
                    zero_copied = (not lossless and sink is not None
                                   and length == len(sink))
                    if zero_copied:
                        recv_into(sc.sock, sink)
                        payload = ZERO_COPIED
                    else:
                        payload = bytearray(length)
                        if length:
                            recv_into(sc.sock, memoryview(payload))
                except (ConnectionError, OSError, ValueError):
                    return
                bad = None
                if crc is not None and frame_checksum(
                    trace, sink if zero_copied else payload
                ) != crc:
                    bad = ("wire_checksum_fail", "its CRC32C")
                elif lossless:
                    # the container is decoded once its CRC32C passed
                    try:
                        payload = decompress_frame(payload, op=op)
                    except LosslessError:
                        bad = ("wire_lossless_fail", "its lossless decode")
                if bad is not None:
                    # the attempt fails at once into the retry path, with
                    # or without a deadline armed (a sink holding garbage
                    # is overwritten by the retried reply before the
                    # caller wakes); a connection that keeps corrupting
                    # goes
                    sc.checksum_fails += 1
                    counters().bump(bad[0], labels={
                        "side": "client", "op": op.name, "server": sc.label})
                    if ck_limit and sc.checksum_fails >= ck_limit:
                        counters().bump("wire_checksum_conn_drop")
                        return
                    entry = sc.pop(seq)
                    if entry is not None:
                        entry[1](f"{op.name} reply from server {sc.label} failed {bad[1]}")
                    continue
                entry = sc.pop(seq)
                if entry is None:
                    continue
                on_reply, _ = entry
                on_reply(Message(op, key=key, payload=payload, seq=seq, cmd=cmd,
                                 version=version, status=status, flags=flags))
        finally:
            close_socket(sc.sock)
            for _, on_error in sc.mark_dead():
                on_error(f"server {sc.label} connection lost")

    def server_for(self, key: int) -> int:
        """The key's owning server rank: the ownership map's owner under
        resharding, else the hash over the server count."""
        omap = self._ownership
        if omap is not None:
            return omap.owner(key)
        return self._hash_index(key, self.num_servers)

    def _await_redirect(self, key: int, epoch: int, n: int, redirected_by) -> bool:
        """Before the ``n``-th chase of ``key``: wait (bounded) for the book
        of the redirect's map ``epoch``, then back off while the map still
        routes to the server that redirected (the key is on its way between
        servers).  False once the client closed."""
        self._wait_map_epoch(epoch, timeout=min(2.0, 0.25 * n))
        if self._route_rank(key) == redirected_by:
            return not self._stop.wait(min(2.0, 0.05 * 2 ** n))
        return not self._stop.is_set()

    def _route_rank(self, key: int) -> Optional[int]:
        """The rank ``key`` routes to now (None without a book)."""
        try:
            return self.server_for(key)
        except (ValueError, ZeroDivisionError):
            return None

    def _hash_index(self, key: int, num_servers: int) -> int:
        return assign_server(
            key, num_servers, fn=self.cfg.key_hash_fn,
            coef=self.cfg.built_in_hash_coef,
            mixed_mode=self.cfg.enable_mixed_mode,
            mixed_bound=self.cfg.mixed_mode_bound,
            num_workers=self.num_workers,
            ring_vnodes=self.cfg.ring_vnodes,
        )

    def _sid(self, key: int) -> str:
        """The key's server as a counter label ("?" when it has none)."""
        try:
            return str(self.server_for(key))
        except (ValueError, ZeroDivisionError, IndexError):
            return "?"

    def _conn_for(self, key: int, revive: bool = False):
        """The key's server connection; with ``revive`` (a retry) a dead
        one is dialed again first."""
        servers = self._servers
        if not servers:
            raise ConnectionError("no server connections")
        # the map routes only with the list it was installed with (they
        # swap together); mid-swap the hash routes, and a redirect corrects
        routing = self._routing
        ranks, omap = (routing[1], routing[2]) if routing[0] is servers else ([], None)
        if omap is not None and len(ranks) == len(servers):
            owner = omap.owner(key)
            if owner not in ranks:
                raise ConnectionError(f"owner rank {owner} is not in the current book")
            idx = ranks.index(owner)
        else:
            idx = self._hash_index(key, self.num_servers)
        if idx >= len(servers):
            raise ConnectionError("the server set is being rebuilt")
        sc = servers[idx]
        if revive and sc.dead:
            sc = self._revive_conn(idx, sc)
        return sc

    def _revive_conn(self, idx: int, dead_sc):
        """Replace a dead connection with a fresh dial to the same address.
        The dial runs outside the lock (a black-holed server must not hold
        up other revivals); a revival that lost the race is closed."""
        with self._rebuild_lock:
            if self._stop.is_set():
                raise ConnectionError("client closed")
            if idx >= len(self._servers):
                raise ConnectionError("the server set was rebuilt")
            cur = self._servers[idx]
            if cur is not dead_sc and not cur.dead:
                return cur  # another retry revived the slot already
            host, port = self._server_addrs[idx]
        # with deadlines armed, a dial that black-holes must not hold a
        # resend thread for the van's whole timeout
        dial_timeout = (min(30.0, max(2.0, 4 * self.cfg.rpc_deadline_s))
                        if self.cfg.rpc_deadline_s > 0 else 30.0)
        fresh = self._new_conn(host, port, str(idx), dial_timeout)
        with self._rebuild_lock:
            cur = self._servers[idx] if idx < len(self._servers) else None
            if self._stop.is_set() or cur is None:
                fresh.close_all()
                raise ConnectionError("client closed during a revival")
            if cur is not dead_sc and not cur.dead:
                fresh.close_all()
                return cur
            self._servers[idx] = fresh
        counters().bump("conn_revive", labels={"server": str(idx)})
        cur.close_all()
        return fresh

    def _worker_flag(self) -> int:
        """rank + 1 in the header's flags byte: the server dedupes a
        replayed push on (worker, key, version); 0 = anonymous."""
        r = self.rank
        return r + 1 if r is not None and 0 <= r < 255 else 0

    def _init_token(self, key: int) -> int:
        with self._init_seq_lock:
            seq = self._init_seqs.get(key, 0) + 1
            self._init_seqs[key] = seq
        return (self._init_salt << 16) | (seq & 0xFFFF)

    # --- deadlines and the retry timer wheel -----------------------------

    def _ensure_scanner_locked(self) -> None:
        """Start, or wake, the timing thread.  Caller holds
        ``_outstanding_lock``."""
        if self._deadline_thread is None:
            self._deadline_thread = threading.Thread(
                target=self._deadline_loop, name="bps-rpc-deadline", daemon=True)
            self._deadline_thread.start()
        else:
            self._scan_cv.notify()

    def _deadline_arm(self, sc, sid: str) -> Optional[int]:
        """Register an attempt in flight; its token, or None with the
        deadline off."""
        if self.cfg.rpc_deadline_s <= 0:
            return None
        token = next(self._rpc_tokens)
        with self._outstanding_lock:
            self._outstanding[token] = (sc, time.monotonic() + self.cfg.rpc_deadline_s, sid)
            self._ensure_scanner_locked()
        return token

    def _deadline_clear(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._outstanding_lock:
            self._outstanding.pop(token, None)

    def _timer_after(self, delay: float, fn) -> None:
        """Run ``fn`` on the resend pool after ``delay`` seconds; at once
        after close(), so that its stop check fails it instead of leaving
        it parked."""
        with self._outstanding_lock:
            if not self._stop.is_set():
                heapq.heappush(self._timers,
                               (time.monotonic() + delay, next(self._rpc_tokens), fn))
                self._ensure_scanner_locked()
                return
        fn()

    def _dispatch_retry(self, fn) -> None:
        """Queue ``fn`` on the resend pool, growing it (up to its cap) while
        work waits, so a resend blocked in a dial does not hold up another
        server's."""
        self._retry_q.put(fn)
        threads = self._retry_threads
        if not threads or (self._retry_q.qsize() > 0 and len(threads) < self._retry_pool_cap):
            t = threading.Thread(target=self._retry_loop,
                                 name=f"bps-rpc-retry-{len(threads)}", daemon=True)
            threads.append(t)
            t.start()

    def _retry_loop(self) -> None:
        while True:
            try:
                fn = self._retry_q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                fn()  # after close() too: its stop check fails it
            except Exception:  # noqa: BLE001 - the pool must survive
                pass

    def _deadline_loop(self) -> None:
        """Tear down the connection of every attempt past its deadline (its
        server is hung: a dead one would have closed), which fails all its
        pending requests into the retry path; hand due resends to the
        pool.  Sleeps until the next resend or the next scan tick."""
        tick = (max(0.01, min(0.25, self.cfg.rpc_deadline_s / 4))
                if self.cfg.rpc_deadline_s > 0 else 0.25)
        try:
            while True:
                due, doomed = [], []
                with self._outstanding_lock:
                    if self._stop.is_set():
                        return
                    now = time.monotonic()
                    while self._timers and self._timers[0][0] <= now:
                        due.append(heapq.heappop(self._timers)[2])
                    for t in [t for t, (_, at, _) in self._outstanding.items() if at <= now]:
                        sc, _, sid = self._outstanding.pop(t)
                        doomed.append((sc, sid))
                    if not due and not doomed:
                        timeout = self._timers[0][0] - now if self._timers else None
                        if self._outstanding:
                            timeout = tick if timeout is None else min(timeout, tick)
                        self._scan_cv.wait(timeout)
                        continue
                for _, sid in doomed:
                    counters().bump("rpc_deadline_expired", labels={"server": sid})
                for sc in {id(s): s for s, _ in doomed}.values():
                    try:
                        sc.close_all()
                    except Exception:  # noqa: BLE001
                        pass
                for fn in due:
                    self._dispatch_retry(fn)
        finally:
            # every parked resend still resolves (its stop check fails it)
            with self._outstanding_lock:
                leftovers = [fn for _, _, fn in self._timers]
                self._timers.clear()
            for fn in leftovers:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    pass

    # --- requests --------------------------------------------------------

    def _async_rpc(self, key: int, make_msg: Callable[[int], Message],
                   deliver: Callable[[Message], None], on_error: Callable[[str], None],
                   sink=None, abort_check: Optional[Callable[[], bool]] = None,
                   heal: bool = True, chase: bool = True) -> None:
        """Send one request with deadline, retries and revival.
        ``make_msg(seq)`` builds each attempt's frame; ``deliver(msg)``
        fires once on success, ``on_error(reason)`` once when the retries
        (and with ``heal`` the in-place heal) are spent, when the server
        answered with a frame the port cannot use, or when ``abort_check()``
        says the caller abandoned the request.  A WRONG_OWNER reply (the
        key migrated) is chased: the request waits for the book of the
        redirect's map epoch off the receiving thread, and is routed and
        sent again, without spending a retry, at most ``_max_chases``
        times; with ``chase`` off (a fused frame, whose members the new
        map may split) it fails the request.  Each attempt's round trip
        is observed as ``rpc_round_trip_seconds{server}`` (``{server,job}``
        for a tenant)."""
        state = {"attempt": 0, "healed": False, "done": False, "chases": 0, "rank": None}
        backoff = Backoff(base=self.cfg.rpc_backoff_s, cap=2.0)
        sid = self._sid(key)

        def terminal(reason: str) -> None:
            if not state["done"]:
                state["done"] = True
                on_error(reason)

        def aborted() -> bool:
            if abort_check is not None and abort_check():
                terminal(f"server {sid}: the request's job was abandoned")
                return True
            return False

        def give_up(reason: str) -> None:
            counters().bump("rpc_giveup", labels={"server": sid})
            terminal(reason)

        def fail(reason: str) -> None:
            # the retries are spent: once, try the in-place heal (off this
            # thread, which may be a receive loop; the heal dials and
            # blocks on recovery requests)
            if (heal and not state["healed"] and not self._stop.is_set()
                    and self.cfg.resync_deadline_s > 0):
                state["healed"] = True

                def heal_and_resend() -> None:
                    if aborted():
                        return
                    if self._heal_in_place(key, sid):
                        state["attempt"] = 0
                        send_attempt()
                    else:
                        give_up(f"{reason}; the in-place heal failed")

                self._dispatch_retry(heal_and_resend)
                return
            give_up(reason)

        def retry_later(reason: str) -> None:
            if aborted():
                return
            if self._stop.is_set() or state["attempt"] >= self.cfg.rpc_retries:
                fail(reason)
                return
            state["attempt"] += 1
            counters().bump("rpc_retry", labels={"server": sid})
            self._timer_after(backoff.next_delay(), send_attempt)

        def chase_redirect(msg: Message) -> None:
            # the server holds a newer ownership map: the key migrated, and
            # its new owner's migrated ledger dedupes whatever the old one
            # summed already
            counters().bump("wrong_owner_redirect", labels={"server": sid})
            if aborted():
                return
            state["chases"] += 1
            if not chase or self._stop.is_set() or state["chases"] > self._max_chases:
                give_up(f"server {sid} answered WRONG_OWNER (map epoch {msg.version}); "
                        + ("a fused frame does not chase" if not chase
                           else f"{state['chases'] - 1} chases"))
                return
            target, n, redirected_by = msg.version, state["chases"], state["rank"]

            def rechase() -> None:
                if not aborted() and self._await_redirect(key, target, n, redirected_by):
                    send_attempt()

            # off the receiving thread: the book that ends the wait comes
            # through the scheduler link, and a native drain thread must
            # not block
            self._dispatch_retry(rechase)

        def send_attempt() -> None:
            if aborted():
                return
            if self._stop.is_set():
                fail(f"server {sid}: the client closed")
                return
            try:
                sc = self._conn_for(key, revive=state["attempt"] > 0)
            except (ConnectionError, OSError) as e:
                retry_later(f"server {sid}: {e}")
                return
            state["rank"] = self._route_rank(key)
            token = [None]
            sent = [None, 0.0]  # op, time

            def on_reply(msg: Message) -> None:
                self._deadline_clear(token[0])
                if aborted():
                    return
                if msg.op == Op.WRONG_OWNER:
                    chase_redirect(msg)
                    return
                if msg.op != sent[0]:
                    terminal(f"server {sc.label} answered a {sent[0].name} request with "
                             f"{msg.op.name}")
                    return
                # per server, and per job for a tenant (job 0 keeps its series)
                metrics().observe("rpc_round_trip_seconds", time.monotonic() - sent[1],
                                  labels={"server": sid, **(job_labels(self.cfg.job_id) or {})})
                state["done"] = True
                deliver(msg)

            def on_attempt_error(reason: str) -> None:
                self._deadline_clear(token[0])
                retry_later(reason)

            # armed before the alloc: a dead connection's alloc fails the
            # attempt at once, and must find the token
            token[0] = self._deadline_arm(sc, sid)
            seq = sc.alloc_seq(on_reply, on_attempt_error, sink=sink)
            if seq < 0:
                return
            msg = make_msg(seq)
            sent[0], sent[1] = msg.op, time.monotonic()
            try:
                sc.send(msg)
                counters().bump("wire_rpc")
            except (ConnectionError, OSError) as e:
                # died between the alloc and the send: the retry is ours
                # unless the receive loop's drain took the callback first
                if sc.pop(seq) is not None:
                    self._deadline_clear(token[0])
                    retry_later(f"server {sc.label} send failed: {e!r}")

        send_attempt()

    def _blocking_request(self, sc, make_msg, what: str, timeout: Optional[float] = None,
                          expect: Optional[Op] = None) -> Message:
        """One request on ``sc``, waiting for its reply (of op ``expect``,
        by default the request's, or a WRONG_OWNER redirect).
        ConnectionError when the connection is or goes down, or ``timeout`` passes (then the connection is torn
        down, as the deadline thread does); :class:`RequestFailed` when
        the server answered with a frame the port cannot use."""
        done = threading.Event()
        box: list = []

        def on_error(reason: str) -> None:
            box.append(reason)
            done.set()

        seq = sc.alloc_seq(lambda m: (box.append(m), done.set()), on_error)
        msg = None
        if seq >= 0:
            msg = make_msg(seq)
            try:
                sc.send(msg)
            except OSError as e:
                sc.pop(seq)
                raise ConnectionError(f"{what}: send failed: {e!r}") from None
        if not done.wait(timeout):
            counters().bump("rpc_deadline_expired")
            sc.close_all()
            done.wait(5.0)
        reply = box[0] if box else f"server {sc.label}: no reply"
        if not isinstance(reply, Message):
            raise ConnectionError(f"{what}: {reply}")
        want = expect if expect is not None else msg.op
        if reply.op not in (want, Op.WRONG_OWNER):
            raise RequestFailed(f"{what}: server {sc.label} answered a {msg.op.name} "
                                f"request with {reply.op.name}")
        return reply

    def _blocking_request_retrying(self, key: int, make_msg, what: str,
                                   use_deadline: bool = True) -> Message:
        """A blocking request (init, compressor registration) with retries,
        revival, the RPC deadline and the WRONG_OWNER chase;
        ``use_deadline=False`` takes ``BYTEPS_INIT_DEADLINE_S`` instead, for
        the init barrier, whose ack waits for every peer worker.  Safe to
        send again: the server keys init waiters by worker and overwrites a
        codec chain."""
        backoff = Backoff(base=self.cfg.rpc_backoff_s, cap=2.0)
        deadline = ((self.cfg.rpc_deadline_s if use_deadline else self.cfg.init_deadline_s)
                    or None)
        sid = self._sid(key)
        last: Optional[BaseException] = None
        attempt = chases = 0
        while attempt <= self.cfg.rpc_retries:
            rank = self._route_rank(key)
            try:
                sc = self._conn_for(key, revive=attempt > 0)
                resp = self._blocking_request(sc, make_msg, what, deadline)
            except RequestFailed:
                raise
            except (ConnectionError, OSError) as e:
                last = e
                attempt += 1
                if attempt <= self.cfg.rpc_retries:
                    counters().bump("rpc_retry", labels={"server": sid})
                    if self._stop.wait(backoff.next_delay()):
                        break
                continue
            if resp.op != Op.WRONG_OWNER:
                return resp
            # the key migrated: a chase spends no retry, and is capped
            counters().bump("wrong_owner_redirect", labels={"server": sid})
            chases += 1
            if chases > self._max_chases:
                last = ConnectionError(f"{chases - 1} WRONG_OWNER chases")
                break
            if not self._await_redirect(key, resp.version, chases, rank):
                break
        counters().bump("rpc_giveup", labels={"server": sid})
        raise RequestFailed(f"{what}: {last or 'the client closed'}")

    # --- the in-place heal -----------------------------------------------

    def resync_in_place(self, key: int) -> bool:
        """Resync ``key``'s server and replay the journaled rounds it lacks;
        True when its ledger now holds every round this worker sent."""
        try:
            sid = str(self.server_for(key))
        except (ValueError, ZeroDivisionError, IndexError):
            return False
        return self._heal_in_place(key, sid)

    def _heal_in_place(self, key: int, sid: str) -> bool:
        """One heal of server ``sid``, serialized per server and bounded by
        ``BYTEPS_RESYNC_DEADLINE_S``; a give-up that waited while another
        heal of the server succeeded rides it.  Counted as
        ``resync_attempt``, ``resync_replayed_rounds`` and
        ``resync_giveup`` (flat and per server).  With a tracer on, the heal
        is a ``RESYNC`` span on the process's timeline, and its frames carry
        the span, so the server's ``resync`` child joins it."""
        if self.cfg.resync_deadline_s <= 0 or self._stop.is_set() or not self._worker_flag():
            # an anonymous worker has no slot in the server's ledger
            return False
        with self._heal_meta_lock:
            lock = self._heal_locks.setdefault(sid, threading.Lock())
            entry_gen = self._heal_gen.get(sid, 0)
        tracer = get_process_tracer()
        trace = None
        if tracer is not None and tracer.enabled and tracer.spans_enabled:
            trace = (new_trace_id(), new_trace_id())
        t0 = time.time()
        with lock:
            with self._heal_meta_lock:
                if self._heal_gen.get(sid, 0) != entry_gen:
                    return True
            counters().bump("resync_attempt", labels={"server": sid})
            ok, replayed = False, 0
            try:
                ok, replayed = self._run_resync(key, sid, trace)
            except Exception:  # noqa: BLE001 - a heal never raises
                ok = False
            if ok:
                with self._heal_meta_lock:
                    self._heal_gen[sid] = entry_gen + 1
            else:
                counters().bump("resync_giveup", labels={"server": sid})
        if trace is not None:
            tracer.record_span("resync", "RESYNC", t0, time.time() - t0,
                               span_args(trace[0], trace[1], server=sid, replayed=replayed,
                                         healed=ok))
        return ok

    def _run_resync(self, route_key: int, sid: str, trace=None) -> tuple:
        """The heal: (1) dial the server again (one that cannot be dialed
        is down, which a heal cannot mend); (2) Op.RESYNC_QUERY for every
        key this worker journals towards it, the triggering one included:
        per key, ``seen``, the newest of this worker's pushes its ledger
        summed; (3) replay, oldest first, the journaled rounds above
        ``seen`` as ordinary pushes (fused members as plain pushes).
        (healed?, rounds replayed); its frames carry ``trace``."""
        from byteps_tpu_torch.comm.journal import get_journal

        deadline_at = time.monotonic() + self.cfg.resync_deadline_s
        j = get_journal()
        wid = self._worker_flag()
        keys = sorted({route_key} | {k for k in (j.keys() if j else [])
                                     if self._sid(k) == sid})
        backoff = Backoff(base=max(0.01, self.cfg.rpc_backoff_s), cap=1.0)

        def recovery_rpc(k: int, make_msg, what: str, expect: Optional[Op] = None):
            """One blocking request, sent again within the heal's budget;
            None once the budget or the server is gone."""
            chases = 0
            while True:
                remaining = deadline_at - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return None
                rank = self._route_rank(k)
                per_try = (min(remaining, max(0.2, self.cfg.rpc_deadline_s))
                           if self.cfg.rpc_deadline_s > 0 else remaining)
                try:
                    sc = self._conn_for(k, revive=True)
                except (ConnectionError, OSError):
                    return None  # not dialable: not a one-sided fault
                try:
                    resp = self._blocking_request(sc, make_msg, what, per_try, expect)
                except RequestFailed:
                    return None
                except ConnectionError:
                    # frames still lost: back off, dial again
                    if self._stop.wait(min(backoff.next_delay(),
                                           max(0.0, deadline_at - time.monotonic()))):
                        return None
                    continue
                if resp.op != Op.WRONG_OWNER:
                    return resp
                # the key migrated: the replay goes to its new owner, whose
                # migrated ledger says what it absorbed
                counters().bump("wrong_owner_redirect", labels={"server": sid})
                chases += 1
                if not self._await_redirect(k, resp.version, chases, rank):
                    return None

        resp = recovery_rpc(
            route_key,
            lambda seq: Message(Op.RESYNC_QUERY, key=route_key, seq=seq, flags=wid,
                                payload=encode_resync_query(wid, keys), trace=trace),
            "resync query", Op.RESYNC_STATE)
        if resp is None or resp.status != 0:
            return False, 0
        replayed = 0
        state = decode_resync_state(resp.payload)
        for k in keys:
            info = state.get(k)
            if info is None:
                if j is not None and j.entries_after(k, 0):
                    # journaled pushes of a key the server no longer holds:
                    # its store was lost, only the init barrier rebuilds it
                    return False, replayed
                continue
            for e in (j.entries_after(k, int(info.get("seen", 0))) if j else []):
                ack = recovery_rpc(
                    k,
                    lambda seq, _k=k, _e=e: Message(
                        Op.PUSH, key=_k, seq=seq, cmd=_e.cmd, version=_e.version,
                        flags=wid, payload=_e.payload, trace=trace),
                    f"resync replay of key {k}")
                if ack is None or ack.status != 0:
                    return False, replayed
                counters().bump("resync_replayed_rounds", labels={"server": sid})
                replayed += 1
        return True, replayed

    # --- the data plane --------------------------------------------------

    def init_tensor(self, key: int, num_elements: int, dtype_id: int,
                    trace: Optional[tuple] = None,
                    async_profile: bool = False, staleness: int = -1,
                    server_opt: Optional[str] = None,
                    server_opt_hp: Optional[dict] = None) -> None:
        """Blocking init push: the server allocates the key, and the reply
        is the cross-worker barrier for it (operations.cc:283-414).
        Payload: u64 elements + u32 dtype, network order; an async key
        (``async_profile``, pulls within ``staleness`` rounds of the slowest
        worker, -1 unbounded) or a key with a server-side update rule
        (``server_opt`` and its hyperparameters) adds the profile
        extension.  A server that refuses the INIT makes it raise with the
        reason.  Retried without the RPC deadline (``BYTEPS_INIT_DEADLINE_S``
        instead), under one idempotency token, and one ``trace`` span."""
        token = self._init_token(key)
        profile = (PROFILE_ASYNC if async_profile else 0) | (
            PROFILE_SERVER_OPT if server_opt else 0)
        block = (encode_server_opt_block(server_opt, canonical_hp(server_opt_hp or {}))
                 if server_opt else b"")
        payload = encode_init(num_elements, dtype_id, profile, staleness, block)
        resp = self._blocking_request_retrying(
            key,
            lambda seq: Message(Op.INIT, key=key, seq=seq, flags=self._worker_flag(),
                                version=token, payload=payload, trace=trace),
            f"init of key {key}", use_deadline=False,
        )
        if resp.status != 0:
            if server_opt:
                why = (f"the server-side optimizer (rule {server_opt!r}) needs "
                       "Python-engine servers, a known rule and a floating tensor "
                       "(the server's log says which failed)")
            elif async_profile:
                why = "a per-key async profile needs Python-engine servers"
            elif job_of_key(key):
                why = (f"job {job_of_key(key)} keys need Python-engine servers (multi-tenant "
                       "namespaces are rejected by the C++ engine) — see docs/async.md")
            else:
                why = "the server refused the init"
            raise RuntimeError(f"server refused init for key {key} (status "
                               f"{resp.status}): {why}")

    def register_compressor(self, key: int, kwargs: Dict[str, str]) -> None:
        """Ship the codec config to the key's server: newline-separated
        ``key=value`` text (operations.cc:396-408)."""
        payload = "\n".join(f"{k}={v}" for k, v in sorted(kwargs.items())).encode()
        self._blocking_request_retrying(
            key,
            lambda seq: Message(Op.REGISTER_COMPRESSOR, key=key, seq=seq,
                                payload=payload),
            f"compressor registration for key {key}",
        )

    def set_compression_lr(self, lr: float) -> None:
        """Send the learning rate to every server's error-feedback chains:
        REGISTER_COMPRESSOR with flag bit 0 and a big-endian f64 payload
        (the wire's replacement for the reference's lr.s file).
        Fire-and-forget, as the reference sends it: a server whose
        connection is down is left to the data path to report."""
        payload = struct.pack("!d", float(lr))
        for sc in list(self._servers):
            seq = sc.alloc_seq(lambda msg: None, lambda reason: None)
            if seq < 0:
                continue
            try:
                sc.send(Message(Op.REGISTER_COMPRESSOR, seq=seq, payload=payload, flags=1))
            except OSError:
                sc.pop(seq)

    def push(self, key: int, payload, dtype_id: int, version: int,
             cb: Callable[[], None], on_error: Callable[[str], None],
             request_type: RequestType = RequestType.DEFAULT_PUSH_PULL,
             abort_check: Optional[Callable[[], bool]] = None,
             lossless: Optional[bool] = None, trace: Optional[tuple] = None) -> None:
        """Asynchronous push; ``cb`` fires on the server's ack (ZPush).  A
        resend of a push the server summed already is acked without a sum
        (the worker flag and version key its replay ledger).  ``lossless``
        asks for the payload's lossless container (the Python lanes).
        Every attempt carries the one ``trace`` (trace id, span id)."""
        cmd = get_command_type(request_type, dtype_id)
        flags = self._worker_flag()
        self._async_rpc(
            key,
            lambda seq: Message(Op.PUSH, key=key, seq=seq, payload=payload,
                                cmd=cmd, version=version, flags=flags, lossless=lossless,
                                trace=trace),
            lambda msg: cb(), on_error, abort_check=abort_check,
        )

    def push_fused(self, members: List[tuple], cb: Callable[[list], None],
                   on_error: Callable[[str], None],
                   abort_check: Optional[Callable[[], bool]] = None,
                   trace: Optional[tuple] = None,
                   member_spans: Optional[List[int]] = None) -> None:
        """One fused push and pull of small partitions of one server
        (Op.FUSED): ``members`` is ``[(key, cmd, version, payload), ...]``,
        routed by the first key, and ``cb`` gets the decoded reply
        ``[(key, version, payload), ...]``.  The frame carries the worker
        flag, so the server runs each member through its replay ledger.
        No in-place heal: a failed frame falls back to per-key requests.
        ``trace`` is the pack's span (the frame's trace block) and
        ``member_spans`` the members' (the body's trailer), fixed for every
        attempt."""
        frame = encode_fused_push(members, span_ids=member_spans)
        route_key = members[0][0]
        flags = self._worker_flag()

        def deliver(msg: Message) -> None:
            try:
                reply = decode_fused_reply(msg.payload)
            except (ValueError, struct.error) as e:
                counters().bump("fused_reply_malformed")
                on_error(f"fused reply of key {route_key}: {e}")
                return
            cb(reply)

        self._async_rpc(
            route_key,
            lambda seq: Message(Op.FUSED, key=route_key, seq=seq, payload=frame,
                                cmd=len(members), flags=flags, trace=trace),
            deliver, on_error, abort_check=abort_check, heal=False, chase=False,
        )

    def pull(self, key: int, version: int, cb: Callable, on_error: Callable[[str], None],
             dtype_id: int = 0,
             request_type: RequestType = RequestType.DEFAULT_PUSH_PULL,
             sink: Optional[memoryview] = None,
             abort_check: Optional[Callable[[], bool]] = None,
             payload: bytes = b"", trace: Optional[tuple] = None) -> None:
        """Asynchronous pull of round ``version``; ``cb`` gets the payload,
        or :data:`ZERO_COPIED` when it landed in ``sink`` (ZPull).  Read
        only, so retried freely: a retry follows the teardown of the
        attempt's connection, so no late reply writes into the sink.  A
        row-sparse pull's ``payload`` names its rows."""
        cmd = get_command_type(request_type, dtype_id)
        self._async_rpc(
            key,
            lambda seq: Message(Op.PULL, key=key, seq=seq, cmd=cmd, version=version,
                                payload=payload, trace=trace),
            lambda msg: cb(msg.payload), on_error, sink=sink, abort_check=abort_check,
        )
