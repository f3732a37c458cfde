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
backoff while the data plane serves on.  Each heartbeat carries the
process's metric delta and its flight ledger tail (``core/flightrec.py``:
a server stamps one record a beat), and, once a book carried a ``tuning``
section, the hot-key report the autotuner's rebalance reads
(:meth:`PSServer._hot_report`: the request bytes of each key since the
last beat, counted on enqueue); a book without the section disarms it.

Online resharding (``BYTEPS_ELASTIC_RESHARD=1``, docs/robustness.md
"migration flow"): each book's ``server_ranks`` and ``map_epoch`` name an
ownership map (``common.hashing.OwnershipMap``).  On a newer one the
server ships each key the map homes elsewhere to its new owner over
Op.MIGRATE_STATE: the store, the accumulator, the replay ledger, the init
tokens, the codec config, the async profile and the update rule with its
step and slots, snapshotted in the same ``ks.lock`` section as the key's
tombstone.  A request for a shipped key, or for a key the map homes
elsewhere that the server never held, is answered Op.WRONG_OWNER with the
new map epoch (a fused frame once, as a whole); a request for a key whose
state is on its way here parks until it lands
(``BYTEPS_MIGRATE_DEADLINE_S``).  A drain book (a scale-down) ships every
key, and the server then stops by itself.

Sums and codecs run in the port's C++ (``native.cpu_reducer``,
``compression/impl.py``), as the reference's Python server's do.
Each push's sum is observed as ``server_sum_seconds`` and the publish of
the round it closed as ``server_publish_seconds``; a server process logs
its pushes, rounds, parked pulls and those histograms when it stops
(:func:`stop_report`).  ``BYTEPS_SERVER_NATIVE=1`` serves the data plane
in C++ instead (``server/native.py``).

The worker-facing listener rides the van ``BYTEPS_VAN`` selects (tcp, uds,
shm, or the chaos van around one; ``comm/van.py``), and the address the
server publishes carries the scheme.  A row-sparse push
(``RequestType.ROW_SPARSE_PUSH_PULL``: ``!II`` rows and row length,
big-endian u32 indices, the rows) scatter-sums its rows into the key's
dense store, duplicate indices accumulating and the rows no worker pushed
reset each round; a row-sparse pull (the same header and indices) gathers
those rows once the round is out.  Under ``BYTEPS_WIRE_LOSSLESS=1`` the
RESYNC_STATE and MIGRATE_STATE bodies go out as lossless containers, and
any flagged frame is decoded on receipt.

Jobs (docs/async.md): a key's top 16 bits name the job it belongs to, so
two jobs that declare the same names hold disjoint state here.  Each book's
``jobs`` map gives every job its worker ranks, its priority and its quota
(:meth:`PSServer._adopt_jobs`); a key's rounds, init barrier, async
staleness gate and update rule then complete against its job's workers,
not the fleet's.  Once some job declares a priority above 1 or a quota,
the engine queues serve the jobs by weighted fair queuing (bytes served
over the job's priority), each job's requests pass its admission quota
(``_QuotaBucket``: a request past the rate is deferred, never dropped;
INITs never wait), and the engine threads hand their replies to one
writer thread per connection (``_ConnWriter``), so that a slow tenant's
socket blocks only its own replies.  With no declaration the queues, the
replies and the frames are what they were for a single job, and job 0
mints no job-labelled series.
"""

from __future__ import annotations

import collections
import json
import signal
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from byteps_tpu_torch.common.config import Config, check_unported_env, resolve_node_uid
from byteps_tpu_torch.common.hashing import OwnershipMap
from byteps_tpu_torch.common.types import (
    DataType,
    RequestType,
    decode_command_type,
    job_of_key,
    storage_numpy_dtype,
    to_datatype,
)
from byteps_tpu_torch.comm.rendezvous import GROUP_ALL, RESIZE_SEQ, Scheduler
from byteps_tpu_torch.comm.shaping import maybe_shape, shaping_enabled, warn_native_bypass_once
from byteps_tpu_torch.comm.transport import (
    PROFILE_ASYNC,
    PROFILE_SERVER_OPT,
    RULE_BLOCK_OFFSET,
    ChecksumError,
    LosslessError,
    Message,
    Op,
    UnsupportedFrameError,
    close_socket,
    connect,
    decode_fused_push,
    decode_fused_spans,
    decode_init_profile,
    decode_migrate_extra,
    decode_migrate_state,
    decode_resync_query,
    decode_server_opt_block,
    encode_fused_reply,
    encode_migrate_state,
    encode_resync_state,
    encode_wrong_owner,
    recv_message,
    send_message,
)
from byteps_tpu_torch.comm.van import get_van, unlink_published
from byteps_tpu_torch.core.telemetry import Counters, _state_percentile, counters, metrics
from byteps_tpu_torch.core.tracing import (
    Tracer,
    get_process_tracer,
    new_trace_id,
    set_process_tracer,
    span_args,
)
from byteps_tpu_torch.native import cpu_reducer
from byteps_tpu_torch.server import update_rules

#: the histograms a server's stop report summarizes
SERVER_HISTOGRAMS = ("server_sum_seconds", "server_publish_seconds")


def _log(msg: str) -> None:
    print(f"byteps_tpu_torch server: {msg}", file=sys.stderr, flush=True)


def init_tuning_state(srv) -> None:
    """The tuning fields a server's control plane keeps (the C++ engine's
    wrapper borrows that plane): the newest tuning section and overrides
    seen, reported on a rejoin, and whether the hot report is armed."""
    srv._seen_tuning: Optional[dict] = None
    srv._seen_tuning_epoch = 0
    srv._seen_ring_overrides: Dict[str, int] = {}
    srv._tuning_on = False


def _ef_stage(codec):
    """The error-feedback stage of a server chain (momentum is skipped
    there, so it is the chain's head when present), or None."""
    from byteps_tpu_torch.compression.error_feedback import VanillaErrorFeedback

    while codec is not None:
        if isinstance(codec, VanillaErrorFeedback):
            return codec
        codec = getattr(codec, "inner", None)
    return None


class _KeyState:
    __slots__ = (
        "store", "accum", "dtype_id", "recv_count", "store_version",
        "pending_pulls", "fused_waiters", "init_waiters", "init_done", "push_seen",
        "compressor", "compressor_kwargs",
        "pull_payload", "pull_version", "raw_payload", "raw_version",
        "async_mode", "staleness", "opt_rule", "opt_step", "opt_seeded",
        "migrated_to", "migrate_epoch", "req_bytes", "job", "lock",
    )

    def __init__(self, job: int = 0) -> None:
        self.store: Optional[np.ndarray] = None
        self.accum: Optional[np.ndarray] = None
        self.dtype_id = 0
        self.recv_count = 0
        self.store_version = 0
        #: parked pulls: (version, conn, send_lock, seq, wants), ``wants``
        #: the compressed flag of a dense pull or a row-sparse pull's
        #: request body (bytes)
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
        #: the codec config the chain was built from (it ships with a
        #: migration, and the new owner builds the chain again)
        self.compressor_kwargs: Dict[str, str] = {}
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
        #: the resharding tombstone: the rank this key's state was shipped
        #: to (None: it lives here), and the map epoch of the last
        #: migration in either direction, which WRONG_OWNER carries
        self.migrated_to: Optional[int] = None
        self.migrate_epoch = 0
        #: request bytes enqueued for the key: the hot-key report's load
        self.req_bytes = 0
        #: the job the key is namespaced under: its rounds complete against
        #: that job's workers
        self.job = job
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
                 "versions", "remaining", "aborted", "lock")

    def __init__(self, conn, send_lock, seq: int, route_key: int, keys: List[int]) -> None:
        self.conn = conn
        self.send_lock = send_lock
        self.seq = seq
        self.route_key = route_key
        self.keys = keys
        self.slots: List[Optional[bytes]] = [None] * len(keys)
        self.versions = [0] * len(keys)
        self.remaining = len(keys)
        #: the frame was answered out of band (WRONG_OWNER, or parked on a
        #: migration): no later publish may answer its seq again
        self.aborted = False
        self.lock = threading.Lock()

    def fill(self, slot: int, payload: bytes, version: int) -> bool:
        """Record one member's payload; True once, when it completed the
        frame."""
        with self.lock:
            if self.aborted or self.slots[slot] is not None:
                return False
            self.slots[slot] = payload
            self.versions[slot] = version
            self.remaining -= 1
            return self.remaining == 0

    def abort(self) -> bool:
        """Mark the frame answered out of band; True once, for the caller
        that then sends the out-of-band reply on its seq."""
        with self.lock:
            if self.aborted or self.remaining == 0:
                return False
            self.aborted = True
            return True

    def send(self) -> None:
        body = encode_fused_reply(list(zip(self.keys, self.versions, self.slots)))
        send_message(self.conn, Message(Op.FUSED, key=self.route_key, seq=self.seq,
                                        payload=body), self.send_lock)


class _EngineQueue:
    """The queue of one engine thread: a FIFO lane per job, served by
    weighted fair queuing.  Each lane's virtual time is the payload bytes
    it was served over its job's weight (``weight_fn``, the books'
    priority), and a get serves the lane with the lowest; a lane that
    goes idle and comes back joins at the floor of the live ones.  With
    one job (every request put as job 0 while no job declared QoS) it is
    the plain FIFO."""

    def __init__(self, weight_fn=None) -> None:
        self._weight_fn = weight_fn or (lambda job: 1.0)
        self._cv = threading.Condition()
        #: job -> [FIFO of (item, cost), virtual time]
        self._lanes: Dict[int, list] = {}
        self._size = 0

    def _weight(self, job: int) -> float:
        try:
            return max(0.001, float(self._weight_fn(job)))
        except Exception:  # noqa: BLE001 - a weight lookup must not stall the queue
            return 1.0

    def put(self, item, job: int = 0, cost: int = 1) -> None:
        with self._cv:
            lane = self._lanes.get(job)
            if lane is None:
                lane = self._lanes[job] = [collections.deque(), 0.0]
            if not lane[0]:
                active = [ln[1] / self._weight(j) for j, ln in self._lanes.items() if ln[0]]
                if active:
                    lane[1] = max(lane[1], min(active) * self._weight(job))
            lane[0].append((item, max(1, cost)))
            self._size += 1
            self._cv.notify()

    def get(self, timeout: float):
        with self._cv:
            self._cv.wait_for(lambda: self._size > 0, timeout)
            if self._size == 0:
                return None
            job = min((j for j, ln in self._lanes.items() if ln[0]),
                      key=lambda j: self._lanes[j][1] / self._weight(j))
            lane = self._lanes[job]
            item, cost = lane[0].popleft()
            lane[1] += cost
            self._size -= 1
            return item


class _ConnWriter:
    """One connection's reply writer, under QoS: the engine threads queue
    send closures here instead of blocking in ``sendall`` on a slow
    tenant's socket, which would hold every other job's requests behind
    it.  Past ``max_bytes`` of queued replies ``submit`` blocks (the
    engine thread then waits on this one connection, as without a
    writer).  The thread ends after ``idle_s`` without replies, or when a
    send fails (the backlog goes: the worker's retry path owns recovery);
    :meth:`PSServer._reply_writer` replaces a dead writer."""

    __slots__ = ("_q", "_cv", "_bytes", "max_bytes", "idle_s", "dead")

    def __init__(self, max_bytes: int = 16 << 20, idle_s: float = 5.0) -> None:
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._bytes = 0
        self.max_bytes = max_bytes
        self.idle_s = idle_s
        self.dead = False
        threading.Thread(target=self._loop, name="ps-reply-writer", daemon=True).start()

    def submit(self, fn, nbytes: int) -> bool:
        """Queue one send; False when the writer is dead."""
        with self._cv:
            while not self.dead and self._bytes >= self.max_bytes:
                self._cv.wait(0.1)
            if self.dead:
                return False
            self._q.append((fn, nbytes))
            self._bytes += nbytes
            self._cv.notify_all()
            return True

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q:
                    if not self._cv.wait(self.idle_s) and not self._q:
                        self.dead = True
                        return
                fn, nbytes = self._q.popleft()
            try:
                fn()
            except (ConnectionError, OSError):
                with self._cv:
                    self.dead = True
                    self._q.clear()
                    self._bytes = 0
                    self._cv.notify_all()
                return
            with self._cv:
                self._bytes -= nbytes
                self._cv.notify_all()


class _QuotaBucket:
    """A job's admission meter (``BYTEPS_JOB_QUOTA_MBPS``, megabytes a
    second on this server): a virtual wire over request payload bytes.
    ``reserve(n)`` returns how long the request must wait before it is
    served; idle credit is capped at one burst window."""

    __slots__ = ("rate", "burst_s", "_free_at", "lock")

    def __init__(self, mbps: float, burst_s: float = 0.25) -> None:
        self.rate = max(1.0, mbps * 1e6)  # bytes a second
        self.burst_s = burst_s
        self._free_at = 0.0
        self.lock = threading.Lock()

    def reserve(self, nbytes: int) -> float:
        with self.lock:
            now = time.monotonic()
            self._free_at = max(self._free_at, now - self.burst_s)
            admit_at = self._free_at
            self._free_at += nbytes / self.rate
            return max(0.0, admit_at - now)


def _summed_already(ks, msg: Message) -> bool:
    """A traced push the replay ledger holds (its sum span's ``dedupe``);
    the fence and the count are :meth:`PSServer._is_replayed_push_locked`'s."""
    return (msg.trace is not None and bool(msg.flags)
            and 0 < msg.version <= ks.push_seen.get(msg.flags, 0))


def server_tracer(cfg: Config) -> Tracer:
    """A server's tracer (``BYTEPS_TRACE_ON``): its children of the
    workers' spans, written under ``BYTEPS_TRACE_DIR/server<rank>``.  It is
    the process tracer unless one is set already (an in-process fleet's
    worker's), so that the chaos van tags faults on it."""
    tracer = Tracer(enabled=cfg.trace_on, trace_dir=cfg.trace_dir, local_rank="server",
                    process_name="server", spans_enabled=cfg.trace_spans)
    if get_process_tracer() is None:
        set_process_tracer(tracer)
    return tracer


class PSServer:
    def __init__(self, cfg: Config, host: str = "127.0.0.1") -> None:
        check_unported_env()
        self.cfg = cfg
        self._sock, self.host, self.port = get_van().listen(host)
        self._keys: Dict[int, _KeyState] = {}
        self._keys_lock = threading.Lock()
        self._stop = threading.Event()
        nthreads = max(1, cfg.server_engine_threads)
        # --- jobs (docs/async.md) ---
        #: job -> its worker flags (rank + 1), and its priority and quota,
        #: from the newest book's ``jobs`` map
        self._job_workers: Dict[int, set] = {}
        self._job_qos: Dict[int, dict] = {}
        #: job -> its admission meter (jobs with a quota)
        self._job_quota: Dict[int, _QuotaBucket] = {}
        #: some job declared a priority above 1 or a quota: the engine
        #: queues weigh jobs, and replies go through per-connection writers
        self._qos_active = False
        self._writers: Dict[int, _ConnWriter] = {}
        self._writers_lock = threading.Lock()
        self._queues = [_EngineQueue(weight_fn=self._job_weight) for _ in range(nthreads)]
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
        # --- online resharding (docs/robustness.md "migration flow") ---
        #: ownership is the books' epoch-stamped ring over server ranks:
        #: on a newer map this server ships each re-homed key to its new
        #: owner, answers stale requests with WRONG_OWNER, and parks the
        #: requests of a key whose migration is inbound
        self.reshard = cfg.elastic_reshard
        self._ownership: Optional[OwnershipMap] = None
        self._prev_ownership: Optional[OwnershipMap] = None
        self._own_lock = threading.Lock()
        self._peer_addrs: Dict[int, tuple] = {}
        #: ranks the last book says leave by a drain (they ship their keys)
        self._draining: set = set()
        #: key -> parked (time, msg, conn, send_lock)
        self._awaiting: Dict[int, List[tuple]] = {}
        self._awaiting_lock = threading.Lock()
        self._awaiting_sweeper: Optional[threading.Thread] = None
        init_tuning_state(self)
        #: the hot report's baseline: key -> request bytes at the last beat
        self._hot_last: Dict[int, int] = {}
        self._metrics_http = None
        self.tracer = server_tracer(cfg)
        from byteps_tpu_torch.core.flightrec import ensure_process_recorder

        ensure_process_recorder(cfg, context_fn=self._flight_context, tracer=self.tracer)

    def _flight_context(self) -> dict:
        """The control context stamped into each flight record."""
        deg = metrics()._gauges.get(("control_plane_degraded", ()), 0)
        return {"epoch": self.membership_epoch, "map_epoch": self._map_epoch,
                "incarnation": self.sched_incarnation, "degraded": int(deg)}

    # --- lifecycle -------------------------------------------------------

    def start(self, register: bool = True) -> None:
        for i, q in enumerate(self._queues):
            self._spawn(self._engine_loop, (q,), f"ps-engine-{i}")
        self._spawn(self._accept_loop, (), "ps-accept")
        self._serve_metrics()
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

    def _serve_metrics(self) -> None:
        """The process registry's Prometheus endpoint (BYTEPS_METRICS_PORT)."""
        if self.cfg.metrics_port > 0 and self._metrics_http is None:
            from byteps_tpu_torch.core.telemetry import serve_metrics

            self._metrics_http = serve_metrics(self.cfg.metrics_port)

    def _stop_observing(self) -> None:
        """Close the endpoint; release the recorder iff this server made it
        (not a worker's) and the process tracer iff it is this one."""
        from byteps_tpu_torch.core.flightrec import release_process_recorder

        if self._metrics_http is not None:
            self._metrics_http.close()
            self._metrics_http = None
        release_process_recorder(self._flight_context)
        if get_process_tracer() is self.tracer:
            set_process_tracer(None)

    def stop(self) -> None:
        self._stop.set()
        self._stop_observing()
        self.tracer.flush()
        close_socket(self._sock)  # shutdown wakes the accept loop
        unlink_published(self.host)
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
                # the tuning and overrides last seen, for a successor's tuner
                rep = dict(self._seen_tuning or {})
                if self._seen_ring_overrides:
                    rep["ring_overrides"] = dict(self._seen_ring_overrides)
                if rep:
                    payload["tuning"] = rep
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
        # the process's name and trace directory on the merged timeline
        self.tracer.process_name = self.tracer.local_rank = f"server{self.rank}"
        self._adopt_jobs(book)  # before any round completes against it
        if initial:
            self.num_workers = book["num_workers"]
        else:
            # a rejoin: a changed worker count completes rounds and
            # barriers as a resize book does
            self.update_num_workers(book["num_workers"])
        self._adopt_worker_ranks(book)
        self._adopt_book(book)
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
            self._seen_ring_overrides = dict(book.get("ring_overrides") or {})
        t = book.get("tuning")
        if isinstance(t, dict):
            try:
                te = int(t.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                te = 0
            if te >= self._seen_tuning_epoch:
                self._seen_tuning_epoch = te
                self._seen_tuning = dict(t)
        self._adopt_tuning(book)

    def _adopt_tuning(self, book: dict) -> None:
        """A book with a ``tuning`` section arms the hot report (its
        baseline taken now, so that the first report holds only traffic
        seen under the tuner); a book without one disarms it."""
        on = isinstance(book.get("tuning"), dict)
        if on and not self._tuning_on and hasattr(self, "_keys_lock"):
            with self._keys_lock:
                self._hot_last = {k: ks.req_bytes for k, ks in self._keys.items()}
        self._tuning_on = on

    def _hot_report(self) -> Optional[dict]:
        """The autotuner's input for this beat: the request bytes of each
        key since the last beat (the 8 hottest, and the total) and the
        keys held here.  Control thread only; redirected traffic counts,
        it is load served."""
        if not self._tuning_on:
            return None
        with self._keys_lock:
            cur = {k: ks.req_bytes for k, ks in self._keys.items()}
            owned = sum(1 for ks in self._keys.values()
                        if ks.store is not None and ks.migrated_to is None)
        last, self._hot_last = self._hot_last, cur
        if not cur:
            return None
        deltas = {k: v - last.get(k, 0) for k, v in cur.items() if v - last.get(k, 0) > 0}
        top = sorted(deltas.items(), key=lambda kv: -kv[1])[:8]
        return {"total": int(sum(deltas.values())),
                "keys": [[int(k), int(v)] for k, v in top], "owned": int(owned)}

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
            self._adopt_jobs(book)  # the jobs' workers first: the rounds read them
            self.update_num_workers(book["num_workers"])
            self._adopt_worker_ranks(book)
            # last: a drain's wave, and its stop, see the settled count
            self._adopt_book(book)
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

        from byteps_tpu_torch.core.flightrec import get_process_recorder

        hb = self.cfg.heartbeat_interval
        beat_incarnation = None
        while not self._stop.is_set():
            next_beat = time.monotonic() + hb if hb > 0 else None
            delta: dict = {}
            ups = None
            try:
                while not self._stop.is_set():
                    now = time.monotonic()
                    if next_beat is not None and now >= next_beat:
                        if self.sched_incarnation != beat_incarnation:
                            # a new scheduler's aggregate starts empty
                            metrics().reship_for(self.sched_incarnation)
                            beat_incarnation = self.sched_incarnation
                        # a server has no steps: a beat is its record
                        rec = get_process_recorder()
                        if rec is not None and rec.enabled:
                            rec.record_step()
                        delta = metrics().delta_snapshot()
                        if rec is not None and rec.enabled:
                            tail = rec.ledger_tail()
                            if tail:
                                delta["fr"] = tail
                            # bundles for the scheduler (BYTEPS_FLIGHT_UPLOAD)
                            ups = rec.take_uploads()
                            if ups:
                                delta["fb"] = ups
                        # the C++ engine's wrapper has no key table and
                        # sends no hot report: never a rebalance end
                        hot_fn = getattr(self, "_hot_report", None)
                        hot = hot_fn() if hot_fn is not None else None
                        if hot:
                            delta["hot"] = hot
                        send_message(conn, Message(
                            Op.PING, payload=json.dumps(delta).encode() if delta else b""))
                        delta, ups = {}, None
                        next_beat = now + hb
                    readable, _, _ = select.select([conn], [], [], 0.3)
                    if readable:
                        self._handle_control(conn, recv_message(conn))
            except (ConnectionError, OSError, ValueError):
                metrics().requeue_delta(delta)  # a beat that did not leave
                if ups:
                    get_process_recorder().requeue_uploads(ups)
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
                elif 0 < self._workers_for_ks(ks) <= ks.recv_count:
                    flush = self._publish_round_locked(ks)
            self._flush_pulls(key, flush)

    # --- jobs (docs/async.md) ---------------------------------------------

    def _adopt_jobs(self, book: dict) -> None:
        """Adopt a book's ``jobs`` map: each job's worker flags size its
        keys' rounds and barriers, its priority weighs the engine queues,
        and its quota (megabytes a second on this server) arms its
        admission meter; a changed quota gets a new meter, a dropped one
        takes its gauge along.  A book without the map changes nothing.
        A map of job 0 alone (a single-tenant fleet) leaves the rounds on
        the book's worker count and the queues and replies as they were,
        as before jobs were ported: under elastic membership that count
        may differ from the live ranks the map lists (the reference's
        server takes the map's, ROADMAP.md Queue 3, the fourteenth
        divergence)."""
        jobs = book.get("jobs")
        if not isinstance(jobs, dict):
            return
        workers: Dict[int, set] = {}
        qos: Dict[int, dict] = {}
        for raw_job, info in jobs.items():
            try:
                job = int(raw_job)
            except (TypeError, ValueError):
                continue
            flags = {r + 1 for r in (info.get("workers") or []) if 0 <= r < 255}
            if flags:
                workers[job] = flags
            qos[job] = {"priority": max(1, int(info.get("priority", 1) or 1)),
                        "quota_mbps": max(0.0, float(info.get("quota_mbps", 0) or 0))}
        tenants = any(qos)  # a job other than 0
        self._job_workers = workers if tenants else {}
        self._job_qos = qos
        # the lanes and writers engage only once a tenant's fleet declared
        # QoS: with none, the order is the single job's
        self._qos_active = tenants and any(q["priority"] > 1 or q["quota_mbps"] > 0
                                           for q in qos.values())
        quota: Dict[int, _QuotaBucket] = {}
        for job, q in qos.items():
            mbps = q["quota_mbps"]
            if mbps <= 0:
                continue
            old = self._job_quota.get(job)
            quota[job] = (old if old is not None and abs(old.rate - mbps * 1e6) < 1.0
                          else _QuotaBucket(mbps))
            metrics().gauge_set("server_job_quota_mbps", mbps, labels={"job": str(job)})
        for job in self._job_quota:
            if job not in quota:
                metrics().gauge_remove("server_job_quota_mbps", labels={"job": str(job)})
        self._job_quota = quota

    def _job_weight(self, job: int) -> float:
        """A job's weight in the engine queues (its priority; 1 unknown)."""
        q = self._job_qos.get(job)
        return float(q["priority"]) if q else 1.0

    def _workers_for_ks(self, ks: _KeyState) -> int:
        """The workers a key's rounds and init barrier complete against:
        its job's, when the book's map lists them, else the fleet's."""
        flags = self._job_workers.get(ks.job)
        return len(flags) if flags else self.num_workers

    def _reply_writer(self, conn) -> _ConnWriter:
        """The connection's reply writer, made (or replaced, once dead)
        here; dead writers are swept on the way."""
        with self._writers_lock:
            w = self._writers.get(id(conn))
            if w is None or w.dead:
                for k in [k for k, ww in self._writers.items() if ww.dead]:
                    del self._writers[k]
                w = self._writers[id(conn)] = _ConnWriter()
            return w

    def _submit_reply(self, conn, fn, nbytes: int) -> None:
        """Queue a send on the connection's writer; once more on a fresh
        writer when the first died between lookup and submit."""
        if not self._reply_writer(conn).submit(fn, nbytes):
            self._reply_writer(conn).submit(fn, nbytes)

    def _send_reply(self, conn, msg: Message, send_lock) -> None:
        """An engine thread's reply: through the connection's writer under
        QoS, inline (as for a single job) otherwise."""
        if not self._qos_active:
            send_message(conn, msg, send_lock)
            return
        self._submit_reply(conn, lambda: send_message(conn, msg, send_lock),
                           len(msg.payload) + 64)

    # --- online resharding (docs/robustness.md "migration flow") ---------

    def _adopt_book(self, book: dict) -> None:
        """Adopt a book's ownership map.  A newer map epoch starts a
        migration wave: each key this server holds that the new map homes
        on another rank is shipped there.  A drain book leaves this
        server's rank out, so its wave ships every key, and then the
        server stops."""
        if not self.reshard or self.rank is None:
            return
        epoch, ranks = book.get("map_epoch"), book.get("server_ranks")
        if epoch is None or not ranks:
            return
        drain = bool(book.get("drain"))
        servers = [tuple(a) for a in (book.get("servers") or [])]
        with self._own_lock:
            cur = self._ownership
            if cur is not None and int(epoch) <= cur.epoch and not drain:
                return  # an older or repeated book
            new_map = OwnershipMap(ranks, epoch=int(epoch), vnodes=self.cfg.ring_vnodes,
                                   overrides=book.get("ring_overrides"))
            self._prev_ownership, self._ownership = cur, new_map
            self._map_epoch = max(self._map_epoch, new_map.epoch)
            self._peer_addrs = {int(r): servers[i] for i, r in enumerate(ranks)
                                if i < len(servers)}
            self._draining = {int(r) for r in book.get("draining") or ()}
        self._update_owned_gauge()
        # the wave dials peers and ships payloads: off the control thread
        self._spawn(self._migrate_wave, (new_map, drain), "ps-migrate")

    def _migrate_wave(self, new_map: OwnershipMap, drain: bool) -> None:
        """Ship every re-homed key to its new owner, one key at a time over
        one connection per destination.  A key is served as usual up to
        the instant of its snapshot and redirected after it.  A shipment
        that fails is tried again with backoff (on a scale-up the new
        owner may not accept yet); a scale-up wave gives up when a newer
        map supersedes it, a drain retries until the store is empty and
        only then stops the server: stopping with keys unshipped would
        lose them, so a server that cannot drain stays up, off the book
        and still authoritative."""
        t0 = time.monotonic()
        total_moved = total_bytes = 0
        failed = 0
        for attempt in range(120 if drain else 40):
            conns: Dict[int, socket.socket] = {}
            moved = failed = 0
            try:
                with self._keys_lock:
                    keys = sorted(self._keys)
                for key in keys:
                    if self._stop.is_set():
                        return
                    if self._ownership is not new_map and not drain:
                        return  # superseded: the newer map's wave owns it
                    with self._keys_lock:
                        ks = self._keys.get(key)
                    if ks is None:
                        continue
                    owner = (self._ownership or new_map).owner(key)
                    if owner == self.rank:
                        continue
                    nbytes = self._migrate_key(key, ks, owner, new_map.epoch, conns)
                    if nbytes is False:
                        failed += 1
                    elif nbytes is not None:
                        moved += 1
                        total_bytes += nbytes
            finally:
                for sock in conns.values():
                    close_socket(sock)
            total_moved += moved
            self._update_owned_gauge()
            if failed:
                _log(f"rank {self.rank} migration wave (map epoch {new_map.epoch}): "
                     f"{failed} keys not shipped yet, trying again")
            if not failed:
                break
            if self._stop.wait(min(2.0, 0.25 * (attempt + 1))):
                return
        wall = time.monotonic() - t0
        if total_moved or drain:
            _log(f"rank {self.rank} migration wave (map epoch {new_map.epoch}"
                 f"{', drain' if drain else ''}): shipped {total_moved} keys, {total_bytes} "
                 f"bytes in {wall * 1e3:.1f} ms")
        if drain and not self._stop.is_set():
            if failed:
                _log(f"rank {self.rank}: drain incomplete ({failed} keys not shipped); "
                     "staying up to keep their state")
                return
            _log(f"rank {self.rank} drained ({total_moved} keys, {total_bytes} bytes "
                 "shipped): stopping")
            self._sched_shutdown = True  # a deliberate exit, not a lost link
            self.stop()

    def _migrate_key(self, key: int, ks: _KeyState, owner: int, epoch: int,
                     conns: Dict[int, socket.socket]):
        """Ship one key's state to ``owner``: the bytes shipped, False when
        the shipment failed (this server stays authoritative), None when
        there was nothing to ship.  The snapshot and the tombstone are
        taken in one ``ks.lock`` section, so that every push lands before
        the snapshot (and ships in it) or is redirected after it."""
        addr = self._peer_addrs.get(owner)
        with ks.lock:
            if ks.migrated_to is not None:
                return None  # shipped by an earlier wave
            pend, ks.pending_pulls = ks.pending_pulls, []
            fusedw, ks.fused_waiters = ks.fused_waiters, []
            initw, ks.init_waiters = ks.init_waiters, []
            if ks.store is None:
                # nothing to ship (no init barrier completed here): the
                # parked waiters chase to the new owner and init there
                self._redirect_waiters(key, epoch, owner, pend, fusedw, initw)
                return None
            if addr is None:
                ks.pending_pulls, ks.fused_waiters, ks.init_waiters = pend, fusedw, initw
                counters().bump("migration_failed")
                return False
            dt = DataType(ks.dtype_id)
            meta = {
                "key": int(key),
                "epoch": int(epoch),
                "dtype": "bfloat16" if dt == DataType.BFLOAT16 else str(ks.store.dtype),
                "store_version": int(ks.store_version),
                "recv_count": int(ks.recv_count),
                "push_seen": {str(w): int(v) for w, v in ks.push_seen.items()},
                "init_done": {str(w): int(v) for w, v in ks.init_done.items()},
                "compressor_kwargs": dict(ks.compressor_kwargs),
                "async_mode": bool(ks.async_mode),
                "staleness": int(ks.staleness),
            }
            store_b = ks.store.tobytes()
            accum_b = ks.accum.tobytes() if ks.recv_count else b""
            meta["store_nbytes"], meta["accum_nbytes"] = len(store_b), len(accum_b)
            extra_b = b""
            if ks.opt_rule is not None:
                # the update rule's state moves with the store, its slots
                # as raw tails behind the accumulator
                blobs = ks.opt_rule.slot_bytes()
                meta.update(opt_rule=ks.opt_rule.name, opt_hp=dict(ks.opt_rule.hp),
                            opt_step=int(ks.opt_step),
                            opt_seeded=sorted(int(w) for w in ks.opt_seeded),
                            opt_slot_nbytes=[len(b) for b in blobs])
                extra_b = b"".join(blobs)
            ef = _ef_stage(ks.compressor)
            if ef is not None and ef.error is not None:
                # the server chain's error-feedback residual, behind the
                # rule's slots: the next compressed pull at the new owner
                # corrects by it as this server's would.  byteps_tpu's
                # install reads its slots from the tail's front and never
                # this field, so its chains restart at zero
                err_b = np.ascontiguousarray(ef.error, dtype=np.float32).tobytes()
                meta["ef_error_nbytes"] = len(err_b)
                extra_b += err_b
            # from here on a request is redirected: nothing can change the
            # state already serialized
            ks.migrated_to = owner
            ks.migrate_epoch = epoch
        self._redirect_waiters(key, epoch, owner, pend, fusedw, initw)
        body = encode_migrate_state(meta, store_b, accum_b) + extra_b
        t0 = time.monotonic()
        ok = False
        try:
            sock = conns.get(owner)
            if sock is None:
                sock = connect(addr[0], addr[1], timeout=self.cfg.migrate_deadline_s)
                sock.settimeout(max(1.0, self.cfg.migrate_deadline_s))
                conns[owner] = sock
            send_message(sock, Message(Op.MIGRATE_STATE, key=key, version=epoch,
                                       payload=body))
            resp = recv_message(sock)
            # status 3: the key is live there already (an earlier shipment
            # landed and its ack was lost): it is home, drop this copy
            ok = resp.op == Op.MIGRATE_STATE and resp.status in (0, 3)
        except (ConnectionError, OSError, ValueError, struct.error) as e:
            _log(f"rank {self.rank}: shipping key {key} to rank {owner} failed: {e!r}")
            close_socket(conns.pop(owner, None))
        if not ok:
            # this server stays authoritative; a later attempt ships it
            with ks.lock:
                ks.migrated_to = None
            counters().bump("migration_failed")
            return False
        with ks.lock:
            # keep the tombstone, free the bulk
            ks.store = ks.accum = None
            ks.push_seen, ks.init_done = {}, {}
            ks.pull_payload = ks.raw_payload = None
            ks.pull_version = ks.raw_version = -1
            ks.compressor = None
            ks.clear_rule()
        counters().bump("migration_keys_moved")
        metrics().observe("migration_key_seconds", time.monotonic() - t0)
        return len(body)

    @staticmethod
    def _redirect_waiters(key: int, epoch: int, owner: int, pending_pulls=(),
                          fused_waiters=(), init_waiters=()) -> None:
        """Answer the parked requests of a migrating key with WRONG_OWNER:
        their workers chase to the new owner rather than wait on state that
        just left."""
        payload = encode_wrong_owner(epoch, owner)
        targets = [(c, lk, sq) for _v, c, lk, sq, _w in pending_pulls]
        seen: set = set()
        for _v, reply, _slot, _w in fused_waiters:
            if id(reply) not in seen:
                seen.add(id(reply))
                if reply.abort():
                    targets.append((reply.conn, reply.send_lock, reply.seq))
        targets += [(c, lk, sq) for _wid, c, lk, sq, _tok in init_waiters]
        for conn, lock, seq in targets:
            try:
                send_message(conn, Message(Op.WRONG_OWNER, key=key, seq=seq, version=epoch,
                                           payload=payload), lock)
            except (ConnectionError, OSError):
                continue

    def _redirect_locked(self, key: int, ks: Optional[_KeyState]):
        """(epoch, owner) when a request for ``key`` must be redirected,
        else None; caller holds ``ks.lock``.  A key this server still holds
        is served even when the new map homes it elsewhere (its shipment
        carries those sums); a shipped key, and a key this server never
        held that the map homes elsewhere (a stale worker's), redirect.  A
        shipped key that a newer map homes here again (a drain sends it
        back) does not: its requests park until it lands."""
        if not self.reshard:
            return None
        omap = self._ownership
        if ks is not None and ks.migrated_to is not None:
            if (omap is not None and omap.epoch > ks.migrate_epoch
                    and omap.owner(key) == self.rank):
                return None  # a newer map homes it here again: it is on its way back
            return (ks.migrate_epoch, ks.migrated_to)
        if omap is None or self.rank is None:
            return None
        owner = omap.owner(key)
        if owner == self.rank or (ks is not None and ks.store is not None):
            return None
        return (omap.epoch, owner)

    def _send_wrong_owner(self, conn, send_lock, msg: Message, redirect) -> None:
        epoch, owner = redirect
        counters().bump("wrong_owner_served")
        send_message(conn, Message(Op.WRONG_OWNER, key=msg.key, seq=msg.seq, version=epoch,
                                   payload=encode_wrong_owner(epoch, owner)), send_lock)

    def _redirect_or_park_locked(self, key: int, ks: _KeyState, msg: Message, conn,
                                 send_lock) -> bool:
        """A push's or pull's gate, under ``ks.lock``: True when the request
        was answered WRONG_OWNER or parked on an inbound migration."""
        redirect = self._redirect_locked(key, ks)
        if redirect is not None:
            self._send_wrong_owner(conn, send_lock, msg, redirect)
            return True
        if ks.store is None and self._should_park(key):
            self._park_awaiting(key, msg, conn, send_lock)
            return True
        return False

    def _should_park(self, key: int) -> bool:
        """A request for a key this server does not hold parks when the map
        homes the key here and its previous owner is alive, so that its
        state is on the way; not when that owner left the map (nothing will
        come, and the worker's re-init path rebuilds the key), unless the
        book says it leaves by a drain, shipping its keys."""
        if not self.reshard or self.rank is None:
            return False
        omap = self._ownership
        if omap is None or omap.owner(key) != self.rank:
            return False
        prev = self._prev_ownership
        if prev is not None:
            old = prev.owner(key)
            if old != self.rank and old not in omap.ranks and old not in self._draining:
                return False
        return True

    def _park_awaiting(self, key: int, msg: Message, conn, send_lock) -> None:
        """Hold a request until its key's migration lands (taken again by
        :meth:`_handle_migrate`), or ``BYTEPS_MIGRATE_DEADLINE_S`` passes
        (the sweep closes its connection, into the worker's retry path)."""
        with self._awaiting_lock:
            self._awaiting.setdefault(key, []).append((time.monotonic(), msg, conn, send_lock))
            if self._awaiting_sweeper is None:
                self._awaiting_sweeper = threading.Thread(
                    target=self._awaiting_sweep_loop, name="ps-migrate-park", daemon=True)
                self._awaiting_sweeper.start()

    def _awaiting_sweep_loop(self) -> None:
        while not self._stop.wait(0.25):
            cutoff = time.monotonic() - max(0.5, self.cfg.migrate_deadline_s)
            doomed: List[tuple] = []
            with self._awaiting_lock:
                for key in list(self._awaiting):
                    keep = []
                    for entry in self._awaiting[key]:
                        (doomed if entry[0] < cutoff else keep).append(entry)
                    if keep:
                        self._awaiting[key] = keep
                    else:
                        del self._awaiting[key]
            for _t, _msg, conn, _lock in doomed:
                close_socket(conn)

    def _handle_migrate(self, msg: Message, conn, send_lock) -> None:
        """Op.MIGRATE_STATE: install one key's state from its old owner, ack
        it and take again the requests parked on the key.  The ack's
        status: 0 installed; 1 resharding is off here; 2 the sender's map
        is older than this server's and the key is homed elsewhere (the
        sender's next wave ships it right); 3 the key is live here already
        (a duplicate whose first ack was lost, or a stale copy): it is
        home.  A shipment of an older migration epoch than the key's last
        acks without touching newer state."""
        if not self.reshard:
            send_message(conn, Message(Op.MIGRATE_STATE, key=msg.key, seq=msg.seq, status=1),
                         send_lock)
            return
        try:
            meta, store_b, accum_b = decode_migrate_state(msg.payload)
            key = int(meta["key"])
            epoch = int(meta.get("epoch", msg.version))
            dtype_id = int(to_datatype(str(meta["dtype"])))
            extra_b = (decode_migrate_extra(msg.payload, meta)
                       if meta.get("opt_rule") or meta.get("ef_error_nbytes") else b"")
        except (KeyError, ValueError, TypeError, UnicodeDecodeError, struct.error):
            close_socket(conn)  # a malformed control frame
            return
        omap = self._ownership
        if (omap is not None and self.rank is not None and omap.epoch > epoch
                and omap.owner(key) != self.rank):
            send_message(conn, Message(Op.MIGRATE_STATE, key=key, seq=msg.seq, status=2),
                         send_lock)
            return
        ks = self._key_state(key)
        with ks.lock:
            home = ks.store is not None and ks.migrated_to is None
            if not home:
                self._install_migrated_locked(ks, epoch, dtype_id, meta, store_b, accum_b,
                                              extra_b)
        if home:
            send_message(conn, Message(Op.MIGRATE_STATE, key=key, seq=msg.seq, status=3),
                         send_lock)
            return
        counters().bump("migration_keys_received")
        send_message(conn, Message(Op.MIGRATE_STATE, key=key, seq=msg.seq), send_lock)
        with self._awaiting_lock:
            parked = self._awaiting.pop(key, [])
        for _t, m, c, lk in parked:
            # metered on arrival: the park does not charge the job twice
            self._enqueue(m, c, lk, metered=True)
        self._update_owned_gauge()

    def _install_migrated_locked(self, ks: _KeyState, epoch: int, dtype_id: int, meta: dict,
                                 store_b: bytes, accum_b: bytes, extra_b: bytes) -> None:
        """Install a shipped key state; caller holds ``ks.lock``."""
        from byteps_tpu_torch.compression.registry import apply_lr_to_chain, create_compressor

        prev_epoch = ks.migrate_epoch
        if epoch < prev_epoch:
            return  # a straggler of an older migration
        ks.migrated_to = None
        ks.migrate_epoch = epoch
        store_version = int(meta.get("store_version", 0))
        if not (ks.store is None or epoch > prev_epoch or store_version >= ks.store_version):
            return
        dt = storage_numpy_dtype(DataType(dtype_id))
        ks.dtype_id = dtype_id
        ks.store = np.frombuffer(store_b, dtype=dt).copy()
        ks.accum = (np.frombuffer(accum_b, dtype=dt).copy() if accum_b
                    else np.zeros_like(ks.store))
        ks.store_version = store_version
        ks.recv_count = int(meta.get("recv_count", 0))
        ks.push_seen = {int(w): int(v) for w, v in (meta.get("push_seen") or {}).items()}
        ks.init_done = {int(w): int(v) for w, v in (meta.get("init_done") or {}).items()}
        ks.compressor_kwargs = {str(k): str(v)
                                for k, v in (meta.get("compressor_kwargs") or {}).items()}
        if meta.get("async_mode"):
            ks.async_mode = True
            ks.staleness = max(-1, int(meta.get("staleness", -1)))
        ks.clear_rule()
        if meta.get("opt_rule"):
            # the rule again, its slots from the raw tail: the trajectory
            # goes on bitwise here
            rule = update_rules.make_rule(meta["opt_rule"], meta.get("opt_hp") or {},
                                          ks.store.size, ks.store.dtype)
            blobs, off = [], 0
            for nb in meta.get("opt_slot_nbytes") or ():
                blobs.append(extra_b[off: off + int(nb)])
                off += int(nb)
            rule.load_slot_bytes(blobs)
            ks.opt_rule = rule
            ks.opt_step = int(meta.get("opt_step", 0))
            ks.opt_seeded = {int(w) for w in (meta.get("opt_seeded") or ())}
        ks.compressor = None
        if ks.compressor_kwargs:
            ks.compressor = create_compressor(ks.compressor_kwargs, ks.store.size, server=True)
            apply_lr_to_chain(ks.compressor, self._ef_lr)
            ef = _ef_stage(ks.compressor)
            nb = int(meta.get("ef_error_nbytes") or 0)
            if ef is not None and nb == ks.store.size * 4:
                off = sum(int(b) for b in meta.get("opt_slot_nbytes") or ())
                ef.error = np.frombuffer(extra_b[off: off + nb], dtype=np.float32).copy()
        ks.pull_payload = ks.raw_payload = None
        ks.pull_version = ks.raw_version = -1

    def owned_keys(self) -> int:
        """The keys this server holds (not shipped away)."""
        with self._keys_lock:
            states = list(self._keys.values())
        return sum(1 for ks in states if ks.store is not None and ks.migrated_to is None)

    def _update_owned_gauge(self) -> None:
        """``server_owned_keys{rank}`` and ``server_map_epoch{rank}``."""
        if not self.reshard or self.rank is None:
            return
        labels = {"rank": str(self.rank)}
        metrics().gauge_set("server_owned_keys", self.owned_keys(), labels=labels)
        omap = self._ownership
        if omap is not None:
            metrics().gauge_set("server_map_epoch", omap.epoch, labels=labels)

    # --- serve plane -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if conn.family == socket.AF_INET:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = maybe_shape(conn)  # the reply direction of a shaped link
            with self._conns_lock:
                self._conns.append(conn)
            self._spawn(self._serve_conn, (conn,), "ps-serve")

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_message(conn)
                except (ChecksumError, LosslessError) as e:
                    # the connection goes, which fails the worker's pending
                    # requests into its retry path at once: a request
                    # dropped unanswered would wait for a deadline the
                    # worker may not arm
                    name = ("wire_lossless_fail" if isinstance(e, LosslessError)
                            else "wire_checksum_fail")
                    counters().bump(name, labels={
                        "side": "server", "op": getattr(e.op, "name", str(e.op))})
                    counters().bump("wire_checksum_conn_drop")
                    raise
                if msg.op in (Op.PUSH, Op.PULL, Op.INIT, Op.FUSED, Op.RESYNC_QUERY):
                    self._enqueue(msg, conn, send_lock)
                elif msg.op == Op.REGISTER_COMPRESSOR:
                    self._handle_register_compressor(msg, conn, send_lock)
                elif msg.op == Op.MIGRATE_STATE:
                    # a peer ships one key's state, and blocks on the ack
                    self._handle_migrate(msg, conn, send_lock)
                elif msg.op == Op.PING:
                    send_message(conn, Message(Op.PING, seq=msg.seq), send_lock)
                elif msg.op == Op.SHUTDOWN:
                    send_message(conn, Message(Op.SHUTDOWN, seq=msg.seq), send_lock)
                    return
                else:
                    raise UnsupportedFrameError(f"unexpected {msg.op.name} request")
        except (ChecksumError, LosslessError, UnsupportedFrameError) as e:
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
            ks.compressor_kwargs = kwargs
            apply_lr_to_chain(ks.compressor, self._ef_lr)
        send_message(conn, Message(Op.REGISTER_COMPRESSOR, seq=msg.seq), send_lock)

    def _key_state(self, key: int) -> _KeyState:
        with self._keys_lock:
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState(job_of_key(key))
            return ks

    def _enqueue(self, msg: Message, conn, send_lock, metered: bool = False) -> None:
        """Queue a request on its key's engine thread.  A tenant's request
        is counted (``server_job_requests{job}``, ``server_job_bytes{job}``)
        and, past its job's quota, deferred on this connection's serve
        thread first (``job_quota_deferred{job}``): backpressure, as a
        slower link would give, and never a drop.  An INIT never waits;
        ``metered`` requests (taken again from a migration park) were
        counted on arrival."""
        ks = self._key_state(msg.key)
        ks.req_bytes += len(msg.payload)  # the hot report's load
        job = ks.job
        if job and not metered:
            labels = {"job": str(job)}
            counters().bump("server_job_requests", labels=labels)
            counters().bump("server_job_bytes", len(msg.payload), labels=labels)
            bucket = self._job_quota.get(job)
            if bucket is not None and msg.op != Op.INIT:
                delay = bucket.reserve(len(msg.payload))
                if delay > 0:
                    counters().bump("job_quota_deferred", labels=labels)
                    if self._stop.wait(delay):
                        return
        with self._tid_lock:
            tid = self._tid_cache.get(msg.key)
            if tid is None:
                tid = self._tid_cache[msg.key] = int(np.argmin(self._tid_load))
            self._tid_load[tid] += len(msg.payload)
        # the wall-clock stamp bounds the "recv" child span: the queue's
        # wait is part of what the worker sees
        self._queues[tid].put((msg, conn, send_lock, time.time()),
                              job=job if self._qos_active else 0, cost=len(msg.payload))

    # --- engine plane ----------------------------------------------------

    _HANDLERS = {Op.INIT: "_handle_init", Op.PUSH: "_handle_push", Op.PULL: "_handle_pull",
                 Op.FUSED: "_handle_fused", Op.RESYNC_QUERY: "_handle_resync"}

    def _engine_loop(self, q: _EngineQueue) -> None:
        while not self._stop.is_set():
            item = q.get(timeout=0.2)
            if item is None:
                continue
            msg, conn, send_lock, t_enq = item
            try:
                if msg.op in (Op.PUSH, Op.PULL, Op.FUSED):
                    getattr(self, self._HANDLERS[msg.op])(msg, conn, send_lock, t_enq)
                else:
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
        store, a malformed block) is refused with status 1.  The barrier
        holds the INITs of the key's job's workers."""
        n, dtype_id = struct.unpack_from("!QI", msg.payload, 0)
        profile, staleness = decode_init_profile(msg.payload)
        rule = None
        if profile & PROFILE_SERVER_OPT:
            try:
                name, hp_raw = decode_server_opt_block(msg.payload, RULE_BLOCK_OFFSET)
                rule = (name, update_rules.parse_hp(hp_raw))
            except ValueError as e:
                self._reject_server_opt(msg, conn, send_lock, e)
                return
        ks = self._key_state(msg.key)
        created = False
        with ks.lock:
            # atomic with the wave's snapshot and tombstone: a key homed
            # elsewhere is never created here
            redirect = self._redirect_locked(msg.key, ks)
            if redirect is not None:
                self._send_wrong_owner(conn, send_lock, msg, redirect)
                return
            if ks.store is None and ks.migrated_to is not None and self._should_park(msg.key):
                # the key's state is on its way back here
                self._park_awaiting(msg.key, msg, conn, send_lock)
                return
            ks.async_mode = bool(profile & PROFILE_ASYNC)
            ks.staleness = max(-1, int(staleness)) if ks.async_mode else -1
            if ks.store is None:
                created = True
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
        if created:
            self._update_owned_gauge()
        if waiters:
            self._release_init_waiters(msg.key, waiters)

    def _complete_init_barrier_locked(self, ks: _KeyState) -> Optional[List[tuple]]:
        """When the key's init barrier holds the INIT of each of its job's
        workers, consume it and restart the key's rounds; the waiters to
        release, or None.  Caller holds ``ks.lock``."""
        if not 0 < self._workers_for_ks(ks) <= len(ks.init_waiters):
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
        (a worker that never pushed counts 0): of the key's job's workers
        when the book lists them.  Caller holds ``ks.lock``."""
        flags = self._job_workers.get(ks.job)
        if flags:
            return min(ks.push_seen.get(w, 0) for w in flags)
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
        if ks.recv_count < self._workers_for_ks(ks):
            return 0.0
        p0 = time.time()
        flush.extend(self._publish_round_locked(ks))
        return time.time() - p0

    def _push_args(self, ks: _KeyState, msg: Message) -> tuple:
        """(compressed, raw array or None) of a push to ``ks``."""
        rtype, dtype_id = decode_command_type(msg.cmd)
        if rtype == RequestType.ROW_SPARSE_PUSH_PULL:
            raise RuntimeError("row-sparse members cannot fuse")
        if ks.store is None:
            raise RuntimeError(f"push for uninitialized key {msg.key}")
        compressed = rtype == RequestType.COMPRESSED_PUSH_PULL
        if compressed and ks.compressor is None:
            raise RuntimeError(f"compressed push for key {msg.key}, which has "
                               "no registered compressor")
        return compressed, None if compressed else np.frombuffer(msg.payload,
                                                                 dtype=ks.store.dtype)

    @staticmethod
    def _parse_rowsparse(ks: _KeyState, payload: bytes, with_values: bool) -> tuple:
        """(row length, total rows, int64 indices, rows or None) of a
        row-sparse body: ``!II`` (rows, row length), the rows' big-endian
        u32 indices and, in a push, the rows in the key's dtype.  Raises
        when the row length does not divide the store or an index is out
        of range."""
        nrows, row_len = struct.unpack_from("!II", payload, 0)
        if row_len == 0 or ks.store.size % row_len:
            raise RuntimeError(f"rowsparse row_len {row_len} does not divide store size "
                               f"{ks.store.size}")
        total_rows = ks.store.size // row_len
        idx = np.frombuffer(payload, dtype=">u4", count=nrows, offset=8).astype(np.int64)
        if nrows and int(idx.max()) >= total_rows:
            raise RuntimeError(f"rowsparse index {int(idx.max())} >= {total_rows} rows")
        vals = None
        if with_values:
            vals = np.frombuffer(payload, dtype=ks.store.dtype, count=nrows * row_len,
                                 offset=8 + 4 * nrows).reshape(nrows, row_len)
        return row_len, total_rows, idx, vals

    def _sum_rowsparse_locked(self, ks: _KeyState, msg: Message, flush: List) -> float:
        """A row-sparse push under ``ks.lock``: its rows scatter-summed into
        the round's accumulator (the round's first push zeroes it, so the
        rows no worker pushed are 0), or into an async key's store;
        duplicate indices accumulate.  Returns the seconds spent
        publishing the round it closed."""
        if ks.store is None:
            raise RuntimeError(f"push for uninitialized key {msg.key}")
        row_len, total_rows, idx, vals = self._parse_rowsparse(ks, msg.payload, True)
        if self._is_replayed_push_locked(ks, msg):
            return 0.0  # the original push's rows landed: ack only
        if self._async_ks(ks):
            np.add.at(ks.store.reshape(total_rows, row_len), idx, vals)
            ks.store_version += 1
            self._record_push_locked(ks, msg)
            self.stats.bump("pushes_summed")
            flush.extend(self._drain_waiters_locked(
                ks, lambda v: self._staleness_ready_locked(ks, v), async_mode=True))
            return 0.0
        if ks.recv_count == 0:
            ks.accum[:] = 0
        np.add.at(ks.accum.reshape(total_rows, row_len), idx, vals)
        ks.recv_count += 1
        self._record_push_locked(ks, msg)
        self.stats.bump("pushes_summed")
        if ks.recv_count < self._workers_for_ks(ks):
            return 0.0
        p0 = time.time()
        flush.extend(self._publish_round_locked(ks))
        return time.time() - p0

    def _wire_reply(self, ks: _KeyState, wants, async_mode: bool) -> bytes:
        """What a pull receives: a row-sparse pull (``wants`` its request
        body) the rows it names, gathered from the store; a dense one the
        store in the format it asked for."""
        if isinstance(wants, (bytes, bytearray)):
            row_len, total_rows, idx, _ = self._parse_rowsparse(ks, wants, False)
            return ks.store.reshape(total_rows, row_len)[idx].tobytes()
        return ks.wire_payload(wants, async_mode)

    def _observe_push(self, t_start: float, published: float) -> float:
        """Observe the push's sum, less the publish of the round it closed,
        and the publish; the sum's seconds."""
        sum_s = max(0.0, time.time() - t_start - published)
        metrics().observe("server_sum_seconds", sum_s)
        if published:
            metrics().observe("server_publish_seconds", published)
        return sum_s

    def _child_span(self, trace, key: int, name: str, t0: float, dur: float,
                    **extra) -> None:
        """A server-side child of a worker's span: the frame's trace id,
        parented on the frame's span id (``trace`` is that pair; nothing
        for an untraced frame or with the tracer off)."""
        if trace is None or not (self.tracer.enabled and self.tracer.spans_enabled):
            return
        self.tracer.record_span(f"key{key}", name, t0, dur,
                                span_args(trace[0], new_trace_id(), parent_id=trace[1],
                                          **extra))

    def _handle_push(self, msg: Message, conn, send_lock,
                     t_enq: Optional[float] = None) -> None:
        t_start = time.time()
        if t_enq is not None:
            # the wait in the engine queue
            self._child_span(msg.trace, msg.key, "recv", t_enq, t_start - t_enq)
        ks = self._key_state(msg.key)
        rowsparse = decode_command_type(msg.cmd)[0] == RequestType.ROW_SPARSE_PUSH_PULL
        flush: List = []
        with ks.lock:
            if self._redirect_or_park_locked(msg.key, ks, msg, conn, send_lock):
                return
            dedupe = not rowsparse and _summed_already(ks, msg)
            if rowsparse:
                published = self._sum_rowsparse_locked(ks, msg, flush)
            else:
                compressed, arr = self._push_args(ks, msg)
                published = self._apply_push_locked(ks, msg, compressed, arr, flush)
        sum_s = self._observe_push(t_start, published)
        self._child_span(msg.trace, msg.key, "sum", t_start, sum_s, dedupe=dedupe)
        t_summed = t_start + sum_s
        if published:
            self._child_span(msg.trace, msg.key, "publish", t_summed, published)
            t_summed += published
        self._send_reply(conn, Message(Op.PUSH, key=msg.key, seq=msg.seq,
                                       version=msg.version), send_lock)
        self._child_span(msg.trace, msg.key, "reply", t_summed, time.time() - t_summed)
        self._flush_pulls(msg.key, flush)

    def _handle_fused(self, msg: Message, conn, send_lock,
                      t_enq: Optional[float] = None) -> None:
        """A FUSED frame: every member goes through the push path under its
        key's lock (the same replay ledger, publish and rule), and its pull
        half is answered into the frame's one reply at once when its round
        is out (async: when within the staleness bound), or parked on the
        key until then.  A member's sum and publish spans are children of
        the member's own span (the frame's trailer), else of the pack's;
        no reply span: the one reply leaves with the last member's round."""
        members = decode_fused_push(msg.payload)
        if not members:
            raise RuntimeError("empty fused frame")
        member_spans = decode_fused_spans(msg.payload) if msg.trace else None
        if t_enq is not None:
            self._child_span(msg.trace, msg.key, "recv", t_enq, time.time() - t_enq,
                             keys=len(members))
        reply = _FusedReply(conn, send_lock, msg.seq, msg.key, [m[0] for m in members])
        for slot, (key, cmd, version, payload) in enumerate(members):
            t_start = time.time()
            sub = Message(Op.PUSH, key=key, payload=payload, cmd=cmd, version=version,
                          flags=msg.flags)
            ks = self._key_state(key)
            flush: List = []
            with ks.lock:
                redirect = self._redirect_locked(key, ks)
                park = redirect is None and ks.store is None and self._should_park(key)
                if redirect is not None or park:
                    # the frame is answered once, as a whole: the members
                    # summed so far are in the replay ledger, which their
                    # per-key resends (the worker's unfused fallback, or
                    # this frame parked and taken again) meet as replays
                    if reply.abort():
                        if redirect is not None:
                            self._send_wrong_owner(conn, send_lock, msg, redirect)
                        else:
                            self._park_awaiting(key, msg, conn, send_lock)
                    return
                compressed, arr = self._push_args(ks, sub)
                dedupe = _summed_already(ks, sub)
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
            sum_s = self._observe_push(t_start, published)
            if msg.trace is not None:
                member = (msg.trace[0], member_spans[slot] if member_spans is not None
                          else msg.trace[1])
                self._child_span(member, key, "sum", t_start, sum_s, dedupe=dedupe,
                                 fused=True)
                if published:
                    self._child_span(member, key, "publish", t_start + sum_s, published,
                                     fused=True)
            self._flush_pulls(key, flush)

    def _publish_round_locked(self, ks: _KeyState) -> List:
        """Every worker pushed: publish the round and collect the answers it
        releases (server.cc:348-375).  A key with an update rule publishes
        parameters: its seed round adopts the pushed ones, every later round
        applies the rule once to the raw sum.  Caller holds ``ks.lock``; the
        payloads are built under it, before a next round can swap the
        buffers."""
        if ks.opt_rule is not None and ks.opt_step > 0:
            ks.opt_rule.apply(ks.store, ks.accum, self._workers_for_ks(ks), ks.opt_step)
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
                flush.append((pconn, plock, pseq, self._wire_reply(ks, wants, async_mode),
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
        """Answer the released pulls and completed fused frames; a dead
        puller does not hold up the rest.  Under QoS each reply goes
        through its connection's writer."""
        for entry in flush:
            try:
                if isinstance(entry, _FusedReply):
                    if self._qos_active:
                        self._submit_reply(entry.conn, entry.send,
                                           sum(len(s) for s in entry.slots if s) + 64)
                    else:
                        entry.send()
                    continue
                pconn, plock, pseq, payload, ver = entry
                self._send_reply(pconn, Message(Op.PULL, key=key, payload=payload,
                                                seq=pseq, version=ver), plock)
            except (ConnectionError, OSError):
                continue

    def _handle_resync(self, msg: Message, conn, send_lock) -> None:
        """Op.RESYNC_QUERY: per key asked (every key when none), the store's
        version, the newest version of the asking worker's pushes the
        replay ledger holds (``seen``), the round's pushes so far.  A read:
        the worker's replayed pushes take the ordinary PUSH path.  A body
        that does not decode drops the connection (the engine loop).  A
        ``resync`` child span joins the worker's heal."""
        t0 = time.time()
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
        self._child_span(msg.trace, msg.key, "resync", t0, time.time() - t0, keys=len(out))

    def _handle_pull(self, msg: Message, conn, send_lock,
                     t_enq: Optional[float] = None) -> None:
        """A pull: answered at once when its round is out (async: within
        the staleness bound), else parked until the publish answers it
        (the worker's PULL span covers the wait: no server span for it)."""
        if t_enq is not None:
            self._child_span(msg.trace, msg.key, "recv", t_enq, time.time() - t_enq)
        rtype, _ = decode_command_type(msg.cmd)
        wants = (bytes(msg.payload) if rtype == RequestType.ROW_SPARSE_PUSH_PULL
                 else rtype == RequestType.COMPRESSED_PUSH_PULL)
        ks = self._key_state(msg.key)
        with ks.lock:
            if self._redirect_or_park_locked(msg.key, ks, msg, conn, send_lock):
                return
            if ks.store is None:
                raise RuntimeError(f"pull for uninitialized key {msg.key}")
            if wants is True and ks.compressor is None:
                raise RuntimeError(f"compressed pull for key {msg.key}, which has "
                                   "no registered compressor")
            is_async = self._async_ks(ks)
            if not (self._staleness_ready_locked(ks, msg.version) if is_async
                    else msg.version <= ks.store_version):
                ks.pending_pulls.append((msg.version, conn, send_lock, msg.seq, wants))
                if is_async:
                    self.stats.bump("pulls_parked")
                return
            payload = self._wire_reply(ks, wants, is_async)
            ver = ks.store_version
        t_ready = time.time()
        self._send_reply(conn, Message(Op.PULL, key=msg.key, payload=payload,
                                       seq=msg.seq, version=ver), send_lock)
        self._child_span(msg.trace, msg.key, "reply", t_ready, time.time() - t_ready)


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
RECOVERY_COUNTERS = ("push_dedup", "init_replay_ack", "migration_keys_moved",
                     "migration_keys_received", "migration_failed", "wrong_owner_served",
                     "native_wrong_owner", "wire_checksum_fail",
                     "wire_checksum_conn_drop", "chaos_drop", "chaos_delay",
                     "chaos_disconnect", "chaos_truncate", "chaos_corrupt",
                     "chaos_payload_corrupt", "native_push_dedup", "native_init_replay_ack",
                     "native_resync_query", "native_checksum_fail", "sched_reconnect",
                     "sched_rejoin", "sched_stale_book")


#: a Python server's per-job series its stop report carries
JOB_COUNTERS = ("server_job_requests", "server_job_bytes", "job_quota_deferred")


def job_series(node) -> Dict[str, Dict[str, float]]:
    """``{job: {series: value}}``: the process's job-labelled counters of
    :data:`JOB_COUNTERS` and the ``server_job_quota_mbps`` gauges the
    node's books set (the C++ engine's wrapper adopts the books' job map
    too, though its engine refuses job keys)."""
    out: Dict[str, Dict[str, float]] = {}
    raw = counters().labeled_raw()
    for name in JOB_COUNTERS:
        for key, v in raw.get(name, {}).items():
            job = dict(key).get("job")
            if job is not None:
                out.setdefault(job, {})[name] = v
    for job, q in sorted(getattr(node, "_job_qos", {}).items()):
        if job and q["quota_mbps"] > 0:
            out.setdefault(str(job), {})["server_job_quota_mbps"] = q["quota_mbps"]
    return out


def stop_report(node) -> List[str]:
    """A stopped server's log lines: the pushes it summed into rounds
    (the Python engine adds the async pulls it parked and the update rules
    it applied), each histogram's count, sum, p50 and p99 (seconds), its
    recovery counters that are not 0, and, when a job other than 0 was
    seen, a line of each job's series (``rank R job J name=value ...``)."""
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
    ] + [f"rank {node.rank} job {job} " + " ".join(f"{k}={v!r}" for k, v in sorted(vals.items()))
         for job, vals in sorted(job_series(node).items(), key=lambda kv: int(kv[0]))]


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
    """Process entry: become the scheduler or a server per DMLC_ROLE.  A
    SIGUSR1 dumps every thread's stack to stderr (a launcher's view of a
    stalled node)."""
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    cfg = Config.from_env()
    check_unported_env()
    if cfg.role == "scheduler":
        node = Scheduler(cfg.num_worker, cfg.num_server, port=cfg.ps_root_port)
        node.start()
        # with DMLC_PS_ROOT_PORT=0 the port is the kernel's choice: a
        # launcher reads it here
        print(f"BYTEPS_SCHEDULER_PORT={node.port}", flush=True)
    elif cfg.role == "server":
        if cfg.server_native and shaping_enabled():
            # the C++ engine's replies would bypass the shaper: a link shaped
            # one way only; the reference runs the Python engine, warned
            warn_native_bypass_once("ignoring BYTEPS_SERVER_NATIVE=1, using the Python engine")
            node = PSServer(cfg, host=cfg.node_host or "127.0.0.1")
        elif cfg.server_native:
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
