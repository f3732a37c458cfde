"""The C++ data plane behind the port's control shell
(``byteps_tpu.server.server.NativePSServer``).

The engine of ``native/csrc/ps_server.cc`` owns the worker-facing socket:
framing, the CRC32C, KV rounds, the codecs and the sums, on its own
threads with no interpreter lock (``BYTEPS_SERVER_STRIPES`` reducer lanes,
read from the environment).  This wrapper does what the Python server's
control plane does: it registers with the scheduler, passes the bring-up
barrier, heartbeats, follows the scheduler's books and rejoins a restarted
scheduler, with ``PSServer``'s own methods borrowed unbound.  A resize or
eviction book sets the engine's worker count and its zombie fence
(``bps_native_server_set_num_workers``,
``bps_native_server_set_live_workers``); SHUTDOWN stops the engine.
The engine's counters and histograms reach ``core/telemetry.py`` through
the registry's provider seam.  Selected by ``BYTEPS_SERVER_NATIVE=1``.

The engine serves fused frames (Op.FUSED) and, under
``BYTEPS_ENABLE_ASYNC=1``, runs every key async (a cumulative store, pulls
answered from it at once).  It refuses an INIT with a per-key async or a
server-side optimizer profile with status 1 and counts it
(``native_async_reject``, ``native_server_opt_reject``), and answers any
request for a key with job bits (a tenant's namespace, docs/async.md) with
a status-1 echo (``native_job_reject``); the worker raises with the reason
(``comm/ps_client.py``), and nothing falls back to the Python engine.  The
books' ``jobs`` map is adopted all the same, for observability: the
quotas' ``server_job_quota_mbps{job}`` gauges and the stop report's job
lines.

Under ``BYTEPS_ELASTIC_RESHARD=1`` each book's ring goes into the engine
(``bps_native_server_set_ownership``), which then answers WRONG_OWNER for
a key the map homes elsewhere (``native_wrong_owner``).  The engine cannot
export or import key state, so it neither ships nor receives a
migration, and it refuses a drain book loudly: the server stays up, off
the book and still authoritative for what it holds.  For the same reason
it is never a rebalance end of the autotuner: its heartbeats carry the
metric deltas and the flight tail but no hot report, and a book's
``ring_overrides`` are noted (and reported on a rejoin) but the engine's
ownership check stays the ring's, with a warning.

The engine answers Op.RESYNC_QUERY from its own replay ledger
(``native_resync_query``) and acks a replayed INIT from its barrier's
token record (``native_init_replay_ack``), so a worker heals in place
against it as against the Python engine.  ``BYTEPS_VAN=uds|shm`` starts
the engine on a Unix socket (``bps_native_server_start_unix``; with shm
its connections move payloads through the rings of ``comm/shm_ring.py``)
and publishes a ``unix://`` or ``shm+unix://`` address.  Under
``BYTEPS_VAN=chaos:<van>`` it publishes a ``chaos+`` address: the workers
fault their own side, the engine's replies stay clean.  The engine
scatter-sums row-sparse pushes, and decodes lossless frames, in C++.

Under ``BYTEPS_TRACE_ON`` the engine records the Python server's child
spans (recv, sum, publish, reply, resync) of traced frames into its ring,
and a thread of this wrapper drains it every 0.1 s into the server's
tracer, tagged ``engine: "native"``, each reducer stripe on a track of its
own (``stripe<n>``; a serve or control thread's on the key's row); the
stop drains what is left and flushes to ``BYTEPS_TRACE_DIR/server<rank>``.
``BYTEPS_METRICS_PORT`` serves the process registry, the engine's
histograms included.
"""

from __future__ import annotations

import ctypes
import os
import socket
import sys
import threading
from typing import Dict, List, Optional

from byteps_tpu_torch.common.config import Config, check_unported_env, resolve_node_uid
from byteps_tpu_torch.comm.chaos import CHAOS_PREFIX
from byteps_tpu_torch.comm.shaping import shaping_enabled, warn_native_bypass_once
from byteps_tpu_torch.comm.transport import close_socket
from byteps_tpu_torch.comm.van import SHM_PREFIX, UNIX_PREFIX, check_shm_arch, new_socket_path
from byteps_tpu_torch.core.telemetry import metrics
from byteps_tpu_torch.core.tracing import new_trace_id, span_args
from byteps_tpu_torch.server.server import (
    PSServer,
    init_tuning_state,
    server_tracer,
    summarize_histograms,
)

#: the engine's histograms a stop report summarizes (merged over keys)
NATIVE_HISTOGRAMS = ("native_server_sum_seconds", "native_server_publish_seconds")


class NativePSServer:
    def __init__(self, cfg: Config, host: str = "127.0.0.1") -> None:
        from byteps_tpu_torch.native import get_lib, native_server_histograms

        check_unported_env()
        if shaping_enabled():
            # built directly under the shaping knobs: the engine's replies
            # bypass the shaper, and the link is shaped one way only
            warn_native_bypass_once("NativePSServer responses bypass the shaper (half-shaped link)")
        self._lib = get_lib()
        self.cfg = cfg
        # under BYTEPS_VAN=chaos:<van> the engine's listener stays plain
        # and the published address carries the chaos prefix, so the
        # workers that dial it wrap their side in the fault layer
        van = os.environ.get("BYTEPS_VAN") or "tcp"
        chaos = van.startswith("chaos:")
        if chaos:
            van = van[len("chaos:"):]
        if van not in ("tcp", "uds", "shm"):
            raise ValueError(f"BYTEPS_VAN={van!r}: the native engine speaks tcp | uds | "
                             "shm (or chaos:<one of them>)")
        if van == "tcp":
            self.host = host
            self.port = self._id = self._lib.bps_native_server_start(
                0, cfg.num_worker, int(cfg.enable_async))
        else:
            if van == "shm":
                check_shm_arch()
            path = new_socket_path("native")
            self._id = self._lib.bps_native_server_start_unix(
                path.encode(), cfg.num_worker, int(cfg.enable_async), int(van == "shm"))
            self.host = (SHM_PREFIX if van == "shm" else UNIX_PREFIX) + path
            self.port = 0
        if self._id < 0:
            raise RuntimeError(f"bps_native_server_start failed (van {van})")
        if chaos:
            self.host = CHAOS_PREFIX + self.host
        self.rank: Optional[int] = None
        self.num_workers = cfg.num_worker
        self.node_uid = resolve_node_uid()
        self._live_worker_flags: Optional[set] = None
        self.sched_incarnation = 0
        self.membership_epoch = 0
        self._map_epoch = 0
        self._sched_shutdown = False
        #: a drain book came, and was refused
        self.drain_refused = False
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        self._threads: List[threading.Thread] = []
        self._sched_conn: Optional[socket.socket] = None
        # the books' job map, adopted for observability only (the engine
        # refuses job keys)
        self._job_workers: Dict[int, set] = {}
        self._job_qos: Dict[int, dict] = {}
        self._job_quota: Dict[int, object] = {}
        self._qos_active = False
        sid = self._id
        self._hist_provider = lambda: native_server_histograms(sid)
        metrics().register_hist_provider(self._hist_provider)
        #: (pushes, rounds, histograms, counters) frozen when the engine stops
        self._final: Optional[tuple] = None
        init_tuning_state(self)
        self._warned_overrides = False
        self._metrics_http = None
        self.tracer = server_tracer(cfg)
        from byteps_tpu_torch.core.flightrec import ensure_process_recorder
        from byteps_tpu_torch.native import native_server_set_trace

        ensure_process_recorder(cfg, context_fn=self._flight_context, tracer=self.tracer)
        traced = cfg.trace_on and cfg.trace_spans
        native_server_set_trace(sid, traced)
        self._span_drain_thread: Optional[threading.Thread] = None
        if traced:
            self._span_drain_thread = threading.Thread(
                target=self._span_drain_loop, name="bps-native-span-drain", daemon=True)
            self._span_drain_thread.start()

    # the control plane of the Python server: these touch only the state
    # both classes carry (cfg, host, port, uid, rank, num_workers, the
    # scheduler connection and the membership fields, the stop event and
    # the thread list)
    _register_with_scheduler = PSServer._register_with_scheduler
    _sched_register_once = PSServer._sched_register_once
    _fence_book = PSServer._fence_book
    _note_book = PSServer._note_book
    _handle_control = PSServer._handle_control
    _control_plane_loop = PSServer._control_plane_loop
    _sched_reconnect = PSServer._sched_reconnect
    _spawn = PSServer._spawn
    _flight_context = PSServer._flight_context
    _adopt_jobs = PSServer._adopt_jobs
    # the tuning section is noted (and reported on a rejoin); with no
    # _hot_report the borrowed loop sends no hot report
    _adopt_tuning = PSServer._adopt_tuning
    _serve_metrics = PSServer._serve_metrics
    _stop_observing = PSServer._stop_observing

    def _drain_spans_once(self) -> int:
        """Record the engine's buffered child spans on the tracer; the count
        taken.  The children's own ids are minted here (nothing refers to
        them: they parent on the workers' span ids)."""
        from byteps_tpu_torch.native import (
            NATIVE_SPAN_KINDS,
            SPAN_FLAG_DEDUPE,
            SPAN_FLAG_FUSED,
            native_server_drain_spans,
        )

        recs = native_server_drain_spans(self._id)
        for rec in recs:
            kind = int(rec["kind"])
            name = NATIVE_SPAN_KINDS[kind] if 0 <= kind < len(NATIVE_SPAN_KINDS) else f"kind{kind}"
            flags = int(rec["flags"])
            extra = {"engine": "native", "key": int(rec["key"])}
            if name == "sum":
                extra["dedupe"] = bool(flags & SPAN_FLAG_DEDUPE)
            if flags & SPAN_FLAG_FUSED:
                extra["fused"] = True
            stripe = int(rec["stripe"])
            if stripe >= 0:
                track = f"stripe{stripe}"
                extra["stripe"] = stripe
            else:
                track = f"key{int(rec['key'])}"
            self.tracer.record_span(track, name, float(rec["ts"]), float(rec["dur"]),
                                    span_args(int(rec["trace"]), new_trace_id(),
                                              parent_id=int(rec["parent"]), **extra))
        return len(recs)

    def _span_drain_loop(self) -> None:
        while not self._stop.wait(0.1):
            self._drain_spans_once()

    def _adopt_book(self, book: dict) -> None:
        """Hand a book's ownership map to the engine: the ring's sorted
        (point, rank) pairs, this server's rank and the map epoch.  A drain
        book is refused (stopping would lose every key held)."""
        if not self.cfg.elastic_reshard or self.rank is None:
            return
        epoch, ranks = book.get("map_epoch"), book.get("server_ranks")
        if epoch is None or not ranks:
            return
        if book.get("drain"):
            print(f"byteps_tpu_torch server: native server rank {self.rank} received a "
                  "drain book but the C++ engine cannot migrate state: staying up to keep "
                  "it (run Python-engine servers with BYTEPS_ELASTIC_RESHARD)",
                  file=sys.stderr, flush=True)
            self.drain_refused = True
            return
        if book.get("ring_overrides") and not self._warned_overrides:
            # the C++ ownership check is the ring alone: an override would
            # need state the engine cannot ship or take, and a tuned fleet
            # never makes this server a rebalance end (it sends no report)
            self._warned_overrides = True
            print(f"byteps_tpu_torch server: native server rank {self.rank}: the book's "
                  "ring_overrides (autotune rebalance) are not honoured by the C++ engine; "
                  "run Python-engine servers for the rebalance", file=sys.stderr, flush=True)
        from byteps_tpu_torch.common.hashing import HashRing
        from byteps_tpu_torch.native import set_server_ownership

        set_server_ownership(self._id, int(self.rank), int(epoch),
                             HashRing(ranks, vnodes=self.cfg.ring_vnodes).points())
        self._map_epoch = max(self._map_epoch, int(epoch))

    def update_num_workers(self, n: int) -> None:
        """A resized worker count, in the engine (which completes the rounds
        that now hold enough pushes)."""
        self.num_workers = n
        self._lib.bps_native_server_set_num_workers(self._id, n)

    def _adopt_worker_ranks(self, book: dict) -> None:
        """The zombie fence from a book, in the engine (a book with no rank
        list turns it off)."""
        PSServer._adopt_worker_ranks(self, book)  # type: ignore[arg-type]
        flags = self._live_worker_flags
        if flags is None:
            self._lib.bps_native_server_set_live_workers(self._id, None, -1)
            return
        arr = (ctypes.c_uint8 * max(1, len(flags)))(*sorted(flags))
        self._lib.bps_native_server_set_live_workers(self._id, arr, len(flags))

    def start(self, register: bool = True) -> None:
        self._serve_metrics()
        if register:
            try:
                self._register_with_scheduler()
            except (ConnectionError, OSError):
                if not self._stop.is_set():
                    raise
                return
            # the scheduler's book wins over the launch-time environment
            self._lib.bps_native_server_set_num_workers(self._id, self.num_workers)

    def native_counters(self) -> Dict[str, int]:
        """The engine's ``native_*`` counters (empty once stopped)."""
        from byteps_tpu_torch.native import native_server_counters

        return native_server_counters(self._id)

    def _read_stats(self) -> tuple:
        """(pushes summed, rounds published, histogram summaries) from the
        engine.  It counts neither: every push observes its key's sum
        histogram (a replayed one too, counted apart as
        ``native_push_dedup``), so a key's rounds are its pushes over the
        worker count.  The publish histogram is not a count of rounds: the
        engine times a publish on the epoch clock in double seconds (a
        step of ~240 ns) and skips one that reads 0 (ROADMAP.md Queue 3)."""
        from byteps_tpu_torch.native import native_server_histograms

        recs = native_server_histograms(self._id)
        per_key = [int(r["count"]) for r in recs if r.get("name") == NATIVE_HISTOGRAMS[0]]
        hists = summarize_histograms(
            {n: [r for r in recs if r.get("name") == n] for n in NATIVE_HISTOGRAMS})
        pushes = sum(per_key) - self.native_counters().get("native_push_dedup", 0)
        rounds = sum(c // max(1, self.num_workers) for c in per_key)
        return pushes, rounds, hists

    def final_counters(self) -> Dict[str, int]:
        """The engine's ``native_*`` counters, frozen when it stopped."""
        return self._final[3] if self._final is not None else self.native_counters()

    def pushes_and_rounds(self) -> tuple:
        return (self._final or self._read_stats())[:2]

    def histograms(self) -> Dict[str, dict]:
        return (self._final or self._read_stats())[2]

    def stop(self) -> None:
        """Stop the engine (once): its histograms are folded into the
        registry and its totals frozen for the stop report first."""
        self._stop.set()
        self._stop_observing()
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._final = (*self._read_stats(), self.native_counters())
            metrics().absorb_hist_provider(self._hist_provider)
            if self._span_drain_thread is not None:
                self._span_drain_thread.join(timeout=2.0)
                self._span_drain_thread = None
            # the ring's last records, while the instance still exists
            # (a call takes one batch at most)
            while self._drain_spans_once():
                pass
            self._lib.bps_native_server_stop(self._id)
        self.tracer.flush()
        close_socket(self._sched_conn)
