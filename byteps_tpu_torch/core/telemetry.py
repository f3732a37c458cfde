"""Process-wide telemetry of the PS path, under the names of
``byteps_tpu.core.telemetry``.

Counters (:func:`counters`):

- ``d2h_bytes``: bytes that crossed device -> host in COPYD2H (for a
  device-compressed partition, its wire payload only);
- ``wire_tx_bytes`` / ``wire_rx_bytes``: payload bytes pushed to and
  pulled from the servers (a fused frame counts its members' payloads);
- fusion: ``fused_frames``, ``fused_keys``, ``fusion_flush_full`` /
  ``_idle`` / ``_cycle`` (why a pack left its buffer), ``fused_fallback``
  (packs sent again as per-key RPCs), ``fused_reply_malformed``;
- the server-side optimizer: ``server_opt_updates`` (rules applied by a
  Python server), ``server_opt_reject`` (INITs it refused);
- the self-healing data plane (``api.get_robustness_counters()``), flat
  and, where the reference labels them, per server (``{server}``):
  ``rpc_retry``, ``rpc_deadline_expired``, ``rpc_giveup``,
  ``conn_revive``, ``resync_attempt``, ``resync_replayed_rounds``,
  ``resync_giveup`` (worker); ``push_dedup`` and ``init_replay_ack``
  (a Python server: a replayed push acked without a sum, a replayed INIT
  acked from its barrier's token record); ``degraded_jobs`` (engine jobs
  failed with DegradedError); ``wire_rpc`` (data-plane frames sent,
  retries included); ``wire_checksum_fail{side,op}`` and
  ``wire_checksum_conn_drop`` (frames dropped on a CRC32C mismatch, and
  connections given up after ``BYTEPS_CHECKSUM_CONN_LIMIT`` of them); the
  chaos van's ``chaos_drop``, ``chaos_delay``, ``chaos_disconnect``,
  ``chaos_truncate``, ``chaos_corrupt``, ``chaos_payload_corrupt``;
- membership: ``worker_evicted`` and
  ``server_evicted`` (the cumulative evictions the scheduler's books
  report), ``sched_stale_book`` (books refused as from an older scheduler
  incarnation), ``sched_reconnect`` (redials of a lost scheduler link)
  and ``sched_rejoin`` (rejoins that succeeded);
- online resharding: ``migration_keys_moved`` / ``_received`` (keys a
  server shipped out and installed), ``migration_failed`` (shipments
  that did not land), ``wrong_owner_served`` (stale requests a Python
  server redirected), ``wrong_owner_redirect{server}`` (redirects a
  worker chased), ``native_wrong_owner`` (the C++ server's, read from
  its counters).

Histograms (:func:`metrics`), fixed buckets with percentile snapshots,
the reference's names and bounds:

- ``stage_dwell_seconds{stage}``: a partition's time in one engine stage,
  from its enqueue to the stage's end (``core/engine.py``);
- ``rpc_round_trip_seconds{server}``: one data-plane request, send to
  reply (``comm/ps_client.py``);
- ``server_sum_seconds`` / ``server_publish_seconds``: a push's sum, and
  the publish of the round it closed (``server/server.py``);
- ``fused_pack_keys`` (members a flushed pack) and
  ``fused_flush_age_seconds`` (its oldest member's wait);
- ``retry_backoff_seconds``: each backoff delay (``comm/retry.py``);
- ``migration_key_seconds``: one key's shipment, snapshot to the new
  owner's ack (``server/server.py``);
- the C++ lanes' ``native_*`` families, read through the histogram
  provider seam (``native/__init__.py``).

Gauges (:meth:`MetricsRegistry.gauge_set`, or sampled at read time with
:meth:`MetricsRegistry.gauge_fn`): ``fusion_threshold_bytes``, the fusion
threshold the worker's engine runs; ``control_plane_degraded``, 1 while a
node's scheduler link is down (it trains on its last book), else 0;
``server_owned_keys{rank}`` and ``server_map_epoch{rank}``, the keys a
server holds and the ownership map it adopted; ``node_step_seconds``, a
worker's last step (``core/flightrec.py``); on the scheduler's aggregate,
``cluster_map_epoch``, ``cluster_tuning_epoch`` and
``cluster_straggler_rank`` (-1: none).

Adaptive compression and the autotuner (``core/autotune.py``):
``compression_ratio`` (histogram over :data:`RATIO_BUCKETS`, one
observation per compression and per static verdict),
``wire_bytes_saved`` (raw minus wire bytes of each compression),
``compression_auto_off{codec}`` (keys a worker's verdict turned raw),
``tune_codec_off{codec}`` (keys a fleet decision turned raw), and on the
aggregate ``tune_action{rule}`` / ``tune_rollback{rule}``.

Jobs (docs/async.md; :func:`job_labels`, so that job 0 mints no series):
a tenant worker's ``wire_tx_bytes{job}`` / ``wire_rx_bytes{job}``,
``rpc_round_trip_seconds{server,job}``, ``job_step_seconds{job}`` and the
gauge ``job_step_last_seconds{job}``; a Python server's
``server_job_requests{job}`` and ``server_job_bytes{job}`` (the tenant's
enqueued requests and their payload bytes), ``job_quota_deferred{job}``
(requests its admission quota held back) and the gauge
``server_job_quota_mbps{job}`` (the quota this server meters, removed with
the quota).

The heartbeat deltas: :meth:`MetricsRegistry.delta_snapshot` is what
changed since the last beat (counters flat and labeled, histogram
buckets, gauges that changed or went), :meth:`~MetricsRegistry.reship_for`
makes the first beat to a new scheduler incarnation carry the whole
history, and the scheduler folds each delta into its aggregate with
:meth:`~MetricsRegistry.merge_delta` under ``{role, rank}`` labels.

The Prometheus exposition (:meth:`MetricsRegistry.render_prometheus`, text
format 0.0.4, byte for byte the reference's) is served by
:func:`serve_metrics` on ``BYTEPS_METRICS_PORT``: a worker's, a server's
and (its aggregate) the scheduler's.  :class:`PushPullSpeed` is the
windowed push/pull MB/s (``BYTEPS_TELEMETRY_ON``; global.cc:697-752), a
worker's ``pushpull_mbps`` gauge.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

#: PushPullSpeed's window (global.cc:703)
WINDOW_SEC = 10.0


class PushPullSpeed:
    """Bytes pushed and pulled over the last :data:`WINDOW_SEC` seconds, as
    MB/s; records nothing when off."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: Deque[Tuple[float, int]] = deque()
        self._total_bytes = 0

    def record(self, nbytes: int) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            self._events.append((now, nbytes))
            self._total_bytes += nbytes
            self._evict(now)

    def _evict(self, now: float) -> None:
        while self._events and now - self._events[0][0] > WINDOW_SEC:
            _, nb = self._events.popleft()
            self._total_bytes -= nb

    def mbps(self) -> float:
        """The window's MB/s; 0 when off or idle."""
        now = time.monotonic()
        with self._lock:
            self._evict(now)
            if not self._events:
                return 0.0
            span = max(now - self._events[0][0], 1e-6)
            return self._total_bytes / span / 1e6


class Counters:
    """Named monotonic counters.  ``bump(name, n, labels={"server": "1"})``
    also counts under that label set; the flat total includes it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        #: name -> {label key: count}
        self._labeled: Dict[str, Dict[tuple, int]] = {}

    def bump(self, name: str, n: int = 1,
             labels: Optional[Dict[str, str]] = None, flat: bool = True) -> None:
        """``flat=False`` counts under the labels only (an aggregate whose
        flat total already carried the bump)."""
        with self._lock:
            if flat:
                self._counts[name] = self._counts.get(name, 0) + n
            if labels:
                per = self._labeled.setdefault(name, {})
                key = _label_key(labels)
                per[key] = per.get(key, 0) + n

    def set_floor(self, name: str, value: int) -> None:
        """Raise a counter to ``value`` if it is below: a cumulative total
        read from broadcasts, which may come again."""
        with self._lock:
            if self._counts.get(name, 0) < value:
                self._counts[name] = value

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        """The flat totals."""
        with self._lock:
            return dict(self._counts)

    def snapshot_labeled(self) -> Dict[str, Dict[str, int]]:
        """name -> {rendered labels (``{server="1"}``): count}."""
        with self._lock:
            return {name: {_render_labels(k): v for k, v in per.items()}
                    for name, per in self._labeled.items()}

    def labeled_raw(self) -> Dict[str, Dict[tuple, int]]:
        """name -> {label key (sorted (name, value) pairs): count}."""
        with self._lock:
            return {name: dict(per) for name, per in self._labeled.items()}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._labeled.clear()


_counters = Counters()


def counters() -> Counters:
    return _counters


def job_labels(job: int) -> Optional[Dict[str, str]]:
    """``{"job": "<id>"}`` for a tenant's series; None for job 0, the
    default namespace, whose series keep their labels as they were."""
    return {"job": str(job)} if job else None


# latency buckets (seconds), 100 us to 100 s; native/csrc/hist.h keeps the
# same table (its histograms merge into these families)
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
)

#: members per fused frame
COUNT_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)

#: request sizes (bytes); native/csrc/hist.h kSizeBounds
SIZE_BUCKETS: Tuple[float, ...] = (
    64, 256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304, 16777216,
)

#: compressed bytes / raw bytes
RATIO_BUCKETS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 0.9, 1.0, 1.5, 2.0,
)

def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    """Canonical, hashable form of a label set."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Histogram:
    """Fixed-bucket histogram.  Bounds are cumulative upper bounds (``le``)
    with an implicit +Inf bucket; a value equal to a bound falls in that
    bound's bucket."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Tuple[float, ...] = LATENCY_BUCKETS) -> None:
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        """{"count", "sum", "buckets": [(le, cumulative count), ...]} with a
        trailing (inf, count) entry."""
        counts, s, total = self.raw_state()
        out, cum = [], 0
        for le, c in zip(self.bounds, counts):
            cum += c
            out.append((le, cum))
        out.append((float("inf"), total))
        return {"count": total, "sum": s, "buckets": out}

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 on an empty histogram."""
        return _state_percentile(self.bounds, self.raw_state()[0], q)

    def merge_counts(self, bucket_counts: List[int], vsum: float, count: int) -> None:
        """Fold in another histogram's raw bucket counts (same bounds)."""
        with self._lock:
            for i, c in enumerate(bucket_counts[: len(self._counts)]):
                self._counts[i] += int(c)
            self._sum += vsum
            self._count += count

    def raw_state(self) -> Tuple[List[int], float, int]:
        """(raw bucket counts, sum, count), read under one lock."""
        with self._lock:
            return list(self._counts), self._sum, self._count


def _state_percentile(bounds, counts, q: float) -> float:
    """The q-th percentile of raw (bounds, bucket counts), interpolated
    linearly inside the bucket that crosses the rank; past the last finite
    bound it reports that bound."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum, cum = 0.0, 0, 0
    for i, c in enumerate(counts):
        le = bounds[i] if i < len(bounds) else float("inf")
        cum += int(c)
        if cum >= rank and cum > prev_cum:
            if le == float("inf"):
                return bounds[-1] if bounds else prev_le
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span else 1.0
            return prev_le + (le - prev_le) * min(1.0, max(0.0, frac))
        prev_le, prev_cum = (0.0 if le == float("inf") else le), cum
    return bounds[-1] if bounds else 0.0


class MetricsRegistry:
    """Histograms keyed by (name, label set), plus providers: zero-argument
    callables returning records ``{"name", "labels", "le", "b", "sum",
    "count"}`` (``b`` the raw bucket counts, the +Inf slot last; the C++
    lanes' histograms), merged into every snapshot above the baseline
    taken at :meth:`reset`."""

    def __init__(self, counter_store: Optional[Counters] = None) -> None:
        #: the counters its deltas read and its merges bump
        self.counters = counter_store if counter_store is not None else Counters()
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, tuple], Histogram] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._gauge_fns: Dict[Tuple[str, tuple], Callable[[], float]] = {}
        #: id(fn) -> (fn, baseline {(name, labels): (counts, sum, count)})
        self._hist_providers: Dict[int, tuple] = {}
        # the heartbeat deltas' baselines: what was shipped so far.  In an
        # in-process fleet several beat loops share this registry; the
        # lock ships each increment once
        self._delta_lock = threading.Lock()
        self._requeued: List[dict] = []
        self._shipped_counts: Dict[str, int] = {}
        self._shipped_labeled: Dict[str, Dict[tuple, int]] = {}
        self._shipped_hists: Dict[Tuple[str, tuple], Tuple[List[int], float, int]] = {}
        self._shipped_gauges: Dict[Tuple[str, tuple], float] = {}
        #: the consumer of the last reship_for (a scheduler incarnation)
        self._reship_token = None

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 labels: Optional[Dict[str, str]] = None) -> None:
        """A gauge whose value is ``fn()`` at read time."""
        with self._lock:
            self._gauge_fns[(name, _label_key(labels))] = fn

    def gauge_remove(self, name: str, labels: Optional[Dict[str, str]] = None) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges.pop(key, None)
            self._gauge_fns.pop(key, None)

    def _gauge_values(self) -> Dict[Tuple[str, tuple], float]:
        """Set gauges and sampled ones; a gauge function that fails is
        left out."""
        with self._lock:
            cur = dict(self._gauges)
            fns = dict(self._gauge_fns)
        for key, fn in fns.items():
            try:
                cur[key] = float(fn())
            except Exception:  # noqa: BLE001 - a broken gauge is not a broken read
                continue
        return cur

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(name, buckets)
            return h

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Tuple[float, ...] = LATENCY_BUCKETS) -> None:
        self.histogram(name, labels, buckets).observe(value)

    # --- providers -------------------------------------------------------

    def register_hist_provider(self, fn: Callable[[], Iterable[dict]]) -> None:
        with self._lock:
            self._hist_providers[id(fn)] = (fn, {})

    def unregister_hist_provider(self, fn) -> None:
        with self._lock:
            self._hist_providers.pop(id(fn), None)

    def absorb_hist_provider(self, fn) -> None:
        """Fold a provider's values (above its baseline) into local
        histograms and unregister it: called before its source stops, so
        the totals outlive it."""
        with self._lock:
            entry = self._hist_providers.pop(id(fn), None)
        if entry is None:
            return
        fn_live, base = entry
        for key, st in _records_states(_call(fn_live)).items():
            if not _apply_baseline(st, base.get(key)):
                continue
            bounds, counts, vsum, count = st
            h = self.histogram(key[0], labels=dict(key[1]) or None, buckets=bounds)
            if h.bounds == bounds:
                h.merge_counts(counts, vsum, count)

    def _hist_states(self) -> Dict[Tuple[str, tuple], list]:
        """(name, label key) -> [bounds, raw counts, sum, count] across
        local histograms and live providers; providers are called outside
        the lock."""
        with self._lock:
            hists = dict(self._hists)
            providers = list(self._hist_providers.values())
        out: Dict[Tuple[str, tuple], list] = {}
        for key, h in hists.items():
            counts, vsum, count = h.raw_state()
            out[key] = [h.bounds, counts, vsum, count]
        for fn, base in providers:
            for key, st in _records_states(_call(fn)).items():
                if not _apply_baseline(st, base.get(key)):
                    continue
                cur = out.get(key)
                if cur is None:
                    out[key] = st
                elif tuple(cur[0]) == st[0]:
                    cur[1] = [a + x for a, x in zip(cur[1], st[1])]
                    cur[2] += st[2]
                    cur[3] += st[3]
        return out

    # --- reading ---------------------------------------------------------

    def snapshot(self) -> dict:
        """{"counters": flat totals, "counters_labeled": {name: {labels:
        count}}, "gauges": {name{labels}: value}, "histograms":
        {name{labels}: {"count", "sum", "p50", "p90", "p99"}}}, local and
        provider histograms together (``api.get_metrics()``)."""
        gauges = {name + _render_labels(lkey): v
                  for (name, lkey), v in self._gauge_values().items()}
        labeled = {name: {_render_labels(k) or "{}": v for k, v in per.items()}
                   for name, per in self.counters.labeled_raw().items()}
        out = {}
        for (name, lkey), (bounds, counts, vsum, count) in self._hist_states().items():
            out[name + _render_labels(lkey)] = {
                "count": count,
                "sum": vsum,
                "p50": _state_percentile(bounds, counts, 0.50),
                "p90": _state_percentile(bounds, counts, 0.90),
                "p99": _state_percentile(bounds, counts, 0.99),
            }
        return {"counters": self.counters.snapshot(), "counters_labeled": labeled,
                "gauges": gauges, "histograms": out}

    def render_prometheus(self, prefix: str = "byteps_") -> str:
        """The text exposition (format 0.0.4): a counter as ``_total``, its
        label slices as a family of their own (``_labeled_total``: the flat
        total counts them already), gauges, and each histogram's
        ``_bucket``/``_sum``/``_count`` with ``_p50``/``_p90``/``_p99``
        gauges beside, so that a bare scrape reads the tail."""
        lines: List[str] = []
        flat = self.counters.snapshot()
        labeled = self.counters.labeled_raw()
        for name in sorted(flat):
            metric = f"{prefix}{name}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {flat[name]}")
            if labeled.get(name):
                lmetric = f"{prefix}{name}_labeled_total"
                lines.append(f"# TYPE {lmetric} counter")
                for lkey in sorted(labeled[name]):
                    lines.append(f"{lmetric}{_render_labels(lkey)} {labeled[name][lkey]}")
        g_fams: Dict[str, List[Tuple[tuple, float]]] = {}
        for (name, lkey), v in self._gauge_values().items():
            g_fams.setdefault(name, []).append((lkey, v))
        for name in sorted(g_fams):
            metric = f"{prefix}{name}"
            lines.append(f"# TYPE {metric} gauge")
            for lkey, v in sorted(g_fams[name]):
                lines.append(f"{metric}{_render_labels(lkey)} {v}")
        by_family: Dict[str, List[Tuple[tuple, list]]] = {}
        for (name, lkey), st in self._hist_states().items():
            by_family.setdefault(name, []).append((lkey, st))
        for name in sorted(by_family):
            metric = f"{prefix}{name}"
            series = sorted(by_family[name], key=lambda kv: kv[0])
            lines.append(f"# TYPE {metric} histogram")
            for lkey, (bounds, counts, vsum, count) in series:
                cum = 0
                for le, c in zip(bounds, counts):
                    cum += c
                    labels = dict(lkey) | {"le": repr(float(le))}
                    lines.append(f"{metric}_bucket{_render_labels(_label_key(labels))} {cum}")
                labels = dict(lkey) | {"le": "+Inf"}
                lines.append(f"{metric}_bucket{_render_labels(_label_key(labels))} {count}")
                lines.append(f"{metric}_sum{_render_labels(lkey)} {vsum}")
                lines.append(f"{metric}_count{_render_labels(lkey)} {count}")
            for q, tag in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
                qmetric = f"{metric}_{tag}"
                lines.append(f"# TYPE {qmetric} gauge")
                for lkey, (bounds, counts, _vsum, _count) in series:
                    lines.append(f"{qmetric}{_render_labels(lkey)} "
                                 f"{_state_percentile(bounds, counts, q)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop local histograms and the delta baselines; re-baseline
        providers (their sources are never cleared), so their counts start
        again from zero."""
        with self._delta_lock:
            self._requeued.clear()
            self._shipped_counts.clear()
            self._shipped_labeled.clear()
            self._shipped_hists.clear()
            self._shipped_gauges = {}
            self._reship_token = None
        with self._lock:
            self._hists.clear()
            providers = list(self._hist_providers.items())
        rebased = []
        for pid, (fn, _base) in providers:
            base = {k: (st[1], st[2], st[3])
                    for k, st in _records_states(_call(fn)).items()}
            rebased.append((pid, fn, base))
        with self._lock:
            for pid, fn, base in rebased:
                if pid in self._hist_providers:
                    self._hist_providers[pid] = (fn, base)


    # --- the heartbeat deltas ----------------------------------------------

    def delta_snapshot(self) -> dict:
        """What changed since the previous call, the payload a heartbeat
        carries: ``c`` flat counter increments, ``lc`` labeled ones (keyed
        by the JSON of their label pairs), ``h`` histogram bucket
        increments, ``g`` gauges that changed or appeared (current values)
        and ``gr`` gauges that went.  Empty when nothing changed."""
        with self._delta_lock:
            return self._delta_snapshot_locked()

    def _delta_snapshot_locked(self) -> dict:
        out: dict = {}
        flat = self.counters.snapshot()
        labeled = self.counters.labeled_raw()
        c_delta = {name: v - self._shipped_counts.get(name, 0) for name, v in flat.items()
                   if v != self._shipped_counts.get(name, 0)}
        if c_delta:
            out["c"] = c_delta
        lc_delta: Dict[str, Dict[str, int]] = {}
        for name, per in labeled.items():
            shipped = self._shipped_labeled.get(name, {})
            for lkey, v in per.items():
                d = v - shipped.get(lkey, 0)
                if d:
                    lc_delta.setdefault(name, {})[json.dumps(lkey)] = d
        if lc_delta:
            out["lc"] = lc_delta
        h_delta = []
        for (name, lkey), (bounds, raw, vsum, count) in self._hist_states().items():
            prev = self._shipped_hists.get((name, lkey), ([0] * len(raw), 0.0, 0))
            d_counts = [a - b for a, b in zip(raw, prev[0])]
            d_count = count - prev[2]
            if d_count < 0 or any(d < 0 for d in d_counts):
                # a provider is being absorbed: the totals went back for a
                # moment; keep the baseline and ship nothing this beat
                continue
            if d_count > 0:
                h_delta.append({"name": name, "l": [list(kv) for kv in lkey],
                                "le": list(bounds), "b": d_counts, "s": vsum - prev[1],
                                "n": d_count})
            self._shipped_hists[(name, lkey)] = (raw, vsum, count)
        if h_delta:
            out["h"] = h_delta
        cur = self._gauge_values()
        g_delta = [{"n": name, "l": [list(kv) for kv in lkey], "v": v}
                   for (name, lkey), v in cur.items()
                   if self._shipped_gauges.get((name, lkey)) != v]
        if g_delta:
            out["g"] = g_delta
        gone = [{"n": name, "l": [list(kv) for kv in lkey]}
                for (name, lkey) in self._shipped_gauges if (name, lkey) not in cur]
        if gone:
            out["gr"] = gone
        self._shipped_gauges = cur
        self._shipped_counts = flat
        self._shipped_labeled = labeled
        # a delta whose beat failed rides this one
        requeued, self._requeued = self._requeued, []
        for old in requeued:
            for name, d in (old.get("c") or {}).items():
                out.setdefault("c", {})
                out["c"][name] = out["c"].get(name, 0) + int(d)
            for name, per in (old.get("lc") or {}).items():
                dst = out.setdefault("lc", {}).setdefault(name, {})
                for lkey_json, d in per.items():
                    dst[lkey_json] = dst.get(lkey_json, 0) + int(d)
            if old.get("h"):
                out.setdefault("h", []).extend(old["h"])
            # gauges are current values: a requeued record goes first, and
            # is dropped where this beat carries the opposite kind
            fresh = {field: {(r.get("n"), tuple(map(tuple, r.get("l") or ())))
                             for r in out.get(field) or ()}
                     for field in ("g", "gr")}
            for field, opposite in (("g", "gr"), ("gr", "g")):
                keep = [r for r in old.get(field) or ()
                        if (r.get("n"), tuple(map(tuple, r.get("l") or ())))
                        not in fresh[opposite]]
                if keep:
                    out[field] = keep + list(out.get(field, []))
        return out

    def reship_for(self, token) -> bool:
        """Re-arm the baselines so that the next :meth:`delta_snapshot`
        ships the whole history: the first beat to a new consumer (a
        scheduler incarnation, whose aggregate starts empty).  Once per
        ``token``, since several beat loops may share this registry and a
        second rebase would ship the history twice.  True when it
        rebased."""
        with self._delta_lock:
            if token == self._reship_token:
                return False
            self._reship_token = token
            self._requeued.clear()
            self._shipped_counts.clear()
            self._shipped_labeled.clear()
            self._shipped_hists.clear()
            self._shipped_gauges = {}
            return True

    def requeue_delta(self, delta: dict) -> None:
        """Give back a delta whose beat failed: the next one carries it."""
        if delta:
            with self._delta_lock:
                self._requeued.append(delta)

    def merge_delta(self, delta: dict, labels: Optional[Dict[str, str]] = None) -> None:
        """Fold one node's delta into this (the scheduler's aggregate)
        registry: counters under the node's ``labels`` beside the flat
        total, histograms flat, gauges under the node's labels.  A
        malformed record is dropped."""
        for name, d in (delta.get("c") or {}).items():
            self.counters.bump(str(name), int(d), labels=labels)
        for name, per in (delta.get("lc") or {}).items():
            for lkey_json, d in per.items():
                try:
                    node_labels = dict(tuple(kv) for kv in json.loads(lkey_json))
                except (ValueError, TypeError):
                    node_labels = {}
                if labels:
                    node_labels.update(labels)
                # the flat total came with "c" already
                self.counters.bump(str(name), int(d), labels=node_labels, flat=False)
        for rec in delta.get("h") or ():
            try:
                bounds = tuple(float(b) for b in rec["le"])
                node_labels = dict(tuple(kv) for kv in rec.get("l") or ())
                self.histogram(str(rec["name"]), labels=node_labels or None,
                               buckets=bounds).merge_counts(
                    [int(c) for c in rec["b"]], float(rec["s"]), int(rec["n"]))
            except (KeyError, ValueError, TypeError):
                continue
        for field in ("g", "gr"):
            for rec in delta.get(field) or ():
                try:
                    node_labels = dict(tuple(kv) for kv in rec.get("l") or ())
                    if labels:
                        node_labels.update(labels)
                    if field == "g":
                        self.gauge_set(str(rec["n"]), float(rec["v"]),
                                       labels=node_labels or None)
                    else:
                        self.gauge_remove(str(rec["n"]), labels=node_labels or None)
                except (KeyError, ValueError, TypeError):
                    continue


def _call(fn) -> list:
    try:
        return list(fn() or [])
    except Exception:  # noqa: BLE001 - a stopped source has nothing to report
        return []


def _records_states(recs) -> Dict[Tuple[str, tuple], list]:
    """Provider records -> {(name, label key): [bounds, counts, sum,
    count]}; malformed records dropped, duplicates summed."""
    out: Dict[Tuple[str, tuple], list] = {}
    for rec in recs:
        try:
            name = str(rec["name"])
            lkey = _label_key(rec.get("labels") or None)
            bounds = tuple(float(b) for b in rec["le"])
            counts = [int(c) for c in rec["b"]]
            vsum = float(rec["sum"])
            count = int(rec["count"])
        except (KeyError, TypeError, ValueError):
            continue
        if len(counts) != len(bounds) + 1 or count < 0:
            continue
        cur = out.get((name, lkey))
        if cur is None:
            out[(name, lkey)] = [bounds, counts, vsum, count]
        elif cur[0] == bounds:
            cur[1] = [a + b for a, b in zip(cur[1], counts)]
            cur[2] += vsum
            cur[3] += count
    return out


def _apply_baseline(st: list, base) -> bool:
    """Subtract a reset baseline from a state in place (clamped at zero);
    False when nothing is left above it."""
    if base is not None:
        st[1] = [max(0, a - x) for a, x in zip(st[1], base[0])]
        st[2] = max(0.0, st[2] - base[1])
        st[3] = max(0, st[3] - base[2])
    return st[3] > 0


class MetricsHTTPServer:
    """A threaded HTTP server of one render function (the text
    exposition).  Port 0 binds an ephemeral port; a taken port falls back
    to one, logged, so that every process of a host that shares one
    ``BYTEPS_METRICS_PORT`` still serves (:attr:`port` is the one bound)."""

    def __init__(self, port: int, render: Callable[[], str], host: str = "0.0.0.0") -> None:
        import http.server

        render_fn = render

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server's name
                try:
                    body = render_fn().encode()
                except Exception as e:  # noqa: BLE001 - a scrape answers 500, never dies
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(repr(e).encode())
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no line a scrape
                pass

        try:
            self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        except OSError:
            from byteps_tpu_torch.common import logging as bpslog

            self._httpd = http.server.ThreadingHTTPServer((host, 0), _Handler)
            bpslog.warning("BYTEPS_METRICS_PORT=%d in use; serving metrics on %d instead",
                           port, self._httpd.server_address[1])
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="bps-metrics-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


def serve_metrics(port: int, render: Optional[Callable[[], str]] = None,
                  host: str = "0.0.0.0") -> MetricsHTTPServer:
    """The Prometheus endpoint, of the process's registry unless
    ``render`` is given."""
    return MetricsHTTPServer(port, render if render is not None
                             else metrics().render_prometheus, host=host)


_metrics = MetricsRegistry(_counters)


def metrics() -> MetricsRegistry:
    return _metrics
