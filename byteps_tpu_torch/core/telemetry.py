"""Process-wide telemetry of the PS path, under the names of
``byteps_tpu.core.telemetry``.

Counters (:func:`counters`):

- ``d2h_bytes``: bytes that crossed device -> host in COPYD2H (for a
  device-compressed partition, its wire payload only);
- ``wire_tx_bytes`` / ``wire_rx_bytes``: payload bytes pushed to and
  pulled from the servers.

Histograms (:func:`metrics`), fixed buckets with percentile snapshots,
the reference's names and bounds:

- ``stage_dwell_seconds{stage}``: a partition's time in one engine stage,
  from its enqueue to the stage's end (``core/engine.py``);
- ``rpc_round_trip_seconds{server}``: one data-plane request, send to
  reply (``comm/ps_client.py``);
- ``server_sum_seconds`` / ``server_publish_seconds``: a push's sum, and
  the publish of the round it closed (``server/server.py``);
- the C++ lanes' ``native_*`` families, read through the histogram
  provider seam (``native/__init__.py``).

Prometheus exposition, gauges, the heartbeat deltas and the flight
recorder's hooks are not ported (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


_counters = Counters()


def counters() -> Counters:
    return _counters


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

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, tuple], Histogram] = {}
        #: id(fn) -> (fn, baseline {(name, labels): (counts, sum, count)})
        self._hist_providers: Dict[int, tuple] = {}

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
        """{"histograms": {name{labels}: {"count", "sum", "p50", "p90",
        "p99"}}}, local and provider histograms together."""
        out = {}
        for (name, lkey), (bounds, counts, vsum, count) in self._hist_states().items():
            out[name + _render_labels(lkey)] = {
                "count": count,
                "sum": vsum,
                "p50": _state_percentile(bounds, counts, 0.50),
                "p90": _state_percentile(bounds, counts, 0.90),
                "p99": _state_percentile(bounds, counts, 0.99),
            }
        return {"histograms": out}

    def reset(self) -> None:
        """Drop local histograms; re-baseline providers (their sources are
        never cleared), so their counts start again from zero."""
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


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _metrics
