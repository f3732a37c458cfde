"""The flight recorder's step ledger and the scheduler's cluster step
matrix (``byteps_tpu.core.flightrec``).

- :class:`FlightRecorder` keeps a bounded ring (``BYTEPS_FLIGHT_STEPS``,
  default 256; 0 turns it off) of one record per step: a worker engine
  stamps it when a step's last push_pull completes (``record_step(dur)``),
  a server once per heartbeat (``record_step()``).  A record is the delta
  of the process's registry since the last one: the step's wall time,
  each stage's dwell (``stages``), each server's round trip (``rpc``,
  with its retries and give-ups), wire bytes, fused frames and the
  robustness events, with the membership and map epochs and the
  scheduler incarnation it ran under.
- Every heartbeat carries the ring's compact tail (:meth:`ledger_tail`,
  with the per-stage dwell as ``st``), and the scheduler's
  :class:`ClusterFlight` merges the tails into a step matrix, dedupes them
  by step, notices a node whose recorder restarted, forgets an evicted
  node, and names the worker whose last step is slowest by
  ``BYTEPS_FLIGHT_SLOW_FACTOR`` over its peers' median
  (``cluster_straggler_rank``).  The autotuner reads the matrix: its
  canary's median step and the fusion walk's dwell.

Each record carries the job its node trains (``BYTEPS_JOB_ID``; a
server's, 0), so that the ledger and the matrix slice by job.  The
node-side trigger rules (``slo_breach`` among them: ``BYTEPS_JOB_SLO_S``
raises), the diagnostic bundles and their upload (``BYTEPS_FLIGHT_UPLOAD``,
which raises) are not ported (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import os
import statistics
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from byteps_tpu_torch.core.telemetry import _state_percentile, counters, metrics

#: counter families copied (as nonzero deltas) into every record's
#: ``events`` map
EVENT_COUNTERS = (
    "resync_attempt", "resync_giveup", "resync_replayed_rounds",
    "worker_evicted", "server_evicted",
    "migration_keys_moved", "migration_keys_received", "migration_failed",
    "wrong_owner_redirect", "wrong_owner_served",
    "sched_reconnect", "sched_rejoin", "sched_stale_book",
    "degraded_jobs", "push_dedup", "rpc_deadline_expired", "rpc_retry",
    "rpc_giveup", "conn_revive",
    "chaos_drop", "chaos_delay", "chaos_disconnect", "chaos_truncate",
    "chaos_corrupt", "chaos_payload_corrupt",
    "wire_checksum_fail", "wire_checksum_conn_drop",
    "native_checksum_fail", "native_checksum_conn_drop",
)

#: histogram families whose per-label deltas feed a record: (family,
#: label, record field)
_HIST_FAMILIES = (
    ("stage_dwell_seconds", "stage", "stages"),
    ("rpc_round_trip_seconds", "server", "rpc"),
    ("native_stripe_sum_seconds", "stripe", "stripes"),
)

#: record fields kept in the heartbeat's compact tail (plus the rpc p99s
#: and the stage dwell)
_COMPACT_KEYS = ("step", "k", "t", "dur", "deg", "trig", "job")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


class FlightRecorder:
    """The per-step ring of one process.  In an in-process fleet the
    worker and the servers share one registry, and one recorder."""

    def __init__(self, context_fn: Optional[Callable[[], dict]] = None, registry=None,
                 counter_store=None, capacity: Optional[int] = None) -> None:
        self.capacity = (capacity if capacity is not None
                         else _env_int("BYTEPS_FLIGHT_STEPS", 256))
        self._context_fn = context_fn
        self._registry = registry if registry is not None else metrics()
        self._counters = counter_store if counter_store is not None else counters()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, self.capacity or 1))
        self._step = 0
        # delta baselines, clamped at zero (a counters().reset() in flight
        # must not go negative)
        self._base_counts: Dict[str, int] = {}
        self._base_labeled: Dict[str, Dict[tuple, int]] = {}
        self._base_hists: Dict[Tuple[str, tuple], Tuple[List[int], float, int]] = {}
        self._labeled_delta: Dict[str, Dict[str, int]] = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record_step(self, dur: Optional[float] = None) -> Optional[dict]:
        """Stamp one record: the registry's delta since the last one, the
        step's wall time (None on a server's beat) and the control
        context.  Returns it (None when off); never raises into the data
        path."""
        if not self.enabled:
            return None
        try:
            return self._record_step(dur)
        except Exception as e:  # noqa: BLE001 - a ledger must not fail a step
            print(f"byteps_tpu_torch: flight recorder step failed: {e!r}",
                  file=sys.stderr, flush=True)
            return None

    def _record_step(self, dur: Optional[float]) -> dict:
        ctx = {}
        if self._context_fn is not None:
            try:
                ctx = self._context_fn() or {}
            except Exception:  # noqa: BLE001
                ctx = {}
        rec: dict = {
            "k": "step" if dur is not None else "beat",
            "t": time.time(),
            "dur": dur,
            "epoch": int(ctx.get("epoch", 0)),
            "map_epoch": int(ctx.get("map_epoch", 0)),
            "incarnation": int(ctx.get("incarnation", 0)),
            "deg": int(ctx.get("degraded", 0)),
            "job": int(ctx.get("job", 0)),
            "trig": [],
        }
        with self._lock:
            self._step += 1
            rec["step"] = self._step
            self._delta_counters(rec)
            self._delta_hists(rec)
            self._ring.append(rec)
        if dur is not None:
            self._registry.gauge_set("node_step_seconds", dur)
        return rec

    def _delta_counters(self, rec: dict) -> None:
        """The nonzero counter deltas since the last record.  Caller holds
        the lock."""
        flat = self._counters.snapshot()
        rec["events"] = {name: flat.get(name, 0) - self._base_counts.get(name, 0)
                         for name in EVENT_COUNTERS
                         if flat.get(name, 0) - self._base_counts.get(name, 0) > 0}
        for name, field in (("wire_tx_bytes", "tx"), ("wire_rx_bytes", "rx"),
                            ("fused_frames", "fused"), ("fused_keys", "fused_keys"),
                            ("wire_bytes_saved", "comp_saved")):
            rec[field] = max(0, flat.get(name, 0) - self._base_counts.get(name, 0))
        self._base_counts = flat
        labeled = self._counters.labeled_raw()
        self._labeled_delta = {}
        for name in ("rpc_retry", "rpc_giveup"):
            base = self._base_labeled.get(name, {})
            self._labeled_delta[name] = {
                dict(lkey).get("server", "?"): v - base.get(lkey, 0)
                for lkey, v in labeled.get(name, {}).items() if v - base.get(lkey, 0) > 0}
        self._base_labeled = {n: dict(per) for n, per in labeled.items()
                              if n in ("rpc_retry", "rpc_giveup")}

    def _delta_hists(self, rec: dict) -> None:
        """Per-label bucket deltas of the watched families ->
        ``{label value: {"n", "s", "p99"}}``.  Caller holds the lock."""
        wanted = {fam: (lab, field) for fam, lab, field in _HIST_FAMILIES}
        for _fam, (_lab, field) in wanted.items():
            rec[field] = {}
        for (name, lkey), (bounds, cnts, vsum, count) in self._registry._hist_states().items():
            if name not in wanted:
                continue
            lab, field = wanted[name]
            base = self._base_hists.get((name, lkey))
            if base is None:
                d_counts, d_sum, d_count = list(cnts), vsum, count
            else:
                d_counts = [max(0, a - b) for a, b in zip(cnts, base[0])]
                d_sum = max(0.0, vsum - base[1])
                d_count = max(0, count - base[2])
            self._base_hists[(name, lkey)] = (list(cnts), vsum, count)
            if d_count <= 0:
                continue
            rec[field][dict(lkey).get(lab, "?")] = {
                "n": d_count,
                "s": round(d_sum, 9),
                "p99": round(_state_percentile(tuple(bounds), d_counts, 0.99), 9),
            }
        for name in ("rpc_retry", "rpc_giveup"):
            for rank, v in self._labeled_delta.get(name, {}).items():
                rec["rpc"].setdefault(rank, {"n": 0, "s": 0.0, "p99": 0.0})
                rec["rpc"][rank][name[4:]] = v

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def ledger_tail(self, limit: int = 16) -> List[dict]:
        """The last ``limit`` records in compact form, the heartbeat's
        ``fr`` field.  Every beat ships the window again and the scheduler
        dedupes by step, so a lost beat costs nothing."""
        with self._lock:
            recs = list(self._ring)[-max(1, limit):]
        out = []
        for r in recs:
            c = {k: r.get(k) for k in _COMPACT_KEYS}
            c["rpc"] = {rank: v.get("p99", 0.0) for rank, v in (r.get("rpc") or {}).items()}
            # where the step's time went, {stage: [n, seconds]}: the
            # tuner's fusion walk reads it
            st = {name: [v.get("n", 0), v.get("s", 0.0)]
                  for name, v in (r.get("stages") or {}).items()}
            if st:
                c["st"] = st
            out.append(c)
        return out


class ClusterFlight:
    """The scheduler's step matrix over the nodes' heartbeat tails, and its
    one rule: the worker whose last step is ``factor`` times its peers'
    median is the straggler (``cluster_straggler_rank``; -1: none)."""

    def __init__(self, factor: Optional[float] = None, depth: int = 64) -> None:
        self.factor = factor or _env_float("BYTEPS_FLIGHT_SLOW_FACTOR", 3.0)
        self._lock = threading.Lock()
        self._matrix: Dict[Tuple[str, int], deque] = {}
        self._last_step: Dict[Tuple[str, int], int] = {}
        self._depth = depth
        self.straggler_rank = -1
        self._registry = None

    def attach(self, registry) -> None:
        """Register the matrix's gauge on the aggregate registry."""
        self._registry = registry
        registry.gauge_fn("cluster_straggler_rank", lambda: float(self.straggler_rank))

    def merge(self, role: str, rank: int, records: List[dict]) -> int:
        """Fold one node's tail in; the count of records that were new."""
        key = (role, int(rank))
        fresh = 0
        with self._lock:
            dq = self._matrix.setdefault(key, deque(maxlen=self._depth))
            last = self._last_step.get(key, 0)
            steps = []
            for r in records or ():
                try:
                    steps.append((int(r.get("step", 0)), r))
                except (TypeError, ValueError):
                    continue
            # a live node's tail holds its newest record: a tail whose
            # newest step is below the cursor is a restarted recorder, and
            # the dead one's rows must go
            if steps and max(s for s, _ in steps) < last:
                dq.clear()
                last = 0
            for step, r in steps:
                if step <= last:
                    continue
                last = step
                dq.append(dict(r))
                fresh += 1
            self._last_step[key] = last
        if fresh:
            self._evaluate()
        return fresh

    def forget(self, role: str, rank: int) -> None:
        """Drop an evicted node's row: its frozen last step must not feed
        the straggler median."""
        key = (role, int(rank))
        with self._lock:
            self._matrix.pop(key, None)
            self._last_step.pop(key, None)
        self._evaluate()

    def _evaluate(self) -> None:
        with self._lock:
            durs = {}
            for (role, rank), dq in self._matrix.items():
                if role != "worker":
                    continue
                for r in reversed(dq):
                    if r.get("k") == "step" and r.get("dur") is not None:
                        durs[rank] = float(r["dur"])
                        break
        prev = self.straggler_rank
        if len(durs) < 2:
            self.straggler_rank = -1
            return
        worst = max(durs, key=durs.get)
        med = statistics.median(d for rk, d in durs.items() if rk != worst)
        self.straggler_rank = worst if durs[worst] >= self.factor * max(med, 1e-4) else -1
        if self.straggler_rank >= 0 and self.straggler_rank != prev and self._registry:
            self._registry.counters.bump("flight_trigger", labels={"rule": "straggler_node"})

    def matrix(self) -> Dict[str, List[dict]]:
        """``{"<role><rank>": [compact records, oldest first]}``."""
        with self._lock:
            return {f"{role}{rank}": list(dq) for (role, rank), dq in self._matrix.items()}


# --- the process's recorder -------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_process_recorder() -> Optional[FlightRecorder]:
    return _recorder


def set_process_recorder(rec: Optional[FlightRecorder]) -> None:
    global _recorder
    with _recorder_lock:
        _recorder = rec


def release_process_recorder(context_fn) -> None:
    """Drop the process recorder iff it was made with ``context_fn``: a
    stopping server releases the one it installed, never a live worker's
    (bound methods compare equal by instance and function)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None and _recorder._context_fn == context_fn:
            _recorder = None


def ensure_process_recorder(context_fn=None) -> FlightRecorder:
    """The process recorder, made by the first role to come up; later roles
    of an in-process fleet share its ring, as they share the registry."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(context_fn=context_fn)
        return _recorder
