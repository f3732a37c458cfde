"""The flight recorder: the step ledger, the node's trigger rules and
their diagnostic bundles, and the scheduler's cluster step matrix
(``byteps_tpu.core.flightrec``; docs/observability.md "Flight recorder &
doctor").

- :class:`FlightRecorder` keeps a bounded ring (``BYTEPS_FLIGHT_STEPS``,
  default 256; 0 turns it off) of one record per step: a worker engine
  stamps it when a step's last push_pull completes (``record_step(dur)``),
  a server once per heartbeat (``record_step()``).  A record is the delta
  of the process's registry since the last one: the step's wall time,
  each stage's dwell (``stages``), each server's round trip (``rpc``,
  with its retries and give-ups), wire bytes, fused frames and the
  robustness events, with the membership and map epochs, the scheduler
  incarnation and the job it ran under.
- Each record goes through seven rules: ``slow_step`` (the step over
  ``BYTEPS_FLIGHT_SLOW_FACTOR`` times the median of the last ones),
  ``straggler_server`` (one server's round-trip p99 that far over its
  peers' median), ``hot_stripe`` (one C++ reducer stripe's sum time over
  its siblings'), ``queue_stall`` (a stage's dwell p99 past
  ``BYTEPS_FLIGHT_STALL_S``), ``degraded_flip`` (the control plane just
  went degraded), ``slo_breach`` (a step slower than
  ``BYTEPS_JOB_SLO_S``) and ``corruption_storm`` (a burst of CRC32C
  rejections, or a connection given up over them).  A rule that fires
  counts ``flight_trigger{rule}`` and, at most once every
  ``BYTEPS_FLIGHT_BUNDLE_S`` a rule, writes a bundle under
  ``BYTEPS_FLIGHT_DIR``: ``trigger.json``, ``ledger.jsonl``,
  ``metrics.json``, ``config.json`` and, when tracing, the trace window
  it flushed (``trace_window.json``), what ``tools/bps_doctor.py`` reads
  (``flight_bundle`` counts them).  Under ``BYTEPS_FLIGHT_UPLOAD`` a
  bundle's compact form waits for the next heartbeat (``fb``), which the
  scheduler stores under its own ``BYTEPS_FLIGHT_DIR``.
- Every heartbeat carries the ring's compact tail (:meth:`ledger_tail`,
  with the per-stage dwell as ``st``), and the scheduler's
  :class:`ClusterFlight` merges the tails into a step matrix, dedupes them
  by step, notices a node whose recorder restarted, forgets an evicted
  node, and names the worker whose last step is slowest by
  ``BYTEPS_FLIGHT_SLOW_FACTOR`` over its peers' median
  (``cluster_straggler_rank``).  The autotuner reads the matrix: its
  canary's median step and the fusion walk's dwell.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from byteps_tpu_torch.common.config import truthy
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
    """The per-step ring of one process and the node's trigger rules.  In
    an in-process fleet the worker and the servers share one registry, and
    one recorder.  Its knobs come from ``cfg`` when given, else from the
    environment."""

    def __init__(self, cfg=None, context_fn: Optional[Callable[[], dict]] = None,
                 registry=None, counter_store=None, tracer=None,
                 capacity: Optional[int] = None) -> None:
        if capacity is not None:
            self.capacity = capacity
        elif cfg is not None:
            self.capacity = cfg.flight_steps
        else:
            self.capacity = _env_int("BYTEPS_FLIGHT_STEPS", 256)
        self.slow_factor = (getattr(cfg, "flight_slow_factor", None)
                            or _env_float("BYTEPS_FLIGHT_SLOW_FACTOR", 3.0))
        self.stall_s = (getattr(cfg, "flight_stall_s", None)
                        or _env_float("BYTEPS_FLIGHT_STALL_S", 5.0))
        self.bundle_dir = (getattr(cfg, "flight_dir", None)
                           or os.environ.get("BYTEPS_FLIGHT_DIR")
                           or os.path.join(getattr(cfg, "trace_dir", ".") or ".",
                                           "flight_bundles"))
        self.bundle_interval_s = (float(cfg.flight_bundle_s) if cfg is not None
                                  else _env_float("BYTEPS_FLIGHT_BUNDLE_S", 60.0))
        #: BYTEPS_FLIGHT_UPLOAD: a bundle's compact form (rule, evidence,
        #: record) rides the next heartbeat to the scheduler
        self.upload = bool(getattr(cfg, "flight_upload", False)
                           or truthy(os.environ.get("BYTEPS_FLIGHT_UPLOAD") or "0"))
        self._uploads: List[dict] = []
        #: BYTEPS_JOB_SLO_S: a step slower than this fires slo_breach
        self.slo_s = (cfg.job_slo_s if cfg is not None and cfg.job_slo_s
                      else _env_float("BYTEPS_JOB_SLO_S", 0.0))
        #: steps seen before the median rules may fire
        self.min_history = 8
        self._context_fn = context_fn
        self._registry = registry if registry is not None else metrics()
        self._counters = counter_store if counter_store is not None else counters()
        self._tracer = tracer
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, self.capacity or 1))
        self._step = 0
        # delta baselines, clamped at zero (a counters().reset() in flight
        # must not go negative)
        self._base_counts: Dict[str, int] = {}
        self._base_labeled: Dict[str, Dict[tuple, int]] = {}
        self._base_hists: Dict[Tuple[str, tuple], Tuple[List[int], float, int]] = {}
        self._labeled_delta: Dict[str, Dict[str, int]] = {}
        # the rules' state
        self._durs: deque = deque(maxlen=64)
        self._last_degraded: Optional[int] = None
        self._last_fire: Dict[str, float] = {}
        self.bundles_written: List[str] = []

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record_step(self, dur: Optional[float] = None) -> Optional[dict]:
        """Stamp one record: the registry's delta since the last one, the
        step's wall time (None on a server's beat) and the control
        context; then run the rules.  Returns it (None when off); never
        raises into the data path."""
        if not self.enabled:
            return None
        try:
            return self._record_step(dur)
        except Exception as e:  # noqa: BLE001 - a ledger must not fail a step
            from byteps_tpu_torch.common import logging as bpslog

            bpslog.warning("flight recorder step failed: %r", e)
            return None

    def _record_step(self, dur: Optional[float]) -> dict:
        ctx = self._context()
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
        self._evaluate(rec)
        if dur is not None:
            with self._lock:
                self._durs.append(dur)
        return rec

    def _context(self) -> dict:
        if self._context_fn is None:
            return {}
        try:
            return self._context_fn() or {}
        except Exception:  # noqa: BLE001
            return {}

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

    def take_uploads(self) -> List[dict]:
        """The compact bundles waiting for a heartbeat (its ``fb`` field),
        taken; a beat that fails gives them back (:meth:`requeue_uploads`)."""
        with self._lock:
            ups, self._uploads = self._uploads, []
            return ups

    def requeue_uploads(self, ups: List[dict]) -> None:
        with self._lock:
            self._uploads = (list(ups) + self._uploads)[-8:]

    # --- the rules -------------------------------------------------------

    def _evaluate(self, rec: dict) -> None:
        for rule, fn in _RULES:
            try:
                ev = fn(self, rec)
            except Exception:  # noqa: BLE001 - a rule's fault must not fail a step
                continue
            if ev is not None:
                self._fire(rule, ev, rec)

    def _fire(self, rule: str, evidence: dict, rec: dict) -> None:
        """Count the firing; write a bundle unless the rule wrote one in
        the last ``bundle_interval_s``; queue its upload."""
        from byteps_tpu_torch.common import logging as bpslog

        rec["trig"].append(rule)
        self._counters.bump("flight_trigger", labels={"rule": rule})
        now = time.monotonic()
        last = self._last_fire.get(rule)
        if last is not None and now - last < self.bundle_interval_s:
            return  # counted, not written
        self._last_fire[rule] = now
        try:
            path = self.dump_bundle(rule, evidence, rec)
        except Exception as e:  # noqa: BLE001
            bpslog.warning("flight bundle dump failed: %r", e)
            return
        self._counters.bump("flight_bundle")
        if self.upload:
            with self._lock:
                self._uploads.append({
                    "rule": rule, "step": rec.get("step", 0), "t": rec.get("t"),
                    "evidence": evidence,
                    "record": {k: rec.get(k) for k in _COMPACT_KEYS},
                    "bundle": os.path.basename(path),
                })
                del self._uploads[:-8]  # a heartbeat outage must not grow it
        bpslog.warning("flight trigger %s fired at step %d — diagnostic bundle: %s "
                       "(inspect with: python tools/bps_doctor.py %s)",
                       rule, rec["step"], path, path)

    def dump_bundle(self, rule: str, evidence: dict, rec: dict) -> str:
        """Write one bundle directory and return its path: ``trigger.json``
        (rule, evidence, the firing record), ``ledger.jsonl`` (the ring),
        ``metrics.json`` (the registry's snapshot), ``config.json`` (the
        ``BYTEPS_*``/``DMLC_*`` environment and the control context); with
        tracing on, the trace window is flushed and ``trace_window.json``
        names its file."""
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(self.bundle_dir, f"{ts}-step{rec['step']}-{rule}-{os.getpid()}")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "trigger.json"), "w") as f:
            json.dump({"rule": rule, "evidence": evidence, "record": rec,
                       "time": time.time(), "pid": os.getpid()}, f, indent=2, default=str)
        with open(os.path.join(path, "ledger.jsonl"), "w") as f:
            for r in self.snapshot():
                f.write(json.dumps(r, default=str) + "\n")
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(self._registry.snapshot(), f, indent=2, default=str)
        env = {k: v for k, v in os.environ.items() if k.startswith(("BYTEPS_", "DMLC_"))}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"env": env, "context": self._context()}, f, indent=2, default=str)
        tracer = self._tracer
        if tracer is None:
            from byteps_tpu_torch.core.tracing import get_process_tracer

            tracer = get_process_tracer()
        if tracer is not None and tracer.enabled:
            trace_file = tracer.flush()
            with open(os.path.join(path, "trace_window.json"), "w") as f:
                json.dump({"flushed_to": trace_file}, f)
        self.bundles_written.append(path)
        return path


# --- the node's rules -------------------------------------------------------
#
# Each takes (recorder, record) and returns the evidence (it fires) or None.


def _rule_slow_step(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """The step took the slow factor times the median of the last ones."""
    dur = r.get("dur")
    if dur is None or len(rec._durs) < rec.min_history:
        return None
    med = statistics.median(rec._durs)
    if med > 0 and dur > med * rec.slow_factor:
        return {"dur": dur, "median": round(med, 6), "factor": rec.slow_factor}
    return None


def _rule_straggler_server(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """One server's round-trip p99 this step, the slow factor times its
    peers' median (floored at the first latency bucket)."""
    cells = [(rank, v) for rank, v in (r.get("rpc") or {}).items()
             if rank != "?" and v.get("n", 0) > 0]
    if len(cells) < 2:
        return None
    worst_rank, worst = max(cells, key=lambda kv: kv[1]["p99"])
    med = statistics.median(v["p99"] for rank, v in cells if rank != worst_rank)
    if worst["p99"] >= rec.slow_factor * max(med, 1e-4):
        return {"rank": worst_rank, "p99": worst["p99"], "peer_median_p99": round(med, 6),
                "retry": worst.get("retry", 0), "giveup": worst.get("giveup", 0)}
    return None


def _rule_hot_stripe(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """One C++ reducer stripe's sum seconds the slow factor times its
    siblings' median (``native_stripe_sum_seconds{stripe}``)."""
    cells = [(s, v) for s, v in (r.get("stripes") or {}).items() if v.get("n", 0) > 0]
    if len(cells) < 2:
        return None
    worst_stripe, worst = max(cells, key=lambda kv: kv[1]["s"])
    med = statistics.median(v["s"] for s, v in cells if s != worst_stripe)
    if worst["s"] >= rec.slow_factor * max(med, 1e-3):
        total = sum(v["s"] for _, v in cells)
        return {"stripe": worst_stripe, "sum_seconds": round(worst["s"], 6),
                "sibling_median": round(med, 6),
                "share": round(worst["s"] / max(total, 1e-12), 3)}
    return None


def _rule_queue_stall(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """A stage's dwell p99 this step at or past ``BYTEPS_FLIGHT_STALL_S``."""
    hot = {st: v for st, v in (r.get("stages") or {}).items()
           if v.get("n", 0) > 0 and v["p99"] >= rec.stall_s}
    if not hot:
        return None
    worst = max(hot, key=lambda st: hot[st]["p99"])
    return {"stage": worst, "p99": hot[worst]["p99"], "stall_s": rec.stall_s}


def _rule_degraded_flip(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """The control plane went degraded since the last record."""
    prev, rec._last_degraded = rec._last_degraded, r.get("deg", 0)
    if r.get("deg", 0) and not prev and prev is not None:
        return {"degraded": 1, "incarnation": r.get("incarnation", 0)}
    return None


def _rule_slo_breach(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """A step slower than the job's ``BYTEPS_JOB_SLO_S`` (absolute, where
    slow_step is relative to the job's own median)."""
    dur = r.get("dur")
    if dur is None or rec.slo_s <= 0 or dur <= rec.slo_s:
        return None
    return {"job": r.get("job", 0), "dur": dur, "slo_s": rec.slo_s,
            "over": round(dur / rec.slo_s, 3)}


#: CRC32C rejections in one record that make a storm
_CORRUPT_STORM_MIN = 3


def _rule_corruption_storm(rec: FlightRecorder, r: dict) -> Optional[dict]:
    """At least :data:`_CORRUPT_STORM_MIN` CRC32C rejections in one record,
    or a connection given up over them, on either engine."""
    ev = r.get("events") or {}
    fails = ev.get("wire_checksum_fail", 0) + ev.get("native_checksum_fail", 0)
    drops = ev.get("wire_checksum_conn_drop", 0) + ev.get("native_checksum_conn_drop", 0)
    if fails < _CORRUPT_STORM_MIN and not drops:
        return None
    return {"checksum_fails": fails, "conn_drops": drops,
            "injected": ev.get("chaos_payload_corrupt", 0)}


_RULES: Tuple[Tuple[str, Callable], ...] = (
    ("slow_step", _rule_slow_step),
    ("straggler_server", _rule_straggler_server),
    ("hot_stripe", _rule_hot_stripe),
    ("queue_stall", _rule_queue_stall),
    ("degraded_flip", _rule_degraded_flip),
    ("slo_breach", _rule_slo_breach),
    ("corruption_storm", _rule_corruption_storm),
)


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


def ensure_process_recorder(cfg=None, context_fn=None, tracer=None) -> FlightRecorder:
    """The process recorder, made by the first role to come up; later roles
    of an in-process fleet share its ring, as they share the registry."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(cfg=cfg, context_fn=context_fn, tracer=tracer)
        return _recorder
