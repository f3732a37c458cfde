"""The closed-loop autotuner of the scheduler (``byteps_tpu.core.autotune``).

With ``BYTEPS_AUTOTUNE`` the scheduler hosts an :class:`AutoTuner` that
sweeps every ``BYTEPS_AUTOTUNE_INTERVAL_S`` over a view it builds from
what the nodes report on their heartbeats (the metric aggregate, the
cluster step matrix of ``core/flightrec.py``, the servers' hot-key
reports), and ships its decisions to every node as a versioned ``tuning``
section of the books (with ``ring_overrides`` beside the ownership map),
adopted monotonically by tuning epoch.

Three policies, in this order (:data:`TUNE_RULES`):

- ``hot_key_rebalance``: one server's load at or above
  ``BYTEPS_AUTOTUNE_FACTOR`` times its peers' median for
  ``BYTEPS_AUTOTUNE_SWEEPS`` sweeps moves its hottest keys to the least
  loaded peer through a ring override, carried out by the migration
  plane (MIGRATE_STATE and the WRONG_OWNER chase; no re-init);
- ``fusion_threshold``: walks the fleet's ``BYTEPS_FUSION_THRESHOLD`` by
  the wire-RPC pressure and the fused packs' fill, with the flight
  matrix's stage dwell as a veto, inside a hysteresis band; it never
  turns fusion on or off;
- ``codec_consensus``: once a quorum of workers turned a codec off on
  their own (``compression_auto_off{codec}``, ``BYTEPS_COMPRESSION_AUTO``),
  the whole fleet stops compressing with it; its lossless arm does the
  same for ``compression_auto_lossless{codec}`` votes.

Each runs behind a cooldown, a budget of actions a sweep
(``BYTEPS_AUTOTUNE_BUDGET``) and a canary: ``BYTEPS_AUTOTUNE_CANARY_SWEEPS``
after an action the workers' median step is compared with the one at the
action, and a regression past ``BYTEPS_AUTOTUNE_REGRESS`` rolls it back
(``tune_rollback{rule}``) and quadruples the rule's cooldown.  With no
worker step seen, the baseline is None and no rollback can fire; the
decision's bundle records that.  ``BYTEPS_AUTOTUNE_FORCE`` scripts one
action.  Each action and rollback writes a ``decision.json`` under
``BYTEPS_FLIGHT_DIR``.

The policies are pure functions of the view, so tests drive both
packages' tuners on the same synthetic views and clock.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

#: every policy, in evaluation order (the fixed order makes the per-sweep
#: budget deterministic); a test pins it to byteps_tpu's
TUNE_RULES = ("hot_key_rebalance", "fusion_threshold", "codec_consensus")


def _warn(msg: str) -> None:
    print(f"byteps_tpu_torch: {msg}", file=sys.stderr, flush=True)


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


def tuner_enabled() -> bool:
    """``BYTEPS_AUTOTUNE`` truthiness — the master gate.  Off (default)
    keeps the scheduler's books byte-for-byte the legacy shape."""
    return os.environ.get("BYTEPS_AUTOTUNE", "").lower() not in (
        "", "0", "false", "no", "off"
    )


@dataclass
class TunerConfig:
    """Guardrail knobs (docs/autotune.md "Guardrails").  The structural
    bounds (fusion walk range, pack-quality bands) are deliberately NOT
    env vars — they are policy shape, overridable in tests by
    constructing the config directly."""

    interval_s: float = 1.0     # BYTEPS_AUTOTUNE_INTERVAL_S sweep cadence
    factor: float = 2.0         # BYTEPS_AUTOTUNE_FACTOR load-imbalance bar
    sweeps: int = 3             # BYTEPS_AUTOTUNE_SWEEPS consecutive-hot bar
    cooldown_s: float = 30.0    # BYTEPS_AUTOTUNE_COOLDOWN_S per rule
    canary_sweeps: int = 5      # BYTEPS_AUTOTUNE_CANARY_SWEEPS window
    regress: float = 1.3        # BYTEPS_AUTOTUNE_REGRESS rollback bar
    budget: int = 1             # BYTEPS_AUTOTUNE_BUDGET actions per sweep
    max_moves: int = 4          # BYTEPS_AUTOTUNE_MAX_MOVES keys per rebalance
    quorum: float = 0.5         # BYTEPS_AUTOTUNE_QUORUM codec-consensus share
    force: str = ""             # BYTEPS_AUTOTUNE_FORCE one-shot drill action
    bundle_dir: str = ""        # decision evidence (BYTEPS_FLIGHT_DIR)
    # structural policy shape (not env-tunable; see class docstring)
    fusion_min: int = 4096
    fusion_max: int = 4 << 20
    pack_lo: float = 1.5        # avg fused pack ≤ this → fusion is overhead
    pack_hi: float = 6.0        # avg fused pack ≥ this → packs saturate
    rpc_hi: int = 64            # per-sweep wire RPCs that count as pressure
    # dwell evidence bands (flight-matrix per-stage deltas): when the
    # matrix carries stage dwell, a walk step must also be justified in
    # TIME — counts alone can't tell a wire-bound fleet from one whose
    # steps live in COPYD2H/COMPRESS
    dwell_fuse_frac: float = 0.05  # FUSE ≥ this share of wire dwell → fusion costs real time
    dwell_wire_frac: float = 0.2   # wire stages ≥ this share of all dwell → wire-bound

    @classmethod
    def from_env(cls) -> "TunerConfig":
        return cls(
            interval_s=max(0.05, _env_float("BYTEPS_AUTOTUNE_INTERVAL_S", 1.0)),
            factor=max(1.1, _env_float("BYTEPS_AUTOTUNE_FACTOR", 2.0)),
            sweeps=max(1, _env_int("BYTEPS_AUTOTUNE_SWEEPS", 3)),
            cooldown_s=max(0.0, _env_float("BYTEPS_AUTOTUNE_COOLDOWN_S", 30.0)),
            canary_sweeps=max(1, _env_int("BYTEPS_AUTOTUNE_CANARY_SWEEPS", 5)),
            regress=max(1.01, _env_float("BYTEPS_AUTOTUNE_REGRESS", 1.3)),
            budget=max(1, _env_int("BYTEPS_AUTOTUNE_BUDGET", 1)),
            max_moves=max(1, _env_int("BYTEPS_AUTOTUNE_MAX_MOVES", 4)),
            quorum=min(1.0, max(0.0, _env_float("BYTEPS_AUTOTUNE_QUORUM", 0.5))),
            force=os.environ.get("BYTEPS_AUTOTUNE_FORCE", ""),
            bundle_dir=(
                os.environ.get("BYTEPS_FLIGHT_DIR") or "./flight_bundles"
            ),
        )


class TuningState:
    """The versioned fleet decision — what rides the book's ``tuning``
    section (plus ``ring_overrides`` beside the ownership fields).  The
    epoch bumps on every change; nodes adopt monotonically, so a
    re-broadcast or a stale book can never roll a decision back
    accidentally (only an explicit rollback action can, by bumping the
    epoch again)."""

    __slots__ = (
        "epoch", "fusion_threshold", "codec_off", "codec_lossless",
        "overrides",
    )

    def __init__(self) -> None:
        self.epoch = 0
        #: fleet fusion threshold in bytes; None = never touched (the
        #: book omits the field and workers keep their launch value)
        self.fusion_threshold: Optional[int] = None
        #: codec type names the fleet agreed to stop compressing with
        self.codec_off: List[str] = []
        #: codec type names whose raw-pushing keys the fleet agreed to
        #: ship inside the wire lossless container (the consensus
        #: policy's third arm; docs/gradient-compression.md)
        self.codec_lossless: List[str] = []
        #: key → server rank placement overrides (the weighted ring
        #: override); shipped as ``ring_overrides`` so ownership stays
        #: atomic with the map epoch
        self.overrides: Dict[int, int] = {}

    def tuning_dict(self) -> dict:
        t: dict = {"epoch": self.epoch}
        if self.fusion_threshold is not None:
            t["fusion_threshold"] = int(self.fusion_threshold)
        if self.codec_off:
            t["codec_off"] = sorted(self.codec_off)
        if self.codec_lossless:
            t["codec_lossless"] = sorted(self.codec_lossless)
        return t

    def apply_patch(self, patch: dict) -> bool:
        """Apply one action's state patch; returns True when key
        placement changed (the caller must bump the ownership-map epoch
        and let the migration plane execute the move)."""
        moved = False
        if "fusion_threshold" in patch:
            v = patch["fusion_threshold"]
            self.fusion_threshold = None if v is None else int(v)
        for name in patch.get("codec_off_add", ()):
            if name not in self.codec_off:
                self.codec_off.append(name)
        for name in patch.get("codec_off_remove", ()):
            if name in self.codec_off:
                self.codec_off.remove(name)
        for name in patch.get("codec_lossless_add", ()):
            if name not in self.codec_lossless:
                self.codec_lossless.append(name)
        for name in patch.get("codec_lossless_remove", ()):
            if name in self.codec_lossless:
                self.codec_lossless.remove(name)
        for key, rank in (patch.get("overrides_set") or {}).items():
            k = int(key)
            if self.overrides.get(k) != int(rank):
                self.overrides[k] = int(rank)
                moved = True
        for key in patch.get("overrides_del", ()):
            if self.overrides.pop(int(key), None) is not None:
                moved = True
        self.epoch += 1
        return moved


class AutoTuner:
    """The scheduler-hosted policy engine.  One :meth:`sweep` per
    ``BYTEPS_AUTOTUNE_INTERVAL_S``: evaluate due canaries (rolling back
    regressions), then the policies in ``TUNE_RULES`` order under the
    per-sweep budget.  Thread-safe: the scheduler's control threads call
    :meth:`note_hot` / :meth:`book_extras` concurrently with the sweep
    thread."""

    def __init__(
        self,
        cfg: Optional[TunerConfig] = None,
        registry=None,
        reshard: bool = False,
        now_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg or TunerConfig.from_env()
        self.state = TuningState()
        self._registry = registry
        #: rebalance only makes sense when the migration plane is armed
        #: (BYTEPS_ELASTIC_RESHARD on the scheduler): without it clients
        #: route by the legacy hash fns and overrides cannot land
        self.reshard = bool(reshard)
        self._now = now_fn
        self._lock = threading.RLock()
        self._sweep_idx = 0
        # per-rank load accumulators fed by the servers' heartbeat hot
        # reports ({"total": bytes, "keys": [[key, bytes]...], "owned"})
        self._hot_total: Dict[int, float] = {}
        self._hot_keys: Dict[int, Dict[int, float]] = {}
        self._hot_owned: Dict[int, int] = {}
        self._hot_streak: Dict[int, int] = {}
        # guardrail state
        self._last_action: Dict[str, float] = {}
        self._cooldown_mult: Dict[str, float] = {}
        self._canaries: List[dict] = []
        self._fusion_base: Dict[str, float] = {}
        self._forced = False
        #: the applied and rolled-back decisions, with their evidence
        self.actions: List[dict] = []
        self.rollbacks: List[dict] = []

    # --- inputs ----------------------------------------------------------

    def note_hot(self, rank: int, report: dict) -> None:
        """Fold one server's heartbeat hot-key report into the current
        sweep window.  Reports are per-beat deltas; several beats may
        land between sweeps, so totals accumulate until the sweep
        drains them."""
        if not isinstance(report, dict):
            return
        with self._lock:
            r = int(rank)
            try:
                self._hot_total[r] = self._hot_total.get(r, 0.0) + float(
                    report.get("total", 0) or 0
                )
                per = self._hot_keys.setdefault(r, {})
                for item in report.get("keys") or ():
                    key, nbytes = int(item[0]), float(item[1])
                    per[key] = per.get(key, 0.0) + nbytes
                if report.get("owned") is not None:
                    self._hot_owned[r] = int(report["owned"])
            except (TypeError, ValueError, IndexError):
                return

    def drain_hot(self) -> Tuple[Dict[int, float], Dict[int, list], Dict[int, int]]:
        """Consume the accumulated hot reports → (per-rank load bytes,
        per-rank ``[(key, bytes), ...]`` hottest-first, per-rank owned
        key counts).  The scheduler folds these into the sweep view."""
        with self._lock:
            loads = dict(self._hot_total)
            keys = {
                r: sorted(per.items(), key=lambda kv: -kv[1])
                for r, per in self._hot_keys.items()
            }
            owned = dict(self._hot_owned)
            self._hot_total.clear()
            self._hot_keys.clear()
            return loads, keys, owned

    # --- book surface ----------------------------------------------------

    def book_extras(self, live_server_ranks) -> dict:
        """The fields this tuner adds to every address book: the
        versioned ``tuning`` section (always present while the tuner is
        armed — its arrival is what tells servers to start shipping hot
        reports) and ``ring_overrides`` when any placement override is
        live.  Overrides are filtered to the book's own rank list so a
        book can never route a key at a rank it doesn't carry (an
        evicted target's overrides drop with it; the tuner prunes its
        state on the next sweep)."""
        live = {int(r) for r in (live_server_ranks or ())}
        with self._lock:
            extras: dict = {"tuning": self.tuning_dict()}
            if self.state.overrides:
                ov = {
                    str(k): int(r) for k, r in self.state.overrides.items()
                    if int(r) in live
                }
                if ov:
                    extras["ring_overrides"] = ov
        return extras

    def tuning_dict(self) -> dict:
        with self._lock:
            return self.state.tuning_dict()

    def adopt_rejoin_report(self, report: dict) -> bool:
        """Re-adopt a rejoiner's last-applied fleet tuning
        (docs/autotune.md "Rollback flow").  A REBORN scheduler's tuner
        starts empty at epoch 0; without this its first books would
        revert every live decision — workers restore launch fusion
        thresholds and every overridden key migrates home mid-training.
        The survivors carry the state: each rejoin REGISTER reports the
        tuning section (plus the ring overrides) the node last adopted,
        and the successor re-adopts the NEWEST report before emitting
        its first books.  Monotone by tuning epoch, so a live
        scheduler — whose own state is at or above anything the fleet
        ever saw — ignores every report, and racing rejoiners converge
        on the newest.  Returns True when state moved."""
        if not isinstance(report, dict):
            return False
        try:
            epoch = int(report.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            return False
        with self._lock:
            if epoch <= self.state.epoch:
                return False
            self.state.epoch = epoch
            ft = report.get("fusion_threshold")
            try:
                self.state.fusion_threshold = (
                    None if ft is None else int(ft)
                )
            except (TypeError, ValueError):
                self.state.fusion_threshold = None
            self.state.codec_off = [
                str(c) for c in (report.get("codec_off") or ())
            ]
            self.state.codec_lossless = [
                str(c) for c in (report.get("codec_lossless") or ())
            ]
            overrides: Dict[int, int] = {}
            for k, r in (report.get("ring_overrides") or {}).items():
                try:
                    overrides[int(k)] = int(r)
                except (TypeError, ValueError):
                    continue
            self.state.overrides = overrides
            return True

    # --- the sweep -------------------------------------------------------

    def sweep(self, view: dict) -> dict:
        """One control-loop iteration over the assembled cluster view.
        Returns ``{"actions", "rollbacks", "map_changed", "changed"}`` —
        the scheduler bumps the ownership-map epoch on ``map_changed``
        and re-broadcasts books on ``changed``.  Deterministic: equal
        views (and clock) produce equal decisions."""
        with self._lock:
            self._sweep_idx += 1
            applied: List[dict] = []
            rolled: List[dict] = []
            map_changed = False
            med = self._median_step(view)
            # prune overrides whose target rank left the fleet — the
            # ring (minus override) re-homes those keys; books already
            # filtered them, this just reconciles the state + epoch
            live = {int(r) for r in (view.get("server_ranks") or ())}
            if live:
                dead = [
                    k for k, r in self.state.overrides.items() if r not in live
                ]
                if dead:
                    map_changed |= self.state.apply_patch(
                        {"overrides_del": dead}
                    )
            # 1. due canaries first: a rollback must never queue behind
            # this sweep's fresh actions
            for canary in [
                c for c in self._canaries if self._sweep_idx >= c["deadline"]
            ]:
                self._canaries.remove(canary)
                base = canary.get("baseline")
                if base and med is not None and med > base * self.cfg.regress:
                    map_changed |= self._rollback(canary, med)
                    rolled.append(canary)
            # 2. the policies, fixed order, per-sweep budget
            for rule, fn in (
                ("hot_key_rebalance", self._policy_hot_key_rebalance),
                ("fusion_threshold", self._policy_fusion_threshold),
                ("codec_consensus", self._policy_codec_consensus),
            ):
                if len(applied) >= self.cfg.budget:
                    break
                if self._cooling(rule):
                    continue
                act = self._forced_action(rule, view) or fn(view)
                if act is None:
                    continue
                map_changed |= self._apply(act, med)
                applied.append(act)
            changed = bool(applied or rolled)
        return {
            "actions": applied,
            "rollbacks": rolled,
            "map_changed": map_changed,
            "changed": changed,
        }

    @staticmethod
    def _median_step(view: dict) -> Optional[float]:
        steps = [
            float(v) for v in (view.get("steps") or {}).values()
            if v is not None and v > 0
        ]
        return statistics.median(steps) if steps else None

    def _cooling(self, rule: str) -> bool:
        last = self._last_action.get(rule)
        if last is None:
            return False
        cd = self.cfg.cooldown_s * self._cooldown_mult.get(rule, 1.0)
        return self._now() - last < cd

    def _forced_action(self, rule: str, view: dict) -> Optional[dict]:
        """``BYTEPS_AUTOTUNE_FORCE="fusion_threshold=65536"`` (or
        ``codec_off=<name>``, ``codec_lossless=<name>``,
        ``move=<key>:<rank>``): apply one operator-
        scripted action on the first eligible sweep — the canary/rollback
        drill path (docs/autotune.md "Rollback flow")."""
        if self._forced or not self.cfg.force:
            return None
        k, _, v = self.cfg.force.partition("=")
        k = k.strip()
        try:
            if k == "fusion_threshold" and rule == "fusion_threshold":
                self._forced = True
                # undo = the fleet's current concrete value: tuner state
                # if set, else the workers' reported gauge — None would
                # make the rollback a fleet-wide no-op (book omits the
                # field, workers keep the forced value)
                prev_ft = self.state.fusion_threshold
                if prev_ft is None:
                    try:
                        prev_ft = int(
                            (view.get("fusion") or {}).get("threshold") or 0
                        ) or None
                    except (TypeError, ValueError):
                        prev_ft = None
                return {
                    "rule": rule,
                    "set": {"fusion_threshold": int(v)},
                    "undo": {"fusion_threshold": prev_ft},
                    "evidence": {"forced": self.cfg.force},
                }
            if k == "codec_off" and rule == "codec_consensus":
                self._forced = True
                return {
                    "rule": rule,
                    "set": {"codec_off_add": [v.strip()]},
                    "undo": {"codec_off_remove": [v.strip()]},
                    "evidence": {"forced": self.cfg.force},
                }
            if k == "codec_lossless" and rule == "codec_consensus":
                self._forced = True
                return {
                    "rule": rule,
                    "set": {"codec_lossless_add": [v.strip()]},
                    "undo": {"codec_lossless_remove": [v.strip()]},
                    "evidence": {"forced": self.cfg.force},
                }
            if k == "move" and rule == "hot_key_rebalance" and self.reshard:
                key_s, _, rank_s = v.partition(":")
                key = int(key_s)
                self._forced = True
                prev = self.state.overrides.get(key)
                undo = (
                    {"overrides_set": {key: prev}} if prev is not None
                    else {"overrides_del": [key]}
                )
                return {
                    "rule": rule,
                    "set": {"overrides_set": {key: int(rank_s)}},
                    "undo": undo,
                    "evidence": {"forced": self.cfg.force},
                }
        except (TypeError, ValueError):
            self._forced = True  # malformed: warn once, never retry
            _warn(f"BYTEPS_AUTOTUNE_FORCE={self.cfg.force!r} is malformed: ignored")
        return None

    # --- policies (pure: view in, action dict or None out) ---------------

    def _policy_hot_key_rebalance(self, view: dict) -> Optional[dict]:
        """One server's load ≥ factor × peer median for N consecutive
        sweeps → move its hottest keys to the least-loaded reporting
        peer.  Only ranks that ship hot reports participate (the
        Python-engine servers — the native engine cannot migrate state,
        so it is never a source or a target; docs/autotune.md)."""
        if not self.reshard:
            return None
        loads: Dict[int, float] = {
            int(r): float(v) for r, v in (view.get("server_load") or {}).items()
        }
        if len(loads) < 2:
            self._hot_streak.clear()
            return None
        hot_rank = max(loads, key=lambda r: loads[r])
        peers = [v for r, v in loads.items() if r != hot_rank]
        med = statistics.median(peers)
        if loads[hot_rank] < self.cfg.factor * max(med, 1.0):
            self._hot_streak.clear()
            return None
        streak = self._hot_streak.get(hot_rank, 0) + 1
        self._hot_streak = {hot_rank: streak}  # a new hot rank restarts
        if streak < self.cfg.sweeps:
            return None
        hot_keys = (view.get("hot_keys") or {}).get(hot_rank) or []
        target = min(
            (r for r in loads if r != hot_rank), key=lambda r: loads[r]
        )
        moves: Dict[int, int] = {}
        for key, nbytes in hot_keys:
            if len(moves) >= self.cfg.max_moves:
                break
            key = int(key)
            if self.state.overrides.get(key) == target:
                continue
            moves[key] = target
        if not moves:
            return None
        self._hot_streak.clear()
        prev_set = {
            k: self.state.overrides[k] for k in moves
            if k in self.state.overrides
        }
        undo: dict = {"overrides_del": [k for k in moves if k not in prev_set]}
        if prev_set:
            undo["overrides_set"] = prev_set
        return {
            "rule": "hot_key_rebalance",
            "set": {"overrides_set": moves},
            "undo": undo,
            "evidence": {
                "hot_rank": hot_rank,
                "hot_load": round(loads[hot_rank], 1),
                "peer_median": round(med, 1),
                "factor": self.cfg.factor,
                "streak": streak,
                "target": target,
                "moves": {str(k): r for k, r in moves.items()},
            },
        }

    def _policy_fusion_threshold(self, view: dict) -> Optional[dict]:
        """Walk the fleet fusion threshold by the observed step mix.
        Inputs are cumulative totals from the aggregate (``wire_rpc``,
        ``fused_frames``, ``fused_keys``) plus the flight matrix's
        per-stage dwell totals; this policy deltas both against the
        previous sweep.  Shrink when fusion is pure overhead (packs
        barely coalesce AND the FUSE stage dwells a real share of wire
        time), grow when wire-RPC pressure stays high while packs
        saturate (or nothing fuses at all) AND the wire stages dominate
        the pipeline's dwell; the band between is the hysteresis dead
        zone.  Fleets whose heartbeats carry no dwell (older workers)
        degrade to the count-only walk."""
        f = view.get("fusion") or {}
        cur = self.state.fusion_threshold
        if cur is None:
            try:
                cur = int(f.get("threshold") or 0)
            except (TypeError, ValueError):
                cur = 0
        if cur <= 0:
            return None  # fusion off fleet-wide: the FUSE stage doesn't exist
        deltas = {}
        for name in ("wire_rpc", "fused_frames", "fused_keys"):
            total = float(f.get(name) or 0)
            deltas[name] = max(0.0, total - self._fusion_base.get(name, 0.0))
            self._fusion_base[name] = total
        rpc, fused, keys = (
            deltas["wire_rpc"], deltas["fused_frames"], deltas["fused_keys"]
        )
        # per-stage dwell deltas (the flight-matrix evidence): where
        # the workers' step time actually WENT since the last sweep
        dw: Dict[str, float] = {}
        for stage, total in (f.get("dwell") or {}).items():
            name = "dwell." + str(stage)
            try:
                tot = float(total)
            except (TypeError, ValueError):
                continue
            dw[str(stage)] = max(0.0, tot - self._fusion_base.get(name, 0.0))
            self._fusion_base[name] = tot
        wire_d = dw.get("PUSH", 0.0) + dw.get("FUSE", 0.0)
        total_d = sum(dw.values())
        have_dwell = total_d > 0.0
        if rpc <= 0 and fused <= 0:
            return None  # idle sweep: no evidence either way
        avg_pack = keys / fused if fused else 0.0
        new = cur
        if fused and avg_pack <= self.cfg.pack_lo and rpc >= 1:
            # dwell veto: degenerate packs only justify a shrink when
            # the FUSE stage actually dwells a real share of wire time —
            # a fuser nobody waits on isn't worth a fleet-wide walk step
            if not have_dwell or wire_d <= 0.0 or (
                dw.get("FUSE", 0.0) >= self.cfg.dwell_fuse_frac * wire_d
            ):
                new = max(self.cfg.fusion_min, cur // 2)
        elif rpc >= self.cfg.rpc_hi and (
            fused == 0 or avg_pack >= self.cfg.pack_hi
        ):
            # dwell veto: RPC pressure only justifies a grow when the
            # wire stages dominate the pipeline — growing the pack size
            # of a COPYD2H/COMPRESS-bound fleet just adds latency
            if not have_dwell or (
                wire_d >= self.cfg.dwell_wire_frac * total_d
            ):
                new = min(self.cfg.fusion_max, cur * 2)
        if new == cur:
            return None
        evidence = {
            "from": cur, "to": new,
            "wire_rpc": int(rpc), "fused_frames": int(fused),
            "avg_pack": round(avg_pack, 2),
            "band": [self.cfg.pack_lo, self.cfg.pack_hi],
        }
        if have_dwell:
            evidence["dwell_wire_s"] = round(wire_d, 6)
            evidence["dwell_total_s"] = round(total_d, 6)
        return {
            "rule": "fusion_threshold",
            "set": {"fusion_threshold": new},
            # undo restores the CONCRETE pre-action value (cur), never
            # None: a None patch makes the book omit the field, which
            # workers read as "untouched" — the regressed threshold
            # would survive its own rollback
            "undo": {"fusion_threshold": cur},
            "evidence": evidence,
        }

    def _policy_codec_consensus(self, view: dict) -> Optional[dict]:
        """A quorum of workers locally disabled one codec
        (``compression_auto_off{codec}`` verdicts) → make it a fleet
        decision so the stragglers stop paying for a codec the majority
        measured as a loss.  One codec per sweep (the budget applies
        anyway); needs ≥2 workers — one worker's verdict is already
        fleet-wide.

        Third arm: workers whose entropy probe found a raw-pushing
        codec's bytes losslessly compressible vote
        ``compression_auto_lossless{codec}`` — the same quorum share
        turns the wire lossless container on fleet-wide for that
        codec's raw keys (``codec_lossless`` in the book; only codecs
        ALREADY fleet-raw or locally verdicted raw can accumulate these
        votes, so the two arms never race on one codec)."""
        try:
            nw = int(view.get("num_workers") or 0)
        except (TypeError, ValueError):
            nw = 0
        if nw < 2:
            return None
        need = max(1, math.ceil(self.cfg.quorum * nw))
        votes = view.get("codec_votes") or {}
        for name in sorted(votes):
            if name in ("?", "") or name in self.state.codec_off:
                continue
            n = int(votes[name])
            if n >= need:
                return {
                    "rule": "codec_consensus",
                    "set": {"codec_off_add": [name]},
                    "undo": {"codec_off_remove": [name]},
                    "evidence": {
                        "codec": name, "votes": n, "quorum": need,
                        "num_workers": nw,
                    },
                }
        lz_votes = view.get("codec_lossless_votes") or {}
        for name in sorted(lz_votes):
            if name in ("?", "") or name in self.state.codec_lossless:
                continue
            n = int(lz_votes[name])
            if n >= need:
                return {
                    "rule": "codec_consensus",
                    "set": {"codec_lossless_add": [name]},
                    "undo": {"codec_lossless_remove": [name]},
                    "evidence": {
                        "codec": name, "arm": "lossless",
                        "votes": n, "quorum": need, "num_workers": nw,
                    },
                }
        return None

    # --- apply / rollback ------------------------------------------------

    def _apply(self, act: dict, med: Optional[float]) -> bool:
        rule = act["rule"]
        moved = self.state.apply_patch(act["set"])
        self._last_action[rule] = self._now()
        self._bump("tune_action", rule)
        canary = {
            "rule": rule,
            "action": act,
            "sweep": self._sweep_idx,
            "deadline": self._sweep_idx + self.cfg.canary_sweeps,
            # the pre-action cluster median step time; None (no worker
            # steps observed yet) disables the rollback comparison —
            # recorded in the bundle so the absence is auditable
            "baseline": med,
            "epoch": self.state.epoch,
        }
        self._canaries.append(canary)
        self.actions.append(act)
        self._write_bundle("action", rule, {
            "action": act, "baseline_step_s": med,
            "tuning_epoch": self.state.epoch, "sweep": self._sweep_idx,
        })
        _warn(f"autotune action {rule} (tuning epoch {self.state.epoch}): "
              f"{act.get('evidence')}; canary window {self.cfg.canary_sweeps} sweeps, "
              f"baseline step {med if med is not None else -1.0:.4f} s")
        return moved

    def _rollback(self, canary: dict, med: float) -> bool:
        rule = canary["rule"]
        moved = self.state.apply_patch(canary["action"]["undo"])
        self._bump("tune_rollback", rule)
        # a rolled-back rule earns a longer bench before its next try
        self._cooldown_mult[rule] = min(
            16.0, self._cooldown_mult.get(rule, 1.0) * 4.0
        )
        self._last_action[rule] = self._now()
        canary["post_step_s"] = med
        self.rollbacks.append(canary)
        self._write_bundle("rollback", rule, {
            "action": canary["action"],
            "baseline_step_s": canary.get("baseline"),
            "post_step_s": med,
            "regress_bar": self.cfg.regress,
            "tuning_epoch": self.state.epoch,
            "sweep": self._sweep_idx,
        })
        _warn(f"autotune ROLLBACK {rule}: median step {med:.4f} s > "
              f"{canary.get('baseline') or 0.0:.4f} s x {self.cfg.regress:.2f}; decision "
              f"reverted (tuning epoch {self.state.epoch}), cooldown "
              f"x{self._cooldown_mult[rule]:.0f}")
        return moved

    def _bump(self, name: str, rule: str) -> None:
        if self._registry is None:
            return
        try:
            self._registry.counters.bump(name, labels={"rule": rule})
        except Exception:  # noqa: BLE001 — telemetry must not kill a sweep
            pass

    def _write_bundle(self, kind: str, rule: str, body: dict) -> None:
        """Flight-style decision evidence: one directory per decision
        under the scheduler's bundle dir, next to the nodes' uploaded
        trigger bundles — the tuner's actions and their inputs land in
        the same place the incident evidence does."""
        if not self.cfg.bundle_dir:
            return
        try:
            ts = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                self.cfg.bundle_dir,
                f"{ts}-tune-{kind}-{rule}-s{self._sweep_idx}",
            )
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "decision.json"), "w") as fh:
                json.dump(
                    {"kind": kind, "rule": rule, "time": time.time(), **body},
                    fh, indent=2, default=str,
                )
        except OSError:
            pass
