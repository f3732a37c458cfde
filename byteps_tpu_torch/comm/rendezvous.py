"""Scheduler node: registration rendezvous, the global barrier and the
membership of the job (ps-lite's scheduler, SURVEY §2.4), on the wire of
``byteps_tpu.comm.rendezvous``.

Every worker and server REGISTERs at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``
with a JSON payload.  Once the expected population (``DMLC_NUM_WORKER`` +
``DMLC_NUM_SERVER``) is present, the scheduler sends each node an ADDRBOOK:
its rank within its role, the servers' addresses in rank order, and the
fields the reference's books carry, so workers and servers of either
package adopt it.  Persistent connections then serve BARRIER (released when
the group is full), PING, QUERY (heartbeat ages, :meth:`Scheduler.liveness`)
and SHUTDOWN.  Control payloads are JSON, never pickle.

A heartbeat may carry the node's metric delta (``core/telemetry.py``):
the scheduler folds it into ``metrics_agg``, its cluster aggregate, under
``{role, rank}`` labels, served in the Prometheus text format on
``BYTEPS_METRICS_PORT``; the delta's ``fr`` field (the node's flight
ledger tail) goes to ``flight``, the cluster step matrix
(``core/flightrec.py``), its ``fb`` field (the node's uploaded flight
bundles, ``BYTEPS_FLIGHT_UPLOAD``) under the scheduler's
``BYTEPS_FLIGHT_DIR`` (``flight_bundle_rx``), and a server's ``hot``
report to the tuner.

Membership (docs/elasticity.md; docs/robustness.md, "Liveness policy and
eviction" and "Control-plane recovery"):

- a REGISTER after the books went out is a rejoin, matched by the node's
  uid (workers register with no address, so an address would alias them).
  A known uid gets its old rank back in a recovery book, and its first
  barrier is released at once (the rest of the cluster is not at one); a
  reconnect of a live runtime (``reconnect`` in the payload) is not.  An
  unknown uid adopts a dead member's slot, joins at the lowest free rank
  when the population has room, and is refused when the cluster is full;
- a worker that registers with another worker or server count resizes the
  job: dead entries are pruned, a scale-down of the servers keeps the
  lowest ranks and sends SHUTDOWN to the others, and a scale-up parks the
  worker's book until the new server registered.  Every topology change
  bumps the membership ``epoch`` and goes to the other nodes as an
  unsolicited book (seq ``RESIZE_SEQ``);
- with ``BYTEPS_DEAD_NODE_TIMEOUT_S`` set, a monitor evicts every node whose
  last message is older than that: the population shrinks, the barriers
  the dead node would have joined are scrubbed of its waiters and
  released when full, its connection is closed, and the books carry the
  cumulative ``evictions``.  A worker whose book is parked on a server
  scale-up cannot beat and is evicted alike once the timeout passes, so
  the new server must register within it;
- the scheduler restarts without state.  Each instance stamps its books
  with an incarnation id (nodes refuse an older one).  A restarted one
  rebuilds its table from the survivors' re-REGISTERs, which carry uid,
  last rank, topology and both epochs: it honours the ranks, adopts the
  reported topology, floors its epochs to the maxima reported and fences
  its first books above them.  ``BYTEPS_SCHED_REJOIN_WINDOW_S`` bounds how
  long it waits for every reported rank before adopting the partial
  population (a first boot never arms the window).

Online resharding (``BYTEPS_ELASTIC_RESHARD=1``, docs/robustness.md
"migration flow"): ``map_epoch`` is bumped only when the server set
changes, and with ``server_ranks`` it names the ownership map (a
consistent-hash ring over those ranks, ``common.hashing.OwnershipMap``)
that every receiver builds from its book.  A scale-down then queues each
dropped server for a drain book (the settled topology, its own rank
excluded, ``"drain": true``), sent after the map-epoch bump, instead of a
SHUTDOWN: the server ships every key to its new owner and stops itself.

A heartbeat may carry the node's metric delta (``core/telemetry.py``):
the scheduler folds it into ``metrics_agg``, its cluster aggregate, under
``{role, rank}`` labels; the delta's ``fr`` field (the node's flight
ledger tail) goes to ``flight``, the cluster step matrix
(``core/flightrec.py``), and a server's ``hot`` report to the tuner.

The autotuner (``BYTEPS_AUTOTUNE``, ``core/autotune.py``): a thread sweeps
every ``BYTEPS_AUTOTUNE_INTERVAL_S`` over a view of the aggregate, the
step matrix and the hot reports (:meth:`Scheduler._tuner_view`).  A sweep
that changed something sends every node a RESIZE_SEQ book, after bumping
``map_epoch`` when it moved a key (the servers then migrate it).  Every
book carries the ``tuning`` section and any ``ring_overrides``.  A
restarted scheduler adopts the newest tuning its rejoining nodes report
before its first books, so a live decision is confirmed, not reverted.
With the tuner off, the books and the heartbeat replies are what they
were before the tuner existed.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from byteps_tpu_torch.comm.transport import (
    Message,
    Op,
    close_socket,
    listen,
    recv_message,
    send_message,
)

GROUP_WORKERS = 1
GROUP_SERVERS = 2
GROUP_ALL = 3

#: seq of the unsolicited ADDRBOOK a node gets when the topology changed
RESIZE_SEQ = 0xFFFFFFFF


def _log(msg: str) -> None:
    print(f"byteps_tpu_torch scheduler: {msg}", file=sys.stderr, flush=True)


@dataclass
class _Node:
    rank: int
    host: str
    port: int
    conn: Any
    send_lock: Any
    uid: str
    #: the worker's job and its declared share, for the books' job map
    job: int = 0
    job_priority: int = 1
    job_quota_mbps: float = 0.0


class Scheduler:
    """Run with ``DMLC_ROLE=scheduler`` (``python -m byteps_tpu_torch.server``)."""

    def __init__(self, num_workers: int, num_servers: int,
                 host: str = "0.0.0.0", port: int = 0,
                 dead_node_timeout: Optional[float] = None,
                 incarnation: Optional[int] = None,
                 rejoin_window: Optional[float] = None) -> None:
        from byteps_tpu_torch.common.config import _env_bool, _env_float

        self.num_workers = num_workers
        self.num_servers = num_servers
        #: stamped into every book: nodes refuse books from an older
        #: incarnation than one they saw (wall-clock ns, so a successor
        #: compares higher)
        self.incarnation = int(incarnation) if incarnation is not None else time.time_ns()
        if rejoin_window is None:
            rejoin_window = _env_float("BYTEPS_SCHED_REJOIN_WINDOW_S", 15.0)
        self.rejoin_window = rejoin_window
        #: registrants that reported a prior incarnation: a rebirth
        self._rejoin_reports = 0
        self._grace_thread: Optional[threading.Thread] = None
        if dead_node_timeout is None:
            dead_node_timeout = _env_float("BYTEPS_DEAD_NODE_TIMEOUT_S", 0.0)
        self.dead_node_timeout = dead_node_timeout
        if dead_node_timeout > 0:
            hb = _env_float("BYTEPS_HEARTBEAT_INTERVAL", 5.0)
            if hb <= 0 or dead_node_timeout < 3 * hb:
                _log(f"BYTEPS_DEAD_NODE_TIMEOUT_S={dead_node_timeout:.1f} needs heartbeats "
                     f"at least 3x faster (BYTEPS_HEARTBEAT_INTERVAL={hb:.1f}): healthy "
                     "nodes risk eviction")
        #: membership epoch: bumped by every topology change
        self.epoch = 0
        #: the epoch of the server set (bumped when it changes)
        self.map_epoch = 0
        self._map_sig: Optional[tuple] = None
        #: the resharding policy: a scale-down drains the dropped servers
        #: (they ship their keys out and stop) instead of stopping them cold
        self.reshard = _env_bool("BYTEPS_ELASTIC_RESHARD")
        #: dropped servers awaiting their drain book, sent after the
        #: map-epoch bump in _complete_recovery
        self._pending_drains: List[_Node] = []
        #: cumulative evictions per role, carried in every book
        self.eviction_totals: Dict[str, int] = {"worker": 0, "server": 0}
        from byteps_tpu_torch.comm.chaos import ChaosParams, control_chaos_enabled

        #: BYTEPS_CHAOS_SCHED: the accepted control connections are faulted
        self._chaos_params = ChaosParams.from_env() if control_chaos_enabled() else None
        self._sock, self.port = listen(host, port)
        self._lock = threading.Lock()
        self._nodes: Dict[str, List[_Node]] = {"worker": [], "server": []}
        self._addrbook_sent = False
        #: (group, round) -> [(conn, send_lock, seq)]
        self._barriers: Dict[Tuple[int, int], List] = {}
        self._barrier_round = {GROUP_WORKERS: 0, GROUP_SERVERS: 0, GROUP_ALL: 0}
        self._stop = threading.Event()
        self._conns: List[Any] = []
        #: conn -> (role, rank) of a registered node, for its heartbeats
        self._conn_ids: Dict[Any, Tuple[str, int]] = {}
        self._last_seen: Dict[Tuple[str, int], float] = {}
        #: connections of rejoined runtimes: their first barrier releases
        #: at once
        self._recovered_conns: set = set()
        #: worker registrations parked until a server scale-up completes:
        #: (conn, send_lock, role, rank, seq)
        self._parked_regs: List[tuple] = []
        self._pending_broadcast = False
        from byteps_tpu_torch.core.autotune import AutoTuner, tuner_enabled
        from byteps_tpu_torch.core.flightrec import ClusterFlight
        from byteps_tpu_torch.core.telemetry import MetricsRegistry

        #: the cluster aggregate of the nodes' heartbeat deltas, and its
        #: endpoint (BYTEPS_METRICS_PORT)
        self.metrics_agg = MetricsRegistry()
        self._metrics_http = None
        self.metrics_agg.gauge_fn("cluster_map_epoch", lambda: self.map_epoch)
        #: the cluster step matrix of the nodes' flight ledger tails
        self.flight = ClusterFlight()
        self.flight.attach(self.metrics_agg)
        #: the autotuner (BYTEPS_AUTOTUNE), None when off
        self.tuner: Optional[AutoTuner] = None
        if tuner_enabled():
            self.tuner = AutoTuner(registry=self.metrics_agg, reshard=self.reshard)
            self.metrics_agg.gauge_fn("cluster_tuning_epoch", lambda: self.tuner.state.epoch)

    def start(self) -> None:
        threading.Thread(target=self._accept_loop, name="sched-accept", daemon=True).start()
        port = max(0, int(os.environ.get("BYTEPS_METRICS_PORT") or 0))
        if port > 0 and self._metrics_http is None:
            from byteps_tpu_torch.core.telemetry import serve_metrics

            # the cluster aggregate: one scrape sees the whole job
            self._metrics_http = serve_metrics(port, self.metrics_agg.render_prometheus)
        if self.dead_node_timeout > 0:
            threading.Thread(target=self._monitor_loop, name="sched-liveness",
                             daemon=True).start()
        if self.tuner is not None:
            threading.Thread(target=self._tuner_loop, name="sched-autotune",
                             daemon=True).start()

    # --- the autotuner ---------------------------------------------------

    def _tuner_loop(self) -> None:
        while not self._stop.wait(self.tuner.cfg.interval_s):
            try:
                self._tuner_sweep_once()
            except Exception as e:  # noqa: BLE001 - the loop must live
                _log(f"autotune sweep error: {e!r}")

    def _tuner_view(self) -> dict:
        """One sweep's input: each server's load and hottest keys (the hot
        reports since the last sweep), each worker's last step and the
        workers' stage dwell (the step matrix), the fusion counters and
        the fleet's fusion threshold (the aggregate), and per codec the
        workers that turned it off on their own."""
        loads, hot_keys, owned = self.tuner.drain_hot()
        steps: Dict[str, float] = {}
        dwell: Dict[str, float] = {}
        for who, recs in self.flight.matrix().items():
            if not who.startswith("worker"):
                continue
            for r in reversed(recs):
                if r.get("k") == "step" and r.get("dur"):
                    steps[who] = float(r["dur"])
                    break
            for r in recs:
                for stage, nv in (r.get("st") or {}).items():
                    try:
                        dwell[stage] = dwell.get(stage, 0.0) + float(nv[1])
                    except (TypeError, ValueError, IndexError):
                        continue
        flat = self.metrics_agg.counters.snapshot()
        labeled = self.metrics_agg.counters.labeled_raw()

        def votes(name: str) -> Dict[str, int]:
            by_codec: Dict[str, set] = {}
            for lkey, v in (labeled.get(name) or {}).items():
                ld = dict(lkey)
                codec = ld.get("codec")
                if v > 0 and codec and ld.get("role", "worker") == "worker":
                    by_codec.setdefault(codec, set()).add(ld.get("rank", "?"))
            return {c: len(rs) for c, rs in by_codec.items()}

        with self.metrics_agg._lock:
            gauges = dict(self.metrics_agg._gauges)
        thr = max([float(v) for (name, _lk), v in gauges.items()
                   if name == "fusion_threshold_bytes"] or [0.0])
        with self._lock:
            ranks = [n.rank for n in self._nodes["server"]]
            nw = len(self._nodes["worker"])
        return {
            "server_ranks": ranks,
            "num_workers": nw,
            "steps": steps,
            "server_load": loads,
            "hot_keys": hot_keys,
            "owned": owned,
            "fusion": {"threshold": thr, "wire_rpc": flat.get("wire_rpc", 0),
                       "fused_frames": flat.get("fused_frames", 0),
                       "fused_keys": flat.get("fused_keys", 0), "dwell": dwell},
            "codec_votes": votes("compression_auto_off"),
            "codec_lossless_votes": votes("compression_auto_lossless"),
        }

    def _tuner_sweep_once(self) -> dict:
        """One sweep; a change goes out in RESIZE_SEQ books (once the first
        books went out: before, they carry it)."""
        res = self.tuner.sweep(self._tuner_view())
        if not res["changed"]:
            return res
        with self._lock:
            if res["map_changed"]:
                # the placement moved: the map epoch moves with it, so the
                # servers migrate and stale requests chase
                self.map_epoch += 1
            if self._addrbook_sent:
                for r in ("worker", "server"):
                    for node in self._nodes[r]:
                        self._send_addrbook_to(node.conn, node.send_lock, r, node.rank,
                                               RESIZE_SEQ)
        return res

    def _merge_metric_delta(self, conn, payload: bytes) -> None:
        """Fold a heartbeat's metric delta into the aggregate under the
        sender's {role, rank}; its flight tail goes to the step matrix and
        a server's hot report to the tuner (dropped with the tuner off).
        A malformed payload is dropped."""
        try:
            delta = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(delta, dict):
            return
        with self._lock:
            ident = self._conn_ids.get(conn)
        labels = {"role": ident[0], "rank": str(ident[1])} if ident else None
        tail = delta.pop("fr", None)
        if tail and ident:
            try:
                self.flight.merge(ident[0], ident[1], tail)
            except Exception as e:  # noqa: BLE001
                _log(f"flight tail merge failed: {e!r}")
        hot = delta.pop("hot", None)
        if hot and ident and ident[0] == "server" and self.tuner is not None:
            self.tuner.note_hot(ident[1], hot)
        fb = delta.pop("fb", None)
        if fb and ident:
            try:
                self._store_uploaded_bundles(ident, fb)
            except Exception as e:  # noqa: BLE001
                _log(f"flight bundle store failed: {e!r}")
        try:
            self.metrics_agg.merge_delta(delta, labels=labels)
        except Exception as e:  # noqa: BLE001
            _log(f"metric delta merge failed: {e!r}")

    def _store_uploaded_bundles(self, ident, bundles) -> None:
        """A node's uploaded flight bundles (their compact form) under this
        scheduler's ``BYTEPS_FLIGHT_DIR``, one ``trigger.json`` each, beside
        the tuner's decision bundles."""
        base = os.environ.get("BYTEPS_FLIGHT_DIR") or "./flight_bundles"
        who = f"{ident[0]}{ident[1]}" if ident else "unknown"
        for b in bundles or ():
            if not isinstance(b, dict):
                continue
            try:
                path = os.path.join(base, f"{time.strftime('%Y%m%d-%H%M%S')}-{who}"
                                          f"-step{b.get('step', 0)}-{b.get('rule', 'trigger')}")
                os.makedirs(path, exist_ok=True)
                with open(os.path.join(path, "trigger.json"), "w") as f:
                    json.dump(b, f, indent=2, default=str)
            except OSError:
                continue
            self.metrics_agg.counters.bump("flight_bundle_rx")

    def stop(self) -> None:
        self._stop.set()
        if self._metrics_http is not None:
            self._metrics_http.close()
            self._metrics_http = None
        close_socket(self._sock)  # shutdown wakes the accept loop
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            close_socket(conn)

    def crash(self) -> None:
        """Die as ``kill -9`` would: every connection closes with no frame
        (the peers see FIN), no books, no SHUTDOWN.  For tests: a successor
        on the same port rebuilds the table from the re-REGISTERs."""
        self.stop()

    # --- connections -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._chaos_params is not None:
                # the scheduler's half of BYTEPS_CHAOS_SCHED: its frames
                # (books, barrier releases, PING acks) can be faulted
                from byteps_tpu_torch.comm.chaos import ChaosSocket, _next_ctrl_conn_index

                conn = ChaosSocket(conn, self._chaos_params, _next_ctrl_conn_index(),
                                   peer_port=self.port)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn) -> None:
        send_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                msg = recv_message(conn)
                self._touch(conn)
                if msg.op == Op.REGISTER:
                    self._handle_register(conn, send_lock, msg)
                elif msg.op == Op.BARRIER:
                    self._handle_barrier(conn, send_lock, msg)
                elif msg.op == Op.PING:
                    if msg.payload:
                        self._merge_metric_delta(conn, msg.payload)
                    send_message(conn, Message(Op.PING, seq=msg.seq), send_lock)
                elif msg.op == Op.QUERY:
                    send_message(conn, Message(
                        Op.QUERY, seq=msg.seq, payload=json.dumps(self.liveness()).encode(),
                    ), send_lock)
                elif msg.op == Op.SHUTDOWN:
                    send_message(conn, Message(Op.SHUTDOWN, seq=msg.seq), send_lock)
                    return
        except (ConnectionError, OSError):
            return
        except Exception as e:  # noqa: BLE001 - a bad request must not kill the thread
            _log(f"dropped a connection on a bad request: {e!r}")
            return
        finally:
            close_socket(conn)
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                self._conn_ids.pop(conn, None)
                self._recovered_conns.discard(conn)

    def _touch(self, conn) -> None:
        with self._lock:
            ident = self._conn_ids.get(conn)
            if ident is not None:
                self._last_seen[ident] = time.monotonic()

    def liveness(self) -> Dict[str, Dict[int, float]]:
        """Seconds since each registered node's last message."""
        now = time.monotonic()
        out: Dict[str, Dict[int, float]] = {"worker": {}, "server": {}}
        with self._lock:
            for (role, rank), ts in self._last_seen.items():
                out[role][rank] = now - ts
        return out

    # --- the liveness policy ---------------------------------------------

    def _monitor_loop(self) -> None:
        tick = max(0.05, min(1.0, self.dead_node_timeout / 4))
        while not self._stop.wait(tick):
            try:
                self._evict_dead_once()
            except Exception as e:  # noqa: BLE001 - the monitor must live
                _log(f"liveness monitor error: {e!r}")

    def _evict_dead_once(self) -> None:
        """Evict every node silent for longer than the timeout (a crashed
        node and a hung one alike), and send the shrunken topology out."""
        now = time.monotonic()
        doomed: List[Tuple[str, _Node]] = []
        with self._lock:
            if not self._addrbook_sent:
                return  # nobody heartbeats before its book
            for role in ("worker", "server"):
                for n in self._nodes[role]:
                    if now - self._last_seen.get((role, n.rank), now) > self.dead_node_timeout:
                        doomed.append((role, n))
            if not doomed:
                return
            for role, n in doomed:
                _log(f"evicting {role} rank={n.rank} uid={n.uid}: no heartbeat for "
                     f"{self.dead_node_timeout:.1f} s")
                self._nodes[role].remove(n)
                self._conn_ids.pop(n.conn, None)
                self._last_seen.pop((role, n.rank), None)
                self._recovered_conns.discard(n.conn)
                if role == "worker":
                    self.num_workers = max(0, self.num_workers - 1)
                else:
                    self.num_servers = max(0, self.num_servers - 1)
                self.eviction_totals[role] += 1
            self.epoch += 1
            self._bump_map_epoch_locked()
            for r in ("worker", "server"):
                for node in self._nodes[r]:
                    self._send_addrbook_to(node.conn, node.send_lock, r, node.rank,
                                           RESIZE_SEQ)
            # scrub the dead waiters first: a stale one would release a
            # shrunken barrier without a live member and skew the rounds
            doomed_conns = {id(n.conn) for _, n in doomed}
            for waiters in self._barriers.values():
                waiters[:] = [w for w in waiters if id(w[0]) not in doomed_conns]
            self._release_satisfied_barriers_locked()
        for role, n in doomed:
            close_socket(n.conn)  # a hung node's reader learns it was expelled
            # its frozen last step must not feed the straggler median
            self.flight.forget(role, n.rank)

    def _bump_map_epoch_locked(self) -> bool:
        """Advance ``map_epoch`` iff the server set (sorted rank, host,
        port) changed.  Caller holds the lock."""
        sig = tuple(sorted((n.rank, n.host, n.port) for n in self._nodes["server"]))
        if sig == self._map_sig:
            return False
        self._map_sig = sig
        self.map_epoch += 1
        from byteps_tpu_torch.core.telemetry import metrics

        # the ownership map's version, beside the servers' owned-key gauges
        metrics().gauge_set("cluster_map_epoch", self.map_epoch)
        return True

    def _scrub_barrier_waiters_locked(self, dead_conn) -> None:
        for waiters in self._barriers.values():
            waiters[:] = [w for w in waiters if w[0] is not dead_conn]

    def _release_satisfied_barriers_locked(self) -> None:
        """Release the pending barriers a shrunken group already fills."""
        for (group, rnd), waiters in list(self._barriers.items()):
            if 0 < self._group_size(group) <= len(waiters):
                self._barrier_round[group] = max(self._barrier_round[group], rnd + 1)
                del self._barriers[(group, rnd)]
                self._release(waiters, group)

    # --- registration ----------------------------------------------------

    def _handle_register(self, conn, send_lock, msg: Message) -> None:
        info = json.loads(msg.payload.decode())
        role = info["role"]
        # workers dial out with no address: the uid they keep across
        # suspend/resume identifies them; a server without one, its address
        uid = info.get("uid") or f"{info['host']}:{info['port']}"
        hint: Optional[int] = None
        if info.get("last_rank") is not None:
            try:
                hint = int(info["last_rank"])
            except (TypeError, ValueError):
                hint = None
            if hint is not None and hint < 0:
                hint = None
        rejoiner = info.get("last_rank") is not None
        job = int(info.get("job", 0) or 0)
        job_priority = max(1, int(info.get("job_priority", 1) or 1))
        job_quota = max(0.0, float(info.get("job_quota_mbps", 0) or 0))

        def mk_node(rank: int) -> _Node:
            return _Node(rank, info["host"], info["port"], conn, send_lock, uid,
                         job=job, job_priority=job_priority, job_quota_mbps=job_quota)

        # a reconnect of a live runtime runs no re-init barrier, so its
        # connection must not arm the barrier bypass
        reconnect = bool(info.get("reconnect"))
        rep_epoch = int(info.get("epoch", 0) or 0)
        rep_map = int(info.get("map_epoch", 0) or 0)
        recovery = False
        resized = False
        with self._lock:
            self.epoch = max(self.epoch, rep_epoch)
            self.map_epoch = max(self.map_epoch, rep_map)
            if rejoiner:
                self._rejoin_reports += 1
                self._arm_rejoin_grace_locked()
                if (self.tuner is not None and not self._addrbook_sent
                        and info.get("tuning")):
                    # a successor confirms the fleet's live decisions
                    # (newest report wins); a live scheduler's own state
                    # is newer than any report
                    self.tuner.adopt_rejoin_report(info["tuning"])
                if not self._addrbook_sent and role == "worker" and not job:
                    # the job may have been resized since this scheduler's
                    # environment was written: the survivors know
                    nw_r, ns_r = info.get("num_workers"), info.get("num_servers")
                    if nw_r:
                        self.num_workers = int(nw_r)
                    if ns_r:
                        self.num_servers = int(ns_r)
            nw = info.get("num_workers") if not job else None
            ns = info.get("num_servers") if not job else None
            if self._addrbook_sent and role == "worker" and (
                    (nw and int(nw) != self.num_workers)
                    or (ns and int(ns) != self.num_servers)):
                # a resize: dead entries go so their ranks free up; the
                # live ones keep theirs
                for r in ("worker", "server"):
                    self._nodes[r] = [n for n in self._nodes[r] if n.conn in self._conn_ids]
                if nw and int(nw) != self.num_workers:
                    self.num_workers = int(nw)
                if ns and int(ns) != self.num_servers:
                    # scale-down keeps the lowest ranks and stops the rest;
                    # scale-up parks books until the new server registers
                    self.num_servers = int(ns)
                    keep, dropped = [], []
                    for n in sorted(self._nodes["server"], key=lambda n: n.rank):
                        (keep if n.rank < self.num_servers else dropped).append(n)
                    self._nodes["server"] = keep
                    for n in dropped:
                        self._conn_ids.pop(n.conn, None)
                        if self.reshard:
                            self._pending_drains.append(n)
                            continue
                        try:
                            send_message(n.conn, Message(Op.SHUTDOWN, seq=RESIZE_SEQ),
                                         n.send_lock)
                        except (ConnectionError, OSError):
                            pass
                resized = True
            nodes = self._nodes[role]
            existing = [n for n in nodes if n.uid == uid]
            if existing and self._addrbook_sent:
                node = existing[0]
                rank = node.rank
                # the dead connection's bytes must not refresh the rejoined
                # node's stamp, and its parked barrier waiters must not
                # count the rank twice against the retry on this one
                self._conn_ids.pop(node.conn, None)
                self._scrub_barrier_waiters_locked(node.conn)
                nodes[nodes.index(node)] = mk_node(rank)
                recovery = True
                if not reconnect:
                    self._recovered_conns.add(conn)
            elif self._addrbook_sent:
                dead = [n for n in nodes if n.conn not in self._conn_ids]
                expected = self.num_workers if role == "worker" else self.num_servers
                if dead:
                    # adopt a dead member's slot: its identity changed, so
                    # the peers hear of it
                    rank = dead[0].rank
                    nodes[nodes.index(dead[0])] = _Node(rank, info["host"], info["port"],
                                                        conn, send_lock, uid)
                    resized = True
                elif len(nodes) < expected:
                    used = {n.rank for n in nodes}
                    rank = next(r for r in range(expected) if r not in used)
                    nodes.append(mk_node(rank))
                    resized = True
                elif hint is not None and hint not in {n.rank for n in nodes}:
                    # a late reconnector after the rejoin window adopted a
                    # partial population: its rank is free, so it comes back
                    rank = hint
                    nodes.append(mk_node(rank))
                    if role == "worker":
                        self.num_workers += 1
                    else:
                        self.num_servers += 1
                    resized = True
                else:
                    err = {"error": f"cluster full: no dead {role} slot to adopt; "
                                    "set BYTEPS_NODE_UID to rejoin as a known member"}
                    try:
                        send_message(conn, Message(Op.ADDRBOOK, status=1, seq=msg.seq,
                                                   payload=json.dumps(err).encode()),
                                     send_lock)
                    except (ConnectionError, OSError):
                        pass
                    return
                recovery = True
                if not reconnect:
                    self._recovered_conns.add(conn)
            elif existing:
                # the same uid again during the fill (its parked reply's
                # connection died): replace the entry, never append a ghost
                node = existing[0]
                rank = node.rank
                self._conn_ids.pop(node.conn, None)
                self._scrub_barrier_waiters_locked(node.conn)
                nodes[nodes.index(node)] = mk_node(rank)
            else:
                # the fill: a rejoiner's rank hint is honoured when free, a
                # first boot takes ranks in arrival order
                used = {n.rank for n in nodes}
                if hint is not None and hint not in used:
                    rank = hint
                else:
                    rank = next(r for r in range(len(nodes) + 1) if r not in used)
                nodes.append(mk_node(rank))
            self._conn_ids[conn] = (role, rank)
            self._last_seen[(role, rank)] = time.monotonic()
            if recovery:
                self._complete_recovery(conn, send_lock, role, rank, msg.seq, resized)
                return
            full = (len(self._nodes["worker"]) >= self.num_workers
                    and len(self._nodes["server"]) >= self.num_servers)
            if full and not self._addrbook_sent:
                self._emit_initial_books_locked()

    def _emit_initial_books_locked(self) -> None:
        """This incarnation's first books.  A rebirth fences both epochs
        above every report; the liveness stamps restart here, since no node
        can heartbeat while its registration is parked.  Caller holds the
        lock."""
        self._addrbook_sent = True
        recovery = self._rejoin_reports > 0
        if recovery:
            self.epoch += 1
        self._bump_map_epoch_locked()
        now = time.monotonic()
        for r in ("worker", "server"):
            for node in self._nodes[r]:
                self._last_seen[(r, node.rank)] = now
                self._send_addrbook_to(node.conn, node.send_lock, r, node.rank, 0,
                                       recovery=recovery)

    def _arm_rejoin_grace_locked(self) -> None:
        """Start the rebirth's grace timer, once.  Caller holds the lock."""
        if self._grace_thread is not None or self._addrbook_sent or self.rejoin_window <= 0:
            return
        deadline = time.monotonic() + self.rejoin_window

        def expire() -> None:
            while not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if self._stop.wait(min(remaining, 0.2)):
                    return
            self._adopt_partial_population()

        self._grace_thread = threading.Thread(target=expire, name="sched-rejoin-grace",
                                              daemon=True)
        self._grace_thread.start()

    def _adopt_partial_population(self) -> None:
        """The window expired with ranks missing: the nodes present become
        the population, and the books go out."""
        with self._lock:
            if self._addrbook_sent or self._stop.is_set():
                return
            nw, ns = len(self._nodes["worker"]), len(self._nodes["server"])
            if nw + ns == 0:
                return
            _log(f"rejoin window ({self.rejoin_window:.1f} s) expired with {nw}/"
                 f"{self.num_workers} workers and {ns}/{self.num_servers} servers: "
                 "adopting the partial population")
            self.num_workers, self.num_servers = nw, ns
            self._emit_initial_books_locked()

    def _complete_recovery(self, conn, send_lock, role, rank, seq, resized) -> None:
        """Answer a registration after the books went out: a worker's book
        waits while a server scale-up leaves the population short; once the
        topology settles, every other node gets a RESIZE_SEQ book.  Caller
        holds the lock."""
        if role == "worker" and len(self._nodes["server"]) < self.num_servers:
            self._parked_regs.append((conn, send_lock, role, rank, seq))
            self._pending_broadcast = self._pending_broadcast or resized
            return
        if resized or self._parked_regs or self._pending_broadcast:
            self.epoch += 1
            self._bump_map_epoch_locked()
        self._send_addrbook_to(conn, send_lock, role, rank, seq, recovery=True)
        parked, self._parked_regs = self._parked_regs, []
        for pconn, plock, prole, prank, pseq in parked:
            self._send_addrbook_to(pconn, plock, prole, prank, pseq, recovery=True)
        if resized or parked or self._pending_broadcast:
            self._pending_broadcast = False
            exclude = {conn} | {p[0] for p in parked}
            for r in ("worker", "server"):
                for node in self._nodes[r]:
                    if node.conn not in exclude:
                        self._send_addrbook_to(node.conn, node.send_lock, r, node.rank,
                                               RESIZE_SEQ)
        # each dropped server drains against the settled topology
        drains, self._pending_drains = self._pending_drains, []
        for n in drains:
            self._send_addrbook_to(n.conn, n.send_lock, "server", n.rank, RESIZE_SEQ,
                                   drain=True)

    def _send_addrbook_to(self, conn, send_lock, role, rank, seq, recovery=False,
                          drain=False) -> None:
        servers = sorted(self._nodes["server"], key=lambda n: n.rank)
        book = {
            "role": role,
            "rank": rank,
            "num_workers": self.num_workers,
            # during a scale-up the new server may register before the
            # worker that asked for it: never fewer than the list
            "num_servers": max(self.num_servers, len(servers)),
            "servers": [(n.host, n.port) for n in servers],
            "is_recovery": recovery,
            "epoch": self.epoch,
            "evictions": dict(self.eviction_totals),
            # the servers' zombie fence: pushes of other ranks are refused
            "worker_ranks": sorted(n.rank for n in self._nodes["worker"]),
            "server_ranks": [n.rank for n in servers],
            "map_epoch": self.map_epoch,
            "sched_incarnation": self.incarnation,
            "jobs": self._jobs_map_locked(),
        }
        if self.tuner is not None:
            # the tuning section, and the overrides of this book's ranks
            book.update(self.tuner.book_extras(book["server_ranks"]))
        if drain:
            # this server is off the rank list: it ships every key it
            # holds to the book's owners, then stops
            book["drain"] = True
        elif self._pending_drains:
            # the ranks leaving by a drain (alive, shipping their keys):
            # their keys' new owners park requests until the state lands,
            # where a rank that left by eviction has nothing to ship
            book["draining"] = sorted(n.rank for n in self._pending_drains)
        try:
            send_message(conn, Message(Op.ADDRBOOK, payload=json.dumps(book).encode(),
                                       seq=seq), send_lock)
        except (ConnectionError, OSError):
            pass

    def _jobs_map_locked(self) -> Dict[str, dict]:
        """{job: {"workers": [ranks], "priority", "quota_mbps"}} of the live
        workers, as the reference builds it (the fleet-wide quota split
        over the servers)."""
        jobs: Dict[str, dict] = {}
        for n in self._nodes["worker"]:
            j = jobs.setdefault(str(n.job), {"workers": [], "priority": 1, "quota_mbps": 0.0})
            j["workers"].append(n.rank)
            j["priority"] = max(j["priority"], n.job_priority)
            j["quota_mbps"] = max(j["quota_mbps"], n.job_quota_mbps)
        ns = max(1, len(self._nodes["server"]))
        for j in jobs.values():
            j["workers"].sort()
            if j["quota_mbps"] > 0:
                j["quota_mbps_total"] = j["quota_mbps"]
                j["quota_mbps"] = j["quota_mbps"] / ns
        return jobs

    # --- barriers --------------------------------------------------------

    def _group_size(self, group: int) -> int:
        return {
            GROUP_WORKERS: self.num_workers,
            GROUP_SERVERS: self.num_servers,
            GROUP_ALL: self.num_workers + self.num_servers,
        }[group]

    @staticmethod
    def _release(waiters, group: int) -> None:
        for wconn, wlock, wseq in waiters:
            try:
                send_message(wconn, Message(Op.BARRIER, seq=wseq, flags=group), wlock)
            except (ConnectionError, OSError):
                pass

    def _handle_barrier(self, conn, send_lock, msg: Message) -> None:
        group = msg.flags or GROUP_ALL
        with self._lock:
            if conn in self._recovered_conns:
                # a rejoined runtime's re-init barrier: nobody else is at one
                self._recovered_conns.discard(conn)
                self._release([(conn, send_lock, msg.seq)], group)
                return
            rnd = self._barrier_round[group]
            waiters = self._barriers.setdefault((group, rnd), [])
            waiters.append((conn, send_lock, msg.seq))
            if len(waiters) < self._group_size(group):
                return
            self._barrier_round[group] = rnd + 1
            del self._barriers[(group, rnd)]
            self._release(waiters, group)
