"""Worker-side pipeline engine of the PS path (``byteps_tpu.core.engine``;
the reference's stage loops, core_loops.cc).

Each push_pull is cut into partitions (one key each), and every partition
walks a list of stages, one ScheduledQueue and one thread each:

    COPYD2H -> PUSH -> PULL -> COPYH2D                          (raw)
    COPYD2H -> COMPRESS -> PUSH -> PULL -> DECOMPRESS -> COPYH2D  (codec)

PUSH and PULL complete from the PS client's callbacks, which move the task
to its next stage (FinishOrProceed, core_loops.cc:31-137).  The PUSH queue
is priority-ordered, so the gradients the backward pass produces last
(the front layers, which the next forward needs first) go out first, and
it is gated per key by round, so a later round of a key never overtakes
an earlier one.

Small-tensor fusion (``BYTEPS_FUSION_THRESHOLD`` > 0, ``byteps_tpu``'s
addition): a partition whose wire bytes (the codec's payload size for a
compressed one) are at or below the threshold takes FUSE in place of PUSH:

    COPYD2H -> FUSE -> PULL -> COPYH2D                          (raw)
    COPYD2H -> COMPRESS -> FUSE -> PULL -> DECOMPRESS -> COPYH2D  (codec)

The FUSE queue shares PUSH's round gate.  It packs same-server partitions
into a buffer (``_Fuser``) that flushes at ``BYTEPS_FUSION_BYTES``, when
the queue drains, or after ``BYTEPS_FUSION_CYCLE_MS``; the pack enters the
PUSH queue as one group task with its members' highest priority, exempt
from the gate, and goes out as one Op.FUSED frame whose reply fans back
out: each member's PULL delivers its slot locally.  A frame that fails
sends its members again as per-key pushes and pulls.

Profiles declared at INIT (``_async_profile``, ``_server_opt_profile``):
an async key (``BYTEPS_ASYNC`` or the ``byteps_async`` declare kwarg, with
``BYTEPS_STALENESS_BOUND`` / ``byteps_staleness``) pulls the server's
cumulative store, with no round barrier; a key with a server-side update
rule (``BYTEPS_SERVER_OPT`` / ``byteps_server_opt``) pushes gradients and
pulls parameters, so its result is never averaged here (the rule averages
on the server).

Lanes, by input:

- numpy arrays: the host lane of the reference.  COPYD2H takes a view,
  COMPRESS runs the host codec, the pulls land in a numpy result.
- torch tensors: the device lane (the counterpart of the reference's jax
  branch), whatever device they are on.  At submit a CUDA tensor gets an
  event recorded on the caller's current stream; COPYD2H runs on the
  engine's side stream after waiting on that event, so it never reads a
  gradient that backward has not finished writing, and it waits on its
  own copy's event (never on the whole device).
  - A partition with a device codec (bare onebit, topk, dithering) is
    compressed on the side stream (onebit by K4) and only its wire
    payload crosses to pinned host memory; DECOMPRESS moves the pulled
    payload back (pinned, non_blocking) and decodes it on a second side
    stream, and ``_finalize`` assembles and averages the result there.
  - Any other CUDA partition is copied into pinned memory on the side
    stream, so its PUSH overlaps the copies of later partitions; the
    pulls land in a pinned result that ``_finalize`` copies back to the
    device.  A host codec chain (randomk, or any chain with error
    feedback or momentum) compresses that pinned copy in COMPRESS and
    decodes the pull into the pinned result in DECOMPRESS.
  - A CPU tensor takes the same lane with the kernels' plain versions and
    no copies.
  The result of a CUDA push_pull carries an event; ``synchronize`` makes
  the caller's stream wait on it.  Averaging divides floating dtypes only
  (the reference's device branch divides every dtype, engine.py:1228-1229;
  its host branch has the guard).

The recovery plane (docs/robustness.md "healing flow"): every push is
journaled before it leaves (``comm/journal.py``; a fused pack's members
one by one), so that the PS client's in-place heal can replay the rounds
a live server lost; a key's entries go when its init barrier runs again.
A job that fails on the data plane surfaces ``DegradedError`` (counted as
``degraded_jobs``), stops its other requests' retries (the abort fence),
and marks its tensor for a forced init barrier on its next submit;
:meth:`PipelineEngine.heal_degraded` heals it in place instead where it
can.

Adaptive compression (``BYTEPS_COMPRESSION_AUTO``): a partition whose
codec's wire ratio (wire over raw bytes) is at or above
``BYTEPS_COMPRESSION_AUTO_RATIO`` joins ``_compression_auto_off`` and its
later rounds push raw; the codec stays registered on its server, which
serves raw and compressed rounds of one key alike.  Every shipped codec
has a size-deterministic wire (``wire_static``), so the verdict is taken
at registration; a data-dependent chain is judged on its first
``BYTEPS_COMPRESSION_AUTO_ROUNDS`` compressions.  An off partition pushes
raw on both lanes: in a device-lane job it is copied raw to the host and
its pull moved back in COPYH2D, while the job's other partitions stay on
the device lane (ROADMAP.md Queue 3, the ninth divergence: byteps_tpu's
device lane does not read the off set and keeps compressing).

The fleet's tuning (``core/autotune.py``), handed over by the PS client
from the books (:meth:`PipelineEngine._apply_tuning`): its fusion
threshold is adopted live (never turning fusion on from 0, and a section
without it restores the launch value), and its ``codec_off`` turns every
partition of the named codecs raw, a rollback turning back exactly those.
The flight recorder gets one record a step: a step opens with the first
push_pull after a quiet spell and closes when the last one completes.

The lossless arm of adaptive compression (``BYTEPS_WIRE_LOSSLESS=1``): a
partition in the off set has its first raw push probed once
(:meth:`PipelineEngine._lossless_probe`): at or under
``BYTEPS_LOSSLESS_ENTROPY`` bits a byte, and a trial container at least
10% smaller, that push and every later one go out as lossless containers
(``transport.LOSSLESS_FLAG``), and it votes ``compression_auto_lossless``.
A fleet's ``codec_lossless`` puts the off partitions of the named codecs
there too, a rollback taking exactly those out.  The probe reads the raw
bytes an off partition pushes on either lane (the device lane copies them
to the host: the ninth divergence, above).

Row-sparse push_pull (:meth:`PipelineEngine.submit_rowsparse`,
``RequestType.ROW_SPARSE_PUSH_PULL``): one partition covering the dense
``total_rows x row_len`` tensor, whose task has the PUSH and PULL stages
alone.  The rows come to the host at submit (a CUDA pair by one copy on
the side stream into the pinned push payload, and one wait), the result
goes back to the device when it is delivered.  It never fuses and never
compresses.

Each stage's dwell is observed as ``stage_dwell_seconds{stage}``
(``core/telemetry.py``).  With a tracer on (``BYTEPS_TRACE_ON``,
``core/tracing.py``) every push_pull has a trace id and each of its
partition tasks a span id, fixed for the task's life (every resend of its
RPCs carries it), which rides the task's INIT, PUSH and PULL frames, and a
fusion pack's frame its own span with the members' ids in its trailer
(``FUSED_RPC``).  A finished stage records the tensor's stage envelope (in
the ``BYTEPS_TRACE_START_STEP``..``_END_STEP`` window) and the task's span;
an INIT its own span.  ``BYTEPS_DEBUG_SAMPLE_TENSOR`` logs, at INFO, the
norm and first value a tensor's partitions hold after each stage
(core_loops.cc:37-67).  The bytes pushed and pulled feed the windowed
``PushPullSpeed``.
"""

from __future__ import annotations

import contextlib
import itertools
import struct
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.config import Config, truthy
from byteps_tpu_torch.common.partition import (
    check_rowsparse_shapes,
    partition_tensor,
    validate_rowsparse,
)
from byteps_tpu_torch.common.registry import get_registry
from byteps_tpu_torch.comm.journal import configure_journal
from byteps_tpu_torch.common.types import (
    DataType,
    Partition,
    QueueType,
    RequestType,
    Status,
    TensorTableEntry,
    divide,
    get_command_type,
    is_floating,
    to_datatype,
)
from byteps_tpu_torch.core.ready_table import ReadyTable
from byteps_tpu_torch.core.scheduler import ScheduledQueue, set_job_weight
from byteps_tpu_torch.core.telemetry import (
    COUNT_BUCKETS,
    RATIO_BUCKETS,
    counters,
    job_labels,
    metrics,
)
from byteps_tpu_torch.core.tracing import new_trace_id, span_args
from byteps_tpu_torch.server.update_rules import parse_hp, rule_name


def _log(msg: str) -> None:
    print(f"byteps_tpu_torch: {msg}", file=sys.stderr, flush=True)


#: per CUDA device: (COPYD2H stream, H2D and decode stream), for every engine
_STREAMS: Dict[torch.device, tuple] = {}
_STREAMS_LOCK = threading.Lock()


class DeviceResult(NamedTuple):
    """A push_pull result on a CUDA device, valid once ``event`` fired."""

    tensor: torch.Tensor
    event: torch.cuda.Event


def _np_view(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a CPU tensor's elements (bfloat16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class _Job:
    """One push_pull: the state its partitions share."""

    __slots__ = (
        "name", "ctx", "flat", "result", "result_t", "dtype_id", "average",
        "handle", "pending", "shape", "is_torch", "device", "ready",
        "version", "device_parts", "failed", "step_counted", "rowsparse", "lock",
        "t0", "trace_id",
    )

    def __init__(self, name, ctx, flat, dtype_id, average, handle, shape,
                 is_torch, device, ready) -> None:
        self.name = name
        self.ctx = ctx
        self.flat = flat
        self.dtype_id = dtype_id
        self.average = average
        self.handle = handle
        self.pending = len(ctx.partitions)
        self.shape = shape
        self.is_torch = is_torch
        self.device = device
        #: CUDA event recorded on the caller's stream at submit
        self.ready = ready
        self.version = ctx.version
        #: host result buffer (numpy; a view of ``result_t`` for torch)
        self.result: Optional[np.ndarray] = None
        self.result_t: Optional[torch.Tensor] = None
        #: device-codec jobs: offset -> decoded partition on the device
        self.device_parts: Optional[Dict[int, torch.Tensor]] = None
        self.failed = False
        #: the job left the step window (completed or failed), once
        self.step_counted = False
        #: a row-sparse job's (push payload, pull request)
        self.rowsparse: Optional[tuple] = None
        self.lock = threading.Lock()
        #: the stage envelopes start here
        self.t0 = time.time()
        #: the trace every partition task's span joins (0: tracing off)
        self.trace_id = 0


class _FusionGroup:
    """One flushed pack: [(member task, payload)], sent as one Op.FUSED
    frame.  Member keys are unique in a pack (the round gate lets one
    round of a key out at a time)."""

    __slots__ = ("members", "done", "lock")

    def __init__(self, members: List[tuple]) -> None:
        self.members = members
        #: once-guard: the reply and the error path race here
        self.done = False
        self.lock = threading.Lock()


class _FusionBuffer:
    """The pack accumulating for one server."""

    __slots__ = ("members", "nbytes", "max_priority", "oldest")

    def __init__(self) -> None:
        self.members: List[tuple] = []
        self.nbytes = 0
        self.max_priority = -(1 << 62)
        self.oldest = time.monotonic()


class _Fuser:
    """The FUSE stage's buffers, one per destination server.  A buffer
    flushes (counted as ``fusion_flush_<reason>``) when it reaches
    ``BYTEPS_FUSION_BYTES`` (full), when the FUSE queue drained and no
    small partition is on its way (idle), or when its oldest member waited
    ``BYTEPS_FUSION_CYCLE_MS`` (cycle)."""

    def __init__(self, engine: "PipelineEngine") -> None:
        self._engine = engine
        self._cv = threading.Condition()
        #: (destination server, job) -> its pack: one frame never mixes
        #: jobs, since a pack competes, spends credit and is metered as one
        self._bufs: Dict[tuple, _FusionBuffer] = {}
        self._cycle_thread: Optional[threading.Thread] = None

    def add(self, task: TensorTableEntry, payload) -> None:
        sid = (self._engine.client.server_for(task.key), task.job)
        full = None
        with self._cv:
            buf = self._bufs.get(sid)
            if buf is None:
                buf = self._bufs[sid] = _FusionBuffer()
                self._cv.notify()  # arm the cycle deadline of the new pack
            buf.members.append((task, payload))
            buf.nbytes += memoryview(payload).nbytes
            buf.max_priority = max(buf.max_priority, task.priority)
            if buf.nbytes >= self._engine.cfg.fusion_bytes:
                full = self._bufs.pop(sid)
            if self._cycle_thread is None:
                self._cycle_thread = threading.Thread(target=self._cycle_loop,
                                                      name="bps-fusion-cycle", daemon=True)
                self._cycle_thread.start()
        if full is not None:
            self._emit(full, "full")

    def drain_idle(self) -> None:
        with self._cv:
            bufs, self._bufs = self._bufs, {}
        for buf in bufs.values():
            self._emit(buf, "idle")

    def _cycle_loop(self) -> None:
        """Sleeps until the oldest pack's deadline (woken when a pack is
        born), and flushes the packs that reached it."""
        cycle_s = max(0.0005, self._engine.cfg.fusion_cycle_ms / 1e3)
        while not self._engine._stop.is_set():
            with self._cv:
                if not self._bufs:
                    self._cv.wait(0.5)
                    continue
                now = time.monotonic()
                due = min(b.oldest for b in self._bufs.values()) + cycle_s
                if due > now:
                    self._cv.wait(due - now)
                    continue
                aged = [sid for sid, b in self._bufs.items() if now - b.oldest >= cycle_s]
                bufs = [self._bufs.pop(sid) for sid in aged]
            for buf in bufs:
                self._emit(buf, "cycle")

    def _emit(self, buf: _FusionBuffer, reason: str) -> None:
        """The pack enters the PUSH queue as one group task: its members'
        highest priority (fusion never defeats priority scheduling), their
        summed length (credit), exempt from the round gate its members
        passed at the FUSE queue."""
        counters().bump(f"fusion_flush_{reason}")
        metrics().observe("fused_pack_keys", len(buf.members), buckets=COUNT_BUCKETS)
        metrics().observe("fused_flush_age_seconds", time.monotonic() - buf.oldest)
        members = buf.members
        self._engine.queues[QueueType.PUSH].add_task(TensorTableEntry(
            tensor_name="<fused>", key=members[0][0].key, priority=buf.max_priority,
            length=sum(t.length for t, _ in members), queue_list=[QueueType.PUSH],
            context=_FusionGroup(members), gate_exempt=True,
        ))


class _StripedStage:
    """A stage served by several threads; each key sticks to one stripe."""

    def __init__(self, queue_type: QueueType, n: int) -> None:
        self.stripes = [ScheduledQueue(queue_type) for _ in range(max(1, n))]

    def add_task(self, task: TensorTableEntry) -> None:
        self.stripes[task.key % len(self.stripes)].add_task(task)

    def report_finish(self, task: TensorTableEntry) -> None:
        self.stripes[task.key % len(self.stripes)].report_finish(task)


class PipelineEngine:
    STAGES = [QueueType.COPYD2H, QueueType.PUSH, QueueType.PULL, QueueType.COPYH2D]
    STAGES_COMPRESSED = [
        QueueType.COPYD2H, QueueType.COMPRESS, QueueType.PUSH,
        QueueType.PULL, QueueType.DECOMPRESS, QueueType.COPYH2D,
    ]
    #: a small partition takes FUSE in place of PUSH; the fused reply
    #: carries its pull, which PULL delivers locally
    STAGES_FUSED = [QueueType.COPYD2H, QueueType.FUSE, QueueType.PULL, QueueType.COPYH2D]
    #: a compressed partition whose payload fits the threshold; under a
    #: device codec COPYD2H lands the payload packed on the device, COMPRESS
    #: passes it through and the reply's slot is decoded on the device
    STAGES_COMPRESSED_FUSED = [
        QueueType.COPYD2H, QueueType.COMPRESS, QueueType.FUSE,
        QueueType.PULL, QueueType.DECOMPRESS, QueueType.COPYH2D,
    ]

    #: engine instance ids: the registry outlives shutdown()/init(), the
    #: servers' stores do not, so a tensor first used under an earlier
    #: engine re-runs its init barrier
    _epoch_counter = itertools.count()

    def __init__(self, cfg: Config, ps_client, telemetry=None, tracer=None,
                 flightrec=None) -> None:
        self.cfg = cfg
        self.client = ps_client
        #: core.telemetry.PushPullSpeed and core.tracing.Tracer, or None
        self.telemetry = telemetry
        self.tracer = tracer
        self._epoch = next(PipelineEngine._epoch_counter)
        self._stop = threading.Event()
        # PUSH round gate: counts[key] = highest round allowed out
        self._push_ready = ReadyTable()
        self._seeded: set = set()
        disc = cfg.scheduling
        pool = max(1, cfg.threadpool_size)
        # the process's job registers its weighted share of the stage
        # queues, and its in-flight byte budget when it has one (with one
        # job in a process the lanes change no order)
        set_job_weight(cfg.job_id, max(1, cfg.job_priority))
        job_credits = {cfg.job_id: cfg.job_credit_bytes} if cfg.job_credit_bytes > 0 else None
        self.queues: Dict[QueueType, Any] = {
            QueueType.COPYD2H: ScheduledQueue(QueueType.COPYD2H, discipline=disc),
            QueueType.COMPRESS: _StripedStage(QueueType.COMPRESS, pool),
            QueueType.PUSH: ScheduledQueue(
                QueueType.PUSH, credit_bytes=cfg.scheduling_credit,
                ready_table=self._push_ready, discipline=disc, job_credits=job_credits,
            ),
            # FUSE shares PUSH's round gate: a small partition passes it
            # where it leaves for the fusion buffer
            QueueType.FUSE: ScheduledQueue(QueueType.FUSE, ready_table=self._push_ready,
                                           discipline=disc, job_credits=job_credits),
            QueueType.PULL: ScheduledQueue(QueueType.PULL, discipline=disc),
            QueueType.DECOMPRESS: _StripedStage(QueueType.DECOMPRESS, pool),
            QueueType.COPYH2D: ScheduledQueue(QueueType.COPYH2D, discipline=disc),
        }
        self._fuser = _Fuser(self)
        #: FUSE-routed tasks submitted and not yet in the fusion buffer: the
        #: idle flush needs them, since the FUSE queue cannot see a task an
        #: earlier stage holds
        self._staged_smalls = 0
        self._fuse_lock = threading.Lock()
        metrics().gauge_set("fusion_threshold_bytes", cfg.fusion_threshold)
        self._threads: List[threading.Thread] = []
        self._init_lock = threading.Lock()
        #: per-key host codec chains and device adapters
        self._compressors: Dict[int, Any] = {}
        self._device_codecs: Dict[int, Any] = {}
        self._compress_started = False
        #: key -> (tensor name, elements, bytes per element) of every
        #: partition this engine initialized
        self._table: Dict[int, tuple] = {}
        #: the learning rate of error-feedback chains, and the one the
        #: servers were last sent (their chains start at 1.0)
        self._compression_lr = 1.0
        self._lr_sent_to_servers = 1.0
        #: the round journal of this engine's generation
        self._journal = configure_journal(cfg.journal_rounds, cfg.journal_bytes)
        #: tensors whose last job failed degraded: their next submit runs
        #: the init barrier again, unless heal_degraded mends them first
        self._reinit_names: set = set()
        add = getattr(ps_client, "add_server_set_listener", None)
        if add is not None:
            add(self._resend_lr)
        # --- adaptive compression and the fleet's tuning ---
        #: keys whose rounds push raw (a verdict, or a fleet codec_off)
        self._compression_auto_off: set = set()
        #: key -> [rounds, wire bytes, raw bytes] until a probe's verdict,
        #: None once decided
        self._auto_stats: Dict[int, Any] = {}
        #: key -> its codec's type name (what codec_off names)
        self._codec_names: Dict[int, str] = {}
        #: codec name -> the keys a fleet codec_off turned raw here
        self._fleet_codec_off: Dict[str, set] = {}
        #: the lossless arm: off keys whose raw pushes go out as lossless
        #: containers, the keys probed once, and codec name -> the keys a
        #: fleet codec_lossless put in
        self._lossless_keys: set = set()
        self._lossless_probed: set = set()
        self._fleet_codec_lossless: Dict[str, set] = {}
        self._tuning_lock = threading.Lock()
        self._fuse_enabled = cfg.fusion_threshold > 0
        self._launch_fusion_threshold = cfg.fusion_threshold
        # --- the step window of the flight recorder ---
        self._flight = flightrec
        self._step_lock = threading.Lock()
        self._step_open = 0
        self._step_t0 = 0.0
        add = getattr(ps_client, "add_tuning_listener", None)
        if add is not None:
            add(self._apply_tuning)

    # --- lifecycle -------------------------------------------------------

    def start(self) -> None:
        stages = [(QueueType.COPYD2H, self._copy_d2h_once),
                  (QueueType.PUSH, self._push_once),
                  (QueueType.PULL, self._pull_once),
                  (QueueType.COPYH2D, self._copy_h2d_once)]
        if self.cfg.fusion_threshold > 0:
            stages.append((QueueType.FUSE, self._fuse_once))
        for qt, fn in stages:
            self._spawn_stage(qt, fn)

    def _spawn_stage(self, qt: QueueType, fn) -> None:
        q = self.queues[qt]
        for i, sq in enumerate(q.stripes if isinstance(q, _StripedStage) else [q]):
            t = threading.Thread(target=self._loop, args=(sq, fn),
                                 name=f"bps-{qt.name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _ensure_compress_threads(self) -> None:
        if not self._compress_started:
            self._compress_started = True
            self._spawn_stage(QueueType.COMPRESS, self._compress_once)
            self._spawn_stage(QueueType.DECOMPRESS, self._decompress_once)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []

    # --- adaptive compression and the fleet's tuning ----------------------

    def _apply_tuning(self, t: dict) -> None:
        """Adopt a fleet tuning section (the PS client calls it with each
        newer one, and with ``{}`` when the books stop carrying one).  The
        fusion threshold is one int each submit reads; the codec flips
        move keys in and out of the off set under the tuning lock."""
        ft = t.get("fusion_threshold")
        if ft is None:
            ft = self._launch_fusion_threshold  # untouched: the launch value
        if self._fuse_enabled:
            # never on from 0: with no FUSE stage at start there is no
            # thread to serve it
            try:
                ft = int(ft)
            except (TypeError, ValueError):
                ft = 0
            if ft > 0 and ft != self.cfg.fusion_threshold:
                _log(f"autotune: fleet fusion threshold {self.cfg.fusion_threshold} -> "
                     f"{ft} bytes")
                self.cfg.fusion_threshold = ft
                metrics().gauge_set("fusion_threshold_bytes", ft)
        off = {str(n) for n in (t.get("codec_off") or ())}
        with self._tuning_lock:
            for name in sorted(off - set(self._fleet_codec_off)):
                keys = {k for k, n in self._codec_names.items()
                        if n == name and k not in self._compression_auto_off}
                self._fleet_codec_off[name] = keys
                self._compression_auto_off.update(keys)
                if keys:
                    counters().bump("tune_codec_off", len(keys), labels={"codec": name})
                _log(f"autotune: fleet codec consensus disabled {name!r} ({len(keys)} "
                     "local keys push raw)")
            for name in sorted(set(self._fleet_codec_off) - off):
                # the keys the fleet turned raw compress again; a key this
                # worker judged raw on its own stays raw
                keys = self._fleet_codec_off.pop(name)
                self._compression_auto_off.difference_update(keys)
                _log(f"autotune: fleet codec decision on {name!r} rolled back ({len(keys)} "
                     "keys compress again)")
            # the lossless arm: the named codecs' raw-pushing keys ship the
            # container; a worker with BYTEPS_WIRE_LOSSLESS off ignores it
            from byteps_tpu_torch.comm.transport import wire_lossless_enabled

            lz = ({str(n) for n in (t.get("codec_lossless") or ())}
                  if wire_lossless_enabled() else set())
            for name in sorted(lz - set(self._fleet_codec_lossless)):
                keys = {k for k, n in self._codec_names.items()
                        if n == name and k in self._compression_auto_off
                        and k not in self._lossless_keys}
                self._fleet_codec_lossless[name] = keys
                self._lossless_keys.update(keys)
                if keys:
                    counters().bump("tune_codec_lossless", len(keys), labels={"codec": name})
                _log(f"autotune: fleet lossless arm on {name!r} ({len(keys)} local raw keys "
                     "ship the lossless frame)")
            for name in sorted(set(self._fleet_codec_lossless) - lz):
                # exactly the fleet's keys drop it; a probe's verdict stays
                keys = self._fleet_codec_lossless.pop(name)
                self._lossless_keys.difference_update(keys)
                _log(f"autotune: fleet lossless arm on {name!r} rolled back ({len(keys)} "
                     "keys push plain raw again)")

    def _lossless_probe(self, key: int, payload) -> None:
        """The lossless arm's probe of an off key's first raw push (once a
        key and engine; only under BYTEPS_WIRE_LOSSLESS): when its first 64
        KiB read at or under the entropy cutoff and their trial container
        is at least 10% smaller, the key's pushes from this one on ship the
        container and it votes ``compression_auto_lossless{codec}``."""
        self._lossless_probed.add(key)
        from byteps_tpu_torch.comm.transport import wire_lossless_enabled

        if not wire_lossless_enabled():
            return
        from byteps_tpu_torch.compression.lossless import (
            MIN_BYTES,
            byte_entropy,
            compress_frame,
            lossless_entropy_cutoff,
        )

        raw = bytes(memoryview(payload).cast("B")[:65536])
        if len(raw) < MIN_BYTES:
            return
        ent = byte_entropy(raw)
        metrics().gauge_set("lossless_probe_entropy", ent, labels={"key": str(key)})
        if ent > lossless_entropy_cutoff():
            return
        comp = compress_frame(raw)
        if len(comp) * 10 > len(raw) * 9:
            return  # the entropy looked low but the LZ pass won nothing
        with self._tuning_lock:
            self._lossless_keys.add(key)
        counters().bump("compression_auto_lossless",
                        labels={"codec": self._codec_names.get(key, "?")})
        _log(f"lossless arm enabled for key {key}: raw push entropy {ent:.2f} bits/byte, "
             f"trial container {len(raw) / max(1, len(comp)):.2f}x; its pushes ship the wire "
             "lossless frame")

    def _auto_static_verdict(self, key: int, codec) -> None:
        """The verdict of a size-deterministic codec at registration: its
        exact wire ratio decides the key before any round."""
        ratio = codec.wire_nbytes() / max(1, codec.size * 4)
        metrics().observe("compression_ratio", ratio, buckets=RATIO_BUCKETS)
        self._auto_stats[key] = None
        if ratio < self.cfg.compression_auto_ratio:
            return
        self._compression_auto_off.add(key)
        counters().bump("compression_auto_off",
                        labels={"codec": self._codec_names.get(key, "?")})
        _log(f"compression auto-disabled for key {key} at registration: static wire "
             f"ratio {ratio:.3f} >= {self.cfg.compression_auto_ratio:.3f}; its rounds "
             "push raw")

    def _note_compression(self, key: int, raw_nbytes: int, comp_nbytes: int) -> None:
        """One host compression's outcome (``wire_bytes_saved``,
        ``compression_ratio``) and, for a key not yet judged, the probe:
        after ``BYTEPS_COMPRESSION_AUTO_ROUNDS`` compressions a mean ratio
        at or above the cutoff turns it raw.  Runs on the key's COMPRESS
        stripe, so a key's stats never race."""
        if comp_nbytes < raw_nbytes:
            counters().bump("wire_bytes_saved", raw_nbytes - comp_nbytes)
        metrics().observe("compression_ratio", comp_nbytes / max(1, raw_nbytes),
                          buckets=RATIO_BUCKETS)
        if not self.cfg.compression_auto or key in self._compression_auto_off:
            return
        st = self._auto_stats.get(key, False)
        if st is None:
            return  # judged: it keeps its codec
        if st is False:
            st = self._auto_stats[key] = [0, 0, 0]
        st[0] += 1
        st[1] += comp_nbytes
        st[2] += raw_nbytes
        if st[0] < self.cfg.compression_auto_rounds:
            return
        ratio = st[1] / max(1, st[2])
        if ratio < self.cfg.compression_auto_ratio:
            self._auto_stats[key] = None
            return
        self._auto_stats.pop(key, None)
        self._compression_auto_off.add(key)
        counters().bump("compression_auto_off",
                        labels={"codec": self._codec_names.get(key, "?")})
        _log(f"compression auto-disabled for key {key}: observed wire ratio {ratio:.3f} >= "
             f"{self.cfg.compression_auto_ratio:.3f} over {st[0]} rounds; later rounds "
             "push raw")

    def auto_off_keys(self) -> set:
        """The keys whose rounds push raw now."""
        with self._tuning_lock:
            return set(self._compression_auto_off)

    # --- the flight recorder's step window --------------------------------

    def _step_begin(self) -> None:
        with self._step_lock:
            if self._step_open == 0:
                self._step_t0 = time.monotonic()
            self._step_open += 1

    def _step_end(self, job: _Job) -> None:
        """A job left the pipeline, completed or failed (once a job): the
        last one out closes the step and stamps its record."""
        with job.lock:
            if job.step_counted:
                return
            job.step_counted = True
        with self._step_lock:
            if self._step_open <= 0:
                return
            self._step_open -= 1
            done = self._step_open == 0
            dur = time.monotonic() - self._step_t0
        if not done:
            return
        labels = job_labels(self.cfg.job_id)
        if labels:
            # the job's step times: the cluster aggregate's per-job p99
            # and the live value (job 0 mints no series)
            metrics().observe("job_step_seconds", dur, labels=labels)
            metrics().gauge_set("job_step_last_seconds", dur, labels=labels)
        if self._flight is not None and self._flight.enabled:
            self._flight.record_step(dur)

    def _loop(self, q: ScheduledQueue, fn) -> None:
        while not self._stop.is_set():
            task = q.get_task(timeout=0.2)
            if task is None:
                continue
            try:
                fn(task)
            except Exception as e:  # noqa: BLE001 - surfaced on the handle
                self._fail_task(task, q.queue_type, repr(e),
                                degraded=isinstance(e, (ConnectionError, OSError)))
            # an idle stage must not keep its last task's buffers (pinned
            # staging, the job's result) alive until its next poll
            del task

    @staticmethod
    def streams(device: torch.device) -> tuple:
        """(COPYD2H stream, H2D/decode stream) of a CUDA device: one pair
        per device for the process's life, so every partition of a tensor
        is decoded on the stream its result is assembled on, and an engine
        after a suspend/resume reuses the pair (and K4's workspace, kept
        per stream) instead of growing device memory."""
        with _STREAMS_LOCK:
            st = _STREAMS.get(device)
            if st is None:
                st = _STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
            return st

    # --- submission ------------------------------------------------------

    def submit(self, name: str, tensor: Any, average: bool, priority: int,
               version: int, handle: int) -> None:
        """EnqueueTensor (operations.cc:182-281): run the tensor's init
        barrier when needed, partition it, and queue every partition's
        first stage.  A torch tensor is not read here: its partitions come
        off the device on the COPYD2H thread."""
        ctx = get_registry().declare(name)
        is_torch = isinstance(tensor, torch.Tensor)
        device, ready = None, None
        if is_torch:
            t = tensor.detach()
            flat = t.reshape(-1)
            dtype_id, itemsize, device = to_datatype(t.dtype), t.element_size(), t.device
            if device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
                flat.record_stream(self.streams(device)[0])
        else:
            flat = np.ascontiguousarray(np.asarray(tensor)).reshape(-1)
            dtype_id, itemsize = to_datatype(flat.dtype), flat.dtype.itemsize
        self._prepare_round(ctx, int(dtype_id), flat.numel() if is_torch else flat.size,
                            itemsize)
        if self._server_opt_profile(ctx)[0]:
            average = False  # the pull is the parameters the rule computed
        job = _Job(name, ctx, flat, int(dtype_id), average, handle,
                   tuple(np.shape(tensor)) if not is_torch else tuple(tensor.shape),
                   is_torch, device, ready)
        on_device = is_torch and all(p.key in self._device_codecs for p in ctx.partitions)
        if on_device:
            job.device_parts = {}
        elif is_torch:
            job.result_t = torch.empty(flat.numel(), dtype=flat.dtype,
                                       pin_memory=device.type == "cuda")
            job.result = _np_view(job.result_t)
        else:
            job.result = np.empty(flat.shape, dtype=flat.dtype)
        if self._traced():
            job.trace_id = new_trace_id()
        self._step_begin()
        for part in ctx.partitions:
            stages, small = self._stages(part, job, itemsize)
            if small:
                with self._fuse_lock:
                    self._staged_smalls += 1
            task = TensorTableEntry(
                tensor_name=name, key=part.key, priority=priority,
                version=ctx.version, offset=part.offset, length=part.length,
                queue_list=list(stages), context=job, fuse_staged=small,
            )
            self._stamp_task_trace(task, job)
            self.queues[QueueType.COPYD2H].add_task(task)

    def submit_rowsparse(self, name: str, indices: Any, values: Any, total_rows: int,
                         average: bool, priority: int, handle: int) -> None:
        """Row-sparse push_pull (RequestType::kRowSparsePushPull,
        common.h:267-271): push the ``values`` rows at ``indices`` of a
        ``(total_rows, row_len)`` tensor, which the server scatter-sums into
        its dense store, and pull the same rows of the round's sum.  One
        key; the task has the PUSH and PULL stages alone.  The push payload
        is ``!II`` (rows, row length), the indices as big-endian u32 and the
        float32 rows; the pull request its first two parts."""
        idx, vals, payload = self._rowsparse_to_host(indices, values, total_rows)
        nrows, row_len = vals.shape
        ctx = get_registry().declare(name)
        if self._server_opt_profile(ctx)[0]:
            # the server would update against a partial accumulator
            raise ValueError(f"tensor {name!r}: the server-side optimizer profile does not "
                             "support row-sparse push_pull (dense only)")
        self._prepare_round(ctx, int(DataType.FLOAT32), total_rows * row_len, 4, one_part=True)
        payload[:8] = np.frombuffer(struct.pack("!II", nrows, row_len), np.uint8)
        payload[8: 8 + 4 * nrows].view(">u4")[:] = idx
        is_torch = isinstance(values, torch.Tensor)
        device = values.device if is_torch else None
        job = _Job(name, ctx, None, int(DataType.FLOAT32), average, handle,
                   (nrows, row_len), is_torch, device, None)
        job.rowsparse = (payload, payload[: 8 + 4 * nrows].tobytes())
        if is_torch:
            job.result_t = torch.empty(nrows * row_len, dtype=torch.float32,
                                       pin_memory=device.type == "cuda")
            job.result = job.result_t.numpy()
        else:
            job.result = np.empty(nrows * row_len, dtype=np.float32)
        if self._traced():
            job.trace_id = new_trace_id()
        self._step_begin()
        part = ctx.partitions[0]
        task = TensorTableEntry(
            tensor_name=name, key=part.key, priority=priority, version=ctx.version,
            offset=0, length=part.length, queue_list=[QueueType.PUSH, QueueType.PULL],
            context=job)
        self._stamp_task_trace(task, job)
        self.queues[QueueType.PUSH].add_task(task)

    def _rowsparse_to_host(self, indices: Any, values: Any, total_rows: int) -> tuple:
        """(int64 indices, float32 rows, push payload) of a row-sparse call,
        validated, on the host.  The payload is a uint8 buffer with room for
        the header and the indices, its tail the rows: a CUDA call's rows
        are copied there (pinned) on the side stream after the caller's
        stream, with its indices, and waited for once."""
        if isinstance(values, torch.Tensor) and values.device.type == "cuda":
            dev = values.device
            rows = values.detach()
            idx_d = torch.as_tensor(indices).detach()
            check_rowsparse_shapes(tuple(idx_d.shape), tuple(rows.shape))
            n, r = rows.shape
            payload_t = torch.empty(8 + 4 * n + 4 * n * r, dtype=torch.uint8, pin_memory=True)
            idx_h = torch.empty(idx_d.shape, dtype=torch.int64, pin_memory=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            d2h = self.streams(dev)[0]
            with torch.cuda.stream(d2h):
                d2h.wait_event(ready)
                idx_h.copy_(idx_d, non_blocking=True)
                payload_t[8 + 4 * n:].view(torch.float32).view(n, r).copy_(
                    rows, non_blocking=True)
                done = torch.cuda.Event()
                done.record(d2h)
            done.synchronize()
            counters().bump("d2h_bytes", 4 * n * r + idx_h.numel() * 8)
            payload = payload_t.numpy()
            idx, vals = validate_rowsparse(idx_h.numpy(), payload[8 + 4 * n:].view(np.float32)
                                           .reshape(n, r), total_rows)
            return idx, vals, payload
        if isinstance(indices, torch.Tensor):
            indices = indices.detach().cpu().to(torch.int64).numpy()
        if isinstance(values, torch.Tensor):
            values = values.detach().to(torch.float32).numpy()
        idx, vals = validate_rowsparse(indices, values, total_rows)
        n = idx.shape[0]
        payload = np.empty(8 + 4 * n + vals.nbytes, dtype=np.uint8)
        payload[8 + 4 * n:] = vals.reshape(-1).view(np.uint8)
        return idx, vals, payload

    def _stages(self, part, job: _Job, itemsize: int) -> tuple:
        """(stage list, fused?) of a partition: a compressed one is gauged
        against the fusion threshold by its codec's wire bytes, a raw one
        (a key in the off set too, on either lane) by its own."""
        limit = self.cfg.fusion_threshold
        if part.key in self._compression_auto_off:
            codec = None
        elif job.device_parts is not None:
            codec = self._device_codecs[part.key]
        else:
            codec = self._compressors.get(part.key)
        if codec is not None:
            small = bool(limit) and codec.wire_nbytes() <= limit
            return (self.STAGES_COMPRESSED_FUSED if small else self.STAGES_COMPRESSED), small
        small = bool(limit) and part.length * itemsize <= limit
        return (self.STAGES_FUSED if small else self.STAGES), small

    def _prepare_round(self, ctx, dtype_id: int, n_elements: int, itemsize: int,
                       one_part: bool = False) -> None:
        """Run the init barrier of every partition, then advance the
        tensor's round and seed the gate.  It runs again under a new engine
        (the servers' stores are new), after the client's
        ``server_generation`` changed (a resize re-homed the keys: their
        new owners start empty, the codec configs are sent to them again,
        and the journal of the old numbering is cleared), and after a job
        of the tensor failed degraded."""
        with self._init_lock:
            if ctx.partitions and sum(p.length for p in ctx.partitions) != n_elements:
                raise ValueError(
                    f"tensor {ctx.name!r} re-used with a different size: declared "
                    f"{sum(p.length for p in ctx.partitions)} elements, got "
                    f"{n_elements} (use a distinct name per tensor)"
                )
            gen = self.client.server_generation
            if (not ctx.initialized or ctx.engine_epoch != self._epoch
                    or ctx.server_generation != gen or ctx.name in self._reinit_names):
                if ctx.partitions:
                    pass
                elif one_part:  # a row-sparse tensor: one key, never cut
                    ctx.partitions = [Partition(key=ctx.key_for_part(0), offset=0,
                                                length=n_elements)]
                else:
                    partition_tensor(ctx, n_elements, itemsize, self.cfg.partition_bytes)
                if self._journal is not None:
                    # the barrier restarts the keys' round numbering: no
                    # entry of the old numbering may replay into the new
                    for part in ctx.partitions:
                        self._journal.clear_key(part.key)
                again = ctx.initialized and ctx.engine_epoch == self._epoch
                profile = {}
                is_async, staleness = self._async_profile(ctx)
                if is_async:
                    profile.update(async_profile=True, staleness=staleness)
                rule, hp = self._server_opt_profile(ctx)
                if rule:
                    # the average is the rule's to do, on the server
                    profile.update(server_opt=rule, server_opt_hp={"average": True, **hp})
                for part in ctx.partitions:
                    trace = (new_trace_id(), new_trace_id()) if self._traced() else None
                    t0 = time.time()
                    self.client.init_tensor(part.key, part.length, dtype_id,
                                            trace=trace, **profile)
                    if trace is not None:
                        self.tracer.record_span(ctx.name, "INIT", t0, time.time() - t0,
                                                span_args(*trace, key=part.key))
                    self._table[part.key] = (ctx.name, part.length, itemsize)
                if again:
                    # a forced re-init under this engine: the servers' chains
                    # are registered again, the worker's keep their state
                    self._reship_compressors(ctx)
                    for part in ctx.partitions:
                        self._seeded.discard(part.key)
                else:
                    self._maybe_setup_compression(ctx, dtype_id, n_elements * itemsize)
                ctx.version = 0
                ctx.initialized = True
                ctx.engine_epoch = self._epoch
                ctx.server_generation = gen
                self._reinit_names.discard(ctx.name)
            ctx.version += 1
            for part in ctx.partitions:
                if part.key not in self._seeded:
                    self._seeded.add(part.key)
                    self._push_ready.set_ready_count(part.key, ctx.version)

    def _maybe_setup_compression(self, ctx, dtype_id: int, nbytes: int) -> None:
        """Build each partition's codec and ship its config to the owning
        server (operations.cc:396-408): float32 tensors of at least
        BYTEPS_MIN_COMPRESS_BYTES only (global.cc:137)."""
        from byteps_tpu_torch.compression.registry import apply_lr_to_chain, create_compressor
        from byteps_tpu_torch.core.device_codec import device_codec_for

        if not any(k in ctx.kwargs for k in ("byteps_compressor_type", "compressor")):
            return
        if dtype_id != DataType.FLOAT32 or nbytes < self.cfg.min_compress_bytes:
            return
        ctype = str(ctx.kwargs.get("byteps_compressor_type") or ctx.kwargs.get("compressor")
                    or "?")
        for part in ctx.partitions:
            codec = create_compressor(ctx.kwargs, part.length)
            self._ensure_compress_threads()
            self._compressors[part.key] = codec
            self._codec_names[part.key] = ctype
            with self._tuning_lock:
                if ctype in self._fleet_codec_off:
                    # the fleet turned this codec off before the key came
                    self._fleet_codec_off[ctype].add(part.key)
                    self._compression_auto_off.add(part.key)
            # a chain made after set_compression_lr must still honour it
            apply_lr_to_chain(codec, self._compression_lr)
            if self.cfg.compression_auto and codec.wire_static:
                self._auto_static_verdict(part.key, codec)
            self.client.register_compressor(part.key, ctx.kwargs)
            dc = device_codec_for(ctx.kwargs, part.length)
            if dc is not None:
                self._device_codecs[part.key] = dc
        self._maybe_send_lr()

    def _reship_compressors(self, ctx) -> None:
        """Register each partition's codec config with its server again
        (after a forced re-init); a new server chain starts at lr 1, so the
        current lr goes out again."""
        shipped = False
        for part in ctx.partitions:
            if part.key in self._compressors:
                self.client.register_compressor(part.key, ctx.kwargs)
                shipped = True
        if shipped:
            self._lr_sent_to_servers = 1.0
            self._maybe_send_lr()

    def _async_profile(self, ctx) -> tuple:
        """(async?, staleness bound) of a tensor's keys: the
        ``byteps_async`` / ``byteps_staleness`` declare kwargs, else
        ``BYTEPS_ASYNC`` / ``BYTEPS_STALENESS_BOUND``."""
        raw = ctx.kwargs.get("byteps_async")
        is_async = self.cfg.async_mode if raw in (None, "") else truthy(str(raw))
        if not is_async:
            return False, -1
        raw = ctx.kwargs.get("byteps_staleness")
        return True, max(-1, int(raw) if raw not in (None, "") else self.cfg.staleness_bound)

    def _server_opt_profile(self, ctx) -> tuple:
        """(rule name or None, hyperparameters) of a tensor's keys: the
        ``byteps_server_opt`` / ``byteps_server_opt_hp`` declare kwargs (an
        off spelling opts a tensor out), else ``BYTEPS_SERVER_OPT`` /
        ``BYTEPS_SERVER_OPT_HP``."""
        raw = ctx.kwargs.get("byteps_server_opt")
        name = rule_name(self.cfg.server_opt if raw in (None, "") else raw)
        if name is None:
            return None, {}
        hp = ctx.kwargs.get("byteps_server_opt_hp")
        return name, parse_hp(self.cfg.server_opt_hp if hp in (None, "") else hp)

    def set_compression_lr(self, lr: float) -> None:
        """Feed the learning rate to every error-feedback stage: this
        worker's chains, and the servers' chains over the wire (the
        reference's lr.s file, vanilla_error_feedback.h:44-58).  An lr set
        before any chain exists is applied to chains as they are made and
        sent with the first registration; an unchanged lr sends nothing."""
        from byteps_tpu_torch.compression.registry import apply_lr_to_chain

        self._compression_lr = float(lr)
        for codec in list(self._compressors.values()):
            apply_lr_to_chain(codec, self._compression_lr)
        self._maybe_send_lr()

    def _resend_lr(self) -> None:
        """A book grew the server set or moved keys: send the current lr
        to every server again, as after a forced re-init.  Under resharding
        no re-init runs, and a server that joined after
        ``set_compression_lr`` would build a migrated chain at lr 1.0
        (both packages' servers apply a late lr frame to the chains they
        hold and keep it for later ones).  A deliberate divergence from
        ``byteps_tpu``, whose worker sends the lr only when it changes."""
        if self._compressors:
            self._lr_sent_to_servers = 1.0
            self._maybe_send_lr()

    def _maybe_send_lr(self) -> None:
        if self._compressors and self._compression_lr != self._lr_sent_to_servers:
            self.client.set_compression_lr(self._compression_lr)
            self._lr_sent_to_servers = self._compression_lr

    def partition_table(self) -> List[dict]:
        """Every partition this engine initialized: name, key, elements,
        bytes per element, and its wire payload size when it has a device
        codec (None for the raw lane)."""
        with self._init_lock:
            return [
                {"name": name, "key": key, "length": length, "itemsize": itemsize,
                 "wire_nbytes": (self._device_codecs[key].wire_nbytes()
                                 if key in self._device_codecs else None)}
                for key, (name, length, itemsize) in self._table.items()
            ]

    # --- tracing ---------------------------------------------------------

    def _traced(self) -> bool:
        return (self.tracer is not None and self.tracer.enabled
                and self.tracer.spans_enabled)

    @staticmethod
    def _stamp_task_trace(task: TensorTableEntry, job: _Job) -> None:
        """A partition task's span under its job's trace, fixed for the
        task's life: every attempt of its RPCs carries it, so the servers'
        children (a replay's ``dedupe`` too) join the right span."""
        if job.trace_id:
            task.trace_id = job.trace_id
            task.span_id = new_trace_id()

    @staticmethod
    def _task_trace(task: TensorTableEntry) -> Optional[tuple]:
        """The (trace id, span id) a task's frames carry, or None."""
        return (task.trace_id, task.span_id) if task.trace_id else None

    def _wire_bytes(self, name: str, nbytes: int, task: TensorTableEntry) -> None:
        """Bytes a task moved on the wire: ``wire_tx_bytes`` /
        ``wire_rx_bytes`` and the push/pull speed."""
        counters().bump(name, nbytes, labels=job_labels(task.job))
        if self.telemetry is not None:
            self.telemetry.record(nbytes)

    def _sample(self, task: TensorTableEntry, job: _Job, finished: QueueType) -> None:
        """``BYTEPS_DEBUG_SAMPLE_TENSOR`` (core_loops.cc:37-67): the norm and
        first value of what a stage left, at INFO.  Pull-side stages sample
        what came back (a device-lane job's decoded partition on the card;
        a compressed PULL, codec bytes, not at all), push-side stages the
        host copy."""
        from byteps_tpu_torch.common import logging as bpslog

        back = (QueueType.DECOMPRESS, QueueType.COPYH2D)
        if job.device_parts is not None and finished in back:
            part = job.device_parts.get(task.offset)
            vals = None if part is None else part.detach().double().cpu().numpy()
        elif finished in back or (finished == QueueType.PULL and task.compressed is None):
            vals = (None if job.result is None
                    else job.result[task.offset: task.offset + task.length])
        elif finished == QueueType.PULL:
            vals = None
        else:
            vals = task.cpubuff
        if vals is None or not np.size(vals):
            return
        vals = np.asarray(vals)
        if job.dtype_id == DataType.BFLOAT16 and vals.dtype == np.uint16:
            vals = (vals.astype(np.uint32) << 16).view(np.float32)
        vals = vals.reshape(-1).astype(np.float64)
        bpslog.info("sample %s key=%d stage=%s v=%d norm=%.6g first=%.6g", job.name,
                    task.key, finished.name, task.version, float(np.linalg.norm(vals)),
                    float(vals[0]))

    # --- completion ------------------------------------------------------

    def _proceed(self, task: TensorTableEntry) -> None:
        """Advance a task to its next stage, or finish its partition."""
        finished = task.queue_list.pop(0)
        job: _Job = task.context
        if self.cfg.debug_sample_tensor and self.cfg.debug_sample_tensor in job.name:
            self._sample(task, job, finished)
        if self.tracer is not None:
            self.tracer.record(job.name, finished.name, job.t0, time.time() - job.t0,
                               job.version)
        if task.enqueued_at:
            # the finished stage's dwell, enqueue to done
            metrics().observe("stage_dwell_seconds", time.monotonic() - task.enqueued_at,
                              labels={"stage": finished.name})
        if task.trace_id and self._traced():
            self.tracer.record_span(job.name, finished.name, task.enqueued_wall,
                                    time.time() - task.enqueued_wall,
                                    span_args(task.trace_id, task.span_id, key=task.key,
                                              version=task.version))
        self.queues[finished].report_finish(task)
        if task.queue_list:
            self.queues[task.queue_list[0]].add_task(task)
            return
        # the partition's round trip is over: the key's next round may go
        self._push_ready.add_ready_count(task.key)
        self.queues[QueueType.PUSH].notify()
        self.queues[QueueType.FUSE].notify()
        with job.lock:
            job.pending -= 1
            done = job.pending == 0
        if done:
            self._finalize(job)

    def _fail_task(self, task: TensorTableEntry, stage: QueueType, reason: str,
                   degraded: bool = False) -> None:
        """Fail a task once: return its credit, re-arm its key's gate, and
        surface the error on the handle.  ``degraded`` (the data plane gave
        up): DegradedError, and the tensor's next submit runs its init
        barrier again, since the abandoned round left the worker's and the
        server's round numbers apart.  The job's ``failed`` flag is the
        abort fence of its other tasks' retries."""
        from byteps_tpu_torch.core.state import get_state

        job = task.context
        if isinstance(job, _FusionGroup):
            # a pack's group task: return its credit once and fail its
            # members, which own the accounting
            with job.lock:
                if job.done:
                    return
                job.done = True
            self.queues[QueueType.PUSH].report_finish(task)
            for mtask, _ in job.members:
                self._fail_task(mtask, QueueType.FUSE, reason, degraded=degraded)
            return
        with job.lock:
            if task.failed:
                return
            task.failed = True
            first = not job.failed
            job.failed = True
        # a small partition that died before the fusion buffer leaves the
        # staging count, or the idle flush would never fire again
        self._unstage_small(task)
        self.queues[stage].report_finish(task)
        self._push_ready.add_ready_count(task.key)
        self.queues[QueueType.PUSH].notify()
        self.queues[QueueType.FUSE].notify()
        if first:
            self._step_end(job)
            if degraded:
                counters().bump("degraded_jobs")
                self._reinit_names.add(job.name)  # no lock: a receive loop may run this
            status = (Status.Degraded if degraded else Status.Aborted)(
                f"{stage.name}: {reason}")
            get_state().handles.mark_done(job.handle, None, status)

    def _finalize(self, job: _Job) -> None:
        """All partitions are back: assemble, average (floating dtypes), put
        the result on the tensor's device, and complete the handle."""
        from byteps_tpu_torch.core.state import get_state

        if job.failed:
            return
        self._step_end(job)
        n = self.client.num_workers
        average = job.average and is_floating(job.dtype_id)
        if not job.is_torch:
            out = job.result / n if average else job.result
            get_state().handles.mark_done(job.handle, out.reshape(job.shape))
            return
        cuda = job.device.type == "cuda"
        stream = self.streams(job.device)[1] if cuda else None
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            if job.device_parts is not None:
                parts = [job.device_parts[o] for o in sorted(job.device_parts)]
                out = parts[0] if len(parts) == 1 else torch.cat(parts)
            else:
                out = job.result_t.to(job.device, non_blocking=True)
            if average:
                out = divide(out, n)
            out = out.reshape(job.shape)
            if cuda:
                done = torch.cuda.Event()
                done.record(stream)
                out = DeviceResult(out, done)
        get_state().handles.mark_done(job.handle, out)

    # --- the recovery plane ---------------------------------------------

    def heal_degraded(self, name: str, tensor: Any, average: bool) -> Any:
        """Mend in place a tensor whose last job failed degraded while the
        fleet stayed as it was: resync every server that owns one of its
        partitions (replaying the journaled pushes it never absorbed, which
        completes the abandoned round with its original payloads), then
        pull the round and return what the job would have returned, on the
        tensor's device; its next submit goes on with the round numbers
        as they are, with no init barrier and no peer waiting on it.

        None where that cannot work: the tensor is not marked, the server
        set changed since its init barrier, it has a codec (its pull needs
        the codec pipeline), a server cannot resync, or the round's pull
        does not come back in time.  The caller then
        submits the step again through the init barrier."""
        from byteps_tpu_torch.comm.ps_client import ZERO_COPIED

        try:
            ctx = get_registry().get(name)
        except KeyError:
            return None
        with self._init_lock:
            if (name not in self._reinit_names or not ctx.initialized
                    or ctx.engine_epoch != self._epoch or not ctx.partitions
                    or ctx.server_generation != self.client.server_generation):
                return None
        if any(p.key in self._compressors or p.key in self._device_codecs
               for p in ctx.partitions):
            return None
        if self._server_opt_profile(ctx)[0]:
            average = False  # the pull is the parameters the rule computed
        is_torch = isinstance(tensor, torch.Tensor)
        total = sum(p.length for p in ctx.partitions)
        if (tensor.numel() if is_torch else int(np.size(tensor))) != total:
            return None
        if is_torch:
            result_t = torch.empty(total, dtype=tensor.dtype)
            result = _np_view(result_t)
        else:
            result = np.empty(total, dtype=np.asarray(tensor).dtype)
        dtype_id = int(to_datatype(tensor.dtype if is_torch else result.dtype))
        # 1. resync each owning server: its replay completes the round
        route_keys: Dict[int, int] = {}
        for p in ctx.partitions:
            route_keys.setdefault(self.client.server_for(p.key), p.key)
        for key in route_keys.values():
            if not self.client.resync_in_place(key):
                return None
        # 2. pull the round, every partition at once, then wait
        timeout = max(10.0, self.cfg.resync_deadline_s
                      + (self.cfg.rpc_deadline_s or 1.0) * (self.cfg.rpc_retries + 1))
        pending = []
        for p in ctx.partitions:
            done, box = threading.Event(), {}
            sink = memoryview(result).cast("B")[p.offset * result.itemsize:
                                                 (p.offset + p.length) * result.itemsize]

            def on_pull(payload, _box=box, _done=done) -> None:
                _box["payload"] = payload
                _done.set()

            self.client.pull(p.key, ctx.version, on_pull,
                             on_error=lambda reason, _done=done: _done.set(),
                             dtype_id=dtype_id, sink=sink)
            pending.append((p, done, box))
        deadline = time.monotonic() + timeout
        for p, done, box in pending:
            if not done.wait(max(0.0, deadline - time.monotonic())) or "payload" not in box:
                return None
            if box["payload"] is not ZERO_COPIED:
                arr = np.frombuffer(box["payload"], dtype=result.dtype)
                result[p.offset: p.offset + p.length] = arr[: p.length]
        self._reinit_names.discard(name)
        n = self.client.num_workers
        if not is_torch:
            out = result / n if average and is_floating(dtype_id) else result
            return out.reshape(np.shape(tensor))
        out = result_t.to(tensor.device)
        if average and is_floating(dtype_id):
            out = divide(out, n)
        return out.reshape(tensor.shape)

    # --- stage bodies ----------------------------------------------------

    def _copy_d2h_once(self, task: TensorTableEntry) -> None:
        """COPYD2H (core_loops.cc:378-443): the partition's bytes, or with a
        device codec its wire payload, reach host memory."""
        job: _Job = task.context
        sl = job.flat[task.offset: task.offset + task.length]
        # a device-lane job's partition in the off set is copied raw
        on_device = job.device_parts is not None and QueueType.COMPRESS in task.queue_list
        if not job.is_torch:
            task.cpubuff = sl
        elif job.device.type == "cpu":
            if on_device:
                task.compressed = self._device_codecs[task.key].compress(sl)
            else:
                task.cpubuff = _np_view(sl)
        else:
            d2h = self.streams(job.device)[0]
            with torch.cuda.stream(d2h):
                d2h.wait_event(job.ready)
                if on_device:
                    task.compressed = self._device_codecs[task.key].compress(sl)
                    counters().bump("d2h_bytes", len(task.compressed))
                else:
                    host = torch.empty(task.length, dtype=sl.dtype, pin_memory=True)
                    host.copy_(sl, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(d2h)
                    done.synchronize()
                    task.cpubuff = _np_view(host)
                    counters().bump("d2h_bytes", task.cpubuff.nbytes)
        self._proceed(task)

    def _compress_once(self, task: TensorTableEntry) -> None:
        """COMPRESS (core_loops.cc:498-536): the host codec; a pass-through
        for a partition the device already packed."""
        if task.compressed is None:
            task.compressed = self._compressors[task.key].compress(task.cpubuff)
            self._note_compression(task.key, task.cpubuff.nbytes, len(task.compressed))
        self._proceed(task)

    def _unstage_small(self, task: TensorTableEntry) -> None:
        """A FUSE-routed task reached the fusion buffer or died before it:
        it leaves the staging count, once."""
        with self._fuse_lock:
            if task.fuse_staged:
                task.fuse_staged = False
                self._staged_smalls -= 1

    def _fuse_once(self, task: TensorTableEntry) -> None:
        """FUSE: put a small partition into its server's fusion buffer (a
        compressed one's codec payload, what an unfused push would send).
        When no small partition is left in flight before this stage, the
        burst is over and every buffer flushes."""
        if task.compressed is not None:
            payload = task.compressed
        else:
            payload = task.cpubuff.data.cast("B")
        self._fuser.add(task, payload)
        self._unstage_small(task)
        with self._fuse_lock:
            staging = self._staged_smalls
        if staging == 0 and self.queues[QueueType.FUSE].pending() == 0:
            self._fuser.drain_idle()

    def _push_group(self, group_task: TensorTableEntry, group: _FusionGroup) -> None:
        """Send one pack as one Op.FUSED frame and fan its reply out to the
        members' PULL stages; a frame that fails sends its members again as
        per-key pushes and pulls."""
        members = group.members

        def finish_group() -> bool:
            """The group's credit, once; True for the winner of the race
            between the reply and the error."""
            with group.lock:
                if group.done:
                    return False
                group.done = True
            self.queues[QueueType.PUSH].report_finish(group_task)
            return True

        # the pack was grouped by server at FUSE time; a resize since may
        # have re-homed members apart, and one frame cannot reach two
        # servers: they go unfused, each routed on its own
        if len({self.client.server_for(m.key) for m, _ in members}) > 1:
            if finish_group():
                self._unfuse_members(group, "the server set was resized under the pack")
            return

        wire = [(m.key,
                 get_command_type(RequestType.COMPRESSED_PUSH_PULL if m.compressed is not None
                                  else RequestType.DEFAULT_PUSH_PULL, m.context.dtype_id),
                 m.version, payload)
                for m, payload in members]
        counters().bump("fused_frames")
        counters().bump("fused_keys", len(members))
        self._wire_bytes("wire_tx_bytes", sum(memoryview(p).nbytes for *_, p in wire),
                         group_task)
        if self._journal is not None:
            # each member on its own: a heal replays them as plain pushes,
            # which the server sums through the same replay ledger
            for key, cmd, version, payload in wire:
                self._journal.record(key, version, cmd, payload, fused=True)

        # the pack's own span (its members are spans of their jobs' traces,
        # whose ids ride the frame's trailer), fixed for the frame's life
        pack_trace = member_spans = None
        t_pack = time.time()
        if self._traced():
            pack_trace = (new_trace_id(), new_trace_id())
            member_spans = [m.span_id for m, _ in members]

        def deliver(replies: list) -> None:
            if not finish_group():
                return
            if pack_trace is not None:
                self.tracer.record_span("<fused>", "FUSED_RPC", t_pack, time.time() - t_pack,
                                        span_args(pack_trace[0], pack_trace[1],
                                                  keys=len(members)))
            by_key = {key: payload for key, _, payload in replies}
            for mtask, _ in members:
                payload = by_key.get(mtask.key)
                if payload is None:
                    self._fail_task(mtask, QueueType.FUSE, "the fused reply lacks the "
                                    "member's key", degraded=True)
                    continue
                mtask.fused_reply = payload
                self._proceed(mtask)  # FUSE is done; PULL delivers the slot

        def on_error(reason: str) -> None:
            if finish_group():
                self._unfuse_members(group, reason)

        self.client.push_fused(wire, cb=deliver, on_error=on_error,
                               abort_check=lambda: all(m.context.failed for m, _ in members),
                               trace=pack_trace, member_spans=member_spans)

    def _unfuse_members(self, group: _FusionGroup, reason: str) -> None:
        """A pack whose frame failed: each live member goes back to the PUSH
        queue in place of its FUSE stage (its round allowance still holds),
        the pipeline it would have taken with fusion off.  Once: a per-key
        push that fails again fails its task."""
        counters().bump("fused_fallback")
        for mtask, _ in group.members:
            if mtask.context.failed or mtask.queue_list[:1] != [QueueType.FUSE]:
                self._fail_task(mtask, QueueType.FUSE, f"unfused fallback: {reason}",
                                degraded=True)
                continue
            mtask.queue_list[0] = QueueType.PUSH
            self.queues[QueueType.PUSH].add_task(mtask)

    def _push_once(self, task: TensorTableEntry) -> None:
        """ZPush in priority order (core_loops.cc:538-582); a fusion pack
        goes out as one fused frame."""
        job = task.context
        if isinstance(job, _FusionGroup):
            self._push_group(task, job)
            return
        if job.rowsparse is not None:
            payload, rtype = job.rowsparse[0].data, RequestType.ROW_SPARSE_PUSH_PULL
        elif task.compressed is not None:
            payload, rtype = task.compressed, RequestType.COMPRESSED_PUSH_PULL
        else:
            payload, rtype = task.cpubuff.data.cast("B"), RequestType.DEFAULT_PUSH_PULL
            if (self.cfg.compression_auto and task.key in self._compression_auto_off
                    and task.key not in self._lossless_probed):
                self._lossless_probe(task.key, payload)
        # the lossless arm: a raw push of a key the probe or the fleet put
        # there ships its container; wire_tx_bytes counts the raw bytes
        lossless = (rtype == RequestType.DEFAULT_PUSH_PULL and task.key in self._lossless_keys
                    ) or None
        self._wire_bytes("wire_tx_bytes", memoryview(payload).nbytes, task)
        if self._journal is not None:
            # before the send, so a give-up of this very push can replay it
            self._journal.record(task.key, task.version,
                                 get_command_type(rtype, job.dtype_id), payload)
        self.client.push(
            task.key, payload, job.dtype_id, task.version,
            cb=lambda: self._proceed(task),
            on_error=lambda reason: self._fail_task(task, QueueType.PUSH, reason,
                                                    degraded=True),
            request_type=rtype, abort_check=lambda: job.failed, lossless=lossless,
            trace=self._task_trace(task),
        )

    def _pull_once(self, task: TensorTableEntry) -> None:
        """ZPull (core_loops.cc:584-618): a raw pull lands in the result
        buffer with no copy; a compressed one goes on to DECOMPRESS; a
        row-sparse one sends the rows it gathers."""
        job: _Job = task.context
        compressed = (job.rowsparse is None
                      and task.queue_list[1] == QueueType.DECOMPRESS)
        if task.fused_reply is not None:
            # a fused member: the frame's reply carried this round already
            payload, task.fused_reply = task.fused_reply, None
            self._wire_bytes("wire_rx_bytes", len(payload), task)
            if compressed:
                task.compressed = payload
            else:
                dst = self._raw_dst(task, job)
                dst[:] = np.frombuffer(payload, dtype=dst.dtype)[: task.length]
            self._proceed(task)
            return
        sink = dst = None
        if not compressed:
            dst = self._raw_dst(task, job)
            sink = memoryview(dst).cast("B")

        def on_pull(payload) -> None:
            from byteps_tpu_torch.comm.ps_client import ZERO_COPIED

            if payload is ZERO_COPIED:
                self._wire_bytes("wire_rx_bytes", len(sink), task)
            else:
                self._wire_bytes("wire_rx_bytes", len(payload), task)
                if compressed:
                    task.compressed = payload
                else:
                    dst[:] = np.frombuffer(payload, dtype=dst.dtype)[: task.length]
            self._proceed(task)

        if job.rowsparse is not None:
            rtype = RequestType.ROW_SPARSE_PUSH_PULL
        else:
            rtype = (RequestType.COMPRESSED_PUSH_PULL if compressed
                     else RequestType.DEFAULT_PUSH_PULL)
        self.client.pull(
            task.key, task.version, on_pull,
            on_error=lambda reason: self._fail_task(task, QueueType.PULL, reason,
                                                    degraded=True),
            dtype_id=job.dtype_id, request_type=rtype, sink=sink,
            abort_check=lambda: job.failed,
            payload=job.rowsparse[1] if job.rowsparse is not None else b"",
            trace=self._task_trace(task),
        )

    @staticmethod
    def _raw_dst(task: TensorTableEntry, job: _Job) -> np.ndarray:
        """Where a raw pull lands: the job's host result, or for a raw
        partition of a device-lane job a host tensor of its own
        (``task.raw_out``, pinned for CUDA) that COPYH2D moves over."""
        if job.device_parts is None:
            return job.result[task.offset: task.offset + task.length]
        if task.raw_out is None:
            task.raw_out = torch.empty(task.length, dtype=job.flat.dtype,
                                       pin_memory=job.device.type == "cuda")
        return _np_view(task.raw_out)

    def _decompress_once(self, task: TensorTableEntry) -> None:
        """DECOMPRESS (core_loops.cc:620-648): device-codec partitions are
        decoded on the device (the H2D stream for CUDA), host-codec ones
        into the host result."""
        job: _Job = task.context
        if job.device_parts is not None:
            dc = self._device_codecs[task.key]
            if job.device.type == "cuda":
                with torch.cuda.stream(self.streams(job.device)[1]):
                    part = dc.decompress(task.compressed, task.length, job.device)
            else:
                part = dc.decompress(task.compressed, task.length, job.device)
            with job.lock:
                job.device_parts[task.offset] = part
        else:
            arr = self._compressors[task.key].decompress(task.compressed, task.length)
            job.result[task.offset: task.offset + task.length] = arr[: task.length]
        self._proceed(task)

    def _copy_h2d_once(self, task: TensorTableEntry) -> None:
        """COPYH2D (core_loops.cc:650-753): the copy back to the device
        happens once per tensor in ``_finalize``, but for a raw partition
        of a device-lane job, which goes over here on the stream the job
        is assembled on."""
        job: _Job = task.context
        if job.device_parts is not None and task.raw_out is not None:
            host, task.raw_out = task.raw_out, None
            if job.device.type == "cuda":
                with torch.cuda.stream(self.streams(job.device)[1]):
                    part = host.to(job.device, non_blocking=True)
            else:
                part = host
            with job.lock:
                job.device_parts[task.offset] = part
        self._proceed(task)

