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

Not ported (ROADMAP.md Queue 1b): fusion, journal and resync healing,
row-sparse, the async and server-optimizer profiles, adaptive compression,
the tuner, tracing spans and the flight recorder.  Each stage's dwell is
observed as ``stage_dwell_seconds{stage}`` (``core/telemetry.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.partition import partition_tensor
from byteps_tpu_torch.common.registry import get_registry
from byteps_tpu_torch.common.types import (
    DataType,
    QueueType,
    RequestType,
    Status,
    TensorTableEntry,
    divide,
    is_floating,
    to_datatype,
)
from byteps_tpu_torch.core.ready_table import ReadyTable
from byteps_tpu_torch.core.scheduler import ScheduledQueue
from byteps_tpu_torch.core.telemetry import counters, metrics


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
        "version", "device_parts", "failed", "lock",
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
        self.lock = threading.Lock()


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

    #: engine instance ids: the registry outlives shutdown()/init(), the
    #: servers' stores do not, so a tensor first used under an earlier
    #: engine re-runs its init barrier
    _epoch_counter = itertools.count()

    def __init__(self, cfg: Config, ps_client) -> None:
        self.cfg = cfg
        self.client = ps_client
        self._epoch = next(PipelineEngine._epoch_counter)
        self._stop = threading.Event()
        # PUSH round gate: counts[key] = highest round allowed out
        self._push_ready = ReadyTable()
        self._seeded: set = set()
        disc = cfg.scheduling
        pool = max(1, cfg.threadpool_size)
        self.queues: Dict[QueueType, Any] = {
            QueueType.COPYD2H: ScheduledQueue(QueueType.COPYD2H, discipline=disc),
            QueueType.COMPRESS: _StripedStage(QueueType.COMPRESS, pool),
            QueueType.PUSH: ScheduledQueue(
                QueueType.PUSH, credit_bytes=cfg.scheduling_credit,
                ready_table=self._push_ready, discipline=disc,
            ),
            QueueType.PULL: ScheduledQueue(QueueType.PULL, discipline=disc),
            QueueType.DECOMPRESS: _StripedStage(QueueType.DECOMPRESS, pool),
            QueueType.COPYH2D: ScheduledQueue(QueueType.COPYH2D, discipline=disc),
        }
        self._threads: List[threading.Thread] = []
        self._init_lock = threading.Lock()
        #: per-key host codec chains and device adapters
        self._compressors: Dict[int, Any] = {}
        self._device_codecs: Dict[int, Any] = {}
        self._compress_started = False
        #: key -> (tensor name, elements, bytes per element) of every
        #: partition this engine initialized
        self._table: Dict[int, tuple] = {}
        #: per CUDA device: (COPYD2H stream, H2D and decode stream)
        self._streams: Dict[torch.device, tuple] = {}
        self._streams_lock = threading.Lock()
        #: the learning rate of error-feedback chains, and the one the
        #: servers were last sent (their chains start at 1.0)
        self._compression_lr = 1.0
        self._lr_sent_to_servers = 1.0

    # --- lifecycle -------------------------------------------------------

    def start(self) -> None:
        for qt, fn in ((QueueType.COPYD2H, self._copy_d2h_once),
                       (QueueType.PUSH, self._push_once),
                       (QueueType.PULL, self._pull_once),
                       (QueueType.COPYH2D, self._copy_h2d_once)):
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

    def streams(self, device: torch.device) -> tuple:
        """(COPYD2H stream, H2D/decode stream) of a CUDA device: one pair
        per device for the engine's life, so every partition of a tensor
        is decoded on the stream its result is assembled on."""
        with self._streams_lock:
            st = self._streams.get(device)
            if st is None:
                st = self._streams[device] = (torch.cuda.Stream(device),
                                              torch.cuda.Stream(device))
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
        for part in ctx.partitions:
            compressed = part.key in self._compressors
            self.queues[QueueType.COPYD2H].add_task(TensorTableEntry(
                tensor_name=name, key=part.key, priority=priority,
                version=ctx.version, offset=part.offset, length=part.length,
                queue_list=list(self.STAGES_COMPRESSED if compressed else self.STAGES),
                context=job,
            ))

    def _prepare_round(self, ctx, dtype_id: int, n_elements: int, itemsize: int) -> None:
        """Run (or, under a new engine, re-run) the init barrier of every
        partition, then advance the tensor's round and seed the gate."""
        with self._init_lock:
            if ctx.partitions and sum(p.length for p in ctx.partitions) != n_elements:
                raise ValueError(
                    f"tensor {ctx.name!r} re-used with a different size: declared "
                    f"{sum(p.length for p in ctx.partitions)} elements, got "
                    f"{n_elements} (use a distinct name per tensor)"
                )
            if not ctx.initialized or ctx.engine_epoch != self._epoch:
                if not ctx.partitions:
                    partition_tensor(ctx, n_elements, itemsize, self.cfg.partition_bytes)
                for part in ctx.partitions:
                    self.client.init_tensor(part.key, part.length, dtype_id)
                    self._table[part.key] = (ctx.name, part.length, itemsize)
                self._maybe_setup_compression(ctx, dtype_id, n_elements * itemsize)
                ctx.version = 0
                ctx.initialized = True
                ctx.engine_epoch = self._epoch
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
        for part in ctx.partitions:
            codec = create_compressor(ctx.kwargs, part.length)
            self._ensure_compress_threads()
            self._compressors[part.key] = codec
            # a chain made after set_compression_lr must still honour it
            apply_lr_to_chain(codec, self._compression_lr)
            self.client.register_compressor(part.key, ctx.kwargs)
            dc = device_codec_for(ctx.kwargs, part.length)
            if dc is not None:
                self._device_codecs[part.key] = dc
        self._maybe_send_lr()

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

    # --- completion ------------------------------------------------------

    def _proceed(self, task: TensorTableEntry) -> None:
        """Advance a task to its next stage, or finish its partition."""
        finished = task.queue_list.pop(0)
        job: _Job = task.context
        if task.enqueued_at:
            # the finished stage's dwell, enqueue to done
            metrics().observe("stage_dwell_seconds", time.monotonic() - task.enqueued_at,
                              labels={"stage": finished.name})
        self.queues[finished].report_finish(task)
        if task.queue_list:
            self.queues[task.queue_list[0]].add_task(task)
            return
        # the partition's round trip is over: the key's next round may go
        self._push_ready.add_ready_count(task.key)
        self.queues[QueueType.PUSH].notify()
        with job.lock:
            job.pending -= 1
            done = job.pending == 0
        if done:
            self._finalize(job)

    def _fail_task(self, task: TensorTableEntry, stage: QueueType, reason: str,
                   degraded: bool = False) -> None:
        """Fail a task once: return its credit, re-arm its key's gate, and
        surface the error on the handle (DegradedError for a lost
        connection)."""
        from byteps_tpu_torch.core.state import get_state

        job: _Job = task.context
        with job.lock:
            if task.failed:
                return
            task.failed = True
            first = not job.failed
            job.failed = True
        self.queues[stage].report_finish(task)
        self._push_ready.add_ready_count(task.key)
        self.queues[QueueType.PUSH].notify()
        if first:
            status = (Status.Degraded if degraded else Status.Aborted)(
                f"{stage.name}: {reason}")
            get_state().handles.mark_done(job.handle, None, status)

    def _finalize(self, job: _Job) -> None:
        """All partitions are back: assemble, average (floating dtypes), put
        the result on the tensor's device, and complete the handle."""
        from byteps_tpu_torch.core.state import get_state

        if job.failed:
            return
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

    # --- stage bodies ----------------------------------------------------

    def _copy_d2h_once(self, task: TensorTableEntry) -> None:
        """COPYD2H (core_loops.cc:378-443): the partition's bytes, or with a
        device codec its wire payload, reach host memory."""
        job: _Job = task.context
        sl = job.flat[task.offset: task.offset + task.length]
        if not job.is_torch:
            task.cpubuff = sl
        elif job.device.type == "cpu":
            if job.device_parts is not None:
                task.compressed = self._device_codecs[task.key].compress(sl)
            else:
                task.cpubuff = _np_view(sl)
        else:
            d2h = self.streams(job.device)[0]
            with torch.cuda.stream(d2h):
                d2h.wait_event(job.ready)
                if job.device_parts is not None:
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
        self._proceed(task)

    def _push_once(self, task: TensorTableEntry) -> None:
        """ZPush in priority order (core_loops.cc:538-582)."""
        job: _Job = task.context
        if task.compressed is not None:
            payload, rtype = task.compressed, RequestType.COMPRESSED_PUSH_PULL
        else:
            payload, rtype = task.cpubuff.data.cast("B"), RequestType.DEFAULT_PUSH_PULL
        counters().bump("wire_tx_bytes", memoryview(payload).nbytes)
        self.client.push(
            task.key, payload, job.dtype_id, task.version,
            cb=lambda: self._proceed(task),
            on_error=lambda reason: self._fail_task(task, QueueType.PUSH, reason,
                                                    degraded=True),
            request_type=rtype,
        )

    def _pull_once(self, task: TensorTableEntry) -> None:
        """ZPull (core_loops.cc:584-618): a raw pull lands in the result
        buffer with no copy; a compressed one goes on to DECOMPRESS."""
        job: _Job = task.context
        compressed = task.queue_list[1] == QueueType.DECOMPRESS
        sink = None
        if not compressed:
            itemsize = job.result.itemsize
            sink = memoryview(job.result).cast("B")[
                task.offset * itemsize: (task.offset + task.length) * itemsize]

        def on_pull(payload) -> None:
            from byteps_tpu_torch.comm.ps_client import ZERO_COPIED

            if payload is ZERO_COPIED:
                counters().bump("wire_rx_bytes", len(sink))
            else:
                counters().bump("wire_rx_bytes", len(payload))
                if compressed:
                    task.compressed = payload
                else:
                    arr = np.frombuffer(payload, dtype=job.result.dtype)
                    job.result[task.offset: task.offset + task.length] = arr[: task.length]
            self._proceed(task)

        self.client.pull(
            task.key, task.version, on_pull,
            on_error=lambda reason: self._fail_task(task, QueueType.PULL, reason,
                                                    degraded=True),
            dtype_id=job.dtype_id,
            request_type=(RequestType.COMPRESSED_PUSH_PULL if compressed
                          else RequestType.DEFAULT_PUSH_PULL),
            sink=sink,
        )

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
        happens once per tensor in ``_finalize``; the stage keeps the
        reference's pipeline shape."""
        self._proceed(task)

