"""The Chrome-trace timeline of the communication stages, and distributed
spans (``byteps_tpu.core.tracing``; docs/observability.md).

One tracer records two families of events:

- **stage envelopes** (:meth:`Tracer.record`, global.cc:448-564): a
  tensor's pipeline stage as one complete event from the push_pull's start
  to the stage's end, for the steps from ``BYTEPS_TRACE_START_STEP`` to
  ``BYTEPS_TRACE_END_STEP`` (a tensor's version), one row per tensor;
- **spans** (:meth:`Tracer.record_span`, :meth:`Tracer.record_instant`):
  every engine task has a (trace id, span id) pair, the ids ride each data
  frame's trace block (``comm/transport.py``), and the servers record
  child spans (recv, sum, publish, reply, resync) under the worker's trace
  id with the worker's span as their parent.  ``BYTEPS_TRACE_SPANS=0``
  keeps the envelopes and drops the spans.

:meth:`Tracer.flush` writes the events recorded since the last flush as
``<dir>/<local_rank>/comm.json`` in the Chrome trace-event format, or as
``comm.<n>.json`` when an earlier window is there already, and clears the
buffer: ``profiler.trace()`` captures any number of windows.
``tools/trace_merge.py`` joins the processes' files into one timeline on
the ids.  Past :attr:`Tracer.MAX_EVENTS` buffered events new ones are
dropped and counted; the flush logs the count and writes it into the file.
Timestamps are wall-clock seconds (``time.time()``), so that the spans of
the processes of one host line up.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import List, Optional

_id_rng = random.SystemRandom()


def new_trace_id() -> int:
    """A nonzero 63-bit trace or span id, from the system's generator: two
    workers that seeded Python's generator alike must not mint the same
    ids."""
    return _id_rng.getrandbits(63) | 1


def span_args(trace_id: int, span_id: int, parent_id: int = 0, **extra) -> dict:
    """A span event's args: the ids as hex strings (Perfetto's JSON reader
    takes large integers for doubles), then ``extra``."""
    args = {"trace": format(trace_id, "x"), "span": format(span_id, "x")}
    if parent_id:
        args["parent"] = format(parent_id, "x")
    args.update(extra)
    return args


class Tracer:
    #: buffered events at most between two flushes; the spans have no step
    #: window, so a long traced run drops (and counts) past it
    MAX_EVENTS = 1 << 18

    def __init__(self, enabled: bool = False, start_step: int = 10, end_step: int = 20,
                 trace_dir: str = ".", local_rank=0, process_name: str = "",
                 spans_enabled: bool = True) -> None:
        self.enabled = enabled
        self.start_step = start_step
        self.end_step = end_step
        self.trace_dir = trace_dir
        self.local_rank = local_rank
        #: False (BYTEPS_TRACE_SPANS=0): the envelopes only
        self.spans_enabled = spans_enabled
        #: the process's name on span events ("worker0", "server1"), set
        #: once the scheduler gave it a rank
        self.process_name = process_name or f"rank{local_rank}"
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._dropped = 0  # past MAX_EVENTS since the last flush

    def _active(self, step: int) -> bool:
        return self.enabled and self.start_step <= step <= self.end_step

    def _append_locked(self, event: dict) -> None:
        if len(self._events) >= self.MAX_EVENTS:
            self._dropped += 1
            return
        self._events.append(event)

    def record(self, name: str, stage: str, start: float, dur: float, step: int) -> None:
        """One complete event for (tensor, stage) (global.cc:478-530)."""
        if not self._active(step):
            return
        with self._lock:
            self._append_locked({"name": stage, "cat": "comm", "ph": "X",
                                 "ts": start * 1e6, "dur": dur * 1e6,
                                 "pid": name, "tid": stage})

    def record_span(self, track: str, name: str, start: float, dur: float,
                    args: Optional[dict] = None) -> None:
        """One complete span event on this process's ``track`` (a tensor
        name, "resync", "<fused>", ...); ``args`` from :func:`span_args`."""
        if not self.enabled or not self.spans_enabled:
            return
        with self._lock:
            self._append_locked({"name": name, "cat": "span", "ph": "X",
                                 "ts": start * 1e6, "dur": dur * 1e6,
                                 "pid": self.process_name, "tid": track,
                                 "args": args or {}})

    def record_instant(self, track: str, name: str, args: Optional[dict] = None,
                       ts: Optional[float] = None) -> None:
        """A zero-length marker (a chaos fault's tag)."""
        if not self.enabled or not self.spans_enabled:
            return
        with self._lock:
            self._append_locked({"name": name, "cat": "span", "ph": "i", "s": "t",
                                 "ts": (time.time() if ts is None else ts) * 1e6,
                                 "pid": self.process_name, "tid": track,
                                 "args": args or {}})

    def pending_events(self) -> int:
        with self._lock:
            return len(self._events)

    def flush(self) -> str:
        """Write the window recorded since the last flush and clear it; the
        file's path, or "" when off or empty.  A window never overwrites an
        earlier one: with ``comm.json`` there, it goes to ``comm.<n>.json``
        (``tools/trace_merge.py`` reads ``comm*.json``)."""
        if not self.enabled:
            return ""
        with self._lock:
            if not self._events:
                return ""
            events, self._events = self._events, []
            dropped, self._dropped = self._dropped, 0
        if dropped:
            from byteps_tpu_torch.common import logging as bpslog

            bpslog.warning("tracer dropped %d events past the %d-event buffer cap "
                           "(flush more often, or narrow the trace window)",
                           dropped, self.MAX_EVENTS)
        out_dir = os.path.join(self.trace_dir, str(self.local_rank))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "comm.json")
        n = 2
        while os.path.exists(path):
            path = os.path.join(out_dir, f"comm.{n}.json")
            n += 1
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            payload["otherData"] = {"dropped_events": dropped}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


class StageTimer:
    """A context manager that records one stage interval on a tracer."""

    def __init__(self, tracer: Tracer, name: str, stage: str, step: int) -> None:
        self.tracer = tracer
        self.name = name
        self.stage = stage
        self.step = step

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.tracer.record(self.name, self.stage, self.t0, time.time() - self.t0, self.step)
        return False


#: the process's tracer (a worker's runtime, or a server), for the layers
#: that hold no runtime state (the chaos van, the PS client's heal)
_process_tracer: Optional[Tracer] = None


def set_process_tracer(tracer: Optional[Tracer]) -> None:
    global _process_tracer
    _process_tracer = tracer


def get_process_tracer() -> Optional[Tracer]:
    return _process_tracer
