"""Priority-scheduled stage queue (``BytePSScheduledQueue``,
scheduled_queue.cc), with weighted fair queuing across jobs:

- tasks ordered by (priority desc, key asc) (scheduled_queue.cc:82-102),
  or by arrival under ``BYTEPS_SCHEDULING=fifo``;
- optional byte credit: the bytes in flight out of the queue are bounded
  by ``BYTEPS_SCHEDULING_CREDIT``, returned by :meth:`report_finish`;
- optional version gate: a task may leave only when its round is at or
  below its key's allowance in the ready table, so a later round of a key
  never overtakes an earlier one.  A fusion pack's group task is exempt
  (``gate_exempt``): its members passed their own gates at the FUSE queue,
  and gating the group under its first member's key would stall the
  others.  The group still competes on priority (it carries its members'
  highest) and still spends credit.

Jobs (docs/async.md): a task carries the job its key is namespaced under,
and each job has a lane of its own with a virtual time, the bytes served
divided by the job's weight (``BYTEPS_JOB_PRIORITY``, :func:`set_job_weight`).
A pop serves the eligible task of the lane with the lowest virtual time, so
a weight-1 job is never starved, and task priority orders tasks only
within a job: a job's huge priorities cannot outrank another job.  A job
that goes idle and comes back joins at the floor of the live lanes'
virtual times.  ``BYTEPS_JOB_CREDIT_BYTES`` bounds each job's bytes in
flight as the global credit bounds the queue's.  With one job the order is
exactly the classic one (``byteps_tpu/core/scheduler.py``).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional

from byteps_tpu_torch.common.types import QueueType, TensorTableEntry
from byteps_tpu_torch.core.ready_table import ReadyTable

#: bytes a task is charged against the credit per element, whatever its
#: dtype (the reference's queue default)
_CREDIT_ITEMSIZE = 4

#: job -> WFQ weight.  A process is one job and registers its own weight at
#: engine start; an in-process fleet registers every job it hosts.
_job_weights: Dict[int, float] = {}
_job_weights_lock = threading.Lock()


def set_job_weight(job: int, weight: float) -> None:
    """Register a job's weighted share (``BYTEPS_JOB_PRIORITY``)."""
    with _job_weights_lock:
        _job_weights[int(job)] = max(0.001, float(weight))


def get_job_weight(job: int) -> float:
    with _job_weights_lock:
        return _job_weights.get(int(job), 1.0)


class _JobLane:
    """One job's tasks, sorted, and its WFQ account."""

    __slots__ = ("job", "tasks", "vtime", "inflight")

    def __init__(self, job: int) -> None:
        self.job = job
        self.tasks: List[TensorTableEntry] = []
        self.vtime = 0.0
        self.inflight = 0  # the job's bytes in flight, under a job credit


class ScheduledQueue:
    def __init__(
        self,
        queue_type: QueueType,
        credit_bytes: int = 0,
        ready_table: Optional[ReadyTable] = None,
        discipline: str = "priority",
        job_credits: Optional[Dict[int, int]] = None,
    ) -> None:
        if discipline not in ("priority", "fifo"):
            raise ValueError(
                f"BYTEPS_SCHEDULING={discipline!r} unknown; use priority|fifo"
            )
        self.queue_type = queue_type
        self.discipline = discipline
        self.credit_enabled = credit_bytes > 0
        self._credits = credit_bytes
        #: job -> its in-flight byte budget (a job without one is bounded by
        #: the global credit only)
        self._job_credits: Dict[int, int] = dict(job_credits or {})
        self._ready_table = ready_table
        self._cv = threading.Condition()
        #: job -> lane; insertion order breaks virtual-time ties
        self._lanes: Dict[int, _JobLane] = {}

    def add_task(self, task: TensorTableEntry) -> None:
        # the stage's dwell (stage_dwell_seconds) counts from here, so the
        # wait in the queue is part of it
        task.enqueued_at = time.monotonic()
        task.enqueued_wall = time.time()
        with self._cv:
            lane = self._lanes.get(task.job)
            if lane is None:
                lane = self._lanes[task.job] = _JobLane(task.job)
            if not lane.tasks:
                # a job that (re)activates joins at the live clock's floor,
                # in normalized units: neither a debt from its idle time
                # nor a credit that would starve the others
                active = [ln.vtime / get_job_weight(ln.job)
                          for ln in self._lanes.values() if ln.tasks]
                if active:
                    lane.vtime = max(lane.vtime, min(active) * get_job_weight(lane.job))
            if self.discipline == "fifo":
                lane.tasks.append(task)
            else:
                bisect.insort(lane.tasks, task, key=lambda t: (-t.priority, t.key))
            self._cv.notify_all()

    def _eligible(self, task: TensorTableEntry, lane: _JobLane) -> bool:
        nbytes = task.length * _CREDIT_ITEMSIZE
        if self.credit_enabled and nbytes > self._credits:
            return False
        cap = self._job_credits.get(task.job)
        if cap is not None and lane.inflight + nbytes > cap:
            return False  # the job's budget is spent; other jobs flow on
        if self._ready_table is not None and not task.gate_exempt:
            return task.version <= self._ready_table.get_count(task.key)
        return True

    def _pop_eligible(self) -> Optional[TensorTableEntry]:
        """The first eligible task of the lane with the lowest virtual time
        (a lane whose tasks are all gated does not block the next)."""
        lanes = sorted((ln for ln in self._lanes.values() if ln.tasks),
                       key=lambda ln: ln.vtime / get_job_weight(ln.job))
        for lane in lanes:
            for i, t in enumerate(lane.tasks):
                if self._eligible(t, lane):
                    lane.tasks.pop(i)
                    nbytes = t.length * _CREDIT_ITEMSIZE
                    if self.credit_enabled:
                        self._credits -= nbytes
                    if self._job_credits:
                        lane.inflight += nbytes
                    # service is bytes (at least 1, so that an empty task
                    # still advances the clock)
                    lane.vtime += max(1, nbytes)
                    return t
        return None

    def get_task(self, timeout: Optional[float] = None) -> Optional[TensorTableEntry]:
        """Pop the first eligible task of the least-served job; None on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                task = self._pop_eligible()
                if task is not None:
                    return task
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def report_finish(self, task: TensorTableEntry) -> None:
        """Return the task's credits, global and its job's
        (scheduled_queue.cc:197-203)."""
        if not self.credit_enabled and not self._job_credits:
            return
        nbytes = task.length * _CREDIT_ITEMSIZE
        with self._cv:
            if self.credit_enabled:
                self._credits += nbytes
            lane = self._lanes.get(task.job)
            if lane is not None:
                lane.inflight = max(0, lane.inflight - nbytes)
            self._cv.notify_all()

    def notify(self) -> None:
        """Wake waiters: the ready table changed."""
        with self._cv:
            self._cv.notify_all()

    def pending(self) -> int:
        """Tasks waiting in the queue."""
        with self._cv:
            return sum(len(ln.tasks) for ln in self._lanes.values())
