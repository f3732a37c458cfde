"""Priority-scheduled stage queue (``BytePSScheduledQueue``,
scheduled_queue.cc):

- tasks ordered by (priority desc, key asc) (scheduled_queue.cc:82-102),
  or by arrival under ``BYTEPS_SCHEDULING=fifo``;
- optional byte credit: the bytes in flight out of the queue are bounded
  by ``BYTEPS_SCHEDULING_CREDIT``, returned by :meth:`report_finish`;
- optional version gate: a task may leave only when its round is at or
  below its key's allowance in the ready table, so a later round of a key
  never overtakes an earlier one.

The per-tenant weighted fair queuing of ``byteps_tpu.core.scheduler`` is
not ported: one process is one job.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import List, Optional

from byteps_tpu_torch.common.types import QueueType, TensorTableEntry
from byteps_tpu_torch.core.ready_table import ReadyTable

#: bytes a task is charged against the credit per element, whatever its
#: dtype (the reference's queue default)
_CREDIT_ITEMSIZE = 4


class ScheduledQueue:
    def __init__(
        self,
        queue_type: QueueType,
        credit_bytes: int = 0,
        ready_table: Optional[ReadyTable] = None,
        discipline: str = "priority",
    ) -> None:
        if discipline not in ("priority", "fifo"):
            raise ValueError(
                f"BYTEPS_SCHEDULING={discipline!r} unknown; use priority|fifo"
            )
        self.queue_type = queue_type
        self.discipline = discipline
        self.credit_enabled = credit_bytes > 0
        self._credits = credit_bytes
        self._ready_table = ready_table
        self._cv = threading.Condition()
        self._tasks: List[TensorTableEntry] = []

    def add_task(self, task: TensorTableEntry) -> None:
        # the stage's dwell (stage_dwell_seconds) counts from here, so the
        # wait in the queue is part of it
        task.enqueued_at = time.monotonic()
        with self._cv:
            if self.discipline == "fifo":
                self._tasks.append(task)
            else:
                bisect.insort(self._tasks, task, key=lambda t: (-t.priority, t.key))
            self._cv.notify_all()

    def _eligible(self, task: TensorTableEntry) -> bool:
        if self.credit_enabled and task.length * _CREDIT_ITEMSIZE > self._credits:
            return False
        if self._ready_table is not None:
            return task.version <= self._ready_table.get_count(task.key)
        return True

    def get_task(self, timeout: Optional[float] = None) -> Optional[TensorTableEntry]:
        """Pop the first eligible task; None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                for i, t in enumerate(self._tasks):
                    if self._eligible(t):
                        self._tasks.pop(i)
                        if self.credit_enabled:
                            self._credits -= t.length * _CREDIT_ITEMSIZE
                        return t
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def report_finish(self, task: TensorTableEntry) -> None:
        """Return the task's credits (scheduled_queue.cc:197-203)."""
        if not self.credit_enabled:
            return
        with self._cv:
            self._credits += task.length * _CREDIT_ITEMSIZE
            self._cv.notify_all()

    def notify(self) -> None:
        """Wake waiters: the ready table changed."""
        with self._cv:
            self._cv.notify_all()
