"""Async-handle table for push_pull_async / poll / synchronize:
monotonically increasing int handles, poll() checks completion,
synchronize() blocks and re-raises errors."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from byteps_tpu_torch.common.types import DegradedError, Status, StatusType


class HandleManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Any] = {}
        self._status: Dict[int, Status] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._events[h] = threading.Event()
            return h

    def mark_done(self, handle: int, result: Any, status: Optional[Status] = None) -> None:
        with self._lock:
            ev = self._events.get(handle)
            if ev is None:
                # late duplicate completion of an already-cleared handle:
                # storing it would leak the entry, nobody waits on it again
                return
            self._results[handle] = result
            self._status[handle] = status or Status.OK()
        ev.set()

    def poll(self, handle: int) -> bool:
        with self._lock:
            ev = self._events.get(handle)
        if ev is None:
            raise ValueError(f"unknown handle {handle}")
        return ev.is_set()

    def wait_and_clear(self, handle: int) -> Any:
        with self._lock:
            ev = self._events.get(handle)
        if ev is None:
            raise ValueError(f"unknown handle {handle}")
        ev.wait()
        with self._lock:
            result = self._results.pop(handle)
            status = self._status.pop(handle)
            del self._events[handle]
        if not status.ok():
            if status.type == StatusType.DEGRADED:
                raise DegradedError(f"push_pull failed: {status.reason}")
            raise RuntimeError(f"push_pull failed: {status.reason}")
        return result

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._results.clear()
            self._status.clear()
