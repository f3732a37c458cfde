"""Key-count rendezvous table (ready_table.cc:24-44).  The engine uses it
as the per-key round gate: ``counts[key]`` is the highest round allowed to
leave the PUSH queue, so a later round of a key never overtakes an earlier
one.  The FUSE queue shares the table: a small partition passes the same
gate where it leaves for the fusion buffer."""

from __future__ import annotations

import threading
from typing import Dict


class ReadyTable:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}

    def get_count(self, key: int) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def add_ready_count(self, key: int, n: int = 1) -> int:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n
            return self._counts[key]

    def set_ready_count(self, key: int, n: int) -> None:
        with self._lock:
            self._counts[key] = n
