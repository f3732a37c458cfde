"""Process-wide counters of the PS path, under the names of
``byteps_tpu.core.telemetry.counters()``:

- ``d2h_bytes``: bytes that crossed device -> host in COPYD2H (for a
  device-compressed partition, its wire payload only);
- ``wire_tx_bytes`` / ``wire_rx_bytes``: payload bytes pushed to and
  pulled from the servers.
"""

from __future__ import annotations

import threading
from typing import Dict


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


_counters = Counters()


def counters() -> Counters:
    return _counters
