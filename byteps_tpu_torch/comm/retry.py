"""The backoff schedule of the self-healing data plane, as
``byteps_tpu.comm.retry`` has it.

One policy serves every layer that tries network work again: the PS
client's per-RPC retries (a deadline expired, a frame was dropped, the
connection was torn down) and the in-place heal's recovery RPCs.

Exponential backoff with full jitter: the delay before attempt ``k`` is
uniform in ``[0.1, 1] * min(cap, base * 2**k)`` (never 0, so a dead
connection's retry loop cannot spin).
"""

from __future__ import annotations

import random
from typing import Optional


class Backoff:
    """Exponential backoff with full jitter.  ``rng`` is injectable so that
    a test can pin the schedule; the default is a private
    ``random.Random()``, never the global one (training code may have
    seeded it for its data order)."""

    def __init__(self, base: float = 0.1, cap: float = 2.0,
                 rng: Optional[random.Random] = None) -> None:
        self.base = max(1e-4, base)
        self.cap = cap
        self._rng = rng or random.Random()
        self.attempt = 0

    def next_delay(self) -> float:
        """The delay to sleep before the next attempt (advances the
        schedule), observed as ``retry_backoff_seconds``."""
        from byteps_tpu_torch.core.telemetry import metrics

        ceiling = min(self.cap, self.base * (2 ** self.attempt))
        self.attempt += 1
        delay = ceiling * (0.1 + 0.9 * self._rng.random())
        metrics().observe("retry_backoff_seconds", delay)
        return delay

    def reset(self) -> None:
        self.attempt = 0
