"""Link shaping for the PS data plane (the port's copy of
``byteps_tpu/comm/shaping.py``, same knobs, same time model).

The PS design exists for the DCN regime — links with real propagation
delay and finite bandwidth (reference rationale: docs/rationale.md,
"inter-machine bandwidth is the bottleneck") — but every test in this
environment runs on loopback, where sends complete in microseconds and
any queueing discipline looks the same.  These knobs let loopback
emulate a DCN link so scheduling/overlap effects become measurable:

- ``BYTEPS_VAN_DELAY_MS``   — one-way propagation delay added per
  message (pipelined: it delays delivery, it does not occupy the wire).
- ``BYTEPS_VAN_RATE_MBYTES_S`` — link bandwidth in **megabytes per
  second**; serialization time ``bytes/rate`` occupies the virtual
  wire, so back-to-back messages queue behind each other exactly like
  a real NIC.  (``BYTEPS_VAN_RATE_MBPS`` is the deprecated original
  spelling of the same knob — it always meant MB/s despite the
  "mbps" suffix, the naming trap this rename closes; it still works,
  with a one-time warning, and the canonical name wins when both are
  set.)
- ``BYTEPS_VAN_SHAPE_BUF_KB`` — shaping buffer (default 256): once this
  many bytes are queued on the virtual wire, ``sendall`` blocks.  This
  is the kernel-socket-buffer analogue that propagates backpressure to
  the engine's PUSH stage — without it every gradient would "send"
  instantly and the scheduler's pop order could never matter.

Model per connection (one virtual wire each way):

    arrival = max(enqueue_time, wire_free) + bytes/rate + delay

The delivery thread preserves FIFO order per connection — shaping never
reorders; only the *sender's* queueing discipline (the scheduler under
test) decides order.

Shaping wraps only data-plane sockets (worker<->server); the scheduler
control plane stays unshaped.  Payload bytes are copied at ``sendall``
time: the engine's zero-copy staging buffers are reused after
``send_message`` returns, and a shaped send outlives that return by
design.  That copy is why this is a test knob, not a production path.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Optional


_warned_legacy_rate = False


def _rate_mbytes_s() -> float:
    """Link bandwidth in MB/s: canonical ``BYTEPS_VAN_RATE_MBYTES_S``,
    falling back to the deprecated ``BYTEPS_VAN_RATE_MBPS`` alias (same
    unit — it was always megaBYTES/s despite the name) with a one-time
    warning.  The canonical spelling wins when both are set."""
    v = os.environ.get("BYTEPS_VAN_RATE_MBYTES_S")
    if v not in (None, ""):
        return float(v)
    legacy = os.environ.get("BYTEPS_VAN_RATE_MBPS")
    if legacy in (None, ""):
        return 0.0
    global _warned_legacy_rate
    if not _warned_legacy_rate:
        _warned_legacy_rate = True
        from byteps_tpu_torch.common import logging as bps_logging

        bps_logging.warning(
            "BYTEPS_VAN_RATE_MBPS is deprecated (the unit is megaBYTES/s, "
            "not megabits) — use BYTEPS_VAN_RATE_MBYTES_S; honoring the "
            "old name with the same MB/s meaning",
        )
    return float(legacy)


def shaping_params() -> tuple:
    """(delay_s, rate_Bps, buf_bytes) from env; (0, 0, _) means off."""
    delay_ms = float(os.environ.get("BYTEPS_VAN_DELAY_MS", "0") or 0)
    rate_mbytes_s = _rate_mbytes_s()
    buf_kb = float(os.environ.get("BYTEPS_VAN_SHAPE_BUF_KB", "256") or 256)
    return delay_ms / 1e3, rate_mbytes_s * 1e6, max(1, int(buf_kb * 1024))


def shaping_enabled() -> bool:
    delay_s, rate_bps, _ = shaping_params()
    return delay_s > 0 or rate_bps > 0


class ShapedSocket:
    """Socket proxy whose sends traverse a virtual shaped link.

    ``sendall`` copies the data, enqueues it, and blocks only on the
    shaping buffer; a delivery thread serializes the queue onto the real
    socket at the configured rate + delay.  Receives, timeouts, and
    teardown pass straight through.  Deliberately does NOT expose
    ``sendmsg`` so transport._send falls back to plain ``sendall``.
    """

    def __init__(self, sock: socket.socket, delay_s: float, rate_bps: float,
                 buf_bytes: int) -> None:
        self._sock = sock
        self._delay = delay_s
        self._rate = rate_bps
        self._buf_limit = buf_bytes
        self._queue: deque = deque()        # (data, deliver_at)
        self._inflight: deque = deque()     # (nbytes, serialized_at)
        self._queued_bytes = 0
        self._wire_free = 0.0               # virtual wire clock (lock-guarded)
        self._lock = threading.Lock()
        self._can_send = threading.Condition(self._lock)
        self._can_deliver = threading.Condition(self._lock)
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._delivery_loop, name="van-shaper", daemon=True
        )
        self._thread.start()

    # --- sender side ------------------------------------------------------
    def _reap_serialized(self, now: float) -> Optional[float]:
        """Release buffer bytes whose virtual serialization time has
        passed (they are "on the wire"); returns the next release time.
        Caller holds the lock.  Propagation delay deliberately does NOT
        hold buffer space — otherwise sustained throughput would cap at
        buf_bytes/delay instead of the configured rate."""
        while self._inflight and self._inflight[0][1] <= now:
            nbytes, _ = self._inflight.popleft()
            self._queued_bytes -= nbytes
        return self._inflight[0][1] if self._inflight else None

    def sendall(self, data) -> None:
        data = bytes(data)  # staging buffers are reused after return
        with self._lock:
            while True:
                if self._error is not None:
                    raise ConnectionError(f"shaped link dead: {self._error!r}")
                if self._closed:
                    raise ConnectionError("shaped link closed")
                now = time.monotonic()
                next_release = self._reap_serialized(now)
                if (self._queued_bytes + len(data) <= self._buf_limit
                        or self._queued_bytes == 0):
                    break
                timeout = 1.0
                if next_release is not None:
                    timeout = min(timeout, max(next_release - now, 0.0) + 1e-4)
                self._can_send.wait(timeout=timeout)
            # virtual wire times are fixed at ENQUEUE: the delivery
            # thread's position (which includes propagation sleeps) must
            # never slow the serialization clock
            start = max(now, self._wire_free)
            tx = (len(data) / self._rate) if self._rate > 0 else 0.0
            self._wire_free = start + tx
            self._queue.append((data, self._wire_free + self._delay))
            self._inflight.append((len(data), self._wire_free))
            self._queued_bytes += len(data)
            self._can_deliver.notify()

    def _delivery_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._can_deliver.wait(timeout=1.0)
                if self._closed and not self._queue:
                    return
                data, deliver_at = self._queue.popleft()
            # absolute deadline: back-to-back messages' propagation
            # delays overlap (pipelined, not cumulative)
            wait = deliver_at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            try:
                self._sock.sendall(data)
            except BaseException as e:  # noqa: BLE001 — surface to senders
                with self._lock:
                    self._error = e
                    self._queue.clear()
                    self._inflight.clear()
                    self._queued_bytes = 0
                    self._can_send.notify_all()
                return

    # --- passthrough ------------------------------------------------------
    @property
    def family(self):
        return self._sock.family

    def recv(self, n: int) -> bytes:
        return self._sock.recv(n)

    def recv_into(self, buf, nbytes: int = 0) -> int:
        return self._sock.recv_into(buf, nbytes)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def setsockopt(self, *a) -> None:
        self._sock.setsockopt(*a)

    def fileno(self) -> int:
        return self._sock.fileno()

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        # teardown path: queued-but-undelivered data is dropped, exactly
        # like un-flushed kernel buffers on a hard shutdown
        with self._lock:
            self._closed = True
            self._queue.clear()
            self._inflight.clear()
            self._queued_bytes = 0
            self._can_deliver.notify_all()
            self._can_send.notify_all()
        try:
            self._sock.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._queue.clear()
            self._inflight.clear()
            self._queued_bytes = 0
            self._can_deliver.notify_all()
            self._can_send.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


_warned_native = set()


def warn_native_bypass_once(context: str) -> None:
    """One warning per process per context when a native (C++) data
    plane is disabled/bypassed because shaping is on — the C++ lanes
    would silently skip the shaper and report an unshaped link as
    shaped."""
    if context in _warned_native:
        return
    _warned_native.add(context)
    from byteps_tpu_torch.common import logging as bps_logging

    bps_logging.warning(
        "BYTEPS_VAN_DELAY_MS/RATE_MBYTES_S set: %s (shaping needs the "
        "Python data plane)", context,
    )


def maybe_shape(sock):
    """Wrap a data-plane socket in the shaped link if env enables it.

    Applied on BOTH ends of a connection (worker connect + server
    accept), giving each direction its own independent virtual wire —
    a full-duplex link, like the real thing.
    """
    delay_s, rate_bps, buf_bytes = shaping_params()
    if delay_s <= 0 and rate_bps <= 0:
        return sock
    if not isinstance(sock, socket.socket):
        return sock  # shm van rings: shaping targets the fd-stream vans
    return ShapedSocket(sock, delay_s, rate_bps, buf_bytes)
