"""The chaos van: seeded fault injection on the PS data plane, with the
schedule of ``byteps_tpu.comm.chaos`` frame for frame.

``BYTEPS_VAN=chaos:<inner>`` wraps the tcp, uds or shm van (``comm/van.py``).
The server's listener wraps
the connections it accepts and publishes a ``chaos+`` address, so the
workers that dial it wrap theirs too: faults hit both directions.  Each
frame is one ``sendall``/``sendmsg`` call of ``transport.py``, so a fault
is decided per frame:

- drop: the frame never leaves; silence until a deadline fires;
- delay: the frame is held up to ``BYTEPS_CHAOS_DELAY_MS``;
- disconnect: the connection is torn down;
- truncate: a prefix of the frame is sent, then the connection is torn
  down (a crash mid-send);
- corrupt: the frame's magic byte is flipped, so the peer's framing check
  rejects it and drops the connection;
- payload corrupt: one seeded bit past the 32-byte header is flipped and
  the frame is otherwise intact; only ``BYTEPS_WIRE_CHECKSUM=1`` catches
  it.

Knobs (probabilities per frame, rolled in the order drop, disconnect,
truncate, corrupt, payload corrupt; delay rolls on its own):

    BYTEPS_CHAOS_SEED            int, default 0
    BYTEPS_CHAOS_DROP            float, default 0
    BYTEPS_CHAOS_DISCONNECT      float, default 0
    BYTEPS_CHAOS_TRUNCATE        float, default 0
    BYTEPS_CHAOS_CORRUPT         float, default 0
    BYTEPS_CHAOS_PAYLOAD_CORRUPT float, default 0
    BYTEPS_CHAOS_DELAY           float, default 0
    BYTEPS_CHAOS_DELAY_MS        float, default 20 (uniform 0..max)

Targeting, for a one-sided fault:

    BYTEPS_CHAOS_OPS          op codes or ``transport.Op`` names, comma
                              separated: only frames of these ops are
                              faulted (empty: all ops)
    BYTEPS_CHAOS_TARGET_PORT  fault only the connections dialed to, or
                              accepted at, this TCP port (0: all)
    BYTEPS_CHAOS_FAULT_BUDGET faults injected in the process in all,
                              after which frames pass untouched (-1:
                              unlimited)

A connection's schedule is ``random.Random((seed << 20) ^ index)``, the
index a process-wide count of chaos connections, so a fixed seed and a
fixed order of connects replay the same faults; frames that are not
targeted use no roll.  Every injected fault bumps a ``chaos_*`` counter
and, with a process tracer on, is an instant on the ``chaos`` track that
carries the faulted frame's trace and span ids and ``injected: true``
(:func:`_tag_span`), so that a rehearsed fault reads apart from an
organic one on the merged timeline.

The scheduler's link: with ``BYTEPS_CHAOS_SCHED=1`` under a chaos van,
the control plane is faulted too.  A node's dial of the scheduler is
wrapped (:func:`wrap_control`) and so are the connections the scheduler
accepts, so ``BYTEPS_CHAOS_TARGET_PORT=<scheduler port>`` and the op names
``REGISTER``, ``PING``, ``ADDRBOOK`` and ``BARRIER`` in
``BYTEPS_CHAOS_OPS`` fault the scheduler link alone.  Control connections
draw their index from a stream of their own (from 2^16), so turning the
flag on shifts no data-plane schedule.
"""

from __future__ import annotations

import itertools
import os
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass

#: the address prefix a chaos listener publishes
CHAOS_PREFIX = "chaos+"

#: process-wide connection index: (seed, index) keys a socket's schedule
_conn_counter = itertools.count()
_conn_counter_lock = threading.Lock()
#: the control plane's own index stream, disjoint from the data plane's
_CTRL_ORIGIN = 1 << 16
_ctrl_conn_counter = itertools.count(_CTRL_ORIGIN)


def _next_conn_index() -> int:
    with _conn_counter_lock:
        return next(_conn_counter)


def _next_ctrl_conn_index() -> int:
    with _conn_counter_lock:
        return next(_ctrl_conn_counter)


def reset_conn_indices() -> None:
    """Start both connection index streams again at their origins.  A
    seeded schedule depends on how many chaos connections the process
    opened before, so a test that needs a fixed schedule calls this first;
    a live job never does."""
    global _conn_counter, _ctrl_conn_counter
    with _conn_counter_lock:
        _conn_counter = itertools.count()
        _ctrl_conn_counter = itertools.count(_CTRL_ORIGIN)


def control_chaos_enabled() -> bool:
    """A chaos van is selected and ``BYTEPS_CHAOS_SCHED`` is on."""
    from byteps_tpu_torch.common.config import truthy

    return (os.environ.get("BYTEPS_VAN", "").startswith("chaos:")
            and truthy(os.environ.get("BYTEPS_CHAOS_SCHED", "0") or "0"))


def wrap_control(sock, peer_port: int):
    """A node's socket to the scheduler, in the fault layer when
    :func:`control_chaos_enabled`, else as it is."""
    if not control_chaos_enabled():
        return sock
    return ChaosSocket(sock, ChaosParams.from_env(), _next_ctrl_conn_index(),
                       peer_port=peer_port)


def _parse_op(tok: str) -> int:
    """One ``BYTEPS_CHAOS_OPS`` token: an op code ("11") or an Op name
    ("push", any case)."""
    tok = tok.strip()
    try:
        return int(tok)
    except ValueError:
        from byteps_tpu_torch.comm.transport import Op

        try:
            return int(Op[tok.upper()])
        except KeyError:
            raise ValueError(f"BYTEPS_CHAOS_OPS token {tok!r} is neither an op code "
                             "nor a transport.Op name") from None


@dataclass(frozen=True)
class ChaosParams:
    seed: int = 0
    drop: float = 0.0
    disconnect: float = 0.0
    truncate: float = 0.0
    corrupt: float = 0.0
    payload_corrupt: float = 0.0
    delay: float = 0.0
    delay_ms: float = 20.0
    #: fault only frames of these ops (empty: all)
    ops: frozenset = frozenset()
    #: fault only connections to or from this TCP port (0: all)
    target_port: int = 0

    @staticmethod
    def from_env() -> "ChaosParams":
        from byteps_tpu_torch.common.config import _env_float

        ops = frozenset(_parse_op(tok) for tok in
                        os.environ.get("BYTEPS_CHAOS_OPS", "").split(",") if tok.strip())
        return ChaosParams(
            seed=int(os.environ.get("BYTEPS_CHAOS_SEED", "0") or 0),
            drop=_env_float("BYTEPS_CHAOS_DROP", 0.0),
            disconnect=_env_float("BYTEPS_CHAOS_DISCONNECT", 0.0),
            truncate=_env_float("BYTEPS_CHAOS_TRUNCATE", 0.0),
            corrupt=_env_float("BYTEPS_CHAOS_CORRUPT", 0.0),
            payload_corrupt=_env_float("BYTEPS_CHAOS_PAYLOAD_CORRUPT", 0.0),
            delay=_env_float("BYTEPS_CHAOS_DELAY", 0.0),
            delay_ms=_env_float("BYTEPS_CHAOS_DELAY_MS", 20.0),
            ops=ops,
            target_port=int(os.environ.get("BYTEPS_CHAOS_TARGET_PORT", "0") or 0),
        )


# the process's fault budget (BYTEPS_CHAOS_FAULT_BUDGET), read at first use
_budget_lock = threading.Lock()
_budget_left: list = [None]  # [None]: not read yet; [-1]: unlimited


def reset_fault_budget(n=None) -> None:
    """Set the fault budget to ``n`` faults, or with None read
    ``BYTEPS_CHAOS_FAULT_BUDGET`` again at the next fault."""
    with _budget_lock:
        _budget_left[0] = None if n is None else int(n)


def _budget_allows() -> bool:
    """Take one fault from the budget; False when it is spent (the frame
    then passes untouched)."""
    with _budget_lock:
        left = _budget_left[0]
        if left is None:
            left = int(os.environ.get("BYTEPS_CHAOS_FAULT_BUDGET", "-1") or -1)
        if left < 0:
            _budget_left[0] = left
            return True
        if left == 0:
            _budget_left[0] = 0
            return False
        _budget_left[0] = left - 1
        return True



def _tag_span(name: str, frame: bytes) -> None:
    """An injected fault as an instant on the process tracer, on the span
    of the frame it hit (the frame's trace block, when it has one)."""
    from byteps_tpu_torch.core.tracing import get_process_tracer

    tracer = get_process_tracer()
    if tracer is None or not tracer.enabled:
        return
    args = {"fault": name, "injected": True}
    if len(frame) >= 48 and frame[2] & 0x80:  # the status byte's TRACE_FLAG
        trace_id, span_id = struct.unpack_from("!QQ", frame, 32)
        args["trace"] = format(trace_id, "x")
        args["span"] = format(span_id, "x")
    tracer.record_instant("chaos", name, args)

class ChaosSocket:
    """A socket proxy that injects send-side faults a frame at a time.
    ``sendmsg`` joins header and payload so that a fault takes a whole
    frame; receives and teardown pass straight through."""

    def __init__(self, sock, params: ChaosParams, conn_index: int,
                 peer_port: int = 0) -> None:
        self._sock = sock
        self._p = params
        self._rng = random.Random((params.seed << 20) ^ conn_index)
        self._send_lock = threading.Lock()
        self._targeted = not params.target_port or peer_port == params.target_port

    @staticmethod
    def _bump(name: str, frame: bytes = b"") -> None:
        from byteps_tpu_torch.core.telemetry import counters

        counters().bump(name)
        _tag_span(name, frame)

    def _die(self, reason: str) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise ConnectionError(f"chaos: injected {reason}")

    def _send_frame(self, data: bytes) -> None:
        p = self._p
        with self._send_lock:
            # an untargeted connection or op passes without a roll, so the
            # targeted schedule does not depend on other traffic
            if not self._targeted or (p.ops and (len(data) < 2 or data[1] not in p.ops)):
                self._sock.sendall(data)
                return
            roll = self._rng.random()
            if roll < p.drop:
                if not _budget_allows():
                    self._sock.sendall(data)
                    return
                self._bump("chaos_drop", data)
                return
            roll -= p.drop
            if roll < p.disconnect:
                if not _budget_allows():
                    self._sock.sendall(data)
                    return
                self._bump("chaos_disconnect", data)
                self._die("disconnect")
            roll -= p.disconnect
            if roll < p.truncate:
                if not _budget_allows():
                    self._sock.sendall(data)
                    return
                self._bump("chaos_truncate", data)
                k = self._rng.randrange(0, max(1, len(data)))
                try:
                    self._sock.sendall(data[:k])
                except OSError:
                    pass
                self._die("truncated frame")
            roll -= p.truncate
            if roll < p.corrupt:
                if not _budget_allows():
                    self._sock.sendall(data)
                    return
                self._bump("chaos_corrupt", data)
                mangled = bytearray(data)
                if mangled:
                    mangled[0] ^= 0xFF  # the magic: the peer's framing rejects it
                self._sock.sendall(bytes(mangled))
                return
            roll -= p.corrupt
            if roll < p.payload_corrupt:
                # one bit past the fixed header; a header-only frame has
                # none and passes without spending budget
                if len(data) <= 32 or not _budget_allows():
                    self._sock.sendall(data)
                    return
                self._bump("chaos_payload_corrupt", data)
                mangled = bytearray(data)
                idx = self._rng.randrange(32, len(mangled))
                mangled[idx] ^= 1 << self._rng.randrange(8)
                self._sock.sendall(bytes(mangled))
                return
            if p.delay > 0 and self._rng.random() < p.delay and _budget_allows():
                self._bump("chaos_delay", data)
                time.sleep(self._rng.random() * p.delay_ms / 1e3)
            self._sock.sendall(data)

    # --- the socket surface transport.py uses ------------------------------

    def sendall(self, data) -> None:
        self._send_frame(bytes(data))

    def sendmsg(self, bufs) -> int:
        frame = b"".join(bytes(b) for b in bufs)
        self._send_frame(frame)
        return len(frame)

    def recv(self, n: int) -> bytes:
        return self._sock.recv(n)

    def recv_into(self, buf, nbytes: int = 0) -> int:
        return self._sock.recv_into(buf, nbytes)

    @property
    def family(self):
        return getattr(self._sock, "family", None)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def setsockopt(self, *a) -> None:
        self._sock.setsockopt(*a)

    def fileno(self) -> int:
        return self._sock.fileno()

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        try:
            self._sock.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class ChaosListener:
    """Accept wrapper: accepted connections are faulted too, so replies
    (acks, pulls) can be lost.  ``port`` is the bound port, which
    ``BYTEPS_CHAOS_TARGET_PORT`` matches."""

    def __init__(self, inner, params: ChaosParams, port: int = 0) -> None:
        self._inner = inner
        self._params = params
        self._port = port

    def accept(self):
        conn, addr = self._inner.accept()
        return ChaosSocket(conn, self._params, _next_conn_index(), peer_port=self._port), addr

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        try:
            self._inner.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._inner.close()
        except OSError:
            pass


class ChaosVan:
    """The chaos layer around an inner van (tcp, uds or shm)."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.name = f"chaos:{inner.name}"
        self.params = ChaosParams.from_env()

    def listen(self, host: str):
        lsock, phost, port = self.inner.listen(host)
        return ChaosListener(lsock, self.params, port=port), CHAOS_PREFIX + phost, port

    def connect(self, host: str, port: int, timeout: float = 30.0):
        if host.startswith(CHAOS_PREFIX):
            host = host[len(CHAOS_PREFIX):]
        sock = self.inner.connect(host, port, timeout=timeout)
        return ChaosSocket(sock, self.params, _next_conn_index(), peer_port=port)
