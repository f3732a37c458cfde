"""Shared-memory SPSC byte ring, the data plane of the ``shm`` van: the
port's copy of ``byteps_tpu.comm.shm_ring``, whose file layout it keeps
byte for byte, so that a port worker and a reference server (or the other
way round, or either with the C++ engine, ps_server.cc) share one ring.

For same-host worker<->server traffic one mmap'd ring per direction
carries the payload: the producer copies payload bytes straight into
shared memory and the consumer copies them out, with no kernel socket
buffers and no syscalls on the bulk path (the reference's zero-copy
ZPush/ZPull and BytePS_ShM staging, core_loops.cc:538-618,
shared_memory.cc:28-50).

Layout of the mapped file (created in ``/dev/shm`` so the pages are
tmpfs-backed, mirroring the reference's ``shm_open``):

    u64 head    @ 0   total bytes ever written (producer-owned)
    u64 tail    @ 8   total bytes ever read (consumer-owned)
    u8  closed  @ 16  either side sets 1 to tear down
    u8  rd_park @ 17  consumer is parked waiting for data (doorbell me)
    u8  wr_park @ 18  producer is parked waiting for space (doorbell me)
    pad to 64B        (cache-line separation of the counters)
    data        @ 64  capacity = file size − 64

Single producer, single consumer (the van serializes senders with the
connection lock).  Counters are monotonically increasing 8-byte aligned
stores: on x86-64's TSO memory model the data-then-head publication
order is preserved without fences, which is the same contract the
reference's lock-free queues rely on.

Stall handoff is doorbell-driven (virtio-style suppressed
notifications): a side that finds the ring empty/full spins briefly,
then sets its park flag and sleeps in select() on the van's CONTROL
socket; the peer, after publishing a counter, checks the flag and —
only when someone is parked — writes one doorbell byte to the control
socket, waking the sleeper instantly.  The bulk path stays
syscall-free; the park timeout (``_PARK_S``) is the backstop for two
lossy cases, each costing one park tick, never a hang: (a) the TSO
store→load race where both sides miss each other (producer:
publish-then-read-flag; parker: set-flag-then-recheck — x86 allows
both to see stale values), and (b) doorbell steal — both directions
share one control socket, so when a process has a reader AND a writer
parked at once, whichever drains the socket first can swallow the
other's wakeup byte.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import time
import uuid

_HDR = 64
#: park backstop: lost-doorbell worst case latency; 20Hz idle wake rate
_PARK_S = 0.05
#: brief pre-park spin: cheap for back-to-back traffic, avoids flag churn
_SPINS = 10


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def create_ring_file(size: int, tag: str = "") -> str:
    """Allocate a ring backing file; returns its path (the wire name)."""
    path = os.path.join(
        _shm_dir(), f"byteps_ring_{tag}{os.getpid()}_{uuid.uuid4().hex[:8]}"
    )
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, _HDR + size)
    finally:
        os.close(fd)
    return path


class ShmRing:
    """One direction of a connection.  ``role`` is "producer" or
    "consumer"; both attach to the same file."""

    def __init__(self, path: str, role: str, unlink: bool = False) -> None:
        assert role in ("producer", "consumer")
        self.path = path
        self.role = role
        self._unlink = unlink
        fd = os.open(path, os.O_RDWR)
        try:
            total = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self.capacity = total - _HDR
        self._view = memoryview(self._mm)
        # Counter access MUST be a single 8-byte load/store: CPython's
        # struct pack_into with a standard ('<Q') format writes the value
        # BYTE BY BYTE, so a cross-process reader (incl. the C++ engine's
        # atomic loads) can observe a torn intermediate counter, compute a
        # wildly inflated avail/free, and run the ring off its own data
        # (found as BAD MAGIC / zero-header desyncs under multi-worker
        # load).  A native-format ('Q') cast memoryview stores via one
        # 8-byte memcpy — a single aligned mov on x86-64, which the shm
        # van already requires (little-endian, TSO).
        self._ctr = self._view[:16].cast("Q")  # [0]=head, [1]=tail
        #: van-provided doorbell: one byte on the control socket to wake a
        #: parked peer; None = fall back to sleep-polling (tests)
        self.kick = None

    # -- counter accessors ------------------------------------------------
    def _head(self) -> int:
        return self._ctr[0]

    def _tail(self) -> int:
        return self._ctr[1]

    def _closed(self) -> bool:
        return self._mm[16] != 0

    def mark_closed(self) -> None:
        try:
            self._mm[16] = 1
        except ValueError:  # already unmapped
            pass

    def _peer_parked(self, flag_off: int) -> bool:
        try:
            return self._mm[flag_off] != 0
        except ValueError:
            return False

    def _set_park(self, flag_off: int, value: int) -> None:
        try:
            self._mm[flag_off] = value
        except ValueError:
            pass

    def _kick_peer(self, flag_off: int) -> None:
        """Doorbell the peer if (and only if) it declared itself parked —
        the common no-contention case stays syscall-free."""
        if self.kick is not None and self._peer_parked(flag_off):
            self.kick()

    def _stall(self, flag_off: int, parked: bool, stalls: int, wait):
        """One step of the park protocol shared by both ring directions:
        spin (yield the CPU — producer and consumer may share a core),
        then declare the park flag and recheck once, then sleep on the
        control socket.  Returns (parked, alive); alive=False means the
        wait saw the peer die."""
        if stalls <= _SPINS:
            os.sched_yield()
            return parked, True
        if not parked:
            # park: declare it, RECHECK (the peer kicks only if it saw
            # the flag), then sleep on the control socket
            self._set_park(flag_off, 1)
            return True, True
        if wait is not None:
            return parked, wait(_PARK_S)
        time.sleep(_PARK_S)
        return parked, True

    # -- producer side ----------------------------------------------------
    def write(self, data, wait=None) -> None:
        """Block until all of ``data`` is in the ring (socket sendall
        semantics).  Raises ConnectionError if the peer closed.
        ``wait(timeout) -> bool`` replaces the stall sleep when given;
        returning False means the peer died without setting the closed
        flag (e.g. SIGKILL) — the van passes a select() on its control
        socket so death wakes the wait instantly."""
        src = memoryview(data)
        if src.nbytes and src.format != "B":
            src = src.cast("B")
        off = 0
        n = src.nbytes
        stalls = 0
        parked = False
        try:
            while off < n:
                try:
                    head, tail = self._head(), self._tail()
                except ValueError:  # our own side already closed/unmapped
                    raise ConnectionError("shm ring closed") from None
                free = self.capacity - (head - tail)
                if free == 0:
                    if self._closed():
                        raise ConnectionError("shm ring peer closed")
                    stalls += 1
                    parked, alive = self._stall(18, parked, stalls, wait)
                    if not alive:
                        raise ConnectionError("shm ring peer closed")
                    continue
                if parked:
                    parked = False
                    self._set_park(18, 0)
                stalls = 0
                pos = head % self.capacity
                chunk = min(free, n - off, self.capacity - pos)
                try:
                    self._view[_HDR + pos : _HDR + pos + chunk] = src[off : off + chunk]
                    # publish AFTER the payload bytes are in place
                    self._ctr[0] = head + chunk
                except ValueError:
                    raise ConnectionError("shm ring closed") from None
                off += chunk
                self._kick_peer(17)  # wake a parked consumer
        finally:
            if parked:
                self._set_park(18, 0)
        if self._closed():
            raise ConnectionError("shm ring peer closed")

    # -- consumer side ----------------------------------------------------
    def recv_into(self, buf, nbytes: int = 0, wait=None) -> int:
        """Socket recv_into semantics: block until ≥1 byte, copy up to
        ``nbytes`` (or len(buf)), return count; 0 once closed+drained.
        ``wait`` as in :meth:`write`."""
        dst = memoryview(buf)
        if dst.nbytes and dst.format != "B":
            dst = dst.cast("B")
        want = nbytes or dst.nbytes
        stalls = 0
        dead = False
        parked = False
        try:
            while True:
                try:
                    head, tail = self._head(), self._tail()
                except ValueError:  # our own side already closed/unmapped
                    return 0
                avail = head - tail
                if avail:
                    if parked:
                        parked = False
                        self._set_park(17, 0)
                    pos = tail % self.capacity
                    chunk = min(avail, want, self.capacity - pos)
                    try:
                        dst[:chunk] = self._view[_HDR + pos : _HDR + pos + chunk]
                        self._ctr[1] = tail + chunk
                    except ValueError:
                        return 0
                    self._kick_peer(18)  # wake a producer parked on full
                    return chunk
                if dead:
                    return 0
                if self._closed():
                    dead = True  # drain once more: a final response may
                    continue     # have landed just before the peer exited
                stalls += 1
                parked, alive = self._stall(17, parked, stalls, wait)
                if not alive:
                    dead = True
        finally:
            if parked:
                self._set_park(17, 0)

    def close(self) -> None:
        self.mark_closed()
        try:
            self._ctr.release()
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass
        if self._unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass
