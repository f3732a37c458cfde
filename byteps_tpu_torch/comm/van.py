"""Transport vans of the PS plane, as ``byteps_tpu.comm.van`` has them.

A van owns listening and dialing for one scheme; the framing
(``transport.py``) is shared:

- ``tcp``: framed TCP, the default;
- ``uds``: Unix-domain stream sockets for a worker and its servers on one
  host, under ``BYTEPS_SOCKET_PATH`` (default the temp directory);
- ``shm``: the handshake and the doorbells ride a Unix socket, the
  payload bytes two mmap'd rings (``comm/shm_ring.py``), one a direction,
  of ``BYTEPS_SHM_RING_BYTES`` (default 512 KiB).  x86-64 only: the
  ring's publication order leans on TSO.

``BYTEPS_VAN=tcp|uds|shm`` selects the server's van; the address it
publishes in the scheduler's book carries the scheme (a uds address is
``("unix://<path>", 0)``, an shm one ``("shm+unix://<path>", 0)``), so a
worker dials by the address alone.  ``BYTEPS_VAN=chaos:<inner>`` wraps
any of them in the fault layer (``comm/chaos.py``) and publishes a
``chaos+`` address.  A dial retries a refused or missing endpoint for
``BYTEPS_CONNECT_RETRY_S`` (default 2 s, at most the dial's timeout).
"""

from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import time
import uuid
from typing import Tuple

from byteps_tpu_torch.comm.chaos import CHAOS_PREFIX

UNIX_PREFIX = "unix://"
SHM_PREFIX = "shm+unix://"

#: bring-up races: the peer's port or socket file is not there yet
_RETRYABLE_DIAL_ERRORS = (ConnectionRefusedError, ConnectionResetError, FileNotFoundError)


def _dial_retry_budget(timeout: float) -> float:
    raw = os.environ.get("BYTEPS_CONNECT_RETRY_S", "2")
    try:
        budget = float(raw or 0)
    except ValueError:
        budget = 2.0
    return max(0.0, min(budget, timeout))


def _dial_with_retry(dial, timeout: float):
    """``dial()``, again every 50 ms while the endpoint refuses, for the
    retry budget."""
    deadline = time.monotonic() + _dial_retry_budget(timeout)
    while True:
        try:
            return dial()
        except _RETRYABLE_DIAL_ERRORS:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def new_socket_path(kind: str) -> str:
    """A fresh socket file name, unique to the process and the call."""
    base = os.environ.get("BYTEPS_SOCKET_PATH") or tempfile.gettempdir()
    return os.path.join(base, f"byteps_{kind}_{os.getpid()}_{uuid.uuid4().hex[:8]}.sock")


def _unix_listener(path: str) -> socket.socket:
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(128)
    except BaseException:
        srv.close()
        raise
    return srv


def _unix_dial(path: str, timeout: float) -> socket.socket:
    def dial():
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect(path)
        except BaseException:
            sock.close()
            raise
        return sock

    return _dial_with_retry(dial, timeout)


def unlink_published(host: str) -> None:
    """Remove the socket file of a published uds or shm address (a
    listener's owner calls it when it stops)."""
    host = strip_chaos(host)
    for prefix in (SHM_PREFIX, UNIX_PREFIX):
        if host.startswith(prefix):
            try:
                os.unlink(host[len(prefix):])
            except OSError:
                pass
            return


class TcpVan:
    name = "tcp"

    def listen(self, host: str) -> Tuple[socket.socket, str, int]:
        """Bind to an ephemeral port; returns (socket, host, port)."""
        from byteps_tpu_torch.comm.transport import listen

        srv, port = listen(host, 0)
        return srv, host, port

    def connect(self, host: str, port: int, timeout: float = 30.0) -> socket.socket:
        sock = _dial_with_retry(lambda: socket.create_connection((host, port),
                                                                 timeout=timeout), timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock


class UdsVan:
    name = "uds"

    def listen(self, host: str) -> Tuple[socket.socket, str, int]:
        path = new_socket_path("uds")
        return _unix_listener(path), UNIX_PREFIX + path, 0

    def connect(self, host: str, port: int, timeout: float = 30.0) -> socket.socket:
        sock = _unix_dial(host[len(UNIX_PREFIX):], timeout)
        sock.settimeout(None)
        return sock


class ShmConnection:
    """A socket-shaped duplex connection whose payload path is a pair of
    shared-memory rings.  The Unix socket carries the handshake (the two
    ring file names), then the doorbell bytes; a peer that dies without
    closing its rings closes its fds, and the EOF ends a ring wait."""

    family = socket.AF_UNIX

    def __init__(self, sock: socket.socket, tx, rx, server_side: bool = False) -> None:
        self._sock = sock
        self._tx = tx
        self._rx = rx
        self._hs_lock = threading.Lock()
        if not server_side:
            sock.setblocking(False)
            tx.kick = rx.kick = self._kick
        # a server's side completes the handshake on first use, in its
        # connection's thread: in accept() a stalled client would hold up
        # every other worker's connect

    def _ensure_handshake(self) -> None:
        if self._rx is not None:
            return
        with self._hs_lock:
            if self._rx is not None:
                return
            from byteps_tpu_torch.comm.shm_ring import ShmRing
            from byteps_tpu_torch.comm.transport import _recv_exact

            try:
                self._sock.settimeout(10.0)
                names = []
                for _ in range(2):
                    (ln,) = struct.unpack("!H", _recv_exact(self._sock, 2))
                    names.append(_recv_exact(self._sock, ln).decode())
                self._sock.settimeout(None)
                # the client's c2s ring is this side's rx; attached, the
                # files are unlinked at once: the mappings live on and the
                # files cannot leak
                rx = ShmRing(names[0], "consumer")
                tx = ShmRing(names[1], "producer")
            except Exception as e:
                raise ConnectionError(f"shm handshake failed: {e!r}") from e
            for name in names:
                try:
                    os.unlink(name)
                except OSError:
                    pass
            self._sock.setblocking(False)
            tx.kick = rx.kick = self._kick
            self._tx, self._rx = tx, rx

    def _kick(self) -> None:
        """The doorbell: one byte wakes the peer parked in select()."""
        try:
            self._sock.send(b"\x01")
        except (BlockingIOError, InterruptedError, OSError):
            pass

    def _peer_gone(self) -> bool:
        """Drain the doorbell bytes; True on EOF (the peer exited)."""
        try:
            while True:
                b = self._sock.recv(4096)
                if b == b"":
                    return True
                if len(b) < 4096:
                    return False
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True

    def _wait(self, timeout: float) -> bool:
        """A ring's park: select() on the control socket, woken by the
        peer's doorbell or its death.  False when the peer is gone."""
        import select

        try:
            readable, _, _ = select.select([self._sock], [], [], timeout)
        except (OSError, ValueError):
            return False
        if readable:
            return not self._peer_gone()
        return True

    # --- the socket surface transport.py uses ------------------------------

    def sendall(self, data) -> None:
        self._ensure_handshake()
        self._tx.write(data, wait=self._wait)

    def recv_into(self, buf, nbytes: int = 0) -> int:
        self._ensure_handshake()
        return self._rx.recv_into(buf, nbytes, wait=self._wait)

    def recv(self, n: int) -> bytes:
        buf = bytearray(n)
        got = self.recv_into(buf, n)
        return bytes(buf[:got])

    def settimeout(self, t) -> None:
        """A no-op: a ring wait ends on data, a doorbell or the peer's
        death, never on a clock (the reference's connection has no
        timeout either)."""

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        if self._tx is not None:
            self._tx.mark_closed()
        if self._rx is not None:
            self._rx.mark_closed()
        try:
            self._sock.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        if self._tx is not None:
            self._tx.close()
        if self._rx is not None:
            self._rx.close()
        try:
            self._sock.close()
        except OSError:
            pass


class ShmListener:
    """Accepts at once; the ring handshake completes in the connection's
    thread (:meth:`ShmConnection._ensure_handshake`), where a failure is a
    ConnectionError that drops that connection alone."""

    def __init__(self, sock: socket.socket, path: str) -> None:
        self._sock = sock
        self._path = path

    def accept(self):
        conn, addr = self._sock.accept()
        return ShmConnection(conn, tx=None, rx=None, server_side=True), addr

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
        try:
            os.unlink(self._path)
        except OSError:
            pass


def check_shm_arch() -> None:
    """Refuse a host that is not x86-64: the ring publishes data before
    its counter without fences, which only TSO keeps in order."""
    import platform

    if platform.machine() not in ("x86_64", "AMD64", "i686"):
        raise RuntimeError(
            "BYTEPS_VAN=shm requires an x86-64 host (TSO store ordering); "
            f"got {platform.machine()!r}: use the uds van instead")


class ShmVan:
    name = "shm"

    def listen(self, host: str) -> Tuple[object, str, int]:
        check_shm_arch()
        path = new_socket_path("shm")
        return ShmListener(_unix_listener(path), path), SHM_PREFIX + path, 0

    def connect(self, host: str, port: int, timeout: float = 30.0) -> ShmConnection:
        from byteps_tpu_torch.comm.shm_ring import ShmRing, create_ring_file

        check_shm_arch()
        sock = _unix_dial(host[len(SHM_PREFIX):], timeout)
        size = int(os.environ.get("BYTEPS_SHM_RING_BYTES") or (512 << 10))
        created = []
        tx = rx = None
        try:
            c2s = create_ring_file(size, tag="c2s_")
            created.append(c2s)
            s2c = create_ring_file(size, tag="s2c_")
            created.append(s2c)
            # mapped before the names go out: the server unlinks the files
            # once attached; unlink=True covers a server that dies first
            tx = ShmRing(c2s, "producer", unlink=True)
            rx = ShmRing(s2c, "consumer", unlink=True)
            for name in (c2s, s2c):
                b = name.encode()
                sock.sendall(struct.pack("!H", len(b)) + b)
            sock.settimeout(None)
            return ShmConnection(sock, tx=tx, rx=rx)
        except Exception:
            # a half-built connection leaves no ring behind
            for ring in (tx, rx):
                if ring is not None:
                    ring.close()
            for path in created:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass
            raise


_VANS = {v.name: v for v in (TcpVan(), UdsVan(), ShmVan())}


def get_van(name: str = ""):
    """Server-side van selection (``BYTEPS_VAN``, default tcp);
    ``chaos:<inner>`` wraps the inner van in the fault layer."""
    name = name or os.environ.get("BYTEPS_VAN") or "tcp"
    if name.startswith("chaos:"):
        inner = name[len("chaos:"):]
        if not inner or inner.startswith("chaos:"):
            raise ValueError(f"BYTEPS_VAN={name!r}: chaos needs a concrete inner van "
                             "(chaos:tcp | chaos:uds | chaos:shm)")
        from byteps_tpu_torch.comm.chaos import ChaosVan

        return ChaosVan(get_van(inner))
    if name not in _VANS:
        raise ValueError(f"unknown van {name!r}; available: {sorted(_VANS)} "
                         "(or chaos:<inner>)")
    return _VANS[name]


def strip_chaos(host: str) -> str:
    """The inner address of a possibly ``chaos+`` one."""
    return host[len(CHAOS_PREFIX):] if host.startswith(CHAOS_PREFIX) else host


def van_for_address(host: str):
    """Client-side dispatch: the scheme is encoded in the address."""
    if host.startswith(CHAOS_PREFIX):
        from byteps_tpu_torch.comm.chaos import ChaosVan

        return ChaosVan(van_for_address(strip_chaos(host)))
    if host.startswith(SHM_PREFIX):
        return _VANS["shm"]
    return _VANS["uds"] if host.startswith(UNIX_PREFIX) else _VANS["tcp"]
