"""Transport vans of the PS plane: the TCP van, and the chaos van around
it (``BYTEPS_VAN=chaos:tcp``, ``comm/chaos.py``).  The uds and shm vans of
``byteps_tpu.comm.van`` are not ported, and an address or a ``BYTEPS_VAN``
that needs one raises."""

from __future__ import annotations

import os
import socket
import time
from typing import Tuple

from byteps_tpu_torch.comm.chaos import CHAOS_PREFIX

#: address prefixes of the unported vans (``byteps_tpu.comm.van``)
_UNPORTED_PREFIXES = ("unix://", "shm://", "shm+unix://")


class TcpVan:
    name = "tcp"

    def listen(self, host: str) -> Tuple[socket.socket, str, int]:
        """Bind to an ephemeral port; returns (socket, host, port)."""
        from byteps_tpu_torch.comm.transport import listen

        srv, port = listen(host, 0)
        return srv, host, port

    def connect(self, host: str, port: int, timeout: float = 30.0) -> socket.socket:
        """Dial, retrying a refused endpoint for ``BYTEPS_CONNECT_RETRY_S``
        (default 2 s): bring-up races close well inside that."""
        budget = max(0.0, min(float(os.environ.get("BYTEPS_CONNECT_RETRY_S") or 2),
                              timeout))
        deadline = time.monotonic() + budget
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=timeout)
                break
            except (ConnectionRefusedError, ConnectionResetError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock


_TCP = TcpVan()


def get_van(name: str = ""):
    """Server-side van selection (``BYTEPS_VAN``, default tcp):
    ``chaos:tcp`` wraps the TCP van in the fault layer."""
    name = name or os.environ.get("BYTEPS_VAN") or "tcp"
    if name == "tcp":
        return _TCP
    if name == "chaos:tcp":
        from byteps_tpu_torch.comm.chaos import ChaosVan

        return ChaosVan(_TCP)
    from byteps_tpu_torch.common.config import unported

    raise unported("van", f"BYTEPS_VAN={name}")


def strip_chaos(host: str) -> str:
    """The inner address of a possibly ``chaos+`` one."""
    return host[len(CHAOS_PREFIX):] if host.startswith(CHAOS_PREFIX) else host


def van_for_address(host: str):
    """Client-side dispatch: the scheme is encoded in the address."""
    if strip_chaos(host).startswith(_UNPORTED_PREFIXES):
        from byteps_tpu_torch.common.config import unported

        raise unported("van", f"server address {host!r}")
    if host.startswith(CHAOS_PREFIX):
        from byteps_tpu_torch.comm.chaos import ChaosVan

        return ChaosVan(_TCP)
    return _TCP
