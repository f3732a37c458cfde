"""Transport vans of the PS plane.  The port carries the TCP van; the
uds, shm and chaos vans of ``byteps_tpu.comm.van`` are not ported, and an
address or a ``BYTEPS_VAN`` that needs one raises."""

from __future__ import annotations

import os
import socket
import time
from typing import Tuple

#: address prefixes of the unported vans (``byteps_tpu.comm.van``)
_UNPORTED_PREFIXES = ("unix://", "shm://", "chaos+")


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


def get_van(name: str = "") -> TcpVan:
    """Server-side van selection (``BYTEPS_VAN``, default tcp)."""
    name = name or os.environ.get("BYTEPS_VAN") or "tcp"
    if name != "tcp":
        from byteps_tpu_torch.common.config import unported

        raise unported("van", f"BYTEPS_VAN={name}")
    return _TCP


def van_for_address(host: str) -> TcpVan:
    """Client-side dispatch: the scheme is encoded in the address."""
    if host.startswith(_UNPORTED_PREFIXES):
        from byteps_tpu_torch.common.config import unported

        raise unported("van", f"server address {host!r}")
    return _TCP
