"""Scheduler node: registration rendezvous and the global barrier
(ps-lite's scheduler, SURVEY §2.4), on the wire of
``byteps_tpu.comm.rendezvous``.

Every worker and server REGISTERs at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``
with a JSON payload.  Once the expected population (``DMLC_NUM_WORKER`` +
``DMLC_NUM_SERVER``) is present, the scheduler sends each node an ADDRBOOK:
its rank within its role, the servers' addresses in rank order, and the
fields the reference's books carry, so workers and servers of either
package adopt it.  Persistent connections then serve BARRIER (released when
the group is full), PING and SHUTDOWN.

Control payloads are JSON, never pickle.  The elastic planes (heartbeat
eviction, rejoin after a scheduler restart, resize, the tuner) are not
ported: a registration after the books went out is refused with an error
book, as the reference refuses one it cannot place.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, List, Tuple

from byteps_tpu_torch.comm.transport import (
    Message,
    Op,
    close_socket,
    listen,
    recv_message,
    send_message,
)

GROUP_WORKERS = 1
GROUP_SERVERS = 2
GROUP_ALL = 3

#: seq of unsolicited ADDRBOOK broadcasts (elastic resize; not sent by
#: the port's scheduler, refused by its nodes)
RESIZE_SEQ = 0xFFFFFFFF


class Scheduler:
    """Run with ``DMLC_ROLE=scheduler`` (``python -m byteps_tpu_torch.server``)."""

    def __init__(self, num_workers: int, num_servers: int,
                 host: str = "0.0.0.0", port: int = 0) -> None:
        self.num_workers = num_workers
        self.num_servers = num_servers
        #: stamped into every book; nodes of the reference refuse books
        #: from an older incarnation than one they saw
        self.incarnation = time.time_ns()
        self._sock, self.port = listen(host, port)
        self._lock = threading.Lock()
        #: role -> [(rank, host, port, conn, send_lock, job)]
        self._nodes: Dict[str, List[tuple]] = {"worker": [], "server": []}
        self._addrbook_sent = False
        self._barriers: Dict[Tuple[int, int], List] = {}
        self._barrier_round = {GROUP_WORKERS: 0, GROUP_SERVERS: 0, GROUP_ALL: 0}
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []

    def start(self) -> None:
        threading.Thread(
            target=self._accept_loop, name="sched-accept", daemon=True
        ).start()

    def stop(self) -> None:
        self._stop.set()
        close_socket(self._sock)  # shutdown wakes the accept loop
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            close_socket(conn)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                msg = recv_message(conn)
                if msg.op == Op.REGISTER:
                    self._handle_register(conn, send_lock, msg)
                elif msg.op == Op.BARRIER:
                    self._handle_barrier(conn, send_lock, msg)
                elif msg.op == Op.PING:
                    # heartbeats may carry metric deltas: the cluster
                    # aggregate is not ported, so they are acked unread
                    send_message(conn, Message(Op.PING, seq=msg.seq), send_lock)
                elif msg.op == Op.QUERY:
                    send_message(conn, Message(
                        Op.QUERY, seq=msg.seq,
                        payload=json.dumps({"worker": {}, "server": {}}).encode(),
                    ), send_lock)
                elif msg.op == Op.SHUTDOWN:
                    send_message(conn, Message(Op.SHUTDOWN, seq=msg.seq), send_lock)
                    return
        except (ConnectionError, OSError, ValueError):
            return
        finally:
            close_socket(conn)
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle_register(self, conn, send_lock, msg: Message) -> None:
        info = json.loads(msg.payload.decode())
        role = info["role"]
        with self._lock:
            if self._addrbook_sent:
                err = {"error": "the cluster is full and the books went out: "
                                "rejoin and resize are not ported yet, "
                                "ROADMAP.md Queue 1b item P3"}
                send_message(conn, Message(
                    Op.ADDRBOOK, status=1, seq=msg.seq,
                    payload=json.dumps(err).encode(),
                ), send_lock)
                return
            nodes = self._nodes[role]
            nodes.append((len(nodes), info["host"], info["port"], conn,
                          send_lock, int(info.get("job", 0) or 0)))
            full = (len(self._nodes["worker"]) >= self.num_workers
                    and len(self._nodes["server"]) >= self.num_servers)
            if full:
                self._addrbook_sent = True
                for r in ("worker", "server"):
                    for node in self._nodes[r]:
                        self._send_addrbook(node, r)

    def _send_addrbook(self, node: tuple, role: str) -> None:
        rank, _, _, conn, send_lock, _ = node
        servers = self._nodes["server"]
        jobs: Dict[str, dict] = {}
        for w in self._nodes["worker"]:
            j = jobs.setdefault(str(w[5]), {"workers": [], "priority": 1,
                                             "quota_mbps": 0.0})
            j["workers"].append(w[0])
        book = {
            "role": role,
            "rank": rank,
            "num_workers": self.num_workers,
            "num_servers": self.num_servers,
            "servers": [(n[1], n[2]) for n in servers],
            "is_recovery": False,
            "epoch": 0,
            "evictions": {"worker": 0, "server": 0},
            "worker_ranks": [w[0] for w in self._nodes["worker"]],
            "server_ranks": [n[0] for n in servers],
            "map_epoch": 0,
            "sched_incarnation": self.incarnation,
            "jobs": jobs,
        }
        try:
            send_message(conn, Message(
                Op.ADDRBOOK, payload=json.dumps(book).encode(), seq=0,
            ), send_lock)
        except (ConnectionError, OSError):
            pass

    def _group_size(self, group: int) -> int:
        return {
            GROUP_WORKERS: self.num_workers,
            GROUP_SERVERS: self.num_servers,
            GROUP_ALL: self.num_workers + self.num_servers,
        }[group]

    def _handle_barrier(self, conn, send_lock, msg: Message) -> None:
        group = msg.flags or GROUP_ALL
        with self._lock:
            rnd = self._barrier_round[group]
            waiters = self._barriers.setdefault((group, rnd), [])
            waiters.append((conn, send_lock, msg.seq))
            if len(waiters) < self._group_size(group):
                return
            self._barrier_round[group] = rnd + 1
            del self._barriers[(group, rnd)]
        for wconn, wlock, wseq in waiters:
            try:
                send_message(wconn, Message(Op.BARRIER, seq=wseq, flags=group), wlock)
            except (ConnectionError, OSError):
                pass
