"""Worker-side PS client (ps-lite's KVWorker), on the wire of
``byteps_tpu.comm.ps_client``.

``connect()`` REGISTERs with the scheduler, adopts the address book (rank,
worker count, server addresses), dials every server and passes the
bring-up barrier.  Data-plane requests are asynchronous: each request
registers a callback under a fresh ``seq`` on its server's connection, and
one receive loop per server hands every reply to its callback.  A pull may
pass a ``sink``, a caller-owned buffer the reply's payload is received
into with no copy (ZPull into the caller's buffer).

Failure handling is the plain form: a connection that dies fails every
request pending on it (``on_error``), and a reply that arrives with a flag
or op the port does not serve fails its request with the reason.  The
reference's per-RPC deadlines, retries, journal replay, resync healing,
ownership chases and fused frames are not ported (ROADMAP.md Queue 1b).
"""

from __future__ import annotations

import json
import random
import struct
import sys
import threading
from typing import Callable, Dict, List, Optional

from byteps_tpu_torch.common.config import UNPORTED, Config
from byteps_tpu_torch.common.hashing import assign_server
from byteps_tpu_torch.common.types import RequestType, get_command_type
from byteps_tpu_torch.comm.rendezvous import GROUP_ALL, GROUP_WORKERS, RESIZE_SEQ
from byteps_tpu_torch.comm.transport import (
    UNPORTED_OPS,
    Message,
    Op,
    close_socket,
    connect,
    frame_checksum,
    recv_header_ex,
    recv_into,
    recv_message,
    send_message,
)

#: pull callbacks receive this instead of bytes when the reply landed in
#: the caller's sink
ZERO_COPIED = object()


class RequestFailed(ConnectionError):
    """A request whose reply could not be used: the connection died, or
    the reply needs a plane the port does not carry."""


class _ServerConn:
    """One server: its socket, send lock and the pending requests."""

    def __init__(self, host: str, port: int, label: str) -> None:
        self.sock = connect(host, port)
        self.send_lock = threading.Lock()
        self.label = label
        self.cb_lock = threading.Lock()
        #: seq -> (on_reply(Message), on_error(reason))
        self.callbacks: Dict[int, tuple] = {}
        self.sinks: Dict[int, memoryview] = {}
        self.next_seq = 0
        self.dead = False
        self.thread: Optional[threading.Thread] = None

    def alloc_seq(self, on_reply, on_error, sink=None) -> int:
        """Register a request's callbacks; -1 (after ``on_error``) when the
        connection is already dead."""
        with self.cb_lock:
            if not self.dead:
                seq = self.next_seq
                self.next_seq = (self.next_seq + 1) & 0xFFFFFFFF
                self.callbacks[seq] = (on_reply, on_error)
                if sink is not None:
                    self.sinks[seq] = sink
                return seq
        on_error(f"server {self.label} connection is down")
        return -1

    def pop(self, seq: int) -> Optional[tuple]:
        with self.cb_lock:
            self.sinks.pop(seq, None)
            return self.callbacks.pop(seq, None)

    def peek_sink(self, seq: int) -> Optional[memoryview]:
        with self.cb_lock:
            return self.sinks.get(seq)

    def mark_dead(self) -> List[tuple]:
        with self.cb_lock:
            self.dead = True
            cbs = list(self.callbacks.values())
            self.callbacks.clear()
            self.sinks.clear()
            return cbs

    def send(self, msg: Message) -> None:
        send_message(self.sock, msg, self.send_lock)


class PSClient:
    def __init__(self, cfg: Config, node_uid: Optional[str] = None) -> None:
        import uuid

        self.cfg = cfg
        self.node_uid = node_uid or uuid.uuid4().hex
        self.rank: Optional[int] = None
        self.num_workers = cfg.num_worker
        self.num_servers = cfg.num_server
        self._sched = None
        self._sched_lock = threading.Lock()
        self._sched_cbs: Dict[int, tuple] = {}
        self._sched_cb_lock = threading.Lock()
        self._sched_seq = 0
        self._sched_dead = False
        self._servers: List[_ServerConn] = []
        self._stop = threading.Event()
        # init-idempotency tokens (INIT ``version``): a per-key sequence
        # under a per-client random salt, as the reference mints them
        self._init_seq_lock = threading.Lock()
        self._init_seqs: Dict[int, int] = {}
        self._init_salt = random.SystemRandom().getrandbits(16)

    # --- rendezvous ------------------------------------------------------

    def connect(self) -> None:
        """Register with the scheduler, dial every server, and pass the
        bring-up barrier (GetOrInitPS, global.cc:283-297)."""
        self._sched = connect(self.cfg.ps_root_uri, self.cfg.ps_root_port)
        send_message(self._sched, Message(Op.REGISTER, payload=json.dumps({
            "role": "worker", "host": "", "port": 0, "uid": self.node_uid,
            "num_workers": self.cfg.num_worker,
            "num_servers": self.cfg.num_server,
            "job": self.cfg.job_id, "job_priority": 1, "job_quota_mbps": 0.0,
        }).encode()))
        resp = recv_message(self._sched)
        if resp.status != 0:
            err = json.loads(resp.payload.decode()).get("error", "register refused")
            raise RuntimeError(f"scheduler refused registration: {err}")
        book = json.loads(resp.payload.decode())
        if book.get("is_recovery"):
            raise NotImplementedError(
                f"the scheduler answered with a recovery book: rejoin is not "
                f"ported yet, {UNPORTED['elastic']}"
            )
        self.rank = book["rank"]
        self.num_workers = self._book_num_workers(book)
        self.num_servers = book["num_servers"]
        for i, (host, port) in enumerate(book["servers"]):
            self._servers.append(self._new_conn(host, port, str(i)))
        threading.Thread(target=self._sched_recv_loop, name="bps-sched-recv",
                         daemon=True).start()
        self.barrier(GROUP_ALL)

    def _book_num_workers(self, book: dict) -> int:
        """The worker count this worker averages over: its job's workers
        when the book carries a job map, else the fleet's."""
        mine = (book.get("jobs") or {}).get(str(self.cfg.job_id))
        if mine and mine.get("workers"):
            return len(mine["workers"])
        return book["num_workers"]

    def close(self) -> None:
        self._stop.set()
        for sc in self._servers:
            close_socket(sc.sock)
        for sc in self._servers:
            if sc.thread is not None:
                sc.thread.join(timeout=5.0)
        close_socket(self._sched)
        self._servers = []

    def _sched_recv_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_message(self._sched)
                except (ConnectionError, OSError, ValueError):
                    return
                if msg.op == Op.ADDRBOOK and msg.seq == RESIZE_SEQ:
                    # a resize or eviction elsewhere in the cluster: this
                    # worker cannot follow it, so it says so
                    print(f"byteps_tpu_torch: the scheduler changed the cluster "
                          f"(resize book): not followed, {UNPORTED['elastic']}",
                          file=sys.stderr, flush=True)
                    continue
                with self._sched_cb_lock:
                    entry = self._sched_cbs.pop(msg.seq, None)
                if entry is not None:
                    entry[1].append(msg)
                    entry[0].set()
        finally:
            with self._sched_cb_lock:
                self._sched_dead = True
                pending = list(self._sched_cbs.values())
                self._sched_cbs.clear()
            for ev, _ in pending:
                ev.set()

    def barrier(self, group: int = GROUP_WORKERS) -> None:
        """Scheduler barrier over ``group`` (Postoffice::Barrier)."""
        with self._sched_cb_lock:
            if self._sched_dead:
                raise ConnectionError("scheduler connection lost")
            seq = self._sched_seq
            self._sched_seq += 1
            ev, box = threading.Event(), []
            self._sched_cbs[seq] = (ev, box)
        send_message(self._sched, Message(Op.BARRIER, flags=group, seq=seq),
                     self._sched_lock)
        ev.wait()
        if not box:
            raise ConnectionError("scheduler connection lost")

    # --- connections -----------------------------------------------------

    def _new_conn(self, host: str, port: int, label: str) -> _ServerConn:
        sc = _ServerConn(host, port, label)
        sc.thread = threading.Thread(target=self._recv_loop, args=(sc,),
                                     name=f"bps-recv-{label}", daemon=True)
        sc.thread.start()
        return sc

    def _recv_loop(self, sc: _ServerConn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    (op, status, flags, seq, key, cmd, version, length,
                     trace, crc, lossless) = recv_header_ex(sc.sock)
                    sink = sc.peek_sink(seq)
                    zero_copied = (not lossless and sink is not None
                                   and length == len(sink))
                    if zero_copied:
                        recv_into(sc.sock, sink)
                        payload = ZERO_COPIED
                    else:
                        payload = bytearray(length)
                        if length:
                            recv_into(sc.sock, memoryview(payload))
                except (ConnectionError, OSError, ValueError):
                    return
                entry = sc.pop(seq)
                if entry is None:
                    continue
                on_reply, on_error = entry
                if crc is not None and frame_checksum(
                    trace, sink if zero_copied else payload
                ) != crc:
                    on_error(f"{op.name} reply from server {sc.label} failed its "
                             "CRC32C: the reference would retry, the port has "
                             f"no retries ({UNPORTED['resync']})")
                elif lossless:
                    on_error(f"{op.name} reply carries a lossless container: "
                             f"not ported yet, {UNPORTED['lossless']}")
                elif op in UNPORTED_OPS:
                    on_error(f"server {sc.label} answered with {op.name}: "
                             f"not ported yet, {UNPORTED[UNPORTED_OPS[op]]}")
                else:
                    on_reply(Message(op, key=key, payload=payload, seq=seq,
                                     cmd=cmd, version=version, status=status,
                                     flags=flags))
        finally:
            close_socket(sc.sock)
            for _, on_error in sc.mark_dead():
                on_error(f"server {sc.label} connection lost")

    def server_for(self, key: int) -> int:
        """The key's owning server rank (the hash over the server count)."""
        return assign_server(
            key, self.num_servers, fn=self.cfg.key_hash_fn,
            coef=self.cfg.built_in_hash_coef,
            mixed_mode=self.cfg.enable_mixed_mode,
            mixed_bound=self.cfg.mixed_mode_bound,
            num_workers=self.num_workers,
        )

    def _worker_flag(self) -> int:
        """rank + 1 in the header's flags byte: the server dedupes a
        replayed push on (worker, key, version); 0 = anonymous."""
        r = self.rank
        return r + 1 if r is not None and 0 <= r < 255 else 0

    def _init_token(self, key: int) -> int:
        with self._init_seq_lock:
            seq = self._init_seqs.get(key, 0) + 1
            self._init_seqs[key] = seq
        return (self._init_salt << 16) | (seq & 0xFFFF)

    # --- requests --------------------------------------------------------

    def _request(self, key: int, make_msg: Callable[[int], Message],
                 on_reply, on_error, sink=None) -> None:
        sc = self._servers[self.server_for(key)]
        seq = sc.alloc_seq(on_reply, on_error, sink=sink)
        if seq < 0:
            return
        try:
            sc.send(make_msg(seq))
        except OSError as e:
            if sc.pop(seq) is not None:
                on_error(f"server {sc.label} send failed: {e!r}")

    def _blocking_request(self, key: int, make_msg, what: str) -> Message:
        """Send and wait for the reply, or for the connection to die (the
        reference's per-RPC deadlines are not ported)."""
        done = threading.Event()
        box: list = []

        def on_error(reason: str) -> None:
            box.append(RequestFailed(f"{what}: {reason}"))
            done.set()

        self._request(key, make_msg, lambda m: (box.append(m), done.set()), on_error)
        done.wait()
        if isinstance(box[0], Exception):
            raise box[0]
        return box[0]

    def init_tensor(self, key: int, num_elements: int, dtype_id: int) -> None:
        """Blocking init push: the server allocates the key, and the reply
        is the cross-worker barrier for it (operations.cc:283-414).
        Payload: u64 elements + u32 dtype, network order."""
        token = self._init_token(key)
        payload = struct.pack("!QI", num_elements, dtype_id)
        resp = self._blocking_request(
            key,
            lambda seq: Message(Op.INIT, key=key, seq=seq, flags=self._worker_flag(),
                                version=token, payload=payload),
            f"init of key {key}",
        )
        if resp.status != 0:
            raise RuntimeError(
                f"server refused init for key {key} (status {resp.status})"
            )

    def register_compressor(self, key: int, kwargs: Dict[str, str]) -> None:
        """Ship the codec config to the key's server: newline-separated
        ``key=value`` text (operations.cc:396-408)."""
        payload = "\n".join(f"{k}={v}" for k, v in sorted(kwargs.items())).encode()
        self._blocking_request(
            key,
            lambda seq: Message(Op.REGISTER_COMPRESSOR, key=key, seq=seq,
                                payload=payload),
            f"compressor registration for key {key}",
        )

    def set_compression_lr(self, lr: float) -> None:
        """Send the learning rate to every server's error-feedback chains:
        REGISTER_COMPRESSOR with flag bit 0 and a big-endian f64 payload
        (the wire's replacement for the reference's lr.s file).
        Fire-and-forget, as the reference sends it: a server whose
        connection is down is left to the data path to report."""
        payload = struct.pack("!d", float(lr))
        for sc in self._servers:
            seq = sc.alloc_seq(lambda msg: None, lambda reason: None)
            if seq < 0:
                continue
            try:
                sc.send(Message(Op.REGISTER_COMPRESSOR, seq=seq, payload=payload, flags=1))
            except OSError:
                sc.pop(seq)

    def push(self, key: int, payload, dtype_id: int, version: int,
             cb: Callable[[], None], on_error: Callable[[str], None],
             request_type: RequestType = RequestType.DEFAULT_PUSH_PULL) -> None:
        """Asynchronous push; ``cb`` fires on the server's ack (ZPush)."""
        cmd = get_command_type(request_type, dtype_id)
        flags = self._worker_flag()
        self._request(
            key,
            lambda seq: Message(Op.PUSH, key=key, seq=seq, payload=payload,
                                cmd=cmd, version=version, flags=flags),
            lambda msg: cb(), on_error,
        )

    def pull(self, key: int, version: int, cb: Callable, on_error: Callable[[str], None],
             dtype_id: int = 0,
             request_type: RequestType = RequestType.DEFAULT_PUSH_PULL,
             sink: Optional[memoryview] = None) -> None:
        """Asynchronous pull of round ``version``; ``cb`` gets the payload,
        or :data:`ZERO_COPIED` when it landed in ``sink`` (ZPull)."""
        cmd = get_command_type(request_type, dtype_id)
        self._request(
            key,
            lambda seq: Message(Op.PULL, key=key, seq=seq, cmd=cmd, version=version),
            lambda msg: cb(msg.payload), on_error, sink=sink,
        )
