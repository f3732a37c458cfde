"""Framed TCP transport of the PS plane, byte for byte the wire of
``byteps_tpu.comm.transport``.

Header (network byte order, 32 bytes):

    u8  magic      0xB5
    u8  op         Op enum
    u8  status     0 = OK; bits 7/6/5 = trace block / checksum / lossless
    u8  flags      the worker's rank + 1 on data-plane requests
    u32 seq        request/response matching id
    u64 key        partition key
    u32 cmd        Cantor-encoded (RequestType, DataType)
    u32 version    round number (INIT: the idempotency token)
    u64 length     payload byte count

A ``TRACE_FLAG`` frame carries a 16-byte (trace_id, span_id) block after
the header.  A ``CHECKSUM_FLAG`` frame then carries a 4-byte big-endian
CRC32C of everything after the header except itself (trace block and
payload).  Stamping is per process (``BYTEPS_WIRE_CHECKSUM=1``, data-plane
ops only); any receiver verifies a stamped frame.  The CRC runs in the
port's own C helper (``ops/csrc/crc32c.c``, built at first use); the
table loop :func:`crc32c_plain` is its plain version, which the tests hold
it to.

A ``LOSSLESS_FLAG`` frame's payload is a lossless container
(``compression/lossless.py``); its ``length`` and CRC32C cover the
container, so integrity is checked before the decoder runs.  Under
``BYTEPS_WIRE_LOSSLESS=1`` RESYNC_STATE and MIGRATE_STATE bodies are sent
so when the container comes out smaller; ``Message(lossless=True)`` asks
for it on any op (the lossless arm of adaptive compression).  Every
receiver decodes a flagged frame after reading it whole, and a container
that does not decode raises ``LosslessError`` then, so the stream stays
framed.
"""

from __future__ import annotations

import ctypes
import enum
import json
import os
import socket
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from byteps_tpu_torch.compression.lossless import LosslessError  # noqa: F401 - re-exported

MAGIC = 0xB5
HEADER_FMT = "!BBBBIQIIQ"
HEADER_SIZE = struct.calcsize(HEADER_FMT)

TRACE_FLAG = 0x80
_TRACE_FMT = "!QQ"
TRACE_SIZE = struct.calcsize(_TRACE_FMT)

CHECKSUM_FLAG = 0x40
_CHECKSUM_FMT = "!I"
CHECKSUM_SIZE = struct.calcsize(_CHECKSUM_FMT)

LOSSLESS_FLAG = 0x20
#: ops whose payloads travel lossless under BYTEPS_WIRE_LOSSLESS=1:
#: RESYNC_STATE and MIGRATE_STATE (wire.h lossless_op)
_LOSSLESS_OPS = frozenset({24, 25})


class Op(enum.IntEnum):
    # scheduler plane
    REGISTER = 1
    ADDRBOOK = 2
    BARRIER = 3
    # data plane
    INIT = 10
    PUSH = 11
    PULL = 12
    REGISTER_COMPRESSOR = 13
    FUSED = 14
    # control
    PING = 20
    SHUTDOWN = 21
    QUERY = 22
    # the recovery plane
    RESYNC_QUERY = 23
    RESYNC_STATE = 24
    # the resharding plane: an old owner ships one key's state to its new
    # owner; a server answers a request for a key it no longer owns with a
    # redirect whose header version is the new map epoch
    MIGRATE_STATE = 25
    WRONG_OWNER = 26


class ChecksumError(ValueError):
    """A frame's CRC32C did not match its bytes.  Raised after the frame
    was consumed, so the stream stays framed."""

    def __init__(self, op, expected: int, got: int) -> None:
        super().__init__(
            f"wire checksum mismatch on {getattr(op, 'name', op)} frame: "
            f"expected {expected:#010x}, computed {got:#010x}"
        )
        self.op = op


class UnsupportedFrameError(ValueError):
    """A received request the port's server does not serve (an op it does
    not expect, a codec it cannot build)."""


#: ops that carry a checksum under BYTEPS_WIRE_CHECKSUM=1: the data plane
#: only, so control frames stay byte-identical
_CHECKSUM_OPS = frozenset({10, 11, 12, 13, 14, 23, 24, 25, 26})


def wire_checksum_enabled() -> bool:
    """Stamp outgoing data-plane frames with CRC32C?  Read on every call;
    verification does not depend on it."""
    return os.environ.get("BYTEPS_WIRE_CHECKSUM", "").lower() not in (
        "", "0", "false", "no", "off",
    )


def wire_lossless_enabled() -> bool:
    """Send RESYNC_STATE and MIGRATE_STATE bodies lossless
    (``BYTEPS_WIRE_LOSSLESS``, default off)?  Read on every call; decoding
    does not depend on it."""
    return os.environ.get("BYTEPS_WIRE_LOSSLESS", "").lower() not in (
        "", "0", "false", "no", "off",
    )


def checksum_conn_limit() -> int:
    """Checksum mismatches one connection may carry before its receiver
    tears it down (``BYTEPS_CHECKSUM_CONN_LIMIT``, default 8; 0 = never;
    a negative or unreadable value is the default)."""
    v = os.environ.get("BYTEPS_CHECKSUM_CONN_LIMIT", "")
    try:
        n = int(v) if v else 8
    except ValueError:
        return 8
    return n if n >= 0 else 8


_CRC32C_POLY = 0x82F63B78
_crc_table: Optional[list] = None
_crc_fn = None
_crc_lock = threading.Lock()


def crc32c_plain(data, crc: int = 0) -> int:
    """CRC32C by the table loop: the plain version of the C helper."""
    global _crc_table
    if _crc_table is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
            tbl.append(c)
        _crc_table = tbl
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = (c >> 8) ^ _crc_table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _crc_native():
    global _crc_fn
    with _crc_lock:
        if _crc_fn is None:
            from byteps_tpu_torch.ops._build import load_library

            fn = load_library("crc32c").bps_crc32c
            fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
            fn.restype = ctypes.c_uint32
            _crc_fn = fn
        return _crc_fn


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like or a contiguous ndarray), chained:
    ``crc32c(b, crc32c(a)) == crc32c(a + b)``.  Runs in the C helper; a
    helper that does not build raises."""
    n = memoryview(data).nbytes
    if not n:
        return crc
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(_crc_native()(arr.ctypes.data, n, crc))


def frame_checksum(trace: Optional[Tuple[int, int]], payload) -> int:
    """The CRC32C a frame's checksum block carries: the trace block, when
    present, chained with the payload."""
    crc = 0
    if trace is not None:
        crc = crc32c(struct.pack(_TRACE_FMT, trace[0], trace[1]))
    return crc32c(payload, crc)


class Message:
    __slots__ = (
        "op", "status", "flags", "seq", "key", "cmd", "version", "payload",
        "trace", "checksum", "lossless", "_lossless_applied",
    )

    def __init__(
        self,
        op: Op,
        key: int = 0,
        payload=b"",
        seq: int = 0,
        cmd: int = 0,
        version: int = 0,
        status: int = 0,
        flags: int = 0,
        trace: Optional[Tuple[int, int]] = None,
        checksum: Optional[bool] = None,
        lossless: Optional[bool] = None,
    ) -> None:
        self.op = op
        self.status = status
        self.flags = flags
        self.seq = seq
        self.key = key
        self.cmd = cmd
        self.version = version
        self.payload = payload
        #: (trace_id, span_id) carried in the trace block, or None
        self.trace = trace
        #: stamp the CRC32C block?  None follows BYTEPS_WIRE_CHECKSUM for
        #: data-plane ops; True/False force it
        self.checksum = checksum
        #: send the payload as a lossless container?  None follows
        #: BYTEPS_WIRE_LOSSLESS for RESYNC_STATE and MIGRATE_STATE; True
        #: tries it on any op; the flag goes out only when the container
        #: is smaller
        self.lossless = lossless
        #: None until the transform ran: it runs once, across resends
        self._lossless_applied: Optional[bool] = None

    def _stamp_checksum(self) -> bool:
        if self.checksum is None:
            return int(self.op) in _CHECKSUM_OPS and wire_checksum_enabled()
        return bool(self.checksum)

    def _stamp_lossless(self) -> bool:
        """Swap the payload for its container when asked and smaller (once;
        before the header is packed, since ``length`` and the CRC32C cover
        the bytes that ship)."""
        if self._lossless_applied is not None:
            return self._lossless_applied
        lz = self.lossless
        if lz is None:
            lz = int(self.op) in _LOSSLESS_OPS and wire_lossless_enabled()
        applied = False
        if lz:
            from byteps_tpu_torch.compression.lossless import MIN_BYTES, compress_frame

            n = memoryview(self.payload).nbytes
            if n >= MIN_BYTES:
                comp = compress_frame(self.payload)
                if len(comp) < n:
                    self.payload = comp
                    applied = True
        self._lossless_applied = applied
        return applied

    def encode_header(self) -> bytes:
        lz = self._stamp_lossless()
        ck = self._stamp_checksum()
        hdr = struct.pack(
            HEADER_FMT,
            MAGIC,
            int(self.op),
            self.status
            | (TRACE_FLAG if self.trace is not None else 0)
            | (CHECKSUM_FLAG if ck else 0)
            | (LOSSLESS_FLAG if lz else 0),
            self.flags,
            self.seq,
            self.key,
            self.cmd,
            self.version,
            memoryview(self.payload).nbytes,
        )
        if self.trace is not None:
            hdr += struct.pack(_TRACE_FMT, self.trace[0], self.trace[1])
        if ck:
            hdr += struct.pack(
                _CHECKSUM_FMT, frame_checksum(self.trace, self.payload)
            )
        return hdr

    def encode(self) -> bytes:
        return self.encode_header() + bytes(self.payload)


def recv_into(sock: socket.socket, view: memoryview) -> None:
    """Receive exactly ``len(view)`` bytes into the caller's buffer."""
    n = len(view)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    recv_into(sock, memoryview(buf))
    return bytes(buf)


def recv_header_ex(sock: socket.socket) -> tuple:
    """Read one header and its optional blocks: (op, status, flags, seq,
    key, cmd, version, length, trace, crc, lossless), with the flag bits
    cleared from ``status``."""
    magic, op, status, flags, seq, key, cmd, version, length = struct.unpack(
        HEADER_FMT, _recv_exact(sock, HEADER_SIZE)
    )
    if magic != MAGIC:
        raise ConnectionError(f"bad magic {magic:#x}")
    trace = None
    if status & TRACE_FLAG:
        trace = struct.unpack(_TRACE_FMT, _recv_exact(sock, TRACE_SIZE))
        status &= ~TRACE_FLAG
    crc = None
    if status & CHECKSUM_FLAG:
        (crc,) = struct.unpack(_CHECKSUM_FMT, _recv_exact(sock, CHECKSUM_SIZE))
        status &= ~CHECKSUM_FLAG
    lossless = bool(status & LOSSLESS_FLAG)
    status &= ~LOSSLESS_FLAG
    return (Op(op), status, flags, seq, key, cmd, version, length, trace,
            crc, lossless)


def verify_checksum(crc: Optional[int], trace, payload, op=None) -> None:
    """Raise :class:`ChecksumError` when a stamped frame's bytes do not
    match its CRC32C; no-op for an unstamped frame."""
    if crc is None:
        return
    got = frame_checksum(trace, payload)
    if got != crc:
        raise ChecksumError(op, crc, got)


def recv_message(sock: socket.socket) -> Message:
    """Receive one frame, verify its checksum, then decode a lossless
    container.  ``ChecksumError`` and ``LosslessError`` are raised after
    the frame was consumed."""
    op, status, flags, seq, key, cmd, version, length, trace, crc, lossless = (
        recv_header_ex(sock)
    )
    payload = _recv_exact(sock, length) if length else b""
    verify_checksum(crc, trace, payload, op=op)
    if lossless:
        from byteps_tpu_torch.compression.lossless import decompress_frame

        payload = decompress_frame(payload, op=op)
    return Message(
        op, key=key, payload=payload, seq=seq, cmd=cmd, version=version,
        status=status, flags=flags, trace=trace,
    )


def send_message(sock: socket.socket, msg: Message,
                 lock: Optional[threading.Lock] = None) -> None:
    """Send one frame: header and payload in one scatter-gather call, with
    no copy of the payload (a van connection without ``sendmsg``, the shm
    van's, takes them in two writes)."""
    hdr = msg.encode_header()  # may swap the payload for its container
    bufs = [memoryview(hdr)]
    if memoryview(msg.payload).nbytes:
        bufs.append(memoryview(msg.payload).cast("B"))
    if lock is not None:
        with lock:
            _sendmsg_all(sock, bufs)
    else:
        _sendmsg_all(sock, bufs)


def _sendmsg_all(sock: socket.socket, bufs: list) -> None:
    if not hasattr(sock, "sendmsg"):
        for b in bufs:
            sock.sendall(b)
        return
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if bufs and sent:
            bufs[0] = bufs[0][sent:]


# --- multi-key fusion frames (Op.FUSED) ------------------------------------
#
# Request body (network byte order):
#     u32 count
#     count x [u64 key, u32 cmd, u32 version, u64 length, length bytes]
#     optional trailer: count x u64 member span ids (a traced worker's;
#     the pack's own span rides the header's trace block)
# Reply body:
#     u32 count
#     count x [u64 key, u32 version, u64 length, length bytes]
#
# The outer header carries the first member's key (the route), the frame's
# seq, the worker flag, and the member count in ``cmd``; each member keeps
# its own key, Cantor-encoded cmd and round version, so the server runs
# every member through the per-(worker, key) exactly-once ledger.

_FUSED_MEMBER_FMT = "!QIIQ"
_FUSED_MEMBER_SIZE = struct.calcsize(_FUSED_MEMBER_FMT)
_FUSED_REPLY_FMT = "!QIQ"
_FUSED_REPLY_SIZE = struct.calcsize(_FUSED_REPLY_FMT)


def encode_fused_push(members, span_ids=None) -> bytes:
    """``[(key, cmd, version, payload), ...]`` as one frame body;
    ``span_ids`` (one per member, in order) append the span trailer."""
    parts = [struct.pack("!I", len(members))]
    for key, cmd, version, payload in members:
        parts.append(struct.pack(_FUSED_MEMBER_FMT, key, cmd, version,
                                 memoryview(payload).nbytes))
        parts.append(payload if isinstance(payload, bytes) else bytes(payload))
    if span_ids:
        if len(span_ids) != len(members):
            raise ValueError("span_ids must match members 1:1")
        parts.append(struct.pack(f"!{len(span_ids)}Q", *span_ids))
    return b"".join(parts)


def _walk_fused_members(body: bytes) -> tuple:
    """(members, offset after the last member); ValueError when the body
    is shorter than its members say."""
    if len(body) < 4:
        raise ValueError("fused frame truncated")
    (count,) = struct.unpack_from("!I", body, 0)
    off = 4
    members = []
    for _ in range(count):
        if off + _FUSED_MEMBER_SIZE > len(body):
            raise ValueError("fused frame truncated")
        key, cmd, version, length = struct.unpack_from(_FUSED_MEMBER_FMT, body, off)
        off += _FUSED_MEMBER_SIZE
        if off + length > len(body):
            raise ValueError("fused frame truncated")
        members.append((key, cmd, version, body[off: off + length]))
        off += length
    return members, off


def decode_fused_push(body: bytes) -> list:
    """Inverse of :func:`encode_fused_push`: [(key, cmd, version, bytes)];
    a span trailer is ignored."""
    return _walk_fused_members(body)[0]


def decode_fused_spans(body: bytes) -> Optional[List[int]]:
    """A fused frame's member span ids from its trailer, or None when it
    carries none."""
    members, off = _walk_fused_members(body)
    if members and len(body) - off == 8 * len(members):
        return list(struct.unpack_from(f"!{len(members)}Q", body, off))
    return None


def encode_fused_reply(members) -> bytes:
    """``[(key, version, payload), ...]`` as one reply body."""
    parts = [struct.pack("!I", len(members))]
    for key, version, payload in members:
        parts.append(struct.pack(_FUSED_REPLY_FMT, key, version, len(payload)))
        parts.append(payload)
    return b"".join(parts)


def decode_fused_reply(body: bytes) -> list:
    """Inverse of :func:`encode_fused_reply`: [(key, version, bytes)];
    ValueError when truncated."""
    if len(body) < 4:
        raise ValueError("fused reply truncated")
    (count,) = struct.unpack_from("!I", body, 0)
    off = 4
    members = []
    for _ in range(count):
        if off + _FUSED_REPLY_SIZE > len(body):
            raise ValueError("fused reply truncated")
        key, version, length = struct.unpack_from(_FUSED_REPLY_FMT, body, off)
        off += _FUSED_REPLY_SIZE
        if off + length > len(body):
            raise ValueError("fused reply truncated")
        members.append((key, version, body[off: off + length]))
        off += length
    return members


# --- the INIT profile extension -------------------------------------------
#
# A sync key's INIT body is u64 elements + u32 dtype (12 bytes).  A profile
# appends ``!Bi``: a profile byte (bit 0 async, bit 1 server-side optimizer)
# and the staleness bound; with bit 1 a rule block follows at offset 17:
# ``!H`` name length, the name, ``!I`` hyperparameter length, canonical
# JSON.  An engine without the plane refuses the INIT with status 1.

PROFILE_ASYNC = 1
PROFILE_SERVER_OPT = 2
_PROFILE_FMT = "!Bi"
PROFILE_OFFSET = 12
RULE_BLOCK_OFFSET = PROFILE_OFFSET + struct.calcsize(_PROFILE_FMT)


def encode_init(num_elements: int, dtype_id: int, profile: int = 0,
                staleness: int = -1, rule_block: bytes = b"") -> bytes:
    """An INIT body: the 12-byte sync form when ``profile`` is 0."""
    payload = struct.pack("!QI", num_elements, dtype_id)
    if profile:
        payload += struct.pack(_PROFILE_FMT, profile, int(staleness)) + rule_block
    return payload


def decode_init_profile(payload: bytes) -> Tuple[int, int]:
    """(profile byte, staleness bound) of an INIT body; (0, -1) for the
    12-byte sync form."""
    if len(payload) < RULE_BLOCK_OFFSET:
        return 0, -1
    return struct.unpack_from(_PROFILE_FMT, payload, PROFILE_OFFSET)


def encode_server_opt_block(rule: str, hp_json: str) -> bytes:
    """The rule block after the profile extension."""
    nb = str(rule).encode("utf-8")
    hb = hp_json.encode("utf-8")
    return struct.pack("!H", len(nb)) + nb + struct.pack("!I", len(hb)) + hb


def decode_server_opt_block(payload: bytes, off: int) -> Tuple[str, bytes]:
    """Inverse of :func:`encode_server_opt_block`: (rule name, raw
    hyperparameter JSON); ValueError when truncated."""
    if off + 2 > len(payload):
        raise ValueError("server-opt block truncated (name length)")
    (nlen,) = struct.unpack_from("!H", payload, off)
    off += 2
    if off + nlen + 4 > len(payload):
        raise ValueError("server-opt block truncated (name)")
    name = payload[off: off + nlen].decode("utf-8")
    off += nlen
    (hlen,) = struct.unpack_from("!I", payload, off)
    off += 4
    if off + hlen > len(payload):
        raise ValueError("server-opt block truncated (hyperparams)")
    return name, payload[off: off + hlen]


# --- the recovery plane (Op.RESYNC_QUERY / Op.RESYNC_STATE) ----------------
#
# JSON bodies.  Query: {"worker": <flags byte>, "keys": [<key>, ...]} (no
# keys: every key the server holds).  State: {"keys": {"<key>":
# {"store_version": v, "seen": s, "recv_count": c, "init": true}}}, where
# "seen" is the newest version of that worker's pushes the server's replay
# ledger absorbed.  Both server engines answer it (the C++ one from its own
# ledger, ps_server.cc).


def encode_resync_query(worker_flag: int, keys) -> bytes:
    """The body of an Op.RESYNC_QUERY frame."""
    return json.dumps({"worker": int(worker_flag), "keys": [int(k) for k in keys]}).encode()


def decode_resync_query(payload: bytes) -> Tuple[int, list]:
    """(worker flag, [key, ...]); ValueError on a malformed body."""
    raw = json.loads(payload.decode())
    if not isinstance(raw, dict):
        raise ValueError("resync query body must be a JSON object")
    return int(raw.get("worker", 0)), [int(k) for k in raw.get("keys", [])]


def encode_resync_state(states: dict) -> bytes:
    """The body of an Op.RESYNC_STATE reply: ``states`` maps key ->
    {"store_version", "seen", "recv_count", "init"}."""
    return json.dumps({"keys": {str(k): v for k, v in states.items()}}).encode()


def decode_resync_state(payload: bytes) -> dict:
    """Inverse of :func:`encode_resync_state`: {key: info}."""
    raw = json.loads(payload.decode())
    if not isinstance(raw, dict) or not isinstance(raw.get("keys", {}), dict):
        raise ValueError("resync state body must be a JSON object")
    return {int(k): v for k, v in raw.get("keys", {}).items()}


# --- the resharding plane (Op.MIGRATE_STATE / Op.WRONG_OWNER) -------------
#
# MIGRATE_STATE body: u32 JSON length, the JSON metadata (key, map epoch,
# dtype, round state, the exactly-once ledger ``push_seen``, the init-token
# record ``init_done``, the profile and the server-side optimizer's rule,
# step and slot layout), then the raw store, the raw accumulator and the
# optimizer's raw slots.  The receiver acks with an empty MIGRATE_STATE
# reply (nonzero status: refused).  WRONG_OWNER body: JSON {"owner": rank,
# "epoch": map_epoch}; the header ``version`` carries the epoch too.


def encode_migrate_state(meta: dict, store: bytes = b"", accum: bytes = b"") -> bytes:
    """The body of an Op.MIGRATE_STATE frame; ``meta`` already carries
    ``store_nbytes``/``accum_nbytes`` matching the raw tails."""
    head = json.dumps(meta).encode()
    return struct.pack("!I", len(head)) + head + store + accum


def decode_migrate_state(payload: bytes) -> Tuple[dict, bytes, bytes]:
    """Inverse of :func:`encode_migrate_state`: (meta, store, accum);
    ValueError on a malformed or truncated body."""
    if len(payload) < 4:
        raise ValueError("migrate frame too short")
    (hlen,) = struct.unpack_from("!I", payload, 0)
    if 4 + hlen > len(payload):
        raise ValueError("migrate frame truncated (header)")
    meta = json.loads(payload[4: 4 + hlen].decode())
    if not isinstance(meta, dict):
        raise ValueError("migrate metadata must be a JSON object")
    off = 4 + hlen
    sn = int(meta.get("store_nbytes", 0))
    an = int(meta.get("accum_nbytes", 0))
    if sn < 0 or an < 0 or off + sn + an > len(payload):
        raise ValueError("migrate frame truncated (payload)")
    return meta, payload[off: off + sn], payload[off + sn: off + sn + an]


def decode_migrate_extra(payload: bytes, meta: dict) -> bytes:
    """The raw tail behind store and accumulator in a MIGRATE_STATE body:
    the optimizer's slot bytes (``meta["opt_slot_nbytes"]`` splits it)."""
    (hlen,) = struct.unpack_from("!I", payload, 0)
    off = 4 + hlen + int(meta.get("store_nbytes", 0)) + int(meta.get("accum_nbytes", 0))
    return payload[off:]


def encode_wrong_owner(epoch: int, owner: int) -> bytes:
    """The body of an Op.WRONG_OWNER reply."""
    return json.dumps({"owner": int(owner), "epoch": int(epoch)}).encode()


def decode_wrong_owner(payload: bytes) -> Tuple[int, int]:
    """(map_epoch, owner_rank); an empty or unreadable body gives (0, -1)
    (the header ``version`` is the authoritative epoch)."""
    try:
        raw = json.loads(payload.decode()) if payload else {}
    except (ValueError, UnicodeDecodeError):
        raw = {}
    if not isinstance(raw, dict):
        raw = {}
    return int(raw.get("epoch", 0)), int(raw.get("owner", -1))


def connect(host: str, port: int, timeout: float = 30.0) -> socket.socket:
    """Dial an address from the scheduler's book."""
    from byteps_tpu_torch.comm.van import van_for_address

    return van_for_address(host).connect(host, port, timeout=timeout)


def connect_control(host: str, port: int, timeout: float = 30.0) -> socket.socket:
    """Dial the scheduler.  With ``BYTEPS_CHAOS_SCHED=1`` under the chaos
    van the link is wrapped in the fault layer (``comm/chaos.py``
    :func:`~byteps_tpu_torch.comm.chaos.wrap_control`)."""
    from byteps_tpu_torch.comm.chaos import wrap_control

    return wrap_control(connect(host, port, timeout=timeout), port)


def decode_liveness(payload: bytes) -> dict:
    """An Op.QUERY reply, {role: {rank: heartbeat age in seconds}}, with
    the ranks JSON made strings turned back into ints."""
    raw = json.loads(payload.decode())
    return {role: {int(r): age for r, age in d.items()} for role, d in raw.items()}


def close_socket(sock: Optional[socket.socket]) -> None:
    """shutdown() then close(): a bare close() while another thread blocks
    in recv on the socket sends no FIN; shutdown wakes the reader."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def listen(host: str = "0.0.0.0", port: int = 0) -> Tuple[socket.socket, int]:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(128)
    return srv, srv.getsockname()[1]
