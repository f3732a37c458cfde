"""Lossless wire-frame compression, the container and LZ codec of
``byteps_tpu.compression.lossless`` byte for byte.

A frame's payload may travel inside a self-describing container:

    MAGIC(4) VERSION(1) METHOD(1) RAW_LEN(4, big-endian) body

``METHOD_STORE`` carries the raw bytes, ``METHOD_LZ`` a greedy LZ token
stream (LZ4-block style: literal/match nibbles with 255-continuation,
2-byte little-endian offsets, MINMATCH 4), so a container is never more
than ``HEADER_SIZE`` bytes larger than its input.  The wire marks such a
frame with ``transport.LOSSLESS_FLAG`` (0x20).

On the path the container is built and decoded by the port's C++
(``native/csrc/wire.h``, ``bps_wire_lossless_compress`` /
``_decompress``).  :func:`lz_compress` / :func:`lz_decompress` and
:func:`compress_frame_plain` / :func:`decompress_frame_plain` are its
plain version, which the tests hold the C++ to bit for bit.  Unlike the
reference, a library that cannot be built raises: there is no quiet
fallback to the plain version (ROADMAP.md Queue 3).

Decoding fails closed: a truncated, corrupt or unknown container raises
:class:`LosslessError`, after its frame was read off the stream.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np

MAGIC = b"\xb5LZ0"
VERSION = 1
METHOD_STORE = 0
METHOD_LZ = 1
HEADER_SIZE = 10

#: payloads below this never win after the 10-byte container (wire.h
#: kLosslessMinBytes)
MIN_BYTES = 64

_MINMATCH = 4
_HASH_BITS = 13
_HASH_MULT = 2654435761
_MAX_OFFSET = 65535


class LosslessError(ValueError):
    """A lossless container failed to decode.  Raised after its frame was
    consumed, so the receiver drops the frame and the stream stays
    framed."""

    def __init__(self, reason: str, op=None) -> None:
        super().__init__(f"lossless decode failed: {reason}"
                         + (f" (op={op})" if op is not None else ""))
        self.reason = reason
        self.op = op


# --- the plain version -----------------------------------------------------


def _hash4(v: int) -> int:
    return ((v * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASH_BITS)


def lz_compress(src: bytes) -> bytes:
    """Greedy single-probe LZ of ``src`` into a token stream (no
    container); deterministic, and byte-identical to wire.h
    ``lossless_lz_compress``."""
    n = len(src)
    out = bytearray()
    if n < _MINMATCH:
        _emit_seq(out, src, 0, n, 0, 0)
        return bytes(out)
    table = [-1] * (1 << _HASH_BITS)
    # no match begins in the last 12 bytes nor reaches into the last 5
    mflimit = n - 12
    matchlimit = n - 5
    anchor = 0
    pos = 0
    while pos <= mflimit:
        h = _hash4(int.from_bytes(src[pos:pos + 4], "little"))
        cand = table[h]
        table[h] = pos
        if (cand >= 0 and pos - cand <= _MAX_OFFSET
                and src[cand:cand + 4] == src[pos:pos + 4]):
            mlen = _MINMATCH
            while pos + mlen < matchlimit and src[cand + mlen] == src[pos + mlen]:
                mlen += 1
            _emit_seq(out, src, anchor, pos - anchor, pos - cand, mlen)
            anchor = pos + mlen
            pos = anchor
        else:
            pos += 1
    _emit_seq(out, src, anchor, n - anchor, 0, 0)
    return bytes(out)


def _emit_seq(out: bytearray, src: bytes, lit_start: int, lit_len: int,
              offset: int, mlen: int) -> None:
    """One sequence: token, extended literal length, literals and, unless
    it is the final literals-only one (``offset`` 0), the offset and the
    extended match length."""
    ml = mlen - _MINMATCH if offset else 0
    out.append((min(lit_len, 15) << 4) | min(ml, 15))
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += src[lit_start:lit_start + lit_len]
    if offset:
        out += offset.to_bytes(2, "little")
        if ml >= 15:
            rem = ml - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)


def _ext_len(src: bytes, pos: int, base: int, what: str) -> tuple:
    """A nibble length of 15 continued by 255-bytes: (length, position)."""
    n = len(src)
    while True:
        if pos >= n:
            raise LosslessError(f"truncated {what} length")
        b = src[pos]
        pos += 1
        base += b
        if b != 255:
            return base, pos


def lz_decompress(block, raw_len: int) -> bytes:
    """Inverse of :func:`lz_compress`; every read and copy is checked
    against the input and ``raw_len``, and a violation raises
    :class:`LosslessError` with the reference's reason."""
    src = bytes(block)
    n = len(src)
    out = bytearray()
    pos = 0
    while True:
        if pos >= n:
            raise LosslessError("truncated token stream")
        token = src[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            lit_len, pos = _ext_len(src, pos, lit_len, "literal")
        if pos + lit_len > n:
            raise LosslessError("literal run past end of input")
        out += src[pos:pos + lit_len]
        pos += lit_len
        if len(out) > raw_len:
            raise LosslessError("output exceeds declared raw length")
        if pos == n:
            break
        if pos + 2 > n:
            raise LosslessError("truncated match offset")
        offset = int.from_bytes(src[pos:pos + 2], "little")
        pos += 2
        if offset == 0 or offset > len(out):
            raise LosslessError("match offset outside window")
        mlen = token & 15
        if mlen == 15:
            mlen, pos = _ext_len(src, pos, mlen, "match")
        mlen += _MINMATCH
        if len(out) + mlen > raw_len:
            raise LosslessError("match run exceeds declared raw length")
        start = len(out) - offset
        for i in range(mlen):  # an overlapping copy goes byte-forward
            out.append(out[start + i])
    if len(out) != raw_len:
        raise LosslessError(f"raw length mismatch (declared {raw_len}, got {len(out)})")
    return bytes(out)


def compress_frame_plain(data) -> bytes:
    """The container of ``data`` by the plain version: LZ when it comes out
    smaller than the input (of at least ``MIN_BYTES``), else stored."""
    raw = bytes(data)
    head = MAGIC + bytes((VERSION,))
    if len(raw) >= MIN_BYTES:
        comp = lz_compress(raw)
        if len(comp) < len(raw):
            return head + bytes((METHOD_LZ,)) + len(raw).to_bytes(4, "big") + comp
    return head + bytes((METHOD_STORE,)) + len(raw).to_bytes(4, "big") + raw


def _check_header(buf: bytes, op) -> tuple:
    """(method, raw length) of a container; LosslessError when malformed."""
    if len(buf) < HEADER_SIZE:
        raise LosslessError("container shorter than header", op=op)
    if buf[:4] != MAGIC:
        raise LosslessError("bad container magic", op=op)
    if buf[4] != VERSION:
        raise LosslessError(f"unknown container version {buf[4]}", op=op)
    method = buf[5]
    if method not in (METHOD_STORE, METHOD_LZ):
        raise LosslessError(f"unknown method {method}", op=op)
    return method, int.from_bytes(buf[6:10], "big")


def decompress_frame_plain(blob, op=None) -> bytes:
    """Inverse of :func:`compress_frame_plain`."""
    buf = bytes(blob)
    method, raw_len = _check_header(buf, op)
    body = buf[HEADER_SIZE:]
    if method == METHOD_STORE:
        if len(body) != raw_len:
            raise LosslessError("stored body length mismatch", op=op)
        return body
    try:
        return lz_decompress(body, raw_len)
    except LosslessError as e:
        raise LosslessError(e.reason, op=op) from None


# --- the path: the port's C++ ---------------------------------------------


def _as_u8(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if memoryview(data).nbytes else np.zeros(1, np.uint8)


def compress_frame(data) -> bytes:
    """``data`` as a container, built by wire.h ``lossless_compress_frame``
    (bitwise :func:`compress_frame_plain`)."""
    from byteps_tpu_torch.native import get_lib

    src = _as_u8(data)
    n = memoryview(data).nbytes
    cap = HEADER_SIZE + n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    got = get_lib().bps_wire_lossless_compress(src.ctypes.data, n, out.ctypes.data, cap)
    if got <= 0:
        raise RuntimeError(f"bps_wire_lossless_compress returned {got} for {n} bytes")
    return out[:got].tobytes()


def decompress_frame(blob, op=None) -> bytes:
    """Inverse of :func:`compress_frame`: the header is checked here, an LZ
    body decoded by wire.h ``lossless_decompress_frame``.  Raises
    :class:`LosslessError` (carrying ``op``) on any corruption."""
    buf = bytes(blob)
    method, raw_len = _check_header(buf, op)
    if method == METHOD_STORE:
        if len(buf) - HEADER_SIZE != raw_len:
            raise LosslessError("stored body length mismatch", op=op)
        return buf[HEADER_SIZE:]
    from byteps_tpu_torch.native import get_lib

    out = ctypes.create_string_buffer(max(raw_len, 1))
    got = get_lib().bps_wire_lossless_decompress(buf, len(buf), out, raw_len)
    if got != raw_len:
        raise LosslessError("native decoder rejected stream", op=op)
    return out.raw[:raw_len]


def byte_entropy(data, limit: int = 65536) -> float:
    """Shannon entropy of ``data`` in bits a byte over at most ``limit``
    leading bytes (0: all): the signal of the lossless arm."""
    view = memoryview(data).cast("B")
    buf = view[:limit] if limit else view
    n = buf.nbytes
    if not n:
        return 0.0
    counts = np.bincount(np.frombuffer(buf, dtype=np.uint8), minlength=256).tolist()
    ent = 0.0
    for c in counts:
        if c:
            p = c / n
            ent -= p * math.log2(p)
    return ent


def lossless_entropy_cutoff() -> float:
    """Entropy (bits a byte) above which the lossless arm declines a key
    (``BYTEPS_LOSSLESS_ENTROPY``, default 6.0)."""
    v = os.environ.get("BYTEPS_LOSSLESS_ENTROPY", "")
    try:
        return float(v) if v else 6.0
    except ValueError:
        return 6.0
