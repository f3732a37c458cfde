"""The host codecs in numpy, byte for byte the wire of
``byteps_tpu.compression.impl`` (little-endian, as
``byteps_tpu/native/compressor.cc`` writes it):

    onebit:    [f32 scale][u32 sign words]; bit i of word w is set when
               x[32w + i] has its sign bit set (negatives, -0.0, negative NaNs)
    topk:      [(i32 idx, f32 val) x k], indices ascending
    randomk:   [(i32 idx, f32 val) x k], indices drawn from the shared xorshift128+
    dithering: [f32 norm][i8 signed level x n]

The onebit scale is mean |x| when scaling, else 1.0.  It is summed in
float64 and rounded once to float32, as ``byteps_tpu/native/compressor.cc``
does (the codec the reference's servers run): with sums that are exact in
float64 the two agree bit for bit.  ``np.packbits(..., bitorder="little")``
lays the sign bits out exactly as the reference's words.  topk, randomk
and dithering follow the reference's numpy paths operation for operation.

``compress`` and ``decompress`` call the port's own copy of
``compressor.cc`` (``byteps_tpu_torch.native``) where the reference's
codecs call theirs: onebit both ways, topk and randomk compress,
dithering both ways; they need no interpreter lock.  The numpy bodies
are the plain versions (``compress_plain``, ``decompress_plain``) the
tests hold the native entries to.  The native onebit scale sums |x| in
float64 over OpenMP threads, so it may differ from the plain one by an
ulp of float32 (ROADMAP.md Queue 3); the words are bitwise.
"""

from __future__ import annotations

import ctypes

import numpy as np

from byteps_tpu_torch.compression.base import Compressor
from byteps_tpu_torch.compression.rng import XorShift128Plus, seed_pair_from
from byteps_tpu_torch.native import get_lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32(grad: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)

#: bit i of byte b, for every byte value: (256, 8) bool
_BYTE_BITS = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)


def onebit_scale(grad: np.ndarray, scaling: bool) -> np.float32:
    n = grad.size
    if not scaling or not n:
        return np.float32(1.0)
    return np.float32(np.abs(grad).sum(dtype=np.float64) / n)


class OneBitCompressor(Compressor):
    """Sign compression packed 32:1, with optional L1 scaling (onebit.cc)."""

    def __init__(self, size: int, scaling: bool = False) -> None:
        super().__init__(size)
        self.scaling = scaling

    wire_static = True  # [f32 scale][packed sign words]

    def wire_nbytes(self) -> int:
        return 4 + 4 * ((self.size + 31) // 32)

    def compress(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        out = np.empty(4 + 4 * ((grad.size + 31) // 32), dtype=np.uint8)
        ln = get_lib().bps_onebit_compress(_ptr(grad), grad.size, _ptr(out), int(self.scaling))
        return out[:ln].tobytes()

    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        buf = np.frombuffer(payload, dtype=np.uint8)
        out = np.empty(n, dtype=np.float32)
        get_lib().bps_onebit_decompress(_ptr(buf), n, _ptr(out))
        return out

    def compress_plain(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        n = grad.size
        bits = np.zeros(32 * ((n + 31) // 32), dtype=bool)
        np.signbit(grad, out=bits[:n])
        words = np.packbits(bits, bitorder="little")
        return onebit_scale(grad, self.scaling).tobytes() + words.tobytes()

    def decompress_plain(self, payload: bytes, n: int) -> np.ndarray:
        """-scale where the bit is set, else scale: one gather of 8 values
        per payload byte from a 256-row table (4x faster than unpacking
        the bits first, on the servers' hot path)."""
        scale = np.frombuffer(payload, dtype="<f4", count=1)[0]
        table = np.where(_BYTE_BITS, -scale, scale).astype(np.float32)
        words = np.frombuffer(payload, dtype=np.uint8, offset=4, count=(n + 7) // 8)
        return table[words].reshape(-1)[:n]


#: the (index, value) records of the topk and randomk wire
_PAIRS = np.dtype([("i", "<i4"), ("v", "<f4")])


def _pairs(idx: np.ndarray, vals: np.ndarray) -> bytes:
    rec = np.empty(idx.size, dtype=_PAIRS)
    rec["i"] = idx
    rec["v"] = vals
    return rec.tobytes()


class TopKCompressor(Compressor):
    """The k largest-magnitude (index, value) pairs (topk.cc:26).  Equal
    magnitudes at the k-th place select in ascending-index order, as the
    reference's three selectors do."""

    def __init__(self, size: int, k: int) -> None:
        super().__init__(size)
        self.k = max(1, min(int(k), size))

    wire_static = True  # exactly k (index, value) pairs

    def wire_nbytes(self) -> int:
        return 8 * self.k

    def compress(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        k = min(self.k, grad.size)
        out = np.empty(8 * k, dtype=np.uint8)
        ln = get_lib().bps_topk_compress(_ptr(grad), grad.size, k, _ptr(out))
        return out[:ln].tobytes()

    def compress_plain(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        k = min(self.k, grad.size)
        idx = np.argsort(-np.abs(grad), kind="stable")[:k]
        idx.sort()
        return _pairs(idx, grad[idx])

    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        rec = np.frombuffer(payload, dtype=_PAIRS)
        out = np.zeros(n, dtype=np.float32)
        out[rec["i"]] = rec["v"]
        return out

    def sum_into(self, payload: bytes, acc: np.ndarray) -> None:
        rec = np.frombuffer(payload, dtype=_PAIRS)
        np.add.at(acc, rec["i"], rec["v"])


class RandomKCompressor(Compressor):
    """k (index, value) pairs at indices drawn from xorshift128+ under the
    declared seed (randomk.cc:25).  The stream restarts from the seed every
    call, so worker and server draw the same indices every round."""

    def __init__(self, size: int, k: int, seed: int = 0) -> None:
        super().__init__(size)
        self.k = max(1, min(int(k), size))
        self.s0, self.s1 = seed_pair_from(seed)

    wire_nbytes = TopKCompressor.wire_nbytes
    wire_static = True

    def compress(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        n, k = grad.size, min(self.k, grad.size)
        out = np.empty(8 * k, dtype=np.uint8)
        ln = get_lib().bps_randomk_compress(_ptr(grad), n, k, self.s0, self.s1, _ptr(out))
        return out[:ln].tobytes()

    def compress_plain(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        n, k = grad.size, min(self.k, grad.size)
        rng = XorShift128Plus(self.s0, self.s1)
        idx = (rng.fill(k) % np.uint64(n)).astype(np.int32)
        return _pairs(idx, grad[idx])

    decompress = TopKCompressor.decompress
    sum_into = TopKCompressor.sum_into


class DitheringCompressor(Compressor):
    """Stochastic quantization to ``k`` levels, linear or natural
    (power-of-two) partition, max or l2 norm (dithering.h:43-78).  The level
    math runs in float64 and the draws come from xorshift128+ under the
    declared seed, restarted every call."""

    def __init__(self, size: int, k: int = 4, partition: str = "linear",
                 normalize: str = "max", seed: int = 0) -> None:
        super().__init__(size)
        self.s = max(1, int(k))  # number of levels
        self.natural = partition in ("natural", "1", 1)
        self.l2 = normalize in ("l2", "L2", "1", 1)
        self.s0, self.s1 = seed_pair_from(seed)

    wire_static = True  # [f32 norm][i8 level x n]

    def wire_nbytes(self) -> int:
        return 4 + self.size

    def compress(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        out = np.empty(4 + grad.size, dtype=np.uint8)
        ln = get_lib().bps_dithering_compress(
            _ptr(grad), grad.size, self.s, int(self.natural), int(self.l2),
            self.s0, self.s1, _ptr(out))
        return out[:ln].tobytes()

    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        buf = np.frombuffer(payload, dtype=np.uint8)
        out = np.empty(n, dtype=np.float32)
        get_lib().bps_dithering_decompress(_ptr(buf), n, self.s, int(self.natural), _ptr(out))
        return out

    def compress_plain(self, grad: np.ndarray) -> bytes:
        grad = _f32(grad)
        n = grad.size
        g64 = grad.astype(np.float64)
        norm = (float(np.sqrt((g64 ** 2).sum())) if self.l2
                else float(np.abs(g64).max(initial=0.0)))
        if norm == 0.0:
            norm = 1.0
        u = XorShift128Plus(self.s0, self.s1).uniform_fill(n)
        s = self.s
        p = np.abs(g64) / norm
        if self.natural:
            level = np.zeros(n, dtype=np.int64)
            pos = p > 0.0
            j = np.zeros(n, dtype=np.float64)
            j[pos] = np.floor(np.log2(p[pos]))
            hi = pos & (j >= 0)
            lo = pos & (j < -s)
            mid = pos & ~hi & ~lo
            level[hi] = s
            level[lo] = (p[lo] / (2.0 ** (-s)) > u[lo]).astype(np.int64)
            jm = j[mid]
            lo_b = 2.0 ** jm
            frac = (p[mid] - lo_b) / (2.0 ** (jm + 1) - lo_b)
            level[mid] = (s + jm).astype(np.int64) + (frac > u[mid])
        else:
            scaled = p * s
            fl = np.floor(scaled)
            level = (fl + ((scaled - fl) > u)).astype(np.int64)
            np.minimum(level, s, out=level)
        levels = np.where(np.signbit(grad), -level, level).astype(np.int8)
        return np.float32(norm).tobytes() + levels.tobytes()

    def decompress_plain(self, payload: bytes, n: int) -> np.ndarray:
        """sign(level) * magnitude * norm, in float64 rounded once to
        float32: the magnitude is 2^(|level| - s) (0 for level 0) when
        natural, else |level| / s."""
        norm = np.frombuffer(payload, dtype="<f4", count=1)[0]
        levels = np.frombuffer(payload, dtype=np.int8, offset=4, count=n).astype(np.int32)
        a = np.abs(levels)
        if self.natural:
            mag = np.where(a == 0, 0.0, 2.0 ** (a.astype(np.float64) - self.s))
        else:
            mag = a.astype(np.float64) / self.s
        return (np.sign(levels) * mag * norm).astype(np.float32)
