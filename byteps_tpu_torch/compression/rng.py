"""xorshift128+ with a shared seed, a copy of ``byteps_tpu.compression.rng``.

Worker and server must draw the same random index and quantization
sequences (randomk rests on it: randomk.cc:25, the RNG of utils.h).  The
stream is bit for bit that of ``byteps_tpu/native/compressor.cc``'s
xorshift128p and of the reference's numpy copy.
"""

from __future__ import annotations

import threading

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
DEFAULT_S0 = 0x9E3779B97F4A7C15
DEFAULT_S1 = 0xBF58476D1CE4E5B9

_S23 = np.uint64(23)
_S17 = np.uint64(17)
_S26 = np.uint64(26)
_B64 = np.arange(64, dtype=np.uint64)

# ---------------------------------------------------------------------------
# GF(2) jump-ahead: the state map T(s0,s1) = (s1, f(s0)^g(s1)) with
# f(x) = x' ^ (x'>>17), x' = x^(x<<23) and g(y) = y ^ (y>>26) is linear
# over GF(2)^128, so T^L composes from bit-basis images.  A map is stored
# as two uint64[128] arrays: out-s0 / out-s1 words per input basis bit
# (bits 0..63 = s0, 64..127 = s1).
# ---------------------------------------------------------------------------


def _base_map() -> tuple:
    mask = 0xFFFFFFFFFFFFFFFF

    def f(x):
        xp = (x ^ (x << 23)) & mask
        return xp ^ (xp >> 17)

    def g(y):
        return y ^ (y >> 26)

    m0 = np.empty(128, dtype=np.uint64)
    m1 = np.empty(128, dtype=np.uint64)
    for b in range(64):  # s0 basis bits: (e, 0) -> (0, f(e))
        m0[b] = 0
        m1[b] = f(1 << b)
    for b in range(64):  # s1 basis bits: (0, e) -> (e, g(e))
        m0[64 + b] = 1 << b
        m1[64 + b] = g(1 << b)
    return m0, m1


def _identity_map() -> tuple:
    """The map that leaves (s0, s1) as it is: basis bit b goes to itself."""
    m0 = np.zeros(128, dtype=np.uint64)
    m1 = np.zeros(128, dtype=np.uint64)
    for b in range(64):
        m0[b] = 1 << b
        m1[64 + b] = 1 << b
    return m0, m1


def _compose(a: tuple, bm: tuple) -> tuple:
    """Map composition out[b] = A(B[b]) — all 128 columns at once."""
    a0, a1 = a
    b0, b1 = bm
    bits0 = ((b0[:, None] >> _B64[None, :]) & np.uint64(1)).astype(bool)
    bits1 = ((b1[:, None] >> _B64[None, :]) & np.uint64(1)).astype(bool)
    z = np.uint64(0)
    out0 = np.bitwise_xor.reduce(
        np.concatenate(
            [np.where(bits0, a0[None, :64], z), np.where(bits1, a0[None, 64:], z)],
            axis=1,
        ),
        axis=1,
    )
    out1 = np.bitwise_xor.reduce(
        np.concatenate(
            [np.where(bits0, a1[None, :64], z), np.where(bits1, a1[None, 64:], z)],
            axis=1,
        ),
        axis=1,
    )
    return out0, out1


def _apply_map(m: tuple, v0: int, v1: int) -> tuple:
    m0, m1 = m
    bits = np.concatenate(
        [
            (np.uint64(v0) >> _B64) & np.uint64(1),
            (np.uint64(v1) >> _B64) & np.uint64(1),
        ]
    ).astype(bool)
    r0 = np.bitwise_xor.reduce(m0[bits]) if bits.any() else np.uint64(0)
    r1 = np.bitwise_xor.reduce(m1[bits]) if bits.any() else np.uint64(0)
    return int(r0), int(r1)


_POW_CACHE: list = []  # _POW_CACHE[i] = T^(2^i)
_JUMP_CACHE: dict = {}
_JUMP_LOCK = threading.Lock()


def _jump_map(steps: int) -> tuple:
    """T^steps by binary-power composition (cached).

    Lock-guarded: the COMPRESS/DECOMPRESS pools run different keys'
    codecs concurrently, and an unsynchronized check-then-append on the
    power table would let two cold-cache callers both append a square of
    the same entry — corrupting every later jump (and with it randomk's
    worker/server index agreement)."""
    with _JUMP_LOCK:
        m = _JUMP_CACHE.get(steps)
        if m is not None:
            return m
        if steps == 0:
            # T^0 is the identity (the reference returns None and caches
            # it: the sixteenth deliberate divergence, ROADMAP.md Queue 3)
            m = _JUMP_CACHE[0] = _identity_map()
            return m
        if not _POW_CACHE:
            _POW_CACHE.append(_base_map())
        while (1 << len(_POW_CACHE)) <= steps:
            last = _POW_CACHE[-1]
            _POW_CACHE.append(_compose(last, last))
        acc = None
        i = 0
        s = steps
        while s:
            if s & 1:
                acc = _POW_CACHE[i] if acc is None else _compose(_POW_CACHE[i], acc)
            s >>= 1
            i += 1
        _JUMP_CACHE[steps] = acc
        return acc


class XorShift128Plus:
    def __init__(self, s0: int = DEFAULT_S0, s1: int = DEFAULT_S1) -> None:
        self.s0 = np.uint64(s0 if s0 else DEFAULT_S0)
        self.s1 = np.uint64(s1 if s1 else DEFAULT_S1)

    def next(self) -> int:
        with np.errstate(over="ignore"):
            x = self.s0
            y = self.s1
            self.s0 = y
            x = (x ^ (x << np.uint64(23))) & _MASK
            self.s1 = x ^ y ^ (x >> np.uint64(17)) ^ (y >> np.uint64(26))
            return int((self.s1 + y) & _MASK)

    def uniform(self) -> float:
        """[0,1) double with 53-bit mantissa, matching the C++ (>>11 * 2^-53)."""
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)

    def fill(self, n: int) -> np.ndarray:
        """``n`` sequential draws as a uint64 array — bit-identical to
        calling :meth:`next` ``n`` times, 1–2 orders of magnitude faster.

        The recurrence is serial, but it is LINEAR over GF(2): the
        128-bit state advances by a fixed xor/shift map T, so ``T^L`` is
        computable by binary-power composition of bit-basis images
        (_jump below).  Large fills jump 256 lane-start states L steps
        apart and then step all lanes together with numpy uint64 array
        ops — n/256 vectorized iterations instead of n Python ones.
        Small fills use a plain Python-int loop (still ~7× faster than
        per-draw np.uint64 scalar stepping).  Either path leaves
        ``self.s0/s1`` exactly where ``n`` :meth:`next` calls would."""
        if n <= 0:
            return np.empty(0, dtype=np.uint64)
        if n < 4096:
            return self._fill_serial(n)
        return self._fill_lanes(n)

    def _fill_serial(self, n: int) -> np.ndarray:
        mask = 0xFFFFFFFFFFFFFFFF
        s0, s1 = int(self.s0), int(self.s1)
        out = [0] * n
        for i in range(n):
            x = s0
            y = s1
            s0 = y
            x = (x ^ (x << 23)) & mask
            s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
            out[i] = (s1 + y) & mask
        self.s0 = np.uint64(s0)
        self.s1 = np.uint64(s1)
        return np.array(out, dtype=np.uint64)

    def _fill_lanes(self, n: int, lanes: int = 256) -> np.ndarray:
        L = -(-n // lanes)  # draws per lane (ceil)
        jump = _jump_map(L)
        s0s = np.empty(lanes, dtype=np.uint64)
        s1s = np.empty(lanes, dtype=np.uint64)
        v0, v1 = int(self.s0), int(self.s1)
        for k in range(lanes):
            s0s[k], s1s[k] = v0, v1
            v0, v1 = _apply_map(jump, v0, v1)
        out = np.empty((lanes, L), dtype=np.uint64)
        a, b = s0s, s1s
        with np.errstate(over="ignore"):
            for i in range(L):
                x = a ^ (a << _S23)
                nb = x ^ b ^ (x >> _S17) ^ (b >> _S26)
                out[:, i] = nb + b
                a, b = b, nb
        # exact final state: T^n applied to the INITIAL state (the lanes
        # overshoot to lanes*L draws; discarding the tail must not leave
        # the stream advanced past n)
        self.s0, self.s1 = (
            np.uint64(w) for w in _apply_map(_jump_map(n), int(self.s0), int(self.s1))
        )
        return out.reshape(-1)[:n]

    def uniform_fill(self, n: int) -> np.ndarray:
        """``n`` sequential [0,1) doubles (53-bit mantissa), bit-identical
        to ``n`` :meth:`uniform` calls."""
        return (self.fill(n) >> np.uint64(11)) * (1.0 / 9007199254740992.0)


def seed_pair_from(seed: int) -> tuple:
    """Derive a (s0, s1) pair from a single integer seed (splitmix-style)."""
    if not seed:
        return DEFAULT_S0, DEFAULT_S1
    z = (seed + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    s0 = (z ^ (z >> 27)) or DEFAULT_S0
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    s1 = (z ^ (z >> 27)) or DEFAULT_S1
    return s0, s1
