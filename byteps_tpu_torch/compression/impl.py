"""The onebit codec in numpy, byte for byte the wire of
``byteps_tpu.compression.impl.OneBitCompressor``:

    [f32 scale][u32 sign words], little-endian; bit i of word w is set
    when x[32w + i] has its sign bit set (negatives, -0.0, negative NaNs)

The scale is mean |x| when scaling, else 1.0.  It is summed in float64 and
rounded once to float32, as ``byteps_tpu/native/compressor.cc`` does (the
codec the reference's servers run): with sums that are exact in float64
the two agree bit for bit.  ``np.packbits(..., bitorder="little")`` lays
the sign bits out exactly as the reference's words.
"""

from __future__ import annotations

import numpy as np

from byteps_tpu_torch.compression.base import Compressor

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

    def wire_nbytes(self) -> int:
        return 4 + 4 * ((self.size + 31) // 32)

    def compress(self, grad: np.ndarray) -> bytes:
        grad = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
        n = grad.size
        bits = np.zeros(32 * ((n + 31) // 32), dtype=bool)
        np.signbit(grad, out=bits[:n])
        words = np.packbits(bits, bitorder="little")
        return onebit_scale(grad, self.scaling).tobytes() + words.tobytes()

    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        """-scale where the bit is set, else scale: one gather of 8 values
        per payload byte from a 256-row table (4x faster than unpacking
        the bits first, on the servers' hot path)."""
        scale = np.frombuffer(payload, dtype="<f4", count=1)[0]
        table = np.where(_BYTE_BITS, -scale, scale).astype(np.float32)
        words = np.frombuffer(payload, dtype=np.uint8, offset=4, count=(n + 7) // 8)
        return table[words].reshape(-1)[:n]
