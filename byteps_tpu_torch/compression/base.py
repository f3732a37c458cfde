"""Codec interface (compressor.h:53-127): ``compress(f32 array) -> bytes``,
``decompress(bytes, n) -> f32 array``, ``sum_into`` for the server's
decompress-then-sum, and ``update_error`` for the error-feedback
decorator.

``Compression`` is the plugins' level-1 selector (torch/compression.py):
``none``, or a cast of float32 gradients to bfloat16 for the wire
(``fp16`` is kept as a name for API parity and casts to bfloat16, as in
``byteps_tpu``).  The cast runs on the tensor's device.
"""

from __future__ import annotations

import abc

import numpy as np


class Compressor(abc.ABC):
    """A codec over one partition's flat float32 values."""

    #: True when :meth:`wire_nbytes` is exact for every payload the codec
    #: emits (a size-deterministic wire), not a bound: adaptive
    #: compression then decides a key at registration.  Every shipped
    #: codec sets it; a custom codec keeping the default size does not.
    wire_static = False

    def __init__(self, size: int) -> None:
        self.size = size  # element count of the uncompressed partition

    @abc.abstractmethod
    def compress(self, grad: np.ndarray) -> bytes:
        ...

    @abc.abstractmethod
    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        ...

    def sum_into(self, payload: bytes, acc: np.ndarray) -> None:
        """Accumulate a compressed payload into a dense buffer (the
        server's SUM_RECV)."""
        acc += self.decompress(payload, acc.size)

    def wire_nbytes(self) -> int:
        """Payload size in bytes: exact where ``wire_static``, else the
        uncompressed size (no savings assumed)."""
        return self.size * 4

    def update_error(self, corrected: np.ndarray, payload: bytes) -> np.ndarray:
        """e = corrected - decompress(compress(corrected)), the
        FastUpdateError hook (error_feedback.h:46-90)."""
        return corrected - self.decompress(payload, corrected.size)


class _NoneCompression:
    def compress(self, tensor: torch.Tensor):
        return tensor, None

    def decompress(self, tensor: torch.Tensor, ctx):
        return tensor


class _Bf16Compression:
    """Level 1: float32 goes on the wire as bfloat16 and comes back as
    float32; other dtypes pass unchanged."""

    def compress(self, tensor: torch.Tensor):
        import torch

        if tensor.dtype == torch.float32:
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    def decompress(self, tensor: torch.Tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """Level-1 selectors (``bps.Compression.none`` / ``.fp16``)."""

    none = _NoneCompression()
    fp16 = _Bf16Compression()  # the name of the reference's API; casts to bfloat16
    bf16 = _Bf16Compression()
