"""Codec interface (compressor.h:53-127): ``compress(f32 array) -> bytes``,
``decompress(bytes, n) -> f32 array``, and ``sum_into`` for the server's
decompress-then-sum."""

from __future__ import annotations

import abc

import numpy as np


class Compressor(abc.ABC):
    """A codec over one partition's flat float32 values."""

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
        """Exact payload size in bytes."""
        return self.size * 4
