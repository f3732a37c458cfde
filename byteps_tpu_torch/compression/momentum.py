"""The Nesterov momentum decorator (momentum.h:44-80,
nesterov_momentum.cc:23), as ``byteps_tpu.compression.momentum``.

It runs before error feedback, on the worker only (the server's chain skips
momentum, compressor_registry.cc:40-56):

    m = mu * m + g
    g' = g + mu * m
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from byteps_tpu_torch.compression.base import Compressor


class NesterovMomentum(Compressor):
    def __init__(self, inner: Compressor, mu: float = 0.9) -> None:
        super().__init__(inner.size)
        self.inner = inner
        self.mu = float(mu)
        self.m: Optional[np.ndarray] = None

    def compress(self, grad: np.ndarray) -> bytes:
        grad = np.ascontiguousarray(grad, dtype=np.float32)
        if self.m is None:
            self.m = np.zeros_like(grad)
        self.m = self.mu * self.m + grad
        return self.inner.compress(grad + self.mu * self.m)

    def decompress(self, payload: bytes, n: int) -> np.ndarray:
        return self.inner.decompress(payload, n)

    def sum_into(self, payload: bytes, acc: np.ndarray) -> None:
        self.inner.sum_into(payload, acc)

    def wire_nbytes(self) -> int:
        return self.inner.wire_nbytes()

    @property
    def wire_static(self) -> bool:
        """The wrapped codec's: the decorator does not change the wire."""
        return self.inner.wire_static
