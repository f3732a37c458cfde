"""The error-feedback decorator (error_feedback.h:46-90), as
``byteps_tpu.compression.error_feedback``.

``compress(g)`` corrects the gradient with the residual of the previous
round scaled by the learning rate (``corrected = g + lr * e``), compresses
the corrected value, and keeps ``e = corrected - decompress(payload)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from byteps_tpu_torch.compression.base import Compressor


class VanillaErrorFeedback(Compressor):
    """Registered "vanilla_ef" in the reference
    (vanilla_error_feedback.h:44-58).  The learning rate comes through
    :meth:`set_lr`, the wire's replacement for the reference's lr.s file."""

    def __init__(self, inner: Compressor) -> None:
        super().__init__(inner.size)
        self.inner = inner
        self.error: Optional[np.ndarray] = None
        self.lr = 1.0

    def set_lr(self, lr: float) -> None:
        self.lr = float(lr)

    def compress(self, grad: np.ndarray) -> bytes:
        grad = np.ascontiguousarray(grad, dtype=np.float32)
        if self.error is None:
            self.error = np.zeros_like(grad)
        corrected = grad + self.lr * self.error
        payload = self.inner.compress(corrected)
        self.error = self.inner.update_error(corrected, payload)
        return payload

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
