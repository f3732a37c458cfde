"""Core value types: operation status, the degraded-step error, and the
wire dtype ids (the same numbers as ``byteps_tpu.common.types.DataType``)
for torch dtypes."""

from __future__ import annotations

import dataclasses
import enum

import torch


class DataType(enum.IntEnum):
    """Wire dtype ids, mshadow-ordered (bfloat16 appended)."""

    FLOAT32 = 0
    FLOAT64 = 1
    FLOAT16 = 2
    UINT8 = 3
    INT32 = 4
    INT8 = 5
    INT64 = 6
    BFLOAT16 = 7


_TORCH_TO_DT = {
    torch.float32: DataType.FLOAT32,
    torch.float64: DataType.FLOAT64,
    torch.float16: DataType.FLOAT16,
    torch.uint8: DataType.UINT8,
    torch.int32: DataType.INT32,
    torch.int8: DataType.INT8,
    torch.int64: DataType.INT64,
    torch.bfloat16: DataType.BFLOAT16,
}


def to_datatype(dtype: torch.dtype) -> DataType:
    """Map a torch dtype to the wire ``DataType``."""
    try:
        return _TORCH_TO_DT[dtype]
    except KeyError as e:
        raise TypeError(f"unsupported dtype: {dtype!r}") from e


class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5
    # the data plane degraded under the operation; retrying the step is safe
    DEGRADED = 6


class DegradedError(RuntimeError):
    """A push_pull failed because the PS data plane degraded mid-flight.
    Resubmitting the same step is safe."""


@dataclasses.dataclass
class Status:
    """Operation status."""

    type: StatusType = StatusType.OK
    reason: str = ""

    @staticmethod
    def OK() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def Aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def Degraded(msg: str) -> "Status":
        return Status(StatusType.DEGRADED, msg)

    def ok(self) -> bool:
        return self.type == StatusType.OK
