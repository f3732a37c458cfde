"""Core value types: operation status, the degraded-step error, the wire
dtype ids (the same numbers as ``byteps_tpu.common.types.DataType``) for
torch and numpy dtypes, the pipeline stages, the request flavours and
their Cantor-paired command ids, and the engine's per-partition task.
torch is imported on first use, so that a server or scheduler process,
which never holds a tensor, starts without it."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np


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


#: torch dtype name -> wire type
_TORCH_TO_DT = {
    "torch.float32": DataType.FLOAT32,
    "torch.float64": DataType.FLOAT64,
    "torch.float16": DataType.FLOAT16,
    "torch.uint8": DataType.UINT8,
    "torch.int32": DataType.INT32,
    "torch.int8": DataType.INT8,
    "torch.int64": DataType.INT64,
    "torch.bfloat16": DataType.BFLOAT16,
}


_NP_TO_DT = {
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.int64): DataType.INT64,
}

#: numpy dtype that holds each wire type's bytes: bfloat16 has no numpy
#: type without ml_dtypes, so its elements travel as uint16 bit patterns
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}
_DT_TO_NP[DataType.BFLOAT16] = np.dtype(np.uint16)


def to_datatype(dtype: Any) -> DataType:
    """Map a torch or numpy dtype to the wire ``DataType``."""
    try:
        if type(dtype).__module__ == "torch" and type(dtype).__name__ == "dtype":
            return _TORCH_TO_DT[str(dtype)]
        if str(dtype) == "bfloat16":
            return DataType.BFLOAT16
        return _NP_TO_DT[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise TypeError(f"unsupported dtype: {dtype!r}") from e


def storage_numpy_dtype(dt: DataType) -> np.dtype:
    """The numpy dtype whose bytes are a wire type's elements (uint16 for
    bfloat16)."""
    return _DT_TO_NP[DataType(dt)]


def is_floating(dt: DataType) -> bool:
    return DataType(dt) in (
        DataType.FLOAT32, DataType.FLOAT64, DataType.FLOAT16, DataType.BFLOAT16,
    )


def divide(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` rounded as a true division on every device.  The divisor is
    a tensor of ``t``'s dtype on ``t``'s device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python scalar (or of a CPU 0-d
    tensor), which rounds otherwise than the reference's division once
    ``n`` is not a power of two."""
    import torch

    return t / torch.full_like(t, n)


class QueueType(enum.IntEnum):
    """Host pipeline stages, numbered as the reference's (common.h:88-102);
    the port's engine runs COPYD2H, COMPRESS, PUSH, PULL, DECOMPRESS and
    COPYH2D, and FUSE (``byteps_tpu``'s addition): a small partition takes
    FUSE in place of PUSH and leaves in one multi-key Op.FUSED frame."""

    COORDINATE_REDUCE = 0
    REDUCE = 1
    COPYD2H = 2
    PCIE_REDUCE = 3
    COMPRESS = 4
    PUSH = 5
    PULL = 6
    DECOMPRESS = 7
    COPYH2D = 8
    COORDINATE_PUSH = 9
    COORDINATE_BROADCAST = 10
    BROADCAST = 11
    FUSE = 12


class RequestType(enum.IntEnum):
    """PS request flavours (common.h:267-271)."""

    DEFAULT_PUSH_PULL = 0
    ROW_SPARSE_PUSH_PULL = 1
    COMPRESSED_PUSH_PULL = 2


def get_command_type(request_type: RequestType, dtype: int) -> int:
    """Cantor pairing of (request, dtype) -> command id (common.cc:98)."""
    a, b = int(request_type), int(dtype)
    return (a + b) * (a + b + 1) // 2 + b


def decode_command_type(cmd: int) -> tuple:
    """Inverse Cantor pairing -> (RequestType, dtype id)."""
    w = int(((8 * cmd + 1) ** 0.5 - 1) / 2)
    t = w * (w + 1) // 2
    b = cmd - t
    return RequestType(w - b), b


@dataclasses.dataclass
class Partition:
    """One contiguous [offset, offset + length) element range of a declared
    tensor, with its own communication key (operations.cc:306-317)."""

    key: int
    offset: int
    length: int


#: bit position of the job id inside a wire key: [job 16][declared key
#: 32][partition 16], job 0 the single-tenant namespace
JOB_SHIFT = 48
MAX_JOB_ID = (1 << 16) - 1


def job_of_key(key: int) -> int:
    """The job a wire key is namespaced under (0: the default)."""
    return (key >> JOB_SHIFT) & MAX_JOB_ID


@dataclasses.dataclass
class TensorTableEntry:
    """One in-flight partition of a push_pull (common.h:221-264): the unit
    the engine's stage queues schedule."""

    tensor_name: str
    key: int
    priority: int = 0
    version: int = 0
    offset: int = 0
    length: int = 0
    queue_list: list = dataclasses.field(default_factory=list)
    #: host bytes of the partition: a numpy view of the source, or of the
    #: pinned staging copy of a device tensor
    cpubuff: Optional[np.ndarray] = None
    #: codec wire payload (onebit: [f32 scale][u32 words])
    compressed: Optional[bytes] = None
    context: Any = None
    #: once-guard: a task may be failed from two racing paths
    failed: bool = False
    #: when the task entered its current stage's queue: time.monotonic()
    #: for the dwell, time.time() for the stage's span
    enqueued_at: float = 0.0
    enqueued_wall: float = 0.0
    #: the job's trace id and this task's span id, carried by the task's
    #: frames (0: tracing off)
    trace_id: int = 0
    span_id: int = 0
    #: a fused member's slot of the fused reply, which PULL delivers
    #: locally instead of pulling
    fused_reply: Optional[bytes] = None
    #: a fusion pack's group task: its members passed their round gates
    #: at the FUSE queue, so the PUSH queue does not gate the group
    gate_exempt: bool = False
    #: a FUSE-routed task that has not reached the fusion buffer yet
    fuse_staged: bool = False
    #: a raw partition of a device-lane job: the host tensor its pull
    #: lands in, moved to the device in COPYH2D
    raw_out: Any = None
    #: the job the key is namespaced under (its top 16 bits, unless given):
    #: the stage queues' weighted fair queuing and per-job credits key on it
    job: Optional[int] = None

    def __post_init__(self) -> None:
        if self.job is None:
            self.job = job_of_key(self.key)


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
