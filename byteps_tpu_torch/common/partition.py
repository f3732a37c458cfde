"""Tensor partitioner: a flat tensor becomes contiguous element ranges of
at most ``BYTEPS_PARTITION_BYTES`` each, every one with its own key
(PartitionTensor, operations.cc:140-180).  The same ranges and keys as
``byteps_tpu.common.partition``, so a server fleet sees identical keys from
workers of either package."""

from __future__ import annotations

from typing import List

import numpy as np

from byteps_tpu_torch.common.registry import MAX_PARTS_PER_TENSOR, TensorContext
from byteps_tpu_torch.common.types import Partition


def partition_elements(
    num_elements: int, itemsize: int, partition_bytes: int, alignment: int = 64
) -> List[tuple]:
    """[(offset, length), ...]: every partition but the last holds
    ``partition_bytes`` rounded down to a multiple of ``alignment`` bytes,
    so every partition starts aligned."""
    if num_elements == 0:
        return []
    per_part = max(1, partition_bytes // itemsize)
    elems_per_align = max(1, alignment // itemsize)
    if per_part > elems_per_align:
        per_part = (per_part // elems_per_align) * elems_per_align
    parts = []
    off = 0
    while off < num_elements:
        ln = min(per_part, num_elements - off)
        parts.append((off, ln))
        off += ln
    if len(parts) > MAX_PARTS_PER_TENSOR:
        raise ValueError(
            f"{len(parts)} partitions exceeds the 2^16 key range per tensor "
            f"(operations.cc:306); raise BYTEPS_PARTITION_BYTES"
        )
    return parts


def partition_tensor(
    ctx: TensorContext, num_elements: int, itemsize: int, partition_bytes: int
) -> List[Partition]:
    """Keyed partitions of a declared tensor, recorded on its context."""
    parts = [
        Partition(key=ctx.key_for_part(i), offset=off, length=ln)
        for i, (off, ln) in enumerate(
            partition_elements(num_elements, itemsize, partition_bytes)
        )
    ]
    ctx.partitions = parts
    return parts


def check_rowsparse_shapes(idx_shape: tuple, vals_shape: tuple) -> None:
    """The shape check of :func:`validate_rowsparse` alone (no read of the
    indices, so no stall on a device)."""
    if len(idx_shape) != 1 or len(vals_shape) != 2 or vals_shape[0] != idx_shape[0]:
        raise ValueError(
            f"rowsparse wants indices (n,), values (n, row_len); got "
            f"{tuple(idx_shape)} / {tuple(vals_shape)}"
        )


def validate_rowsparse(indices, values, total_rows: int):
    """The checks of a row-sparse push_pull, with the reference's errors
    and messages: ``indices`` of shape (n,), ``values`` (n, row_len), every
    index in [0, total_rows).  numpy in, numpy out: (int64 indices,
    float32 rows), contiguous.  Torch tensors stay tensors on their device
    (int64, float32); on a CUDA device the range check reads the minimum
    and maximum in one transfer, the call's one stall."""
    import torch

    if isinstance(indices, torch.Tensor):
        idx = indices.detach().to(torch.int64).contiguous()
        vals = torch.as_tensor(values).detach().to(torch.float32).contiguous()
        idx_shape, vals_shape = tuple(idx.shape), tuple(vals.shape)
    else:
        idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
        vals = np.ascontiguousarray(np.asarray(values, dtype=np.float32))
        idx_shape, vals_shape = idx.shape, vals.shape
    check_rowsparse_shapes(idx_shape, vals_shape)
    if idx_shape[0]:
        if isinstance(idx, torch.Tensor):
            lo, hi = (int(v) for v in torch.stack(torch.aminmax(idx)).tolist())
        else:
            lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= total_rows:
            raise ValueError(f"rowsparse indices out of range [0, {total_rows})")
    return idx, vals
