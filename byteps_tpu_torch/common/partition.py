"""Tensor partitioner: a flat tensor becomes contiguous element ranges of
at most ``BYTEPS_PARTITION_BYTES`` each, every one with its own key
(PartitionTensor, operations.cc:140-180).  The same ranges and keys as
``byteps_tpu.common.partition``, so a server fleet sees identical keys from
workers of either package."""

from __future__ import annotations

from typing import List

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
