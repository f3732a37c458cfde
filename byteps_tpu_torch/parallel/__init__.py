"""Data parallelism over the PS plane (``DistributedDataParallel``), and
attention on one device (sequence parallelism is a later slice)."""

from byteps_tpu_torch.parallel.distributed import DistributedDataParallel

__all__ = ["DistributedDataParallel"]
