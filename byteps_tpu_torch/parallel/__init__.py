"""Data parallelism: over the PS plane (``DistributedDataParallel``), and
in two levels, the host's process group then the PS
(``HybridDataParallel``).  Attention runs on one device (sequence
parallelism is a later slice)."""

from byteps_tpu_torch.parallel.distributed import DistributedDataParallel
from byteps_tpu_torch.parallel.hybrid import HybridDataParallel

__all__ = ["DistributedDataParallel", "HybridDataParallel"]
