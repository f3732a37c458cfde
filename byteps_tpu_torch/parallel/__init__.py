"""Data parallelism: over the PS plane (``DistributedDataParallel``), and
in two levels, the host's process group then the PS
(``HybridDataParallel``, over sharded parameters too).  Model parallelism
over a (dp, pp, sp, tp) mesh: ``mesh_utils`` lays the group out,
``ring_attention`` and ``ulysses`` shard the sequence, and
``models.transformer`` runs tp, sp and pp."""

from byteps_tpu_torch.parallel.distributed import DistributedDataParallel
from byteps_tpu_torch.parallel.hybrid import HybridDataParallel

__all__ = ["DistributedDataParallel", "HybridDataParallel"]
