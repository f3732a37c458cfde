"""byteps_tpu_torch — the port of byteps_tpu to PyTorch and CUDA.

A BytePS-style data-parallel training framework for NVIDIA Hopper GPUs,
with the same Horovod-style surface as ``byteps_tpu``:

    init / shutdown / suspend / resume
    rank / size / local_rank / local_size
    declare_tensor / push_pull / push_pull_async / push_pull_inplace / poll /
    synchronize
    DistributedOptimizer / Compression / set_compression_lr
    get_robustness_counters
    broadcast_parameters / broadcast_optimizer_state / broadcast_object
    parallel.DistributedDataParallel / CrossBarrier

With one worker ``push_pull`` is the identity.  In distributed mode
(``DMLC_NUM_WORKER>1`` or ``BYTEPS_FORCE_DISTRIBUTED=1``) ``init()``
registers with the scheduler and gradients go through the PS plane to CPU
servers (``python -m byteps_tpu_torch.server``), optionally compressed:
onebit, topk or dithering on the card, or any codec with error feedback
and Nesterov momentum on the host.  The flagship transformer is in
``byteps_tpu_torch.models.transformer``; its attention runs on the
hand-written CUDA kernels in ``byteps_tpu_torch.ops``.  The package
imports torch and numpy, never JAX or ``byteps_tpu``.
"""

from byteps_tpu_torch.api import (
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    declare_tensor,
    device,
    get_robustness_counters,
    init,
    local_rank,
    local_size,
    poll,
    push_pull,
    push_pull_async,
    push_pull_inplace,
    push_pull_rowsparse,
    push_pull_rowsparse_async,
    rank,
    resume,
    set_compression_lr,
    shutdown,
    size,
    suspend,
    synchronize,
)
from byteps_tpu_torch.common.config import Config, get_config
from byteps_tpu_torch.common.registry import TensorRegistry, get_registry
from byteps_tpu_torch.common.types import DegradedError
from byteps_tpu_torch.compression.base import Compression
from byteps_tpu_torch.cross_barrier import CrossBarrier
from byteps_tpu_torch.optim import DistributedOptimizer
from byteps_tpu_torch import parallel  # bps.parallel.DistributedDataParallel

__version__ = "0.1.0"

__all__ = [
    "Compression",
    "Config",
    "CrossBarrier",
    "DegradedError",
    "DistributedOptimizer",
    "TensorRegistry",
    "broadcast_object",
    "broadcast_optimizer_state",
    "broadcast_parameters",
    "declare_tensor",
    "device",
    "get_config",
    "get_registry",
    "get_robustness_counters",
    "init",
    "local_rank",
    "local_size",
    "parallel",
    "poll",
    "push_pull",
    "push_pull_async",
    "push_pull_inplace",
    "push_pull_rowsparse",
    "push_pull_rowsparse_async",
    "rank",
    "resume",
    "set_compression_lr",
    "shutdown",
    "size",
    "suspend",
    "synchronize",
]
