"""byteps_tpu_torch — the port of byteps_tpu to PyTorch and CUDA.

A BytePS-style data-parallel training framework for NVIDIA Hopper GPUs,
with the same Horovod-style surface as ``byteps_tpu``:

    init / shutdown / suspend / resume
    rank / size / local_rank / local_size
    declare_tensor / push_pull / push_pull_async / push_pull_inplace / poll /
    synchronize / push_pull_rowsparse / push_pull_rowsparse_async
    DistributedOptimizer / distributed_optimizer / Compression / set_compression_lr
    get_config / reset_config
    get_robustness_counters / get_metrics / get_metrics_text / get_pushpull_speed
    broadcast_parameters / broadcast_optimizer_state / broadcast_object
    parallel.DistributedDataParallel / CrossBarrier / CrossBarrierOptimizer

With one worker ``push_pull`` is the identity.  In distributed mode
(``DMLC_NUM_WORKER>1`` or ``BYTEPS_FORCE_DISTRIBUTED=1``) ``init()``
registers with the scheduler and gradients go through the PS plane to CPU
servers (``python -m byteps_tpu_torch.server``) over the tcp, uds or shm
van, optionally compressed: onebit, topk or dithering on the card, or any
codec with error feedback and Nesterov momentum on the host, with lossless
wire frames for what stays raw.  An embedding's gradient may go row-sparse
(``push_pull_rowsparse``).  Tracing, the Prometheus endpoint, the flight
recorder's bundles and ``byteps_tpu_torch.profiler`` make the
observability plane (docs/observability.md).  The flagship transformer is in
``byteps_tpu_torch.models.transformer``; its attention runs on the
hand-written CUDA kernels in ``byteps_tpu_torch.ops``.  The package
imports torch and numpy, never JAX or ``byteps_tpu``.  Its names load on
first use, so that a server or scheduler process (``python -m
byteps_tpu_torch.server``), which holds no tensor, starts without torch.
"""

import importlib

__version__ = "0.1.0"

#: public name -> the module that defines it
_EXPORTS = {
    **{name: "byteps_tpu_torch.api" for name in (
        "broadcast_object", "broadcast_optimizer_state", "broadcast_parameters",
        "declare_tensor", "device", "get_metrics", "get_metrics_text",
        "get_pushpull_speed", "get_robustness_counters", "init", "local_rank",
        "local_size", "poll", "push_pull", "push_pull_async", "push_pull_inplace",
        "push_pull_rowsparse", "push_pull_rowsparse_async", "rank", "resume",
        "set_compression_lr", "shutdown", "size", "suspend", "synchronize")},
    "Config": "byteps_tpu_torch.common.config",
    "get_config": "byteps_tpu_torch.common.config",
    "reset_config": "byteps_tpu_torch.common.config",
    "TensorRegistry": "byteps_tpu_torch.common.registry",
    "get_registry": "byteps_tpu_torch.common.registry",
    "DegradedError": "byteps_tpu_torch.common.types",
    "Compression": "byteps_tpu_torch.compression.base",
    "CrossBarrier": "byteps_tpu_torch.cross_barrier",
    "CrossBarrierOptimizer": "byteps_tpu_torch.cross_barrier",
    "DistributedOptimizer": "byteps_tpu_torch.optim",
    "distributed_optimizer": "byteps_tpu_torch.optim",
}


def __getattr__(name: str):
    if name == "parallel":  # bps.parallel.DistributedDataParallel
        value = importlib.import_module("byteps_tpu_torch.parallel")
    elif name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    else:
        raise AttributeError(f"module 'byteps_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = [
    "Compression",
    "Config",
    "CrossBarrier",
    "CrossBarrierOptimizer",
    "DegradedError",
    "DistributedOptimizer",
    "TensorRegistry",
    "broadcast_object",
    "broadcast_optimizer_state",
    "broadcast_parameters",
    "declare_tensor",
    "device",
    "distributed_optimizer",
    "get_config",
    "get_metrics",
    "get_metrics_text",
    "get_pushpull_speed",
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
    "reset_config",
    "resume",
    "set_compression_lr",
    "shutdown",
    "size",
    "suspend",
    "synchronize",
]
