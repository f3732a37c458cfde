"""Public Horovod-style API on torch tensors.

The same names and semantics as ``byteps_tpu.api``.  With one worker,
``push_pull`` is the identity: the tensor handed in, on its device, is the
result.  A distributed topology raises at :func:`init` until the port has
its PS plane.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, Mapping, Optional, Tuple, Union

import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.registry import get_registry
from byteps_tpu_torch.core.state import get_state, init_state, require_state, shutdown_state


def init(device: Union[str, torch.device, None] = None) -> None:
    """Initialize the runtime and bind a device: ``cuda:<local_rank>``
    unless ``device`` names one.  Raises when no CUDA device is available
    and none was named."""
    init_state(device)


def shutdown() -> None:
    shutdown_state()


def suspend() -> None:
    """Elastic suspend: tear down but keep tensor declarations, so a later
    :func:`resume` re-assigns identical keys."""
    shutdown_state()


def resume(num_workers: Optional[int] = None, global_rank: Optional[int] = None) -> None:
    """Elastic resume: rewrite the topology env, replay tensor declarations
    in their original order, and re-initialize on the same device."""
    if num_workers is not None:
        os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    if global_rank is not None:
        os.environ["BYTEPS_GLOBAL_RANK"] = str(global_rank)
    get_registry().redeclare_all()
    init_state(get_state().device)


def device() -> torch.device:
    """The device :func:`init` bound."""
    return require_state().device


def rank() -> int:
    cfg = get_config()
    return cfg.global_rank if cfg.global_rank is not None else cfg.worker_id


def size() -> int:
    return get_config().num_worker


def local_rank() -> int:
    return get_config().local_rank


def local_size() -> int:
    return get_config().local_size


def declare_tensor(name: str, **kwargs: Any) -> int:
    """Declare a named tensor ahead of communication; returns its stable
    declared key.  Dict kwargs are canonicalized to JSON strings."""
    ctx = get_registry().declare(name, **{
        k: (json.dumps(v, sort_keys=True) if isinstance(v, dict) else str(v))
        for k, v in kwargs.items()
    })
    return ctx.declared_key


def push_pull_async(
    tensor: torch.Tensor,
    name: str,
    average: bool = True,
    priority: int = 0,
    version: int = 0,
) -> int:
    """Start a cross-worker push_pull; returns a pollable handle whose
    result :func:`synchronize` returns (same shape, dtype and device)."""
    st = require_state()
    get_registry().declare(name)
    handle = st.handles.allocate()
    # init() refuses a distributed topology, so one worker: identity
    st.handles.mark_done(handle, tensor)
    return handle


def poll(handle: int) -> bool:
    return require_state().handles.poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    return require_state().handles.wait_and_clear(handle)


def push_pull(
    tensor: torch.Tensor, name: str, average: bool = True, priority: int = 0
) -> torch.Tensor:
    """Synchronous push_pull (sum over workers, averaged when ``average``).
    ``name`` is the cross-process aggregation key."""
    return synchronize(push_pull_async(tensor, name, average=average, priority=priority))


def _named_tensors(params: Any) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        raise TypeError("pass module.state_dict() or module.named_parameters()")
    items = list(params.items()) if isinstance(params, Mapping) else list(params)
    for item in items:
        if not (isinstance(item, tuple) and len(item) == 2
                and isinstance(item[1], torch.Tensor)):
            raise TypeError(
                "broadcast_parameters takes a state dict or (name, tensor) pairs"
            )
    return items


def broadcast_parameters(params: Any, root_rank: int = 0) -> Any:
    """Sync parameters from ``root_rank`` to every worker, in place: a
    state dict or a list of (name, tensor) pairs such as
    ``module.named_parameters()``.  Returns ``params``.  One worker holds
    root's values already."""
    require_state()
    _named_tensors(params)
    return params


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "obj") -> Any:
    """Broadcast a picklable object from ``root_rank``."""
    require_state()
    return obj
