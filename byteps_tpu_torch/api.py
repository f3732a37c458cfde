"""Public Horovod-style API on torch tensors.

The same names and semantics as ``byteps_tpu.api``.  With one worker,
``push_pull`` is the identity: the tensor handed in, on its device, is the
result.  In distributed mode (more than one worker, or
``BYTEPS_FORCE_DISTRIBUTED=1``) it goes through the PS plane: the engine
partitions the tensor, pushes it to the servers and pulls back the sum,
averaged over the workers when ``average``.  The result lies on the input's
device; for a CUDA tensor, :func:`synchronize` makes the caller's current
stream wait for it.

With a local group (a global mesh: ``init()`` under the launcher, which
starts one process per GPU) ``push_pull`` is host-level, BytePS's own
topology: an all-reduce in the local group, the local root's PS
push_pull of that sum across hosts, and a broadcast from the root, which
:func:`synchronize` runs; ``average`` divides by ``local_size() × size()``.
Every local rank must then start and synchronize its push_pulls in the
same order, as the hooks of ``DistributedOptimizer`` and
``DistributedDataParallel`` do.  ``rank()`` and ``size()`` are the host's
worker rank and the number of hosts, as in ``byteps_tpu``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, Mapping, Optional, Tuple, Union

import torch

from byteps_tpu_torch.comm.mesh import get_global_mesh
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.registry import get_registry
from byteps_tpu_torch.common.types import divide
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
    """The worker's rank: the scheduler's in distributed mode; with a local
    group, the host's."""
    st = get_state()
    if st.host is not None:
        return st.host[0]
    client = st.ps_client
    if client is not None and client.rank is not None:
        return client.rank
    cfg = get_config()
    return cfg.global_rank if cfg.global_rank is not None else cfg.worker_id


def size() -> int:
    """The number of workers (hosts): the scheduler's book in distributed
    mode."""
    st = get_state()
    if st.host is not None:
        return st.host[1]
    client = st.ps_client
    if client is not None:
        return client.num_workers
    return get_config().num_worker


def local_rank() -> int:
    return get_config().local_rank


def local_size() -> int:
    return get_config().local_size


def declare_tensor(name: str, **kwargs: Any) -> int:
    """Declare a named tensor ahead of communication; returns its stable
    declared key.  Dict kwargs are canonicalized to JSON strings.  A codec
    config the port cannot run raises here, not at the first push."""
    from byteps_tpu_torch.compression.registry import check_supported, parse_codec_config

    cfg = parse_codec_config(kwargs, 1)
    if cfg is not None:
        check_supported(cfg)
    if kwargs.get("byteps_server_opt") not in (None, "", "0", "false", "off"):
        from byteps_tpu_torch.common.config import unported

        raise unported("server_opt", f"byteps_server_opt={kwargs['byteps_server_opt']}")
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
    result :func:`synchronize` returns (same shape, dtype and device).
    With a local group: the all-reduce in the group now, the root's PS
    push_pull of the sum, and the broadcast from the root in
    :func:`synchronize` (a handle of a local rank other than the root
    polls done once the group's sum is in)."""
    return host_push_pull_async(tensor, name, average, priority, version, get_global_mesh())


def host_push_pull_async(tensor: torch.Tensor, name: str, average: bool, priority: int,
                         version: int, mesh) -> int:
    """:func:`push_pull_async` over the local group ``mesh`` (None: this
    process alone), the one implementation of the three levels, which
    ``parallel.HybridDataParallel`` runs on its mesh too."""
    st = require_state()
    if mesh is None:
        return _ps_push_pull_async(st, tensor, name, average, priority, version)
    from byteps_tpu_torch.comm import collectives

    local = tensor if tensor.device.type == mesh.device.type else tensor.to(mesh.device)
    summed = collectives.push_pull(local, average=False, mesh=mesh)  # level 1
    if mesh.rank == 0:
        handle = _ps_push_pull_async(st, summed, name, False, priority, version)  # level 2
    else:
        get_registry().declare(name)
        handle = st.handles.allocate()
        st.handles.mark_done(handle, summed)
    st.host_level[handle] = (mesh, average, tensor.device)
    return handle


def _ps_push_pull_async(st, tensor: torch.Tensor, name: str, average: bool, priority: int,
                        version: int) -> int:
    """push_pull across workers through the PS plane alone, the identity
    with one worker."""
    get_registry().declare(name)
    handle = st.handles.allocate()
    if st.engine is None:
        st.handles.mark_done(handle, tensor)  # one worker: identity
        return handle
    st.engine.submit(name=name, tensor=tensor, average=average,
                     priority=priority, version=version, handle=handle)
    return handle


def poll(handle: int) -> bool:
    return require_state().handles.poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Wait for a push_pull and return its result.  A result on a CUDA
    device is returned once the caller's current stream waits for it."""
    from byteps_tpu_torch.core.engine import DeviceResult

    st = require_state()
    out = st.handles.wait_and_clear(handle)
    if isinstance(out, DeviceResult):
        stream = torch.cuda.current_stream(out.tensor.device)
        stream.wait_event(out.event)
        out.tensor.record_stream(stream)
        out = out.tensor
    host_level = st.host_level.pop(handle, None)
    if host_level is not None:
        from byteps_tpu_torch.comm import collectives

        mesh, average, device = host_level
        out = collectives.broadcast(out, root=0, mesh=mesh)  # level 3
        if average and out.is_floating_point():
            out = divide(out, mesh.size * size())
        out = out.to(device)
    return out


def push_pull(
    tensor: torch.Tensor, name: str, average: bool = True, priority: int = 0
) -> torch.Tensor:
    """Synchronous push_pull (sum over workers, averaged when ``average``).
    ``name`` is the cross-process aggregation key."""
    return synchronize(push_pull_async(tensor, name, average=average, priority=priority))


def push_pull_inplace(
    tensor: torch.Tensor, name: str, average: bool = True, priority: int = 0
) -> torch.Tensor:
    """push_pull written back into ``tensor`` (in its dtype); returns it."""
    out = push_pull(tensor, name, average=average, priority=priority)
    if out is not tensor:
        with torch.no_grad():
            tensor.copy_(out.view_as(tensor))
    return tensor


def set_compression_lr(lr: float) -> None:
    """Feed the optimizer's learning rate to every error-feedback chain, on
    this worker and on the servers (the reference's lr.s file,
    vanilla_error_feedback.h:44-58).  Nothing to do with one worker."""
    st = require_state()
    if st.engine is not None:
        st.engine.set_compression_lr(lr)


def _one_worker(st) -> bool:
    """No PS plane and no local group: this process holds every value."""
    return st.engine is None and get_global_mesh() is None


def _is_root(root_rank: int) -> bool:
    """The process whose values a broadcast sends: worker ``root_rank``,
    and on that host local rank 0."""
    mesh = get_global_mesh()
    return rank() == root_rank and (mesh is None or mesh.rank == 0)


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
    root's values already; in distributed mode every other worker pushes
    zeros and an unaveraged sum leaves root's values everywhere
    (torch/__init__.py:268-299).  All pushes start before the first wait."""
    st = require_state()
    items = _named_tensors(params)
    if _one_worker(st):
        return params
    root = _is_root(root_rank)
    handles = []
    for name, t in items:
        src = t.detach() if root else torch.zeros_like(t)
        handles.append((t, push_pull_async(src, name=f"Parameter.{name}", average=False)))
    with torch.no_grad():
        for t, h in handles:
            t.copy_(synchronize(h))
    return params


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "obj") -> Any:
    """Broadcast a picklable object from ``root_rank``: its length, then
    its bytes, each as an unaveraged sum to which the other workers add
    zeros."""
    import pickle

    if _one_worker(require_state()):
        return obj
    payload = pickle.dumps(obj) if _is_root(root_rank) else b""
    total = int(push_pull(torch.tensor([len(payload)], dtype=torch.int64),
                          name=f"{name}.len", average=False)[0])
    buf = torch.zeros(total, dtype=torch.uint8)
    if payload:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    out = push_pull(buf, name=f"{name}.data", average=False)
    return pickle.loads(out.numpy().tobytes())


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer, root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state dict on every worker
    (torch/__init__.py:302-466): pickled by :func:`broadcast_object` with
    its tensors on the host; ``load_state_dict`` puts them back on each
    parameter's device."""
    if _one_worker(require_state()):
        return
    host = _map_tensors(optimizer.state_dict(), lambda t: t.detach().cpu())
    optimizer.load_state_dict(broadcast_object(host, root_rank=root_rank, name="opt_state"))


def _map_tensors(obj: Any, fn) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def push_pull_rowsparse_async(indices: Any, values: Any, name: str, total_rows: int,
                              average: bool = True, priority: int = 0) -> int:
    """Row-sparse push_pull (``byteps_tpu.api.push_pull_rowsparse_async``):
    not ported yet."""
    from byteps_tpu_torch.common.config import unported

    raise unported("rowsparse", f"push_pull_rowsparse of {name!r}")


def push_pull_rowsparse(indices: Any, values: Any, name: str, total_rows: int,
                        average: bool = True, priority: int = 0) -> Any:
    return synchronize(push_pull_rowsparse_async(
        indices, values, name, total_rows, average=average, priority=priority))
