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

When the data plane degrades past its retries and its in-place heal
(docs/robustness.md), :func:`synchronize` raises
:class:`~byteps_tpu_torch.common.types.DegradedError`; with a local group
the root tells every local rank, so all of them raise.  With
``BYTEPS_DEGRADED_STEP_RETRIES`` > 0 the synchronous :func:`push_pull`
heals the step in place first (``PipelineEngine.heal_degraded``), and
failing that submits it again through the init barrier.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable, Mapping, Optional, Tuple, Union

import torch

from byteps_tpu_torch.comm.mesh import get_global_mesh
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.registry import get_registry
from byteps_tpu_torch.common.types import DegradedError, divide
from byteps_tpu_torch.core.state import get_state, init_state, require_state, shutdown_state


def init(device: Union[str, torch.device, None] = None) -> None:
    """Initialize the runtime and bind a device: ``cuda:<local_rank>``
    unless ``device`` names one.  Raises when no CUDA device is available
    and none was named."""
    init_state(device)


def shutdown() -> None:
    shutdown_state()


def suspend() -> None:
    """Elastic suspend: tear down the engine and the PS client, but keep the
    tensor declarations, the node uid and the host's group, so that a later
    :func:`resume` re-assigns identical keys and rejoins the live cluster as
    the same member (docs/elasticity.md).  Under the launcher every local
    rank suspends and resumes; only the root is a PS member."""
    shutdown_state(keep_mesh=True)


def resume(num_workers: Optional[int] = None, num_servers: Optional[int] = None,
           global_rank: Optional[int] = None) -> None:
    """Elastic resume: rewrite the topology env (``DMLC_NUM_WORKER``,
    ``DMLC_NUM_SERVER``, ``BYTEPS_GLOBAL_RANK``), replay tensor declarations
    in their original order, and re-initialize on the same device.  Against
    a live scheduler the worker rejoins by its uid: a changed worker or
    server count resizes the job (a server scale-up returns once the new
    server registered), and the scheduler releases the rejoin's barrier at
    once.  Each key runs its init barrier again on first use.

    Under ``BYTEPS_ELASTIC_RESHARD=1`` a worker that was not suspended
    resizes the job live instead (``PSClient.request_resize``): the servers
    migrate the re-homed keys, and no init barrier runs again."""
    if num_workers is not None:
        os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    if num_servers is not None:
        os.environ["DMLC_NUM_SERVER"] = str(num_servers)
    if global_rank is not None:
        os.environ["BYTEPS_GLOBAL_RANK"] = str(global_rank)
    st = get_state()
    if st.initialized and st.ps_client is not None and st.ps_client.reshard:
        st.ps_client.request_resize(num_workers=num_workers, num_servers=num_servers)
        return
    get_registry().redeclare_all()
    init_state(get_state().device)


def device() -> torch.device:
    """The device :func:`init` bound."""
    return require_state().device


def rank() -> int:
    """The worker's rank: the scheduler's in distributed mode (a tenant's,
    within its job: ``PSClient.job_rank``); with a local group, the
    host's."""
    st = get_state()
    if st.host is not None:
        return st.host[0]
    client = st.ps_client
    if client is not None and client.rank is not None:
        return client.job_rank()
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
    config the port cannot run, or an unknown server-side rule, raises
    here, not at the first push.

    Profiles of the tensor's keys, over the process-wide knobs:
    ``byteps_async`` ("1"/"0") and ``byteps_staleness`` (the bounded
    staleness of its pulls, -1 unbounded); ``byteps_server_opt``
    ("sgd", "momentum", "adam", or an off spelling) and
    ``byteps_server_opt_hp`` (its hyperparameters, a dict or JSON): the
    servers run the rule, so the tensor's push_pull takes gradients and
    returns parameters (its first round, the seed, the parameters
    themselves)."""
    from byteps_tpu_torch.compression.registry import check_supported, parse_codec_config
    from byteps_tpu_torch.server.update_rules import RULE_NAMES, rule_name

    cfg = parse_codec_config(kwargs, 1)
    if cfg is not None:
        check_supported(cfg)
    rule = rule_name(kwargs.get("byteps_server_opt") or "")
    if rule is not None and rule not in RULE_NAMES:
        raise ValueError(f"unknown server update rule {rule!r} (have {RULE_NAMES})")
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
                         version: int, mesh, reduced: bool = False) -> int:
    """:func:`push_pull_async` over the local group ``mesh`` (None: this
    process alone), the one implementation of the three levels, which
    ``parallel.HybridDataParallel`` runs on its mesh too.  ``reduced``:
    ``tensor`` is the group's sum already (level 1 done)."""
    st = require_state()
    if mesh is None:
        return _ps_push_pull_async(st, tensor, name, average, priority, version)
    from byteps_tpu_torch.comm import collectives

    local = tensor if tensor.device.type == mesh.device.type else tensor.to(mesh.device)
    summed = local if reduced else collectives.push_pull(local, average=False, mesh=mesh)
    handle = None
    if mesh.rank == 0:
        try:
            handle = _ps_push_pull_async(st, summed, name, False, priority, version)  # level 2
        except ConnectionError as e:
            # the init barrier could not reach a server: the other local
            # ranks learn it in synchronize, as of a degraded push_pull
            from byteps_tpu_torch.common.types import Status

            handle = st.handles.allocate()
            st.handles.mark_done(handle, None, Status.Degraded(f"{name}: {e}"))
    else:
        get_registry().declare(name)
        handle = st.handles.allocate()
        st.handles.mark_done(handle, summed)
    st.host_level[handle] = (mesh, average, tensor.device, summed)
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


def _wait(st, handle: int) -> torch.Tensor:
    from byteps_tpu_torch.core.engine import DeviceResult

    out = st.handles.wait_and_clear(handle)
    if isinstance(out, DeviceResult):
        stream = torch.cuda.current_stream(out.tensor.device)
        stream.wait_event(out.event)
        out.tensor.record_stream(stream)
        out = out.tensor
    return out


def synchronize(handle: int) -> torch.Tensor:
    """Wait for a push_pull and return its result.  A result on a CUDA
    device is returned once the caller's current stream waits for it.
    With a local group, the root's broadcast of its result carries
    whether its PS push_pull came back: if not, every rank raises
    (DegradedError when the root's did)."""
    st = require_state()
    host_level = st.host_level.pop(handle, None)
    if host_level is None:
        return _wait(st, handle)
    try:
        out, err = _wait(st, handle), None
    except Exception as e:  # noqa: BLE001 - the group learns it first
        out, err = None, e
    code = 0 if err is None else 1 if isinstance(err, DegradedError) else 2
    code, out = _host_broadcast(out, code, host_level)
    if code:
        if err is None:
            err = (DegradedError if code == 1 else RuntimeError)(
                "push_pull failed: the local root's PS push_pull failed")
        err.host_level = host_level  # what a degraded-step heal needs
        raise err
    return _host_finish(out, host_level)


def _host_broadcast(out: Optional[torch.Tensor], code: int,
                    host_level: tuple) -> Tuple[int, torch.Tensor]:
    """Level 3: the root's result (its group's sum when it has none) and
    its status ``code`` in one broadcast, the code in a byte after the
    result's; the root's code and every rank's copy of the result."""
    from byteps_tpu_torch.comm import collectives

    mesh, _, _, summed = host_level
    src = (out if out is not None else summed).detach().contiguous()
    buf = torch.empty(src.numel() * src.element_size() + 1, dtype=torch.uint8,
                      device=mesh.device)
    if mesh.rank == 0:
        buf[:-1].copy_(src.reshape(-1).view(torch.uint8))
        buf[-1] = code
    buf = collectives.broadcast(buf, root=0, mesh=mesh)
    if mesh.rank:
        code = int(buf[-1])  # the other ranks must know before they return
    return code, buf[:-1].view(src.dtype).reshape(src.shape)


def _host_finish(out: torch.Tensor, host_level: tuple) -> torch.Tensor:
    """The broadcast result averaged over the group and every host, on
    the caller's device."""
    mesh, average, device, _ = host_level
    if average and out.is_floating_point():
        out = divide(out, mesh.size * size())
    return out.to(device)


def push_pull(
    tensor: torch.Tensor, name: str, average: bool = True, priority: int = 0
) -> torch.Tensor:
    """Synchronous push_pull (sum over workers, averaged when ``average``).
    ``name`` is the cross-process aggregation key.

    With ``BYTEPS_DEGRADED_STEP_RETRIES=N`` > 0, a step that failed
    degraded is healed in place (the engine resyncs the servers, replays
    the journaled pushes they lost and pulls the round: the fault-free
    result, with no init barrier), or else submitted again, up to N times
    with backoff; the abandoned round was never published and a replayed
    push is deduped, so a resubmission sums once.  Default 0: the error
    goes to the caller."""
    retries = get_config().degraded_step_retries
    if retries <= 0:
        return synchronize(push_pull_async(tensor, name, average=average, priority=priority))
    from byteps_tpu_torch.comm.retry import Backoff

    bo = Backoff(base=0.25, cap=2.0)
    for attempt in range(retries + 1):
        try:
            return synchronize(push_pull_async(tensor, name, average=average,
                                               priority=priority))
        except (DegradedError, ConnectionError) as e:
            # ConnectionError: the submit's init barrier met a dead server
            if attempt >= retries:
                raise
            if isinstance(e, DegradedError):
                healed = _heal_degraded(e, tensor, name, average)
                if healed is not None:
                    return healed
            time.sleep(bo.next_delay())
    raise AssertionError("unreachable")


def _heal_degraded(err: DegradedError, tensor: torch.Tensor, name: str,
                   average: bool) -> Optional[torch.Tensor]:
    """The engine's in-place heal of a degraded step; with a local group
    the root heals its PS push_pull of the group's sum and tells the other
    ranks whether it did, and the healed sum is broadcast as in
    :func:`synchronize`.  None when it could not heal."""
    st = require_state()
    host_level = getattr(err, "host_level", None)
    if host_level is None:
        return st.engine.heal_degraded(name, tensor, average) if st.engine else None
    mesh, _, _, summed = host_level
    out = None
    if mesh.rank == 0 and st.engine is not None:
        out = st.engine.heal_degraded(name, summed, False)
    code, out = _host_broadcast(out, int(mesh.rank == 0 and out is None), host_level)
    return None if code else _host_finish(out, host_level)


def push_pull_inplace(
    tensor: torch.Tensor, name: str, average: bool = True, priority: int = 0
) -> torch.Tensor:
    """push_pull written back into ``tensor`` (in its dtype); returns it."""
    out = push_pull(tensor, name, average=average, priority=priority)
    if out is not tensor:
        with torch.no_grad():
            tensor.copy_(out.view_as(tensor))
    return tensor


def get_robustness_counters() -> dict:
    """The data plane's degradation counters, flat totals of this process:
    retries, deadline expiries, revived connections, deduped pushes, the
    heal's attempts, replayed rounds and give-ups, injected chaos faults
    (docs/robustness.md "Observability"), and the membership plane's
    ``worker_evicted``, ``server_evicted``, ``sched_stale_book``,
    ``sched_reconnect`` and ``sched_rejoin``; a counter that never counted
    is absent, as in ``byteps_tpu``.  Per server:
    ``core.telemetry.counters().snapshot_labeled()``; the gauge
    ``control_plane_degraded`` is in ``core.telemetry.metrics().snapshot()``.
    Usable before :func:`init`."""
    from byteps_tpu_torch.core.telemetry import counters

    return counters().snapshot()


def get_metrics() -> dict:
    """The process registry's snapshot: flat and labeled counters, gauges,
    and the histograms' count, sum, p50, p90 and p99 (round trips, stage
    dwell, the servers' sum and publish; docs/observability.md).  Usable
    before :func:`init`."""
    from byteps_tpu_torch.core.telemetry import metrics

    return metrics().snapshot()


def get_metrics_text() -> str:
    """The Prometheus text this process serves on ``BYTEPS_METRICS_PORT``,
    without the endpoint."""
    from byteps_tpu_torch.core.telemetry import metrics

    return metrics().render_prometheus()


def get_pushpull_speed() -> float:
    """The push/pull MB/s over the last 10 s (``BYTEPS_TELEMETRY_ON``; 0
    when off or idle)."""
    st = require_state()
    return st.telemetry.mbps() if st.telemetry else 0.0


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
    """Start a row-sparse push_pull (RequestType::kRowSparsePushPull,
    common.h:267-271): push the ``values`` rows, shape ``(n, row_len)``, at
    ``indices`` of a ``(total_rows, row_len)`` tensor; the servers
    scatter-sum every worker's rows into a dense store (duplicate indices
    accumulate, rows no worker pushed are 0), and :func:`synchronize`
    returns the same rows of the round's sum, ``(n, row_len)`` float32 on
    the values' device (numpy for numpy), averaged over the workers when
    ``average``: the embedding-gradient path.  Indices and values may lie
    on a CUDA device; only the rows and indices cross to the host.  With
    one worker the rows are scatter-added and gathered in place.  A local
    group of more than one process raises: the reference runs one process
    a host, and has no such path (ROADMAP.md Queue 3)."""
    from byteps_tpu_torch.common.partition import validate_rowsparse

    st = require_state()
    mesh = get_global_mesh()
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"push_pull_rowsparse of {name!r} at local size {mesh.size}: row-sparse "
            "push_pull runs one process a host (the reference's topology); run the "
            "embedding's rows through the local root, or push them dense")
    get_registry().declare(name)
    handle = st.handles.allocate()
    if st.engine is None:
        idx, vals = validate_rowsparse(indices, values, total_rows)
        if isinstance(vals, torch.Tensor):
            dense = torch.zeros(total_rows, vals.shape[1], dtype=vals.dtype,
                                device=vals.device)
            dense.index_add_(0, idx.to(vals.device), vals)
        else:
            import numpy as np

            dense = np.zeros((total_rows, vals.shape[1]), dtype=vals.dtype)
            np.add.at(dense, idx, vals)
        st.handles.mark_done(handle, dense[idx])
        return handle
    st.engine.submit_rowsparse(name=name, indices=indices, values=values,
                               total_rows=total_rows, average=average,
                               priority=priority, handle=handle)
    return handle


def push_pull_rowsparse(indices: Any, values: Any, name: str, total_rows: int,
                        average: bool = True, priority: int = 0) -> Any:
    """Synchronous :func:`push_pull_rowsparse_async`."""
    return synchronize(push_pull_rowsparse_async(
        indices, values, name, total_rows, average=average, priority=priority))
