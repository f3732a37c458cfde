"""Process-wide runtime state: the config snapshot, the bound torch device,
the handle table and, in distributed mode, the PS client and the pipeline
engine (global.cc:105-403).

``init_state()`` binds ``cuda:<local_rank>`` unless the caller names a
device.  With the group's rendezvous in ``BYTEPS_LOCAL_INIT_METHOD``, as
``byteps_tpu_torch.launcher.launch`` sets it for each process it starts
(one per GPU), it brings up the host's process group (``comm.mesh``), at
any size, and makes it the global mesh.  A distributed topology (more
than one worker, or ``BYTEPS_FORCE_DISTRIBUTED=1``) registers with the
scheduler at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, connects to the
servers and starts the engine, on the group's rank 0 alone: one PS worker
per host, as in ``byteps_tpu``, and the root tells the other local ranks
the host's worker rank and the number of hosts.  A distributed process at
``BYTEPS_LOCAL_SIZE > 1`` without the rendezvous raises: it could neither
join the PS nor reach its host's root.
Every init also brings up the observability plane (docs/observability.md):
the log level (``BYTEPS_LOG_LEVEL``), the tracer (``BYTEPS_TRACE_ON``; the
process tracer, named ``worker<rank>`` once the scheduler gave a rank), the
windowed push/pull speed (``BYTEPS_TELEMETRY_ON``, the ``pushpull_mbps``
gauge) and, with ``BYTEPS_METRICS_PORT``, the Prometheus endpoint.
``shutdown_state()`` stops all of it and flushes the tracer; the worker's
node uid stays, so that a resume rejoins as the same member, and a suspend
keeps the host's group.  The server and scheduler roles run
as their own processes (``python -m byteps_tpu_torch.server``).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple, Union

import torch

from byteps_tpu_torch.common.config import (
    LOCAL_INIT_METHOD,
    Config,
    check_unported_env,
    reset_config,
    resolve_node_uid,
)
from byteps_tpu_torch.core.handle_manager import HandleManager


class RuntimeState:
    def __init__(self) -> None:
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None
        self.handles = HandleManager()
        self.ps_client = None  # comm.ps_client.PSClient (distributed mode)
        self.engine = None  # core.engine.PipelineEngine (distributed mode)
        #: core.flightrec.FlightRecorder the engine stamps once a step
        self.flightrec = None
        self.telemetry = None  # core.telemetry.PushPullSpeed
        self.tracer = None  # core.tracing.Tracer
        self.metrics_http = None  # core.telemetry.MetricsHTTPServer
        self.mesh = None  # comm.mesh.Mesh: the host's process group, under the launcher
        #: (worker rank, number of workers) of this host, from local rank 0
        self.host: Optional[Tuple[int, int]] = None
        #: handle -> (mesh, average, device) of each host-level push_pull
        #: whose broadcast from the local root is still to come
        self.host_level: dict = {}
        self.initialized = False
        #: the PS worker's identity, kept across suspend()/resume() so that
        #: the scheduler matches the rejoin to this worker's old registration
        #: (resolved at the first distributed init: ``BYTEPS_NODE_UID`` or a
        #: fresh uuid)
        self.node_uid: Optional[str] = None
        self._lock = threading.Lock()


_state = RuntimeState()


def get_state() -> RuntimeState:
    return _state


def _bind_device(cfg: Config, device: Union[str, torch.device, None]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "byteps_tpu_torch.init(): no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda", cfg.local_rank)


def init_state(device: Union[str, torch.device, None] = None) -> RuntimeState:
    """Bring the process up; a no-op when already initialized."""
    st = _state
    with st._lock:
        if st.initialized:
            return st
        cfg = reset_config()
        if cfg.role != "worker":
            raise ValueError(
                f"DMLC_ROLE={cfg.role!r}: init() brings up a worker; run the "
                "server and scheduler roles with `python -m byteps_tpu_torch.server`"
            )
        st.device = _bind_device(cfg, device)
        local_group = bool(os.environ.get(LOCAL_INIT_METHOD))
        if cfg.is_distributed:
            check_unported_env()
            if cfg.local_size > 1 and not local_group:
                raise RuntimeError(
                    f"BYTEPS_LOCAL_SIZE={cfg.local_size} on a distributed worker needs the "
                    f"host's process group: run under `python -m "
                    f"byteps_tpu_torch.launcher.launch`, or set {LOCAL_INIT_METHOD}"
                )
        try:
            _observe(cfg, st)
            if local_group and st.mesh is None:  # a suspend keeps the host's group
                from byteps_tpu_torch.comm.mesh import build_mesh, set_global_mesh

                st.mesh = build_mesh(spec=cfg.mesh_shape, device=st.device)
                set_global_mesh(st.mesh)
            elif not local_group and cfg.mesh_shape:
                # one process is the whole host: a spec must fit one rank, as
                # the reference's build_mesh holds it to its devices
                from byteps_tpu_torch.comm.mesh import _axes_of

                _axes_of(cfg.mesh_shape, 1)
            if cfg.is_distributed and (st.mesh is None or st.mesh.rank == 0):
                from byteps_tpu_torch.comm.ps_client import PSClient
                from byteps_tpu_torch.core.engine import PipelineEngine

                if st.node_uid is None:
                    st.node_uid = resolve_node_uid()
                from byteps_tpu_torch.core.flightrec import ensure_process_recorder

                client = PSClient(cfg, node_uid=st.node_uid)
                client.connect()
                st.ps_client = client
                if client.rank is not None:
                    # the process's name on the merged timeline
                    st.tracer.process_name = f"worker{client.rank}"

                def flight_context(c=client, job=cfg.job_id) -> dict:
                    # the epochs and incarnation each step ran under
                    return {"epoch": c.membership_epoch,
                            "map_epoch": max(c.map_epoch, c._seen_map_epoch),
                            "incarnation": c.sched_incarnation,
                            "degraded": 0 if c._sched_up.is_set() else 1, "job": job}

                st.flightrec = ensure_process_recorder(cfg, context_fn=flight_context,
                                                       tracer=st.tracer)
                st.engine = PipelineEngine(cfg, client, telemetry=st.telemetry,
                                           tracer=st.tracer, flightrec=st.flightrec)
                st.engine.start()
            if st.mesh is not None:
                st.host = _host_identity(cfg, st)
        except BaseException:
            _stop(st)
            raise
        st.config = cfg
        st.initialized = True
        return st


def _observe(cfg: Config, st: RuntimeState) -> None:
    """The log level, the tracer, the push/pull speed and the endpoint."""
    from byteps_tpu_torch.common import logging as bpslog
    from byteps_tpu_torch.core.telemetry import PushPullSpeed, metrics, serve_metrics
    from byteps_tpu_torch.core.tracing import Tracer, set_process_tracer

    bpslog.apply_env_level()
    st.telemetry = PushPullSpeed(enabled=cfg.telemetry_on)
    st.tracer = Tracer(enabled=cfg.trace_on, start_step=cfg.trace_start_step,
                       end_step=cfg.trace_end_step, trace_dir=cfg.trace_dir,
                       local_rank=cfg.local_rank, spans_enabled=cfg.trace_spans)
    set_process_tracer(st.tracer)
    metrics().gauge_fn("pushpull_mbps", st.telemetry.mbps)
    if cfg.metrics_port > 0 and st.metrics_http is None:
        st.metrics_http = serve_metrics(cfg.metrics_port)


def _host_identity(cfg: Config, st: RuntimeState) -> Tuple[int, int]:
    """The host's worker rank and the number of workers (hosts), as local
    rank 0 knows them (the scheduler's book in distributed mode), on every
    local rank."""
    from byteps_tpu_torch.comm import collectives

    client = st.ps_client
    if client is not None:
        mine = (client.job_rank(), client.num_workers)
    else:
        mine = (cfg.global_rank if cfg.global_rank is not None else cfg.worker_id,
                cfg.num_worker)
    ident = collectives.broadcast(torch.tensor(mine, dtype=torch.int64, device=st.device),
                                  root=0, mesh=st.mesh)
    return int(ident[0]), int(ident[1])


def _stop(st: RuntimeState, keep_mesh: bool = False) -> None:
    if st.engine is not None:
        st.engine.stop()
        st.engine = None
    if st.ps_client is not None:
        st.ps_client.close()
        st.ps_client = None
    if st.flightrec is not None:
        # its context holds the closed client: the next init makes its own
        from byteps_tpu_torch.core.flightrec import get_process_recorder, set_process_recorder

        if get_process_recorder() is st.flightrec:
            set_process_recorder(None)
        st.flightrec = None
    if st.tracer is not None:
        from byteps_tpu_torch.core.tracing import get_process_tracer, set_process_tracer

        st.tracer.flush()
        if get_process_tracer() is st.tracer:
            set_process_tracer(None)
        st.tracer = None
    if st.metrics_http is not None:
        st.metrics_http.close()
        st.metrics_http = None
    if st.mesh is not None and not keep_mesh:
        from byteps_tpu_torch.comm.mesh import get_global_mesh, set_global_mesh

        if get_global_mesh() is st.mesh:
            set_global_mesh(None)
        st.mesh.destroy()
        st.mesh = None
    st.host = None
    st.host_level.clear()


def shutdown_state(keep_mesh: bool = False) -> None:
    """Stop everything; with ``keep_mesh`` (a suspend) the host's process
    group stays up for the resume: only the PS worker leaves the job, and a
    group rebuilt at the same rendezvous would meet its old generation's
    records."""
    st = _state
    with st._lock:
        if not st.initialized:
            if not keep_mesh and st.mesh is not None:
                _stop(st)  # a shutdown after a suspend
            return
        _stop(st, keep_mesh)
        st.handles.clear()
        st.initialized = False


def require_state() -> RuntimeState:
    if not _state.initialized:
        raise RuntimeError(
            "byteps_tpu_torch not initialized; call byteps_tpu_torch.init()"
        )
    return _state
