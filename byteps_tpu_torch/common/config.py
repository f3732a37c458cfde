"""Environment-variable configuration, for the knobs the port reads.

The same names as ``byteps_tpu.common.config``: BytePS is configured
through ``DMLC_*`` and ``BYTEPS_*`` variables, read into one snapshot that
``resume()`` re-reads after it rewrites the topology.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


#: the environment variable that carries the host's local group rendezvous
#: (a torch.distributed init method), set by the launcher for each worker
LOCAL_INIT_METHOD = "BYTEPS_LOCAL_INIT_METHOD"


def resolve_node_uid() -> str:
    """A node's identity for the scheduler to match its rejoin by:
    ``BYTEPS_NODE_UID`` (set by an operator; it outlives a process
    restart), else a fresh uuid.  A worker's runtime state keeps it across
    suspend/resume."""
    import uuid

    return os.environ.get("BYTEPS_NODE_UID") or uuid.uuid4().hex


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def truthy(v: str) -> bool:
    """A knob's value read as a flag: anything but an off spelling."""
    return v.lower() not in ("0", "false", "no", "off")


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return truthy(v)


@dataclasses.dataclass
class Config:
    """Process-wide configuration snapshot."""

    role: str = "worker"  # DMLC_ROLE: worker | server | scheduler
    num_worker: int = 1  # DMLC_NUM_WORKER
    worker_id: int = 0  # DMLC_WORKER_ID
    local_rank: int = 0  # BYTEPS_LOCAL_RANK
    local_size: int = 1  # BYTEPS_LOCAL_SIZE
    #: how the host's group moves CUDA tensors: "" = NCCL, "staged" = gloo
    #: through pinned host buffers, which lets several ranks share one card
    mesh_transport: str = ""  # BYTEPS_MESH_TRANSPORT
    #: the host's group laid out over named axes, the reference's spelling
    #: ("dp:4,tp:2"); empty = dp over the whole group
    mesh_shape: str = ""  # BYTEPS_TPU_MESH
    global_rank: Optional[int] = None  # BYTEPS_GLOBAL_RANK
    force_distributed: bool = False  # BYTEPS_FORCE_DISTRIBUTED
    job_id: int = 0  # BYTEPS_JOB_ID: key namespace of declared tensors
    #: the job's weighted share of the stage queues and of a shared fleet's
    #: engine queues (WFQ; higher = more service under contention)
    job_priority: int = 1  # BYTEPS_JOB_PRIORITY, >= 1
    #: the servers' admission quota for the job's request bytes, megabytes
    #: a second over the fleet (0 = none): excess requests are deferred
    job_quota_mbps: float = 0.0  # BYTEPS_JOB_QUOTA_MBPS
    #: the job's in-flight byte budget in each stage queue (0 = only the
    #: global BYTEPS_SCHEDULING_CREDIT)
    job_credit_bytes: int = 0  # BYTEPS_JOB_CREDIT_BYTES

    # --- the PS plane ---
    num_server: int = 0  # DMLC_NUM_SERVER
    ps_root_uri: str = "127.0.0.1"  # DMLC_PS_ROOT_URI: the scheduler
    ps_root_port: int = 9000  # DMLC_PS_ROOT_PORT
    node_host: str = ""  # DMLC_NODE_HOST: the address a server listens on
    partition_bytes: int = 4096000  # BYTEPS_PARTITION_BYTES
    min_compress_bytes: int = 65536  # BYTEPS_MIN_COMPRESS_BYTES
    scheduling_credit: int = 0  # BYTEPS_SCHEDULING_CREDIT; 0 = unlimited
    scheduling: str = "priority"  # BYTEPS_SCHEDULING: priority | fifo
    threadpool_size: int = 4  # BYTEPS_THREADPOOL_SIZE: (de)compress threads
    key_hash_fn: str = "djb2"  # BYTEPS_KEY_HASH_FN
    built_in_hash_coef: int = 1  # BYTEPS_BUILT_IN_HASH_COEF
    enable_mixed_mode: bool = False  # BYTEPS_ENABLE_MIXED_MODE
    mixed_mode_bound: int = 101  # BYTEPS_MIXED_MODE_BOUND
    server_engine_threads: int = 4  # BYTEPS_SERVER_ENGINE_THREAD
    #: small-tensor fusion: a partition whose wire bytes are at or below the
    #: threshold takes the FUSE stage, packed with same-server neighbours
    #: into one Op.FUSED frame; 0 turns fusion off
    fusion_threshold: int = 0  # BYTEPS_FUSION_THRESHOLD
    #: a server's fusion buffer flushes when it holds this many bytes
    fusion_bytes: int = 262144  # BYTEPS_FUSION_BYTES
    #: or when its oldest member has waited this long
    fusion_cycle_ms: float = 2.0  # BYTEPS_FUSION_CYCLE_MS
    #: a server applies every push at once to a cumulative store and
    #: serves pulls from it, with no round barrier (server-wide async)
    enable_async: bool = False  # BYTEPS_ENABLE_ASYNC
    #: this worker's keys are declared async at INIT (per key; the
    #: ``byteps_async`` declare kwarg overrides it)
    async_mode: bool = False  # BYTEPS_ASYNC
    #: bounded staleness of async keys: a pull of round v waits until every
    #: worker's applied push is at least v - bound; -1 = unbounded
    staleness_bound: int = -1  # BYTEPS_STALENESS_BOUND
    #: the server-side optimizer of every float tensor ("sgd", "momentum",
    #: "adam"; "" = off): workers push gradients and pull parameters
    server_opt: str = ""  # BYTEPS_SERVER_OPT
    #: its hyperparameters as JSON, e.g. '{"lr": 0.01}'
    server_opt_hp: str = ""  # BYTEPS_SERVER_OPT_HP
    #: adaptive compression: a key whose codec's wire ratio (compressed
    #: over raw bytes) is at or above the cutoff stops compressing, its
    #: rounds push raw (servers serve raw and compressed on one key)
    compression_auto: bool = False  # BYTEPS_COMPRESSION_AUTO
    compression_auto_ratio: float = 0.9  # BYTEPS_COMPRESSION_AUTO_RATIO
    #: rounds a data-dependent codec is observed before its verdict
    compression_auto_rounds: int = 3  # BYTEPS_COMPRESSION_AUTO_ROUNDS
    #: the worker's data lanes in C++ (native/csrc/ps_client.cc)
    native_client: bool = False  # BYTEPS_NATIVE_CLIENT
    #: a server's data plane in C++ (native/csrc/ps_server.cc)
    server_native: bool = False  # BYTEPS_SERVER_NATIVE
    # The vans and the wire read their knobs from the environment when
    # they act, as the reference's do: BYTEPS_VAN (tcp | uds | shm, or
    # chaos:<one of them>; read when a server is made), BYTEPS_SOCKET_PATH
    # (the temp directory), BYTEPS_SHM_RING_BYTES (512 KiB),
    # BYTEPS_CONNECT_RETRY_S (2), BYTEPS_WIRE_LOSSLESS (off) and
    # BYTEPS_LOSSLESS_ENTROPY (6.0 bits a byte).

    # --- membership: heartbeats, eviction, scheduler recovery ---
    #: seconds between a node's heartbeats to the scheduler; 0 = none
    heartbeat_interval: float = 5.0  # BYTEPS_HEARTBEAT_INTERVAL
    #: the scheduler evicts a node whose heartbeat is older than this; 0 =
    #: no eviction (ages stay visible through Op.QUERY)
    dead_node_timeout_s: float = 0.0  # BYTEPS_DEAD_NODE_TIMEOUT_S
    #: redials of a lost scheduler link before the control plane is given
    #: up for good (the data plane goes on with the last book); 0 = none
    sched_reconnect_retries: int = 20  # BYTEPS_SCHED_RECONNECT_RETRIES
    #: the backoff's base between redials (full jitter, capped at 10 s)
    sched_reconnect_backoff_s: float = 0.5  # BYTEPS_SCHED_RECONNECT_BACKOFF_S
    #: how long a restarted scheduler waits for every reported rank to
    #: register again before it adopts the partial population
    sched_rejoin_window_s: float = 15.0  # BYTEPS_SCHED_REJOIN_WINDOW_S

    # --- per-RPC deadlines and retries (docs/robustness.md) ---
    #: attempts after the first before a push, pull or init gives up
    rpc_retries: int = 2  # BYTEPS_RPC_RETRIES; 0 fails fast
    #: a server that neither answers nor closes the connection within this
    #: window is taken for hung: the connection is torn down and the
    #: request sent again; 0 turns the deadline off
    rpc_deadline_s: float = 0.0  # BYTEPS_RPC_DEADLINE_S
    #: the backoff's base between attempts (full jitter, capped at 2 s)
    rpc_backoff_s: float = 0.1  # BYTEPS_RPC_BACKOFF_S
    #: the init barrier's own deadline (its ack waits for every peer
    #: worker, so the RPC deadline does not cover it); 0 = none
    init_deadline_s: float = 0.0  # BYTEPS_INIT_DEADLINE_S
    #: a synchronous push_pull that failed degraded is healed in place, or
    #: submitted again, this many times before the error surfaces
    degraded_step_retries: int = 0  # BYTEPS_DEGRADED_STEP_RETRIES

    # --- the round journal and the in-place heal ---
    #: rounds of sent push payloads the journal keeps per key; 0 = none
    journal_rounds: int = 2  # BYTEPS_JOURNAL_ROUNDS
    #: the journal's byte cap over all keys; the oldest rounds go first
    journal_bytes: int = 64 << 20  # BYTEPS_JOURNAL_BYTES
    #: the wall-clock budget of one heal (resync query and replay); 0
    #: turns the in-place heal off
    resync_deadline_s: float = 5.0  # BYTEPS_RESYNC_DEADLINE_S

    # --- online resharding (docs/robustness.md "migration flow") ---
    #: ownership is an epoch-stamped consistent-hash ring: on a server-set
    #: change the old owners ship each re-homed key's state to its new
    #: owner over Op.MIGRATE_STATE and stale requests chase Op.WRONG_OWNER,
    #: with no re-init barrier; off, a resize re-homes keys by the hash
    #: fns and the engine re-runs every init barrier
    elastic_reshard: bool = False  # BYTEPS_ELASTIC_RESHARD
    #: virtual points per server rank on the ring (also fn="ring")
    ring_vnodes: int = 64  # BYTEPS_RING_VNODES
    #: how long a new owner parks requests for a key whose migration is
    #: inbound before it drops them back to the caller's retry path
    migrate_deadline_s: float = 10.0  # BYTEPS_MIGRATE_DEADLINE_S

    # --- observability (docs/observability.md; BYTEPS_LOG_LEVEL is read by
    # common/logging.py at every init) ---
    #: the stage envelopes and spans of core/tracing.py, written under
    #: BYTEPS_TRACE_DIR; envelopes for the tensor versions in the window
    trace_on: bool = False  # BYTEPS_TRACE_ON
    trace_start_step: int = 10  # BYTEPS_TRACE_START_STEP
    trace_end_step: int = 20  # BYTEPS_TRACE_END_STEP
    trace_dir: str = "."  # BYTEPS_TRACE_DIR
    #: off: envelopes only, no spans and no trace blocks on the wire
    trace_spans: bool = True  # BYTEPS_TRACE_SPANS
    #: the windowed push/pull MB/s (api.get_pushpull_speed)
    telemetry_on: bool = False  # BYTEPS_TELEMETRY_ON
    #: the Prometheus endpoint's port (0 = none; a taken port falls back
    #: to an ephemeral one)
    metrics_port: int = 0  # BYTEPS_METRICS_PORT
    #: a tensor name (substring) whose values are logged after each stage
    debug_sample_tensor: str = ""  # BYTEPS_DEBUG_SAMPLE_TENSOR
    # the flight recorder's triggers and bundles (core/flightrec.py)
    flight_steps: int = 256  # BYTEPS_FLIGHT_STEPS
    flight_slow_factor: float = 3.0  # BYTEPS_FLIGHT_SLOW_FACTOR
    flight_stall_s: float = 5.0  # BYTEPS_FLIGHT_STALL_S
    #: where bundles land ("" = <trace_dir>/flight_bundles)
    flight_dir: str = ""  # BYTEPS_FLIGHT_DIR
    #: one bundle a rule at most this often (later firings are counted)
    flight_bundle_s: float = 60.0  # BYTEPS_FLIGHT_BUNDLE_S
    #: a bundle's compact form rides the heartbeat to the scheduler's
    #: BYTEPS_FLIGHT_DIR
    flight_upload: bool = False  # BYTEPS_FLIGHT_UPLOAD
    #: a step slower than this fires slo_breach (0 = off)
    job_slo_s: float = 0.0  # BYTEPS_JOB_SLO_S

    @property
    def is_distributed(self) -> bool:
        """More than one worker, or the single-worker fake-cluster
        topology forced on: either engages the PS plane."""
        return self.num_worker > 1 or self.force_distributed

    @staticmethod
    def from_env() -> "Config":
        return Config(
            role=os.environ.get("DMLC_ROLE") or "worker",
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            mesh_transport=os.environ.get("BYTEPS_MESH_TRANSPORT", ""),
            mesh_shape=os.environ.get("BYTEPS_TPU_MESH", ""),
            global_rank=(
                int(os.environ["BYTEPS_GLOBAL_RANK"])
                if os.environ.get("BYTEPS_GLOBAL_RANK")
                else None
            ),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            job_id=min((1 << 16) - 1, max(0, _env_int("BYTEPS_JOB_ID", 0))),
            job_priority=max(1, _env_int("BYTEPS_JOB_PRIORITY", 1)),
            job_quota_mbps=max(0.0, float(os.environ.get("BYTEPS_JOB_QUOTA_MBPS", "0") or "0")),
            job_credit_bytes=max(0, _env_int("BYTEPS_JOB_CREDIT_BYTES", 0)),
            num_server=_env_int("DMLC_NUM_SERVER", 0),
            ps_root_uri=os.environ.get("DMLC_PS_ROOT_URI") or "127.0.0.1",
            ps_root_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            node_host=os.environ.get("DMLC_NODE_HOST") or "",
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES", 4096000),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES", 65536),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
            scheduling=os.environ.get("BYTEPS_SCHEDULING", "priority"),
            threadpool_size=_env_int("BYTEPS_THREADPOOL_SIZE", 4),
            key_hash_fn=os.environ.get("BYTEPS_KEY_HASH_FN") or "djb2",
            built_in_hash_coef=_env_int("BYTEPS_BUILT_IN_HASH_COEF", 1),
            enable_mixed_mode=_env_bool("BYTEPS_ENABLE_MIXED_MODE"),
            mixed_mode_bound=_env_int("BYTEPS_MIXED_MODE_BOUND", 101),
            server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD", 4),
            fusion_threshold=max(0, _env_int("BYTEPS_FUSION_THRESHOLD", 0)),
            fusion_bytes=max(1, _env_int("BYTEPS_FUSION_BYTES", 262144)),
            fusion_cycle_ms=max(0.0, float(os.environ.get("BYTEPS_FUSION_CYCLE_MS", "2") or "2")),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
            async_mode=_env_bool("BYTEPS_ASYNC"),
            staleness_bound=max(-1, _env_int("BYTEPS_STALENESS_BOUND", -1)),
            server_opt=(os.environ.get("BYTEPS_SERVER_OPT") or "").strip().lower(),
            server_opt_hp=os.environ.get("BYTEPS_SERVER_OPT_HP") or "",
            compression_auto=_env_bool("BYTEPS_COMPRESSION_AUTO"),
            compression_auto_ratio=_env_float("BYTEPS_COMPRESSION_AUTO_RATIO", 0.9),
            compression_auto_rounds=max(1, _env_int("BYTEPS_COMPRESSION_AUTO_ROUNDS", 3)),
            native_client=_env_bool("BYTEPS_NATIVE_CLIENT"),
            server_native=_env_bool("BYTEPS_SERVER_NATIVE"),
            heartbeat_interval=_env_float("BYTEPS_HEARTBEAT_INTERVAL", 5.0),
            dead_node_timeout_s=_env_float("BYTEPS_DEAD_NODE_TIMEOUT_S", 0.0),
            sched_reconnect_retries=max(0, _env_int("BYTEPS_SCHED_RECONNECT_RETRIES", 20)),
            sched_reconnect_backoff_s=_env_float("BYTEPS_SCHED_RECONNECT_BACKOFF_S", 0.5),
            sched_rejoin_window_s=_env_float("BYTEPS_SCHED_REJOIN_WINDOW_S", 15.0),
            rpc_retries=max(0, _env_int("BYTEPS_RPC_RETRIES", 2)),
            rpc_deadline_s=_env_float("BYTEPS_RPC_DEADLINE_S", 0.0),
            rpc_backoff_s=_env_float("BYTEPS_RPC_BACKOFF_S", 0.1),
            init_deadline_s=_env_float("BYTEPS_INIT_DEADLINE_S", 0.0),
            degraded_step_retries=max(0, _env_int("BYTEPS_DEGRADED_STEP_RETRIES", 0)),
            journal_rounds=max(0, _env_int("BYTEPS_JOURNAL_ROUNDS", 2)),
            journal_bytes=max(1, _env_int("BYTEPS_JOURNAL_BYTES", 64 << 20)),
            resync_deadline_s=_env_float("BYTEPS_RESYNC_DEADLINE_S", 5.0),
            elastic_reshard=_env_bool("BYTEPS_ELASTIC_RESHARD"),
            ring_vnodes=max(1, _env_int("BYTEPS_RING_VNODES", 64)),
            migrate_deadline_s=_env_float("BYTEPS_MIGRATE_DEADLINE_S", 10.0),
            trace_on=_env_bool("BYTEPS_TRACE_ON"),
            trace_start_step=_env_int("BYTEPS_TRACE_START_STEP", 10),
            trace_end_step=_env_int("BYTEPS_TRACE_END_STEP", 20),
            trace_dir=os.environ.get("BYTEPS_TRACE_DIR") or ".",
            trace_spans=_env_bool("BYTEPS_TRACE_SPANS", True),
            telemetry_on=_env_bool("BYTEPS_TELEMETRY_ON"),
            metrics_port=max(0, _env_int("BYTEPS_METRICS_PORT", 0)),
            debug_sample_tensor=os.environ.get("BYTEPS_DEBUG_SAMPLE_TENSOR") or "",
            flight_steps=max(0, _env_int("BYTEPS_FLIGHT_STEPS", 256)),
            flight_slow_factor=max(1.1, _env_float("BYTEPS_FLIGHT_SLOW_FACTOR", 3.0)),
            flight_stall_s=max(0.001, _env_float("BYTEPS_FLIGHT_STALL_S", 5.0)),
            flight_dir=os.environ.get("BYTEPS_FLIGHT_DIR") or "",
            flight_bundle_s=max(0.0, _env_float("BYTEPS_FLIGHT_BUNDLE_S", 60.0)),
            flight_upload=_env_bool("BYTEPS_FLIGHT_UPLOAD"),
            job_slo_s=max(0.0, _env_float("BYTEPS_JOB_SLO_S", 0.0)),
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def reset_config() -> Config:
    """Re-read the environment (the resume path)."""
    global _config
    _config = Config.from_env()
    return _config


def clear_config() -> None:
    """Drop the cached snapshot; the next get_config() re-reads env."""
    global _config
    _config = None


#: planes of byteps_tpu this port does not carry yet, each with the
#: ROADMAP.md item that brings it.  Selecting one raises rather than run a
#: different job than the one asked for.  Every plane is ported: the map
#: and the knobs below are empty, and the functions stay for the code that
#: cites them.
UNPORTED: dict = {}


def unported(plane: str, what: str) -> NotImplementedError:
    """The error for a request that needs an unported plane."""
    return NotImplementedError(f"{what}: not ported yet, {UNPORTED[plane]}")


#: environment knobs that select an unported plane: (variable, plane, is
#: it selected by this value)
_UNPORTED_KNOBS: tuple = ()


def check_unported_env() -> None:
    """Raise NotImplementedError when the environment selects a plane of
    the PS path that the port does not carry."""
    for name, plane, selected in _UNPORTED_KNOBS:
        v = os.environ.get(name)
        if v not in (None, "") and selected(v):
            raise unported(plane, f"{name}={v}")
