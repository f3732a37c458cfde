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


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass
class Config:
    """Process-wide configuration snapshot."""

    role: str = "worker"  # DMLC_ROLE: worker | server | scheduler
    num_worker: int = 1  # DMLC_NUM_WORKER
    worker_id: int = 0  # DMLC_WORKER_ID
    local_rank: int = 0  # BYTEPS_LOCAL_RANK
    local_size: int = 1  # BYTEPS_LOCAL_SIZE
    global_rank: Optional[int] = None  # BYTEPS_GLOBAL_RANK
    force_distributed: bool = False  # BYTEPS_FORCE_DISTRIBUTED
    job_id: int = 0  # BYTEPS_JOB_ID: key namespace of declared tensors

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
    #: small-tensor fusion; > 0 is not ported (raises at init)
    fusion_threshold: int = 0  # BYTEPS_FUSION_THRESHOLD
    #: the worker's data lanes in C++ (native/csrc/ps_client.cc)
    native_client: bool = False  # BYTEPS_NATIVE_CLIENT
    #: a server's data plane in C++ (native/csrc/ps_server.cc)
    server_native: bool = False  # BYTEPS_SERVER_NATIVE

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
            global_rank=(
                int(os.environ["BYTEPS_GLOBAL_RANK"])
                if os.environ.get("BYTEPS_GLOBAL_RANK")
                else None
            ),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            job_id=min((1 << 16) - 1, max(0, _env_int("BYTEPS_JOB_ID", 0))),
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
            native_client=_env_bool("BYTEPS_NATIVE_CLIENT"),
            server_native=_env_bool("BYTEPS_SERVER_NATIVE"),
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


#: planes of byteps_tpu this port does not carry yet (the PS path's, and
#: model parallelism), each with the ROADMAP.md item that brings it.
#: Selecting one raises rather than run a different job than the one asked
#: for.
UNPORTED = {
    "fusion": "small-tensor fusion (Op.FUSED): ROADMAP.md Queue 1b item P1",
    "resync": "journal replay and RESYNC healing, RPC deadlines and retries: ROADMAP.md Queue 1b item P2",
    "elastic": "elastic membership and key migration: ROADMAP.md Queue 1b item P3",
    "async": "the async / bounded-staleness profile: ROADMAP.md Queue 1b item P4",
    "server_opt": "the server-side optimizer: ROADMAP.md Queue 1b item P5",
    "rowsparse": "row-sparse push_pull: ROADMAP.md Queue 1b item P6",
    "van": "the uds, shm and chaos vans: ROADMAP.md Queue 1b item P8",
    "lossless": "lossless wire frames: ROADMAP.md Queue 1b item P11",
    "tenancy": "multi-tenant job namespaces on the port's server: ROADMAP.md Queue 1b item P12",
    "auto": "adaptive compression (BYTEPS_COMPRESSION_AUTO): ROADMAP.md Queue 1b item P13",
    "model_parallel": "model parallelism (mesh axes other than dp): ROADMAP.md Queue 1 item 9",
}


def unported(plane: str, what: str) -> NotImplementedError:
    """The error for a request that needs an unported plane."""
    return NotImplementedError(f"{what}: not ported yet, {UNPORTED[plane]}")


#: environment knobs that select an unported plane: (variable, plane, is
#: it selected by this value)
_UNPORTED_KNOBS = (
    ("BYTEPS_FUSION_THRESHOLD", "fusion", lambda v: int(v) > 0),
    ("BYTEPS_ELASTIC_RESHARD", "elastic", lambda v: _truthy(v)),
    ("BYTEPS_DEAD_NODE_TIMEOUT_S", "elastic", lambda v: float(v) > 0),
    ("BYTEPS_AUTOTUNE", "elastic", lambda v: _truthy(v)),
    ("BYTEPS_ASYNC", "async", lambda v: _truthy(v)),
    ("BYTEPS_ENABLE_ASYNC", "async", lambda v: _truthy(v)),
    ("BYTEPS_SERVER_OPT", "server_opt", lambda v: _truthy(v)),
    ("BYTEPS_VAN", "van", lambda v: v != "tcp"),
    ("BYTEPS_WIRE_LOSSLESS", "lossless", lambda v: _truthy(v)),
    ("BYTEPS_RPC_RETRIES", "resync", lambda v: int(v) > 0),
    ("BYTEPS_RPC_DEADLINE_S", "resync", lambda v: float(v) > 0),
    ("BYTEPS_COMPRESSION_AUTO", "auto", lambda v: _truthy(v)),
)


def _truthy(v: str) -> bool:
    return v.lower() not in ("0", "false", "no", "off")


def check_unported_env() -> None:
    """Raise NotImplementedError when the environment selects a plane of
    the PS path that the port does not carry."""
    for name, plane, selected in _UNPORTED_KNOBS:
        v = os.environ.get(name)
        if v not in (None, "") and selected(v):
            raise unported(plane, f"{name}={v}")
