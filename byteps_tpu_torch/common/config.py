"""Environment-variable configuration, for the knobs the port reads.

The same names as ``byteps_tpu.common.config``: BytePS is configured
through ``DMLC_*`` and ``BYTEPS_*`` variables, read into one snapshot that
``resume()`` re-reads after it rewrites the topology.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


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
