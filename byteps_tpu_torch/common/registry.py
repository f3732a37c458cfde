"""Named-tensor registry with stable key assignment.

Every communicated tensor is declared by name and receives a monotonically
increasing ``declared_key``; its wire keys are ``declared_key << 16`` plus
the partition index, with the job id in the top 16 bits.  ``redeclare_all``
replays the declarations in their original order, so keys are identical
across suspend/resume.  Keys equal ``byteps_tpu``'s for the same names in
the same order, so one server fleet can serve workers of both packages.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from byteps_tpu_torch.common.types import JOB_SHIFT, MAX_JOB_ID, Partition

MAX_PARTS_PER_TENSOR = 1 << 16


def job_key(job: int, key: int) -> int:
    """Namespace ``key`` under ``job`` (identity for job 0)."""
    if not 0 <= job <= MAX_JOB_ID:
        raise ValueError(f"job id {job} outside 0..{MAX_JOB_ID}")
    if key >> JOB_SHIFT:
        raise ValueError(f"key {key:#x} already carries job bits")
    return (job << JOB_SHIFT) | key


@dataclasses.dataclass
class TensorContext:
    name: str
    declared_key: int
    kwargs: Dict[str, str] = dataclasses.field(default_factory=dict)
    job: int = 0
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    #: the init-push barrier ran for every partition
    initialized: bool = False
    #: push_pull round of this tensor (the server's round number)
    version: int = 0
    #: engine instance that last ran the init barrier: the registry
    #: outlives shutdown()/init() cycles, the servers' stores do not
    engine_epoch: int = -1
    #: the client's server generation under which the init barrier ran: a
    #: resize re-homes keys onto servers that never saw them
    server_generation: int = 0

    @property
    def base_key(self) -> int:
        return job_key(self.job, self.declared_key << 16)

    def key_for_part(self, i: int) -> int:
        if i >= MAX_PARTS_PER_TENSOR:
            raise ValueError(
                f"tensor {self.name!r} would need partition index {i} "
                f">= {MAX_PARTS_PER_TENSOR}"
            )
        return self.base_key + i


class TensorRegistry:
    """Thread-safe name→context table with stable key replay."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._contexts: Dict[str, TensorContext] = {}
        self._order: List[str] = []
        self._next_key = 0

    def declare(self, name: str, **kwargs: str) -> TensorContext:
        """Declare (or fetch) a named tensor.  ``byteps_job`` in the kwargs
        overrides the process-wide ``BYTEPS_JOB_ID`` at first declaration."""
        with self._lock:
            ctx = self._contexts.get(name)
            if ctx is not None:
                ctx.kwargs.update(kwargs)
                return ctx
            ctx = TensorContext(
                name=name, declared_key=self._next_key, kwargs=dict(kwargs),
                job=self._job_for(kwargs),
            )
            self._next_key += 1
            self._contexts[name] = ctx
            self._order.append(name)
            return ctx

    @staticmethod
    def _job_for(kwargs: dict) -> int:
        raw = kwargs.get("byteps_job")
        if raw is not None:
            return max(0, int(raw))
        from byteps_tpu_torch.common.config import get_config

        return get_config().job_id

    def get(self, name: str) -> TensorContext:
        with self._lock:
            return self._contexts[name]

    def redeclare_all(self) -> None:
        """Replay declarations in original order: every generation assigns
        identical keys.  Keeps name→key, kwargs and job."""
        with self._lock:
            old = self._contexts
            self._contexts = {}
            for key, name in enumerate(self._order):
                prev = old[name]
                self._contexts[name] = TensorContext(
                    name=name, declared_key=key,
                    kwargs=dict(prev.kwargs), job=prev.job,
                )
            self._next_key = len(self._order)


_registry: Optional[TensorRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> TensorRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = TensorRegistry()
        return _registry


def reset_registry() -> TensorRegistry:
    global _registry
    with _registry_lock:
        _registry = TensorRegistry()
        return _registry
