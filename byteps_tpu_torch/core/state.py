"""Process-wide runtime state: the config snapshot, the bound torch device,
the tensor registry and the handle table.

``init_state()`` binds ``cuda:<local_rank>`` unless the caller names a
device.  A distributed topology needs the PS plane (engine, PS client,
transport, servers), which the port does not have yet: it raises rather
than run a different job than the one asked for.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from byteps_tpu_torch.common.config import Config, reset_config
from byteps_tpu_torch.core.handle_manager import HandleManager

PS_PLANE_SLICE = (
    "the PS plane (engine, PS client, transport, servers) is the port's next "
    "slice, ROADMAP.md Queue 1 item 2"
)


class RuntimeState:
    def __init__(self) -> None:
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None
        self.handles = HandleManager()
        self.initialized = False
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
            raise NotImplementedError(
                f"DMLC_ROLE={cfg.role!r}: {PS_PLANE_SLICE}"
            )
        if cfg.is_distributed:
            raise NotImplementedError(
                f"distributed topology (DMLC_NUM_WORKER={cfg.num_worker}, "
                f"BYTEPS_FORCE_DISTRIBUTED={int(cfg.force_distributed)}): "
                f"{PS_PLANE_SLICE}"
            )
        st.device = _bind_device(cfg, device)
        st.config = cfg
        st.initialized = True
        return st


def shutdown_state() -> None:
    st = _state
    with st._lock:
        if not st.initialized:
            return
        st.handles.clear()
        st.initialized = False


def require_state() -> RuntimeState:
    if not _state.initialized:
        raise RuntimeError(
            "byteps_tpu_torch not initialized; call byteps_tpu_torch.init()"
        )
    return _state
