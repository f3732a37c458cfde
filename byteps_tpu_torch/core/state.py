"""Process-wide runtime state: the config snapshot, the bound torch device,
the handle table and, in distributed mode, the PS client and the pipeline
engine (global.cc:105-403).

``init_state()`` binds ``cuda:<local_rank>`` unless the caller names a
device.  A distributed topology (more than one worker, or
``BYTEPS_FORCE_DISTRIBUTED=1``) registers with the scheduler at
``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, connects to the servers and starts
the engine; ``shutdown_state()`` stops both.  The server and scheduler
roles run as their own processes (``python -m byteps_tpu_torch.server``).
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from byteps_tpu_torch.common.config import Config, check_unported_env, reset_config
from byteps_tpu_torch.core.handle_manager import HandleManager


class RuntimeState:
    def __init__(self) -> None:
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None
        self.handles = HandleManager()
        self.ps_client = None  # comm.ps_client.PSClient (distributed mode)
        self.engine = None  # core.engine.PipelineEngine (distributed mode)
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
            raise ValueError(
                f"DMLC_ROLE={cfg.role!r}: init() brings up a worker; run the "
                "server and scheduler roles with `python -m byteps_tpu_torch.server`"
            )
        st.device = _bind_device(cfg, device)
        if cfg.is_distributed:
            check_unported_env()
            from byteps_tpu_torch.comm.ps_client import PSClient
            from byteps_tpu_torch.core.engine import PipelineEngine

            client = PSClient(cfg)
            client.connect()
            st.ps_client = client
            st.engine = PipelineEngine(cfg, client)
            st.engine.start()
        st.config = cfg
        st.initialized = True
        return st


def shutdown_state() -> None:
    st = _state
    with st._lock:
        if not st.initialized:
            return
        if st.engine is not None:
            st.engine.stop()
            st.engine = None
        if st.ps_client is not None:
            st.ps_client.close()
            st.ps_client = None
        st.handles.clear()
        st.initialized = False


def require_state() -> RuntimeState:
    if not _state.initialized:
        raise RuntimeError(
            "byteps_tpu_torch not initialized; call byteps_tpu_torch.init()"
        )
    return _state
