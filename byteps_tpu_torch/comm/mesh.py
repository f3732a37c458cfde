"""The host's local process group, under the reference's mesh names.

``byteps_tpu`` runs one process per host holding all of the host's devices
in a ``jax.sharding.Mesh``; its ``dp`` axis is the intra-host reduction.
The port runs one process per GPU (``byteps_tpu_torch.launcher.launch``),
so the "mesh" is the group of the host's processes, the
``torch.distributed`` default group of each of them, and its one axis is
``dp``.  Its collectives run over NCCL when the process is bound to a
CUDA device and over gloo when it is bound to the CPU: the backend follows
the device, never what happens to be installed.

The group's rendezvous comes from ``BYTEPS_LOCAL_INIT_METHOD`` (a
``torch.distributed`` init method, ``file://...`` or ``tcp://...``), its
rank and size from ``BYTEPS_LOCAL_RANK`` and ``BYTEPS_LOCAL_SIZE``; the
launcher sets all three.  Mesh specs name the same axes as
``byteps_tpu.comm.mesh``: ``""`` or ``"dp:<local size>"``.  The model
parallel axes (``fsdp``, ``pp``, ``tp``, ``sp``, ``ep``) are not ported.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from byteps_tpu_torch.common.config import LOCAL_INIT_METHOD, get_config, unported

DP_AXIS = "dp"

_lock = threading.Lock()
_global_mesh: Optional["Mesh"] = None


class Mesh:
    """The host's process group: ``size`` processes, this one ``rank``,
    bound to ``device``, talking over ``backend``."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str) -> None:
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.group = dist.group.WORLD

    def destroy(self) -> None:
        """Tear the process group down (the rendezvous cannot be reused)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return f"Mesh(dp={self.size}, rank={self.rank}, {self.backend} on {self.device})"


def parse_mesh_spec(spec: str) -> List[Tuple[str, int]]:
    """Parse ``"dp:2,tp:4"`` into [("dp", 2), ("tp", 4)]."""
    out: List[Tuple[str, int]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, num = item.partition(":")
        out.append((name.strip(), int(num)))
    return out


def _bound_device(device: Union[str, torch.device, None], local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    from byteps_tpu_torch.core.state import get_state

    st = get_state()
    return st.device if st.initialized else torch.device("cuda", local_rank)


def build_mesh(
    spec: str = "",
    device: Union[str, torch.device, None] = None,
    init_method: Optional[str] = None,
) -> Mesh:
    """Bring up the host's process group and return it as a Mesh.

    The rank and size are ``BYTEPS_LOCAL_RANK`` and ``BYTEPS_LOCAL_SIZE``;
    ``init_method`` defaults to ``BYTEPS_LOCAL_INIT_METHOD``, ``device`` to
    the one ``init()`` bound (else ``cuda:<local rank>``).  Raises when the
    spec names another axis than dp or another size than the group's, and
    when the group does not come up: a one-element all-reduce over it must
    give the group's size."""
    cfg = get_config()
    rank, size = cfg.local_rank, cfg.local_size
    axes = parse_mesh_spec(spec)
    other = [name for name, _ in axes if name != DP_AXIS]
    if other:
        raise unported("model_parallel", f"mesh spec {spec!r} (axes {other})")
    if axes and (len(axes) > 1 or axes[0][1] != size):
        raise ValueError(f"mesh spec {spec!r} does not match the host's {size} processes")
    device = _bound_device(device, rank)
    backends = {"cuda": "nccl", "cpu": "gloo"}
    if device.type not in backends:
        raise ValueError(f"no collective backend for device {device}")
    backend = backends[device.type]
    init_method = init_method or os.environ.get(LOCAL_INIT_METHOD)
    if not init_method:
        raise RuntimeError(
            f"the local group has no rendezvous: run under `python -m "
            f"byteps_tpu_torch.launcher.launch`, or set {LOCAL_INIT_METHOD}"
        )
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed default group exists already; the "
                           "host's local group is the process's default group")
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device  # bring the communicator up now, not lazily
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, **kwargs)
    mesh = Mesh(rank, size, device, backend)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=mesh.group)
    if probe.item() != size:
        mesh.destroy()
        raise RuntimeError(f"the {backend} group on {device} did not come up: an "
                           f"all-reduce of ones over {size} processes gave {probe.item()}")
    return mesh


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    with _lock:
        _global_mesh = mesh


def get_global_mesh() -> Optional[Mesh]:
    with _lock:
        return _global_mesh


def require_mesh() -> Mesh:
    m = get_global_mesh()
    if m is None:
        raise RuntimeError(
            "byteps_tpu_torch has no local group: init() under the launcher "
            "brings one up, or pass mesh=build_mesh(...)"
        )
    return m


def dp_size(mesh: Optional[Mesh] = None) -> int:
    return (mesh or require_mesh()).size
