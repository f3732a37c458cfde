"""The host's process group, under the reference's mesh names.

``byteps_tpu`` runs one process per host holding all of the host's devices
in a ``jax.sharding.Mesh`` with named axes ``(dp, pp, sp, tp)``.  The port
runs one process per GPU (``byteps_tpu_torch.launcher.launch``), so the
mesh is the group of the host's processes, the ``torch.distributed``
default group of each of them, laid out over the same named axes: rank r
sits where the reference's row-major reshape of its devices puts device r
(:attr:`Mesh.ranks` is that array of ranks), and each axis line of the
mesh (the ranks that differ only in that axis) has its own subgroup
(:meth:`Mesh.axis_group`), over which ``comm.collectives`` runs the axis
collectives.  With every axis but dp at 1 the mesh is the plain
data-parallel group.

The transport follows the device, never what happens to be installed:
NCCL for CUDA, gloo for the CPU.  ``transport="staged"`` (or
``BYTEPS_MESH_TRANSPORT=staged``) runs a gloo group on CUDA tensors,
each collective copying them through pinned host buffers: NCCL refuses
two ranks of one group on one device, and the staged transport is how
several ranks share one card.  Only that explicit request selects it: a
CUDA group whose ranks share a device raises and names the option.

The group's rendezvous comes from ``BYTEPS_LOCAL_INIT_METHOD`` (a
``torch.distributed`` init method, ``file://...`` or ``tcp://...``), its
rank and size from ``BYTEPS_LOCAL_RANK`` and ``BYTEPS_LOCAL_SIZE``; the
launcher sets all three.  Mesh specs name the reference's axes:
``"dp:2,tp:2"`` or ``"dp=1,pp=2,sp=1,tp=2"``, and an expert axis ``ep``.
"""

from __future__ import annotations

import math
import os
import socket
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.common.config import LOCAL_INIT_METHOD, get_config

DP_AXIS = "dp"
#: the training mesh's axes, in the reference's order
AXES = ("dp", "pp", "sp", "tp")
#: the axes a mesh spec may name: the training mesh's and the expert axis
#: (the reference's transformer routes its experts over sp; an ep axis is
#: for models of the caller's that shard experts on an axis of their own)
SPEC_AXES = AXES + ("ep",)
TRANSPORTS = ("", "staged")

_lock = threading.Lock()
_global_mesh: Optional["Mesh"] = None


class Mesh:
    """The host's process group: ``size`` processes, this one ``rank``,
    bound to ``device``, talking over ``backend`` (``transport`` "nccl",
    "gloo" or "staged"), laid out as ``ranks``: an integer array whose
    axes are ``axis_names`` (default one dp axis over every rank)."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str,
                 ranks: Optional[np.ndarray] = None,
                 axis_names: Sequence[str] = (DP_AXIS,),
                 transport: Optional[str] = None) -> None:
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.transport = transport or backend
        self.group = dist.group.WORLD
        self.ranks = np.arange(size) if ranks is None else np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names) or self.ranks.size != size:
            raise ValueError(f"a mesh of {size} ranks cannot take the layout "
                             f"{dict(zip(self.axis_names, self.ranks.shape))}")
        where = np.argwhere(self.ranks == rank)
        self._coords = tuple(int(c) for c in where[0]) if len(where) else (0,) * self.ranks.ndim
        self._groups: Dict[str, Tuple[List[int], object]] = {}

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, (int(n) for n in self.ranks.shape)))

    @property
    def staged(self) -> bool:
        return self.transport == "staged"

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return self._coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of this rank's line along ``axis``, in axis order."""
        if axis not in self.axis_names:
            return [self.rank]
        sel = list(self._coords)
        sel[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.ranks[tuple(sel)]]

    def axis_group(self, axis: str):
        """The subgroup of this rank's line along ``axis``."""
        if axis not in self._groups:
            raise RuntimeError(f"the mesh has no group for axis {axis!r} (size "
                               f"{self.axis_size(axis)}): build it with build_mesh or "
                               f"make_training_mesh")
        return self._groups[axis][1]

    def make_axis_groups(self) -> None:
        """One subgroup per line of every axis above size 1.  Every process
        of the default group calls this, in one order: torch.distributed
        creates a group only where all of them ask for it."""
        for i, axis in enumerate(self.axis_names):
            if self.ranks.shape[i] == 1:
                continue
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if self.rank in members:
                    self._groups[axis] = (members, group)

    def destroy(self) -> None:
        """Tear the process group down (the rendezvous cannot be reused)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        axes = ",".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, rank={self.rank}, {self.transport} on {self.device})"


def parse_mesh_spec(spec: str) -> List[Tuple[str, int]]:
    """Parse ``"dp:2,tp:4"`` (or ``"dp=2,tp=4"``) into [("dp", 2), ("tp", 4)]."""
    out: List[Tuple[str, int]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, num = item.replace("=", ":").partition(":")
        out.append((name.strip(), int(num)))
    return out


def _bound_device(device: Union[str, torch.device, None], local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    from byteps_tpu_torch.core.state import get_state

    st = get_state()
    return st.device if st.initialized else torch.device("cuda", local_rank)


def _physical_device(device: torch.device) -> str:
    """Which card ``device`` is, host included, without touching CUDA:
    ``CUDA_VISIBLE_DEVICES`` maps the index to the card it names."""
    index = device.index if device.index is not None else 0
    visible = [v.strip() for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    card = visible[index] if index < len(visible) else str(index)
    return f"{socket.gethostname()}/{card}"


def _check_devices(store, rank: int, size: int, device: torch.device, transport: str) -> None:
    """Every rank names its card in the rendezvous store; NCCL on a card
    that two ranks share raises before any communicator comes up."""
    store.set(f"bps_mesh_device/{rank}", _physical_device(device))
    cards = [store.get(f"bps_mesh_device/{r}").decode() for r in range(size)]
    shared = sorted({c for c in cards if cards.count(c) > 1})
    if shared and transport != "staged":
        raise ValueError(
            f"ranks of the host's group share a CUDA device ({shared}): NCCL refuses "
            f"two ranks of one group on one device; ask for the staged transport, "
            f"build_mesh(..., transport=\"staged\") or BYTEPS_MESH_TRANSPORT=staged")


def _axes_of(spec: str, size: int) -> Dict[str, int]:
    axes = parse_mesh_spec(spec) or [(DP_AXIS, size)]
    names = [name for name, _ in axes]
    bad = [name for name in names if name not in SPEC_AXES]
    if bad or len(set(names)) != len(names):
        raise ValueError(f"mesh spec {spec!r}: axes must be distinct names of {SPEC_AXES}")
    if math.prod(n for _, n in axes) != size:
        raise ValueError(f"mesh spec {spec!r} does not match the host's {size} processes")
    return dict(axes)


def build_mesh(
    spec: str = "",
    device: Union[str, torch.device, None] = None,
    init_method: Optional[str] = None,
    transport: Optional[str] = None,
) -> Mesh:
    """Bring up the host's process group and return it as a Mesh.

    The rank and size are ``BYTEPS_LOCAL_RANK`` and ``BYTEPS_LOCAL_SIZE``;
    ``init_method`` defaults to ``BYTEPS_LOCAL_INIT_METHOD``, ``device`` to
    the one ``init()`` bound (else ``cuda:<local rank>``), ``transport`` to
    ``BYTEPS_MESH_TRANSPORT``.  ``spec`` lays the ranks out over named axes
    in its order (default: dp over all).  Raises when the spec's sizes do
    not multiply to the group's size, when CUDA ranks share a card without
    the staged transport, and when the group does not come up: a
    one-element all-reduce over it must give the group's size."""
    cfg = get_config()
    rank, size = cfg.local_rank, cfg.local_size
    axes = _axes_of(spec, size)
    transport = cfg.mesh_transport if transport is None else transport
    if transport not in TRANSPORTS:
        raise ValueError(f"mesh transport {transport!r}: one of {TRANSPORTS}")
    device = _bound_device(device, rank)
    backends = {"cuda": "nccl", "cpu": "gloo"}
    if device.type not in backends:
        raise ValueError(f"no collective backend for device {device}")
    if transport == "staged" and device.type != "cuda":
        raise ValueError(f"the staged transport moves CUDA tensors through host "
                         f"buffers; a {device} group runs gloo as it is")
    backend = "gloo" if transport == "staged" else backends[device.type]
    init_method = init_method or os.environ.get(LOCAL_INIT_METHOD)
    if not init_method:
        raise RuntimeError(
            f"the local group has no rendezvous: run under `python -m "
            f"byteps_tpu_torch.launcher.launch`, or set {LOCAL_INIT_METHOD}"
        )
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed default group exists already; the "
                           "host's local group is the process's default group")
    store, _, _ = next(dist.rendezvous(init_method, rank, size))
    if device.type == "cuda":
        _check_devices(store, rank, size, device, transport)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl":
        kwargs["device_id"] = device  # bring the communicator up now, not lazily
    dist.init_process_group(backend, store=store, rank=rank, world_size=size, **kwargs)
    mesh = Mesh(rank, size, device, backend,
                ranks=np.arange(size).reshape(tuple(axes.values())),
                axis_names=tuple(axes), transport=transport or backend)
    from byteps_tpu_torch.comm import collectives

    probe = collectives.push_pull(torch.ones(1, device=device), average=False, mesh=mesh)
    if probe.item() != size:
        mesh.destroy()
        raise RuntimeError(f"the {backend} group on {device} did not come up: an "
                           f"all-reduce of ones over {size} processes gave {probe.item()}")
    mesh.make_axis_groups()
    return mesh


def layout(base: Mesh, ranks: np.ndarray, axis_names: Sequence[str]) -> Mesh:
    """A mesh over ``base``'s process group with another layout: the ranks
    in ``ranks``, an array with axes ``axis_names``.  Every process of the
    group calls it, in one order (it creates the axes' subgroups)."""
    mesh = Mesh(base.rank, base.size, base.device, base.backend, ranks=ranks,
                axis_names=axis_names, transport=base.transport)
    mesh.group = base.group
    if base.size > 1:
        mesh.make_axis_groups()
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
    return (mesh or require_mesh()).axis_size(DP_AXIS)


def model_axes(mesh: Optional[Mesh]) -> Dict[str, int]:
    """The mesh's axes other than dp whose size is above 1."""
    if mesh is None:
        return {}
    return {ax: n for ax, n in mesh.shape.items() if ax != DP_AXIS and n > 1}


def as_axis_sizes(mesh: Union[Mesh, Mapping[str, int], None]) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh.shape) if isinstance(mesh, Mesh) else dict(mesh)
