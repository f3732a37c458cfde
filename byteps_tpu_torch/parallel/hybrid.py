"""Hybrid two-level data parallelism: the local group inside the host, the
PS across hosts (the port of ``byteps_tpu/parallel/hybrid.py``).

BytePS's defining topology (docs/architecture.md:26-44): gradients are
first reduced INSIDE the machine over the fast local interconnect (NCCL),
and only the machine-level result crosses the network through the PS
push/pull plane.  One step:

- level 1: every local rank runs forward and backward on its part of the
  batch; the host's group sums every gradient (an all-reduce) and
  averages the loss;
- level 2: the local root pushes each summed gradient through the PS plane
  (priority = −declaration index, so the front layers go first) and pulls
  back the sum over hosts;
- level 3: the root broadcasts the result to the group, which divides it by
  the number of processes of all hosts, and every local rank applies the
  same update with its own optimizer.

The three levels are the host-level ``push_pull`` of ``api``
(``host_push_pull_async`` and ``synchronize``) on this object's mesh.

On a mesh with model axes (tensor parallelism: ``param_specs`` shards a
parameter over tp; expert parallelism: a transformer's experts over sp),
the local reduce runs over the mesh's dp axis (and the axes
``grad_sync_axes`` lists for a parameter, tp left to the model's f/g
pair), each sharded gradient is gathered over its sharded axes, and the host's root pushes and pulls it whole: one key per
parameter, at the parameter's full shape, as the reference's keys are.
The root broadcasts the pulls to the host's ranks, and each keeps its
shard.  So one fleet serves hybrids of both packages, sharded or not.

    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1))
    for batch in loader:
        loss = hdp.step(batch, loss_fn)   # loss_fn(model, batch) -> scalar
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

from byteps_tpu_torch.api import declare_tensor, host_push_pull_async, synchronize
from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import DP_AXIS, Mesh, get_global_mesh, model_axes


def tree_path(name: str) -> str:
    """A dotted parameter name as the reference's pytree key path:
    ``"layers.0.wq"`` -> ``"['layers']['0']['wq']"``, so the PS keys equal
    ``byteps_tpu``'s for the same parameter tree."""
    return "".join(f"['{part}']" for part in name.split("."))


class _HostView:
    """The host's whole group as the host-level push_pull sees it on a
    sharded mesh: the root's pulls broadcast to every rank, averaged over
    the dp replicas (``size``) and the hosts."""

    def __init__(self, mesh: Mesh) -> None:
        self.rank, self.size, self.device = mesh.rank, mesh.axis_size(DP_AXIS), mesh.device
        self.group, self.backend, self.transport = mesh.group, mesh.backend, mesh.transport
        self.staged = mesh.staged


class HybridDataParallel:
    """Two-level DDP over ``mesh`` (default: the global mesh) and the PS.

    ``param_specs`` maps a parameter name to its partition spec, a tuple
    of mesh axis names or None per dimension, as the reference's
    PartitionSpecs: a tp (sp) entry shards the dimension over the mesh's
    tp (sp) axis.  ``grad_sync_axes`` maps a name to the axes its gradient sums
    over (default dp; a transformer's ``model.grad_sync_axes()``).
    ``loss_fn`` returns the loss of this rank's dp replica; the hybrid
    averages over the replicas and the hosts."""

    _instances = 0

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        mesh: Optional[Mesh] = None,
        name_prefix: str = "Hybrid",
        param_specs: Optional[Mapping[str, Sequence[Any]]] = None,
        grad_sync_axes: Optional[Mapping[str, Sequence[str]]] = None,
    ) -> None:
        self.mesh = mesh or get_global_mesh()
        if self.mesh is None:
            raise RuntimeError("no mesh: init() under the launcher, or pass "
                               "mesh=build_mesh(...)")
        specs = {n: tuple(spec) for n, spec in (param_specs or {}).items()}
        for name, spec in specs.items():
            bad = [ax for ax in spec if ax is not None and ax not in ("tp", "sp")]
            if bad:
                raise ValueError(f"param_specs of {name!r}: {spec} shards over {bad}; a "
                                 f"hybrid shards parameters over tp and sp only")
        if self.mesh.axis_size("pp") > 1:
            raise ValueError("a hybrid runs one pipeline stage per rank's model: its mesh "
                             "takes dp, sp and tp axes (build_train_step runs pp)")
        self.model = model
        self.optimizer = optimizer
        self._iid = HybridDataParallel._instances
        HybridDataParallel._instances += 1
        prefix = f"{name_prefix}.{self._iid}"
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self._params = [p for _, p in named]
        self._names = [f"{prefix}{tree_path(n)}" for n, _ in named]
        self._specs = [specs.get(n, ()) for n, _ in named]
        self._sync = {n: tuple((grad_sync_axes or {}).get(n, (DP_AXIS,))) for n, _ in named}
        self._by_name = dict(named)
        self._sharded = bool(model_axes(self.mesh))
        #: (key, full shape) of every parameter, in push order
        self.keys = [(name, self._full_shape(p, spec))
                     for name, p, spec in zip(self._names, self._params, self._specs)]
        for name in self._names:
            declare_tensor(name)

    def _full_shape(self, p: torch.Tensor, spec: Tuple) -> Tuple[int, ...]:
        return tuple(n * self.mesh.axis_size(ax) if ax else n
                     for n, ax in zip(p.shape, spec + (None,) * (p.dim() - len(spec))))

    def step(self, batch: Any, loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]) -> float:
        """One two-level step; returns the loss averaged over the host's group."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(self.model, batch)
        loss.backward()
        if self._sharded:
            return self._sharded_step(loss)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._params]
        loss = collectives.push_pull(loss.detach(), average=True, mesh=self.mesh)
        # the three levels, front layers first across hosts
        handles = [host_push_pull_async(g, name, average=True, priority=-i, version=0,
                                        mesh=self.mesh)
                   for i, (g, name) in enumerate(zip(grads, self._names))]
        for p, h in zip(self._params, handles):
            p.grad = synchronize(h)
        self.optimizer.step()
        return float(loss)

    def _sharded_step(self, loss: torch.Tensor) -> float:
        mesh = self.mesh
        collectives.sync_grads(self._by_name, self._sync, mesh)  # level 1: dp (and sp) sums
        loss = collectives.all_reduce_axis(loss.detach(), DP_AXIS, mesh) / mesh.axis_size(DP_AXIS)
        view = _HostView(mesh)
        handles = []
        for i, (p, name, spec) in enumerate(zip(self._params, self._names, self._specs)):
            g = p.grad
            for dim, ax in enumerate(spec):
                if ax is not None:
                    g = collectives.all_gather_axis(g.contiguous(), ax, dim, mesh)
            handles.append(host_push_pull_async(g, name, average=True, priority=-i,
                                                version=0, mesh=view, reduced=True))
        for p, h, spec in zip(self._params, handles, self._specs):
            full = synchronize(h)
            for dim, ax in enumerate(spec):
                if ax is not None:
                    n = p.shape[dim]
                    full = full.narrow(dim, mesh.axis_index(ax) * n, n)
            p.grad = full.contiguous()
        self.optimizer.step()
        return float(loss)
