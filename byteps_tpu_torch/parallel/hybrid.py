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

    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1))
    for batch in loader:
        loss = hdp.step(batch, loss_fn)   # loss_fn(model, batch) -> scalar
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from byteps_tpu_torch.api import declare_tensor, host_push_pull_async, synchronize
from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import Mesh, get_global_mesh
from byteps_tpu_torch.common.config import unported


def tree_path(name: str) -> str:
    """A dotted parameter name as the reference's pytree key path:
    ``"layers.0.wq"`` -> ``"['layers']['0']['wq']"``, so the PS keys equal
    ``byteps_tpu``'s for the same parameter tree."""
    return "".join(f"['{part}']" for part in name.split("."))


class HybridDataParallel:
    """Two-level DDP over ``mesh`` (default: the global mesh) and the PS.

    ``param_specs`` maps a parameter name to its partition spec, a tuple
    of mesh axis names or None per dimension, as the reference's
    PartitionSpecs; a spec that shards a parameter (tensor parallelism)
    is not ported and raises."""

    _instances = 0

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        mesh: Optional[Mesh] = None,
        name_prefix: str = "Hybrid",
        param_specs: Optional[Mapping[str, Sequence[Any]]] = None,
    ) -> None:
        self.mesh = mesh or get_global_mesh()
        if self.mesh is None:
            raise RuntimeError("no mesh: init() under the launcher, or pass "
                               "mesh=build_mesh(...)")
        sharded = sorted(n for n, spec in (param_specs or {}).items()
                         if any(ax is not None for ax in spec))
        if sharded:
            raise unported("model_parallel", f"param_specs sharding {sharded}")
        self.model = model
        self.optimizer = optimizer
        self._iid = HybridDataParallel._instances
        HybridDataParallel._instances += 1
        prefix = f"{name_prefix}.{self._iid}"
        self._params = [p for _, p in model.named_parameters() if p.requires_grad]
        self._names = [f"{prefix}{tree_path(n)}" for n, p in model.named_parameters()
                       if p.requires_grad]
        for name in self._names:
            declare_tensor(name)

    def step(self, batch: Any, loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]) -> float:
        """One two-level step; returns the loss averaged over the host's group."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(self.model, batch)
        loss.backward()
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
