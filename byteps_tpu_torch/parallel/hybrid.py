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

The keys are the reference's: its hybrid pushes one key per leaf of its
parameter tree, at the leaf's global shape, priority −(index in the
tree's order).  Two layouts:

- a module that gives its reference tree (``stacked_keys()``, as
  ``models.transformer.Transformer`` does) is pushed as that tree: one
  key per entry, ``"['<name>']"``, in the tree's sorted order; a layer
  parameter is one key stacked ``(pp, layers a stage, ...)`` over every
  layer of every stage, as the reference's ``init_params`` stacks it;
- any other module: one key per named parameter (``"['w1']"``,
  ``"['layers']['0']['wq']"`` for a dotted name), at its full shape.

So one fleet serves hybrids of both packages, sharded or not, the
transformer included.

On a mesh with model axes (tensor parallelism: ``param_specs`` shards a
parameter over tp; expert parallelism: a transformer's experts over sp;
pipeline parallelism: a stage holds its layers) a step runs:

1. level 1: ``collectives.sync_grads`` sums each gradient over the axes
   ``grad_sync_axes`` lists for it (dp, and sp and pp for what every rank
   uses, tp left to the model's f/g pair): a stage that did not use the
   embedding or the head adds zeros;
2. each gradient is gathered whole over the axes its spec shards; a
   stage's layer gradients are stacked and the stacks gathered over pp
   (``collectives.stack_stages``) into the key's ``(pp, layers a stage,
   ...)``;
3. the host's root pushes every key and pulls the sum over hosts; the
   root broadcasts the pulls to the group, averaged over the dp replicas
   and the hosts;
4. each rank narrows a pull to its stage's rows, then to its tp/sp block.

A module with no reference tree cannot run on a pp > 1 mesh: its stage
holds a part of the parameters, and it names no key for the rest.

    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1))
    for batch in loader:
        loss = hdp.step(batch, loss_fn)   # loss_fn(model, batch) -> scalar
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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


class _Key(NamedTuple):
    """One PS key: its name, its global shape, the parameters that fill it
    (this stage's layers in order when ``stacked``) and their specs."""

    name: str
    shape: Tuple[int, ...]
    params: List[torch.Tensor]
    specs: List[Tuple]
    stacked: bool


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
        layout = getattr(model, "stacked_keys", None)
        if layout is None and self.mesh.axis_size("pp") > 1:
            raise ValueError(
                f"{type(model).__name__} gives no reference parameter tree "
                "(stacked_keys(), as models.transformer.Transformer's): on a pp > 1 mesh a "
                "rank holds one stage's parameters, and the hybrid has no key for the other "
                "stages' part of them")
        self.model = model
        self.optimizer = optimizer
        self._iid = HybridDataParallel._instances
        HybridDataParallel._instances += 1
        prefix = f"{name_prefix}.{self._iid}"
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        by_name = dict(named)
        if layout is not None:
            entries = [(f"['{name}']", shape, members) for name, shape, members in layout()]
        else:
            entries = [(tree_path(n), None, [n]) for n, _ in named]
        listed = [n for _, _, members in entries for n in members]
        if sorted(listed) != sorted(by_name):
            raise ValueError(f"the keys' parameters {sorted(listed)} are not the model's "
                             f"trainable parameters {sorted(by_name)}")
        self._keys: List[_Key] = []
        for path, shape, members in entries:
            params = [by_name[n] for n in members]
            key_specs = [specs.get(n, ()) for n in members]
            full = self._full_shape(params[0], key_specs[0])
            stacked = shape is not None and len(shape) == len(full) + 2
            if shape is not None and tuple(shape)[2 if stacked else 0:] != full:
                raise ValueError(f"key {path} is {tuple(shape)}, but its parameters "
                                 f"{members} make {full} under param_specs")
            self._keys.append(_Key(prefix + path, tuple(shape or full), params, key_specs,
                                   stacked))
        self._sync = {n: tuple((grad_sync_axes or {}).get(n, (DP_AXIS,))) for n, _ in named}
        self._by_name = by_name
        self._sharded = bool(model_axes(self.mesh))
        #: (key, global shape) of every key, in push order
        self.keys = [(k.name, k.shape) for k in self._keys]
        for k in self._keys:
            declare_tensor(k.name)

    def _full_shape(self, p: torch.Tensor, spec: Tuple) -> Tuple[int, ...]:
        return tuple(n * self.mesh.axis_size(ax) if ax else n
                     for n, ax in zip(p.shape, spec + (None,) * (p.dim() - len(spec))))

    def step(self, batch: Any, loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]) -> float:
        """One two-level step; returns the loss averaged over the host's group."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(self.model, batch)
        loss.backward()
        mesh = self.mesh
        if self._sharded:  # level 1 here: dp (sp, pp) sums, then the root's view
            collectives.sync_grads(self._by_name, self._sync, mesh)
            loss = collectives.all_reduce_axis(loss.detach(), DP_AXIS, mesh)
            loss = loss / mesh.axis_size(DP_AXIS)
            mesh = _HostView(mesh)
        else:  # level 1 in host_push_pull_async: the group's all-reduce
            loss = collectives.push_pull(loss.detach(), average=True, mesh=mesh)
        # the three levels, front layers first across hosts
        handles = [host_push_pull_async(self._whole(k), k.name, average=True, priority=-i,
                                        version=0, mesh=mesh, reduced=self._sharded)
                   for i, k in enumerate(self._keys)]
        for k, h in zip(self._keys, handles):
            self._assign(k, synchronize(h))
        self.optimizer.step()
        return float(loss)

    def _whole(self, key: _Key) -> torch.Tensor:
        """The key's gradient at its global shape: each parameter's gathered
        over the axes its spec shards, a stage's layers stacked and the
        stages gathered over pp."""
        grads = []
        for p, spec in zip(key.params, key.specs):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            for dim, ax in enumerate(spec):
                if ax is not None:
                    g = collectives.all_gather_axis(g.contiguous(), ax, dim, self.mesh)
            grads.append(g)
        return collectives.stack_stages(grads, self.mesh) if key.stacked else grads[0]

    def _assign(self, key: _Key, full: torch.Tensor) -> None:
        """This rank's block of a pulled key as its parameters' gradients."""
        rows = full[self.mesh.axis_index("pp")] if key.stacked else [full]
        for p, spec, g in zip(key.params, key.specs, rows):
            for dim, ax in enumerate(spec):
                if ax is not None:
                    n = p.shape[dim]
                    g = g.narrow(dim, self.mesh.axis_index(ax) * n, n)
            p.grad = g.contiguous()
