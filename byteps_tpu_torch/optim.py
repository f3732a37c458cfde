"""DistributedOptimizer: a torch optimizer whose gradients go through
push_pull.

Each parameter's post-accumulate-grad hook starts a ``push_pull_async``
of its gradient, named ``Gradient.<name>`` with priority −(declaration
index), while the backward pass is still running.  ``step()`` waits for
every handle, writes the reduced gradients back, then steps the wrapped
optimizer.  Gradients are handed over as the device tensors they are: no
staging copy to the host.

Two levels of compression, as in the reference plugin:

- ``compression``, level 1: ``Compression.none``, or ``Compression.fp16``
  (a bfloat16 cast, as in ``byteps_tpu``), which puts a float32 gradient on
  the wire as bfloat16 and casts the pulled sum back, on the device;
- ``compression_params``, level 2, the reference's spelling (e.g.
  ``{"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov",
  "scaling": True}``), translated to the byteps_* declare kwargs of every
  gradient: onebit, topk, randomk or dithering, with or without error
  feedback and Nesterov momentum.

``server_side=True`` moves the optimizer to the servers
(``byteps_tpu.optim.DistributedOptimizer.server_step``, in torch idiom): each
gradient is declared with ``server_rule`` ("sgd", "momentum", "adam") and
``server_hp``, the worker holds no optimizer state (``optimizer`` may be
None, and is not stepped), the first ``step()`` seeds the servers with the
initial parameters, and each ``step()`` pushes ``p.grad`` and copies the
parameters the servers computed into ``p``.

The step builders of ``byteps_tpu.optim`` run over the host's process
group (``comm.mesh``, NCCL on the card), each process on its own part of
the batch: :func:`allreduce_gradients`, :func:`build_data_parallel_step`
(with ``accumulate_steps`` and the int8 ring, ``grad_quant_bits=8``),
:func:`build_batchnorm_data_parallel_step` (``build_flax_data_parallel_step``:
the batch statistics averaged beside the gradients) and
:func:`build_zero1_step`.  The reference's ``donate`` (buffer donation to
XLA) has no meaning for eager torch and is dropped.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from byteps_tpu_torch.api import declare_tensor, push_pull_async, synchronize
from byteps_tpu_torch.comm import collectives
from byteps_tpu_torch.comm.mesh import Mesh, get_global_mesh, require_mesh
from byteps_tpu_torch.common.types import divide
from byteps_tpu_torch.compression.base import Compression
from byteps_tpu_torch.compression.registry import translate_compression_params
from byteps_tpu_torch.ops.quantized_allreduce import quantized_psum


class DistributedOptimizer(torch.optim.Optimizer):
    def __init__(
        self,
        optimizer: Optional[torch.optim.Optimizer],
        named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
        compression: Any = Compression.none,
        backward_passes_per_step: int = 1,
        compression_params: Optional[Dict] = None,
        server_side: bool = False,
        server_rule: str = "sgd",
        server_hp: Optional[Dict] = None,
    ) -> None:
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.server_side = bool(server_side)
        if self.server_side:
            if compression is not Compression.none or compression_params:
                raise ValueError("server_side=True pushes raw gradients and pulls "
                                 "parameters: no compression")
            if optimizer is None and named_parameters is None:
                raise ValueError("server_side=True without an optimizer needs "
                                 "named_parameters")
            mesh = get_global_mesh()
            if mesh is not None and mesh.size > 1:
                # the group's all-reduce would sum the seed parameters
                raise ValueError("server_side=True runs one process a host: a local "
                                 f"group of {mesh.size} would sum its seed parameters")
        elif optimizer is None:
            raise TypeError("DistributedOptimizer needs an optimizer unless "
                            "server_side=True (the servers run the rule then)")
        self._inner = None if self.server_side else optimizer
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._compression = compression
        self._handles: Dict[torch.nn.Parameter, int] = {}
        #: level-1 context of each in-flight gradient (its dtype before the cast)
        self._ctx: Dict[torch.nn.Parameter, Any] = {}
        #: server_side: the first step seeds the servers with the parameters
        self._seeded = False
        #: server_side: parameters synchronize() pulled since the last step,
        #: whose gradients step() must not push again
        self._synced: set = set()

        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [
                (f"param_{gi}_{pi}", p)
                for gi, group in enumerate(optimizer.param_groups)
                for pi, p in enumerate(group["params"])
            ]
        if len(named) != len({n for n, _ in named}):
            raise ValueError("named_parameters contains duplicate names")
        if self._inner is not None:
            self.param_groups = optimizer.param_groups
            self.defaults = optimizer.defaults
            self.state = optimizer.state
        else:
            # no local optimizer state: the servers hold the rule's slots
            self.param_groups = [{"params": [p for _, p in named]}]
            self.defaults = {}
            self.state = {}
        self._names = {p: n for n, p in named}
        self._order = {p: i for i, (_, p) in enumerate(named)}
        hook = weak_hook(self, "_hook")
        kw = translate_compression_params(compression_params)
        if self.server_side:
            kw = {"byteps_server_opt": server_rule, "byteps_server_opt_hp": dict(server_hp or {})}
        for name, p in named:
            declare_tensor(f"Gradient.{name}", **kw)
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(hook)

    def _hook(self, p: torch.nn.Parameter) -> None:
        if self._passes + 1 < self.backward_passes_per_step:
            return  # accumulate locally; communicate on the last pass
        if self.server_side and not self._seeded:
            return  # the seed round goes first, in step()
        if p in self._handles or p.grad is None:
            return
        self._push(p, p.grad)

    def _push(self, p: torch.nn.Parameter, tensor: torch.Tensor) -> None:
        t, self._ctx[p] = self._compression.compress(tensor)
        self._handles[p] = push_pull_async(
            t, name=f"Gradient.{self._names[p]}", average=not self.server_side,
            priority=-self._order[p],
        )

    def synchronize(self) -> None:
        """Wait for every in-flight push_pull and write it back: the reduced
        gradient into ``p.grad``, or with ``server_side`` the servers'
        parameters into ``p``."""
        for p, handle in list(self._handles.items()):
            out = self._compression.decompress(synchronize(handle), self._ctx.pop(p))
            dst = p if self.server_side else p.grad
            if out is not dst:
                with torch.no_grad():
                    dst.copy_(out.view_as(dst))
        if self.server_side:
            self._synced.update(self._handles)
        self._handles.clear()

    def _server_step(self) -> None:
        """The seed round (the first time), then every gradient not pushed
        by its hook, and the pulled parameters into ``p``.  A gradient
        whose parameters a call of :meth:`synchronize` already pulled is
        not pushed again."""
        params = sorted(self._names, key=self._order.get)
        if not self._seeded:
            self._seeded = True
            for p in params:
                self._push(p, p.detach())
            self.synchronize()
            self._synced.clear()
        for p in params:
            if p not in self._handles and p not in self._synced and p.grad is not None:
                self._push(p, p.grad)
        self.synchronize()
        self._synced.clear()

    def step(self, closure=None):
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None  # still accumulating: no communication, no step
        self._passes = 0
        if self.server_side:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            self._server_step()
            return loss
        self.synchronize()
        return self._inner.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._inner is not None:
            return self._inner.zero_grad(set_to_none=set_to_none)
        for p in self._names:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()
        return None

    def state_dict(self):
        return self._inner.state_dict() if self._inner is not None else {}

    def load_state_dict(self, state_dict):
        if self._inner is not None:
            return self._inner.load_state_dict(state_dict)
        return None


def weak_hook(owner: object, method: str, *args) -> Callable[[torch.nn.Parameter], None]:
    """A parameter hook calling ``owner.<method>(p, *args)``, holding
    ``owner`` weakly.  A parameter keeps its hooks for life, and the owner
    (an optimizer, a DDP wrapper) holds the parameter: a strong reference
    back is a cycle through autograd's C++ side that the collector cannot
    break, so every wrapped model would stay in memory."""
    ref = weakref.ref(owner)

    def hook(p: torch.nn.Parameter) -> None:
        alive = ref()
        if alive is not None:
            getattr(alive, method)(p, *args)

    return hook


# --- step builders over the host's process group ---------------------------


class _MeshReducedOptimizer:
    """``inner`` whose ``step()`` first all-reduces every ``.grad`` over
    the mesh axes ``axis_names`` (:func:`distributed_optimizer`); every
    other attribute is the inner optimizer's."""

    def __init__(self, inner: torch.optim.Optimizer, axis_names: Tuple[str, ...],
                 average: bool, mesh: Optional[Mesh]) -> None:
        self.inner, self.axis_names, self.average, self.mesh = inner, axis_names, average, mesh

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)

    def step(self, closure: Optional[Callable[[], Any]] = None) -> Any:
        mesh = self.mesh or require_mesh()
        missing = [ax for ax in self.axis_names if ax not in mesh.axis_names]
        if missing:
            raise ValueError(f"axes {missing} are not axes of the mesh {mesh.shape}")
        n = 1
        for ax in self.axis_names:
            n *= mesh.axis_size(ax)
        for group in self.inner.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                for ax in self.axis_names:
                    g = collectives.all_reduce_axis(g, ax, mesh)
                p.grad = divide(g, n) if self.average else g
        return self.inner.step(closure)


def distributed_optimizer(optimizer: torch.optim.Optimizer,
                          axis_names: Tuple[str, ...] = ("dp",), average: bool = True,
                          mesh: Optional[Mesh] = None) -> _MeshReducedOptimizer:
    """Horovod-style wrap (``byteps_tpu.optim.distributed_optimizer``, there
    an optax chain): ``optimizer`` whose ``step()`` sums every gradient
    over the named axes of ``mesh`` (default: the global mesh), divides it
    by the product of their sizes when ``average``, then steps."""
    return _MeshReducedOptimizer(optimizer, tuple(axis_names), average, mesh)


def allreduce_gradients(parameters: Iterable[torch.Tensor], average: bool = True,
                        mesh: Optional[Mesh] = None) -> None:
    """All-reduce every ``.grad`` of ``parameters`` in place over the host's
    group, averaged when ``average`` (``byteps_tpu.optim.allreduce_gradients``,
    there an optax transform)."""
    mesh = mesh or require_mesh()
    for p in parameters:
        if p.grad is not None:
            p.grad.copy_(collectives.push_pull(p.grad, average=average, mesh=mesh))


def _grads(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def _mean_loss(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return collectives.push_pull(loss.detach(), average=True, mesh=mesh)


def build_data_parallel_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh] = None,
    accumulate_steps: int = 1,
    grad_quant_bits: Optional[int] = None,
) -> Callable[[Any], torch.Tensor]:
    """DistributedDataParallel as a step builder
    (``byteps_tpu.optim.build_data_parallel_step``): returns
    ``step(batch) -> loss``, which runs ``loss_fn(model, batch)`` on this
    process's part of the batch, averages the gradients over the host's
    group, steps ``optimizer`` (built over ``model``'s parameters) and
    returns the loss averaged over the group.

    ``accumulate_steps = k`` follows ``optax.MultiSteps``: the gradients
    accumulate locally as a running mean for k calls, and only the k-th
    all-reduces and steps the optimizer, with the MEAN of the k
    micro-gradients.

    ``grad_quant_bits=8``: every gradient, raveled in parameter order into
    one f32 vector, rides the int8 ring (``ops.quantized_allreduce``); the
    loss stays dense.  It does not combine with ``accumulate_steps > 1``."""
    if grad_quant_bits is not None and grad_quant_bits != 8:
        raise ValueError("grad_quant_bits: only 8 (int8) is supported")
    if grad_quant_bits and accumulate_steps > 1:
        raise ValueError("grad_quant_bits cannot combine with accumulate_steps>1")
    if accumulate_steps < 1:
        raise ValueError("accumulate_steps must be >= 1")
    mesh = mesh or require_mesh()
    params = [p for p in model.parameters() if p.requires_grad]
    acc: List[torch.Tensor] = []
    mini = 0

    def reduce(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if grad_quant_bits != 8:
            return collectives.push_pull_tree(grads, average=True, mesh=mesh)
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        mean = divide(quantized_psum(flat, mesh=mesh), mesh.size)
        out, off = [], 0
        for g in grads:
            out.append(mean[off: off + g.numel()].reshape(g.shape).to(g.dtype))
            off += g.numel()
        return out

    def step(batch: Any) -> torch.Tensor:
        nonlocal acc, mini
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads = _grads(params)
        if accumulate_steps > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            acc = grads if mini == 0 else [a + divide(g - a, mini + 1) for a, g in zip(acc, grads)]
            mini += 1
            if mini < accumulate_steps:
                optimizer.zero_grad(set_to_none=True)
                return _mean_loss(loss, mesh)
            grads, acc, mini = acc, [], 0
        for p, g in zip(params, reduce(grads)):
            p.grad = g
        optimizer.step()
        return _mean_loss(loss, mesh)

    return step


def build_batchnorm_data_parallel_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh] = None,
) -> Callable[[Any], torch.Tensor]:
    """DistributedDataParallel for models with batch statistics (conv nets
    with BatchNorm): the counterpart of
    ``byteps_tpu.optim.build_flax_data_parallel_step``.

    Returns ``step(batch) -> loss``.  Each process runs ``loss_fn(model,
    batch)`` in train mode on its part of the batch, so each normalizes
    with its own batch's statistics and updates its running ones.  Then
    the gradients and the updated running statistics (floating buffers
    only, as the reference's ``_pmean_float_leaves``) are averaged over the
    host's group, ``optimizer`` steps, and the loss comes back averaged."""
    mesh = mesh or require_mesh()
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(batch: Any) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads = collectives.push_pull_tree(_grads(params), average=True, mesh=mesh)
        if stats:
            with torch.no_grad():
                for b, mean in zip(stats, collectives.push_pull_tree(stats, average=True,
                                                                     mesh=mesh)):
                    b.copy_(mean)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return _mean_loss(loss, mesh)

    return step


def build_zero1_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    model: torch.nn.Module,
    make_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable[[], torch.optim.Optimizer], Callable[[Any], torch.Tensor]]:
    """ZeRO-1 data parallelism (``byteps_tpu.optim.build_zero1_step``): the
    optimizer state is sharded over the host's group.

    The parameters, flattened to f32 and padded to a multiple of the group
    size n, are cut into n shards.  ``init_fn()`` builds this rank's
    optimizer, ``make_optimizer([shard])``, over its REAL parameter shard
    (a flat f32 leaf tensor), so its state is 1/n of the whole, and returns
    it.  ``step(batch) -> loss``: backward on this process's part of the
    batch, the flattened f32 gradient reduce-scattered and divided by n,
    the shard stepped, the updated shards all-gathered back into the
    model's parameters (each in its dtype); the loss averaged over the
    group.

        init_fn, step = build_zero1_step(loss_fn, model,
                                         lambda ps: torch.optim.Adam(ps, lr=1e-3))
        opt = init_fn()
        loss = step(batch)
    """
    mesh = mesh or require_mesh()
    n = mesh.size
    params = [p for p in model.parameters() if p.requires_grad]
    total = sum(p.numel() for p in params)
    shard_size = (total + (-total) % n) // n
    own = slice(mesh.rank * shard_size, (mesh.rank + 1) * shard_size)
    held: Dict[str, Any] = {}

    def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        return torch.cat([flat, flat.new_zeros(n * shard_size - total)])

    def init_fn() -> torch.optim.Optimizer:
        shard = flatten(params)[own].clone().requires_grad_()
        held["shard"], held["opt"] = shard, make_optimizer([shard])
        return held["opt"]

    def step(batch: Any) -> torch.Tensor:
        if "opt" not in held:
            raise RuntimeError("build_zero1_step: call init_fn() before step()")
        shard, opt = held["shard"], held["opt"]
        for p in params:
            p.grad = None
        loss = loss_fn(model, batch)
        loss.backward()
        g_shard = collectives.reduce_scatter(flatten(_grads(params)), average=True, mesh=mesh)
        with torch.no_grad():
            shard.copy_(flatten(params)[own])
        shard.grad = g_shard
        opt.step()
        flat = collectives.all_gather(shard.detach(), mesh=mesh)
        with torch.no_grad():
            off = 0
            for p in params:
                p.copy_(flat[off: off + p.numel()].view_as(p))
                off += p.numel()
                p.grad = None
        return _mean_loss(loss, mesh)

    return init_fn, step
