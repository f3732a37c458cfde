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

``server_side=True`` (the reference's server-side optimizer) is not ported
and raises.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from byteps_tpu_torch.api import declare_tensor, push_pull_async, synchronize
from byteps_tpu_torch.compression.base import Compression
from byteps_tpu_torch.compression.registry import translate_compression_params


class DistributedOptimizer(torch.optim.Optimizer):
    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
        compression: Any = Compression.none,
        backward_passes_per_step: int = 1,
        compression_params: Optional[Dict] = None,
        server_side: bool = False,
    ) -> None:
        if server_side:
            from byteps_tpu_torch.common.config import unported

            raise unported("server_opt", "DistributedOptimizer(server_side=True)")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._inner = optimizer
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._compression = compression
        self._handles: Dict[torch.nn.Parameter, int] = {}
        #: level-1 context of each in-flight gradient (its dtype before the cast)
        self._ctx: Dict[torch.nn.Parameter, Any] = {}

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
        self._names = {p: n for n, p in named}
        self._order = {p: i for i, (_, p) in enumerate(named)}
        hook = weak_hook(self, "_hook")
        kw = translate_compression_params(compression_params)
        for name, p in named:
            declare_tensor(f"Gradient.{name}", **kw)
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(hook)

    def _hook(self, p: torch.nn.Parameter) -> None:
        if self._passes + 1 < self.backward_passes_per_step:
            return  # accumulate locally; communicate on the last pass
        if p in self._handles or p.grad is None:
            return
        grad, self._ctx[p] = self._compression.compress(p.grad)
        self._handles[p] = push_pull_async(
            grad, name=f"Gradient.{self._names[p]}", average=True,
            priority=-self._order[p],
        )

    def synchronize(self) -> None:
        """Wait for every in-flight gradient reduction and write it back."""
        for p, handle in list(self._handles.items()):
            out = self._compression.decompress(synchronize(handle), self._ctx.pop(p))
            if out is not p.grad:
                p.grad.copy_(out.view_as(p.grad))
        self._handles.clear()

    def step(self, closure=None):
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None  # still accumulating: no communication, no step
        self._passes = 0
        self.synchronize()
        return self._inner.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        return self._inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state_dict):
        return self._inner.load_state_dict(state_dict)


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
