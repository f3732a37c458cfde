"""DistributedOptimizer: a torch optimizer whose gradients go through
push_pull.

Each parameter's post-accumulate-grad hook starts a ``push_pull_async``
of its gradient, named ``Gradient.<name>`` with priority −(declaration
index), while the backward pass is still running.  ``step()`` waits for
every handle, writes the reduced gradients back, then steps the wrapped
optimizer.  Gradients are handed over as the device tensors they are: no
staging copy to the host.  ``compression_params`` (the spelling of the
reference plugin, e.g. ``{"compressor": "onebit", "scaling": True}``) is
translated to the byteps_* declare kwargs of every gradient.
``server_side=True`` (the reference's server-side optimizer) is not ported
and raises.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from byteps_tpu_torch.api import declare_tensor, push_pull_async, synchronize
from byteps_tpu_torch.compression.registry import translate_compression_params


class DistributedOptimizer(torch.optim.Optimizer):
    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
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
        self._handles: Dict[torch.nn.Parameter, int] = {}

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
        hook = _weak_hook(self)
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
        self._handles[p] = push_pull_async(
            p.grad, name=f"Gradient.{self._names[p]}", average=True,
            priority=-self._order[p],
        )

    def synchronize(self) -> None:
        """Wait for every in-flight gradient reduction and write it back."""
        for p, handle in list(self._handles.items()):
            out = synchronize(handle)
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


def _weak_hook(opt: DistributedOptimizer) -> Callable[[torch.nn.Parameter], None]:
    """The gradient hook, holding its optimizer weakly.  A parameter keeps
    its hooks for life, and the optimizer holds the parameter: a strong
    reference back is a cycle through autograd's C++ side that the
    collector cannot break, so every wrapped model would stay in memory."""
    ref = weakref.ref(opt)

    def hook(p: torch.nn.Parameter) -> None:
        alive = ref()
        if alive is not None:
            alive._hook(p)

    return hook
