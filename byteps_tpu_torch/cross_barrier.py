"""CrossBarrier: the pipelined per-parameter optimizer of BytePS's
cross-iteration scheduling (``byteps_tpu.torch.cross_barrier``; the
reference's byteps/torch/cross_barrier.py:28-382).

The global barrier between backward and the optimizer goes:

- each parameter's post-accumulate-grad hook starts one push_pull of its
  gradient the moment backward produces it, named
  ``CrossBarrier.<instance>.<param>`` with priority -(declaration index),
  so the front layers' gradients go first;
- a forward pre-hook on each module with parameters waits only for that
  module's gradients and updates its parameters, so step N+1's front
  layers compute while step N's back-layer gradients are still on the wire.

The per-parameter sgd, adam and rmsprop updates are those of
``byteps_tpu/cross_barrier.py:27-76``, in torch on the parameter's device,
written into ``p.data`` in place.

    model = Net()
    opt = bps.CrossBarrier(model, opt_name="sgd", lr=0.1)
    for x, y in loader:
        loss = loss_fn(model(x), y)   # pre-hooks wait, module by module
        loss.backward()               # gradient hooks start the pushes
    opt.step()                        # a final full barrier

A deliberate divergence from the reference: when two backward passes run
with no forward between them, the reference's hook applies the pending
update (which zeroes ``p.grad``) and then pushes the zeroed gradient.
Here the hook takes its snapshot of ``p.grad`` before it waits, so the
second push carries the gradient as the second backward left it (summed
onto the first, as autograd accumulates without ``zero_grad``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from byteps_tpu_torch.api import declare_tensor, push_pull_async, synchronize
from byteps_tpu_torch.optim import weak_hook


class _SGD:
    def __init__(self, lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr, self.mu, self.wd = lr, momentum, weight_decay
        self.state: Dict[str, torch.Tensor] = {}

    def update(self, name: str, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        if self.wd:
            grad = grad + self.wd * param
        if self.mu:
            m = self.state.get(name)
            m = grad if m is None else self.mu * m + grad
            self.state[name] = m
            grad = m
        return param - self.lr * grad


class _Adam:
    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    def update(self, name: str, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        if self.wd:
            grad = grad + self.wd * param
        t = self.t.get(name, 0) + 1
        self.t[name] = t
        m = self.b1 * self.m.get(name, torch.zeros_like(grad)) + (1 - self.b1) * grad
        v = self.b2 * self.v.get(name, torch.zeros_like(grad)) + (1 - self.b2) * grad ** 2
        self.m[name], self.v[name] = m, v
        mhat = m / (1 - self.b1 ** t)
        vhat = v / (1 - self.b2 ** t)
        return param - self.lr * mhat / (torch.sqrt(vhat) + self.eps)


class _RMSProp:
    def __init__(self, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.alpha, self.eps, self.wd = lr, alpha, eps, weight_decay
        self.sq: Dict[str, torch.Tensor] = {}

    def update(self, name: str, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        if self.wd:
            grad = grad + self.wd * param
        sq = (self.alpha * self.sq.get(name, torch.zeros_like(grad))
              + (1 - self.alpha) * grad ** 2)
        self.sq[name] = sq
        return param - self.lr * grad / (torch.sqrt(sq) + self.eps)


_OPTS = {"sgd": _SGD, "adam": _Adam, "rmsprop": _RMSProp}


class CrossBarrier:
    """Per-parameter pipelined optimizer over async push_pull handles.
    ``opt_name``: sgd | adam | rmsprop.  ``average=True`` divides the summed
    gradient by the number of workers before the update."""

    _instances = 0  # names are scoped by instance (GAN, teacher and student)

    def __init__(self, model: torch.nn.Module, opt_name: str = "sgd",
                 average: bool = True, **opt_kwargs) -> None:
        if opt_name not in _OPTS:
            raise ValueError(f"unsupported optimizer {opt_name!r}; use one of {list(_OPTS)}")
        self.model = model
        self.opt = _OPTS[opt_name](**opt_kwargs)
        self.average = average
        self._iid = CrossBarrier._instances
        CrossBarrier._instances += 1

        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self._order: Dict[int, int] = {id(p): i for i, (_, p) in enumerate(named)}
        self._names: Dict[int, str] = {
            id(p): f"CrossBarrier.{self._iid}.{n}" for n, p in named
        }
        self._params: List[torch.nn.Parameter] = [p for _, p in named]
        self._handles: Dict[int, int] = {}  # id(p) -> push_pull handle
        for p in self._params:
            declare_tensor(self._names[id(p)])
            p.register_post_accumulate_grad_hook(weak_hook(self, "_launch"))
        for mod in model.modules():
            if any(True for _ in mod.parameters(recurse=False)):
                mod.register_forward_pre_hook(self._pre_forward(mod))

    def _launch(self, p: torch.nn.Parameter) -> None:
        pid = id(p)
        # the snapshot comes first: _wait zeroes p.grad, and the push must
        # carry this backward's gradient (the reference pushes the zeros)
        grad = p.grad.detach().clone()
        if pid in self._handles:
            self._wait(p)  # two backward passes in a row: apply the first
        self._handles[pid] = push_pull_async(
            grad, name=self._names[pid], average=self.average, priority=-self._order[pid],
        )

    def _pre_forward(self, mod: torch.nn.Module):
        def hook(module, args):
            for p in mod.parameters(recurse=False):
                self._wait(p)

        return hook

    def _wait(self, p: torch.nn.Parameter) -> None:
        """Apply ``p``'s update once its gradient is back, and zero
        ``p.grad`` so that the next backward starts from a fresh gradient
        without a ``zero_grad`` call."""
        handle = self._handles.pop(id(p), None)
        if handle is None:
            return
        avg = synchronize(handle)
        with torch.no_grad():
            p.data.copy_(self.opt.update(self._names[id(p)], p.data,
                                         avg.view_as(p).to(p.dtype)))
            if p.grad is not None:
                p.grad.zero_()

    def step(self) -> None:
        """Full barrier: apply every outstanding update."""
        for p in self._params:
            self._wait(p)

    def zero_grad(self) -> None:
        """Apply the outstanding updates, then zero every gradient (the
        loop needs no zero_grad: each update zeroes its gradient)."""
        for p in self._params:
            self._wait(p)
            if p.grad is not None:
                p.grad.detach_()
                p.grad.zero_()

    def outstanding(self) -> int:
        """Gradients still in flight."""
        return len(self._handles)
