"""Mixed-precision training: f32 master weights and dynamic loss scaling
(``byteps_tpu.mixed_precision``, there a pair of optax transformations;
here wrappers around a ``torch.optim.Optimizer``).

- :func:`master_weights` keeps an f32 master of every parameter and runs
  the inner optimizer on the masters with the gradients upcast to f32.
  The parameter then moves by the update the reference emits,
  ``u = (bf16(m_new) - p)`` in the parameter's dtype, applied as
  ``p = p + u``: not a copy of ``m_new``, whose rounding would differ.
- :func:`dynamic_loss_scale` holds the loss scale.  The caller multiplies
  its loss by ``opt.scale`` before ``backward()``; ``step()`` unscales the
  gradients in f32, and on any inf or nan skips the step (no parameter
  moves and the inner optimizer's state is untouched: it is not stepped)
  and divides the scale by ``factor``, down to 1.  After
  ``growth_interval`` clean steps in a row the scale grows by ``factor``.

    opt = dynamic_loss_scale(master_weights(model.parameters(),
                                            lambda ms: torch.optim.AdamW(ms, lr=1e-4)))
    (loss * opt.scale).backward()
    opt.step()
    opt.zero_grad()
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

__all__ = ["MasterWeights", "DynamicLossScale", "master_weights", "dynamic_loss_scale"]


class MasterWeights:
    """The inner optimizer over f32 masters of ``params``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 make_inner: Callable[[List[torch.Tensor]], torch.optim.Optimizer]) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.masters = [p.detach().to(torch.float32).clone().requires_grad_()
                        for p in self.params]
        self.inner = make_inner(self.masters)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None if set_to_none else (p.grad.zero_() if p.grad is not None else None)
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """Step the masters on ``grads`` (f32, one a parameter; default the
        parameters' ``.grad`` upcast) and move each parameter by the
        emitted update."""
        if grads is None:
            grads = [p.grad for p in self.params]
        for m, g in zip(self.masters, grads):
            m.grad = None if g is None else g.to(torch.float32)
        self.inner.step()
        for p, m in zip(self.params, self.masters):
            p.add_(m.to(p.dtype) - p)


def master_weights(params: Iterable[torch.nn.Parameter],
                   make_inner: Callable[[List[torch.Tensor]], torch.optim.Optimizer]
                   ) -> MasterWeights:
    """``make_inner(masters)`` builds the inner optimizer over the f32
    masters of ``params`` (``byteps_tpu.mixed_precision.master_weights``)."""
    return MasterWeights(params, make_inner)


class DynamicLossScale:
    """Dynamic loss scaling around ``inner``: a torch optimizer or a
    :class:`MasterWeights`."""

    def __init__(self, inner, init_scale: float = 2.0 ** 15, growth_interval: int = 2000,
                 factor: float = 2.0) -> None:
        self.inner = inner
        self.growth_interval = growth_interval
        # the reference keeps the scale as an f32 scalar and unscales by its
        # f32 reciprocal: so does this, bit for bit
        self._scale = torch.tensor(init_scale, dtype=torch.float32)
        self._factor = torch.tensor(factor, dtype=torch.float32)
        self.good_steps = 0
        self.skipped = 0

    @property
    def scale(self) -> float:
        return float(self._scale)

    def _params(self) -> List[torch.Tensor]:
        if isinstance(self.inner, MasterWeights):
            return self.inner.params
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        """Unscale, then step ``inner`` or skip; returns whether it stepped."""
        params = self._params()
        grads = [p.grad for p in params]
        inv = torch.ones((), dtype=torch.float32) / self._scale
        on = {g.device: inv.to(g.device) for g in grads if g is not None}
        unscaled = [None if g is None else g.to(torch.float32) * on[g.device] for g in grads]
        # one host sync a step: the skip is a branch on the host
        flags = [torch.isfinite(u).all() for u in unscaled if u is not None]
        finite = bool(torch.stack([f.to(flags[0].device) for f in flags]).all()) if flags else True
        if finite:
            if isinstance(self.inner, MasterWeights):
                self.inner.step(unscaled)
            else:
                for p, u in zip(params, unscaled):
                    p.grad = None if u is None else u.to(p.dtype)
                self.inner.step()
            self.good_steps += 1
            if self.good_steps >= self.growth_interval:
                self._scale = self._scale * self._factor
                self.good_steps = 0
        else:
            self.skipped += 1
            self.good_steps = 0
            self._scale = torch.maximum(self._scale / self._factor,
                                        torch.ones((), dtype=torch.float32))
        return finite


def dynamic_loss_scale(inner, init_scale: float = 2.0 ** 15, growth_interval: int = 2000,
                       factor: float = 2.0) -> DynamicLossScale:
    """``byteps_tpu.mixed_precision.dynamic_loss_scale`` around ``inner``."""
    return DynamicLossScale(inner, init_scale, growth_interval, factor)
