"""Training-loop callbacks (``byteps_tpu.callbacks``, the Keras plugin's
callbacks as plain objects a torch loop calls at its hook points):

- :class:`BroadcastGlobalVariablesCallback`: syncs a model's state (and
  an optimizer's) from the root once, at the first hook;
- :class:`MetricAverageCallback`: each logged metric becomes the mean
  over the workers (a float64 push_pull named ``Metric.<name>``);
- :class:`LearningRateScheduleCallback`: ``lr(epoch) = initial_lr *
  multiplier(epoch)``, a constant on [start_epoch, end_epoch) or a
  callable, floored with ``staircase``;
- :class:`LearningRateWarmupCallback`: linear warmup from
  ``initial_lr / size()`` to ``initial_lr`` over ``warmup_epochs``.

:meth:`LearningRateScheduleCallback.apply` (or :func:`set_lr`) writes the
rate into a torch optimizer's ``param_groups``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

import byteps_tpu_torch as bps

__all__ = ["BroadcastGlobalVariablesCallback", "MetricAverageCallback",
           "LearningRateScheduleCallback", "LearningRateWarmupCallback", "set_lr"]


def set_lr(optimizer, lr: float) -> None:
    """Set every param group's ``lr`` of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = lr


class BroadcastGlobalVariablesCallback:
    """Sync the parameters (a state dict, or ``(name, tensor)`` pairs) and
    an optimizer's state from ``root_rank`` once, at the first call."""

    def __init__(self, root_rank: int = 0) -> None:
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, params: Any, optimizer: Optional[torch.optim.Optimizer] = None):
        if self._done:
            return params, optimizer
        self._done = True
        params = bps.broadcast_parameters(params, root_rank=self.root_rank)
        if optimizer is not None:
            bps.broadcast_optimizer_state(optimizer, root_rank=self.root_rank)
        return params, optimizer


class MetricAverageCallback:
    """Average a dict of metrics over the workers."""

    def on_epoch_end(self, metrics: Dict[str, float]) -> Dict[str, float]:
        out = {}
        for name, value in metrics.items():
            t = torch.tensor([float(value)], dtype=torch.float64)
            out[name] = float(bps.push_pull(t, name=f"Metric.{name}", average=True)[0])
        return out


class LearningRateScheduleCallback:
    """lr(epoch) = initial_lr * multiplier(epoch) on [start_epoch,
    end_epoch); ``staircase`` floors the epoch a callable sees."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True) -> None:
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        if callable(multiplier):
            self._fn, self._const = multiplier, None
        else:
            self._fn, self._const = None, float(multiplier)

    def lr(self, epoch: float) -> Optional[float]:
        """The rate for a (fractional) epoch; None outside the window."""
        if epoch < self.start_epoch:
            return None
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return None
        if self._const is not None:
            return self.initial_lr * self._const
        e = math.floor(epoch) if self.staircase else epoch
        return self.initial_lr * self._fn(e - self.start_epoch)

    def apply(self, optimizer, epoch: float) -> Optional[float]:
        """Set ``optimizer``'s rate for ``epoch`` where the window holds it;
        returns the rate set, or None."""
        lr = self.lr(epoch)
        if lr is not None:
            set_lr(optimizer, lr)
        return lr


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear warmup from initial_lr / size() to initial_lr over
    ``warmup_epochs`` (the reference's gradual warmup)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = False, steps_per_epoch: Optional[int] = None) -> None:
        if momentum_correction:
            raise NotImplementedError(
                "momentum_correction is not implemented yet; rescale the "
                "optimizer momentum manually during warmup (the reference "
                "applies m' = m * (lr_new/lr_old) each adjustment)"
            )
        self.warmup_epochs = warmup_epochs

        def mult(e: float) -> float:
            if warmup_epochs <= 0:
                return 1.0
            frac = min(1.0, (e + 1) / warmup_epochs)
            base = 1.0 / bps.size() if bps.size() else 1.0
            return base + (1.0 - base) * frac

        super().__init__(initial_lr, mult, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False)
