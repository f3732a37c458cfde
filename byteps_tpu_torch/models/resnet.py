"""ResNet family (``byteps_tpu.models.resnet``): the reference's throughput
benchmark model (docs/performance.md:3-12, ResNet-50 at batch 64).

The modules take the reference's NHWC batch ``(B, H, W, 3)``, so that the
same numpy inputs go into both packages, and compute in NCHW with
``channels_last`` memory (a permute of an NHWC tensor is already that).
What the reference leaves to flax, spelled out:

- **SAME padding.** flax pads ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
  as ``(total // 2, total - total // 2)``: asymmetric at stride 2 (the
  7×7/2 stem on 224 pads (2, 3), a 3×3/2 conv (0, 1), the 3×3/2 max pool
  on 112 (0, 1) with −inf).  torch's symmetric ``padding=`` would give the
  same size over shifted windows, so an asymmetric pad goes through
  ``F.pad`` first (:func:`same_pads`).
- **BatchNorm** (:class:`BatchNorm`): flax's ``momentum=0.9,
  epsilon=1e-5``, statistics reduced in f32 as ``var = max(0, E[x²] −
  E[x]²)`` (biased), the running variance updated with that same biased
  variance (``torch.nn.BatchNorm2d`` would use the unbiased one), the
  normalization in f32 and the output in the compute dtype.  The
  parameters are ``scale`` and ``bias``, the running statistics the
  buffers ``mean`` and ``var``, each named as in flax's tree.
- Each block's last norm starts with scale 0; convolutions have no bias;
  the compute dtype follows ``dtype`` and the final Dense is f32.
- The init has flax's distributions (lecun-normal kernels, zero biases),
  not its draws: ``models.convert.conv_params_from_jax`` carries the
  reference's weights across.

Module and parameter names follow flax's tree (``conv_init``, ``bn_init``,
``BottleneckBlock_3.Conv_1``, ``conv_proj``, ``norm_proj``, ``Dense_0``),
so that the carry-over is a transpose of each kernel and nothing else.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "Dense", "ResNet", "ResNet18", "ResNet50", "ResNet101",
           "ResNetTiny", "same_pads", "to_nchw"]

#: flax's lecun_normal: a normal truncated at ±2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA's SAME padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen).mul_(std)


def to_nchw(x) -> torch.Tensor:
    """An NHWC batch (array or tensor) as NCHW with channels_last memory."""
    return torch.as_tensor(x).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding: an f32 OIHW ``weight``, computed
    in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32, gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight, cin * k * k, gen)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ph0, ph1), (pw0, pw1) = (same_pads(n, self.k, self.stride) for n in x.shape[2:])
        x = x.to(self.dtype)
        if (ph0, pw0) == (ph1, pw1):
            pad = (ph0, pw0)
        else:
            x, pad = F.pad(x, (pw0, pw1, ph0, ph1)), (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad)


class Dense(nn.Module):
    """flax ``nn.Dense``: an f32 ``(out, in)`` weight, computed in ``dtype``."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dout, din))
        _lecun_normal_(self.weight, din, gen)
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW input."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32, scale_init: float = 1.0,
                 momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.scale = nn.Parameter(torch.full((c,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mu = xf.mean((0, 2, 3))
            var = torch.clamp_min(xf.square().mean((0, 2, 3)) - mu.square(), 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mu)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mu[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    """The basic two-conv block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype, gen) -> None:
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, dtype=dtype, gen=gen)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype, gen=gen)
        self.BatchNorm_1 = BatchNorm(filters, dtype, scale_init=0.0)
        self.project = cin != filters or stride != 1
        if self.project:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype=dtype, gen=gen)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """The 1×1-3×3-1×1 bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype, gen) -> None:
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, dtype=dtype, gen=gen)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype, gen=gen)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, 1, dtype=dtype, gen=gen)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype, scale_init=0.0)
        self.project = cin != filters * 4 or stride != 1
        if self.project:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, dtype=dtype, gen=gen)
            self.norm_proj = BatchNorm(filters * 4, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``byteps_tpu.models.resnet.ResNet``: input NHWC ``(B, H, W, 3)``,
    logits ``(B, num_classes)`` in f32.  ``train()`` normalizes with the
    batch's statistics and updates the running ones; ``eval()`` uses the
    running ones."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, dtype=dtype, gen=gen)
        self.bn_init = BatchNorm(num_filters, dtype)
        cin, i = num_filters, 0
        for stage, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if stage > 0 and j == 0 else 1
                filters = num_filters * 2 ** stage
                block = block_cls(cin, filters, stride, dtype, gen)
                self.add_module(f"{block_cls.__name__}_{i}", block)
                cin, i = filters * block_cls.expansion, i + 1
        self.n_blocks = i
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(cin, num_classes, torch.float32, gen)

    def forward(self, x) -> torch.Tensor:
        x = self.conv_init(to_nchw(x))
        x = F.relu(self.bn_init(x))
        (ph0, ph1), (pw0, pw1) = (same_pads(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (pw0, pw1, ph0, ph1), value=float("-inf")), 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        return self.Dense_0(x.mean((2, 3)))


def ResNet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, **kw)


def ResNetTiny(**kw) -> ResNet:
    """The reference's CPU-test variant."""
    kw.setdefault("num_filters", 8)
    kw.setdefault("num_classes", 10)
    return ResNet([1, 1], ResNetBlock, **kw)
