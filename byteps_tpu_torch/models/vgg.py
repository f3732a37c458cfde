"""VGG family (``byteps_tpu.models.vgg``): the reference's
communication-bound benchmark model (docs/performance.md:3-12; VGG-16's
25088×4096 dense layer alone is 411 MB of f32 gradient).

Input NHWC ``(B, H, W, 3)`` as the reference's, computed in NCHW with
``channels_last`` memory.  The max pool is 2×2/2 VALID; the convolutions
are 3×3 SAME with a bias (flax's default).  Before the first Dense the
features are flattened in the reference's NHWC order (H, W, C), so that
the carried-over 25088×4096 kernel multiplies the features it was made
for.  Names follow flax's tree (``Conv_0``..``Conv_12``,
``Dense_0``..``Dense_2``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch.models.resnet import Conv, Dense, to_nchw

__all__ = ["VGG", "VGG16", "VGG11", "VGGTiny"]

_CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_CFG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


class VGG(nn.Module):
    """``byteps_tpu.models.vgg.VGG`` for ``image`` × ``image`` inputs (the
    first Dense's width depends on it, as flax infers it at init)."""

    def __init__(self, cfg: Sequence, num_classes: int = 1000, hidden: int = 4096,
                 dtype: torch.dtype = torch.float32, image: int = 224,
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.cfg, self.dtype = list(cfg), dtype
        cin, side, n = 3, image, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                self.add_module(f"Conv_{n}", Conv(cin, v, 3, bias=True, dtype=dtype, gen=gen))
                cin, n = v, n + 1
        self.Dense_0 = Dense(side * side * cin, hidden, dtype, gen)
        self.Dense_1 = Dense(hidden, hidden, dtype, gen)
        self.Dense_2 = Dense(hidden, num_classes, torch.float32, gen)

    def forward(self, x) -> torch.Tensor:
        x, n = to_nchw(x).to(self.dtype), 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{n}")(x))
                n += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (H, W, C) order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def VGG16(**kw) -> VGG:
    return VGG(_CFG16, **kw)


def VGG11(**kw) -> VGG:
    return VGG(_CFG11, **kw)


def VGGTiny(**kw) -> VGG:
    """The reference's CPU-test variant."""
    kw.setdefault("num_classes", 10)
    kw.setdefault("hidden", 64)
    return VGG([8, "M", 16, "M"], **kw)
