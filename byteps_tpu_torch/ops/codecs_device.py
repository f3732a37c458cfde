"""topk and dithering compression on the device, as plain torch ops.

The reference runs them as XLA ops on the device
(``byteps_tpu/ops/codecs_device.py``) so that the copy to the host carries
the wire payload, not the float32 gradient: 8k bytes for topk instead of
4n, 4 + n for dithering.  Each function here takes the flat partition on
any device and leaves its payload in one contiguous uint8 tensor there, so
the copy to the host is one copy of exactly the wire size.

- topk: byte for byte the host codec's wire (``compression/impl.py``),
  ``[(i32 index, f32 value) x k]`` with indices ascending.  Magnitudes
  that tie at the k-th place select the lower indices, as ``lax.top_k``
  and the reference's host paths do; ``torch.topk`` promises no tie order,
  so the selection is a stable descending sort of the magnitudes.
- dithering: ``[f32 norm][i8 levels]`` on the host codec's level grid.
  The draws come from the ``torch.Generator`` the caller passes, not from
  the host codec's sequential xorshift128+ stream; the server decodes
  without re-deriving any draw, so only the rounding's unbiasedness
  matters.  The decoder is exact: it computes the host codec's float64
  values from a table of the 256 signed levels and rounds once to float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def topk_compress_device(grad: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 indices ascending, float32 values) of the k largest
    magnitudes, ties toward the lower index."""
    flat = grad.reshape(-1).float()
    k = max(1, min(int(k), flat.numel()))
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    idx = torch.sort(order).values
    return idx.to(torch.int32), flat[idx]


def topk_payload_device(grad: torch.Tensor, k: int) -> torch.Tensor:
    """The topk wire payload as a uint8 tensor of 8k bytes on ``grad``'s
    device."""
    idx, vals = topk_compress_device(grad, k)
    return torch.stack([idx, vals.view(torch.int32)], 1).view(torch.uint8).reshape(-1)


def topk_decompress_device(payload: torch.Tensor, n: int) -> torch.Tensor:
    """float32[n] on the payload's device: zeros but at the pairs'
    indices."""
    pairs = payload.view(torch.int32).view(-1, 2)
    out = torch.zeros(n, dtype=torch.float32, device=payload.device)
    out[pairs[:, 0].long()] = pairs[:, 1].view(torch.float32)
    return out


def dithering_compress_device(grad: torch.Tensor, generator: torch.Generator, s: int = 4,
                              natural: bool = False, l2: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(0-dim float32 norm, int8 levels[n]): |x| / norm rounded
    stochastically to the level grid, linear (|level| / s) or natural
    (2^(|level| - s)), with draws from ``generator``.  The norm is the max
    magnitude, or the l2 norm summed in float64, rounded to float32 (1 when
    it is 0)."""
    flat = grad.reshape(-1).float()
    if l2:
        norm = flat.double().square().sum().sqrt().float()
    else:
        norm = flat.abs().max()
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    u = torch.rand(flat.numel(), generator=generator, device=flat.device)
    p = flat.abs() / norm
    if natural:
        pos = p > 0
        j = torch.where(pos, torch.floor(torch.log2(torch.where(pos, p, 1.0))), 0.0)
        hi = pos & (j >= 0)
        lo = pos & (j < -s)
        mid = pos & ~hi & ~lo
        lo_level = (p / 2.0 ** (-s) > u).int()
        lo_b = torch.exp2(j)
        frac = (p - lo_b) / (torch.exp2(j + 1) - lo_b)
        mid_level = (s + j).int() + (frac > u).int()
        level = torch.where(hi, s, torch.where(lo, lo_level, torch.where(mid, mid_level, 0)))
    else:
        scaled = p * s
        fl = torch.floor(scaled)
        level = torch.clamp_max((fl + ((scaled - fl) > u)).int(), s)
    return norm, torch.where(torch.signbit(flat), -level, level).to(torch.int8)


def dithering_payload_device(grad: torch.Tensor, generator: torch.Generator, s: int = 4,
                             natural: bool = False, l2: bool = False) -> torch.Tensor:
    """The dithering wire payload as a uint8 tensor of 4 + n bytes on
    ``grad``'s device."""
    norm, levels = dithering_compress_device(grad, generator, s, natural, l2)
    return torch.cat([norm.reshape(1).view(torch.uint8), levels.view(torch.uint8)])


#: (s, natural, device) -> float64[256]: the signed magnitude of level
#: l at l + 128, as the host codec computes sign(l) * magnitude(|l|)
_tables: Dict[tuple, torch.Tensor] = {}


def _level_table(s: int, natural: bool, device: torch.device) -> torch.Tensor:
    key = (s, natural, device)
    table = _tables.get(key)
    if table is None:
        lv = np.arange(-128, 128, dtype=np.int32)
        a = np.abs(lv)
        mag = (np.where(a == 0, 0.0, 2.0 ** (a.astype(np.float64) - s)) if natural
               else a.astype(np.float64) / s)
        table = _tables.setdefault(key, torch.from_numpy(np.sign(lv) * mag).to(device))
    return table


def dithering_decompress_device(payload: torch.Tensor, n: int, s: int = 4,
                                natural: bool = False) -> torch.Tensor:
    """float32[n] on the payload's device, bit for bit the host codec's
    decode: signed magnitude times the norm in float64, rounded once."""
    norm = payload[:4].view(torch.float32).double()
    levels = payload[4:4 + n].view(torch.int8).long() + 128
    return (_level_table(s, natural, payload.device)[levels] * norm).float()
