"""Device-side codec adapters of the engine (``byteps_tpu.core.device_codec``).

The reference compresses on the CPU after staging the whole float32
gradient to the host (core_loops.cc:498-536).  Here the order is
inverted, as in ``byteps_tpu``: the codec runs on the device before the
device -> host copy, so COPYD2H moves only the wire payload (32 times less
for onebit, about n / 2k times for topk, 4 times for dithering), and the
pulled payload moves host -> device compressed and is decoded there.

On a CUDA tensor ``compress`` runs on the caller's current stream (the
engine's side stream) and copies exactly ``wire_nbytes()`` bytes into
pinned host memory, then waits on that copy's own event.  ``decompress``
moves the pulled payload through pinned memory to the device
(``non_blocking``) and decodes it on the current stream.  A CPU tensor
takes the same torch ops (for onebit, K4's plain version) with no copies.

Eligibility (:func:`device_codec_for`), as in the reference:

- bare codec chains only: error feedback and momentum are stateful host
  transforms of the whole gradient, so their chains take the host lane
  (the residual would need the full-size copy anyway);
- onebit (K4), topk and dithering.  randomk stays on the host: its
  contract is replaying the server's sequential xorshift128+ stream.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from byteps_tpu_torch.compression.registry import parse_codec_config
from byteps_tpu_torch.ops import codecs_device as cd
from byteps_tpu_torch.ops import onebit_device as ob


def _to_host(payload: torch.Tensor) -> np.ndarray:
    """A device payload as host bytes (a uint8 array); on CUDA the only
    device -> host copy of the partition."""
    if payload.device.type == "cpu":
        return payload.numpy()
    host = torch.empty(payload.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(payload, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


def _to_device(payload, device: torch.device) -> torch.Tensor:
    """A pulled payload as a uint8 tensor on ``device``."""
    src = np.frombuffer(payload, dtype=np.uint8)
    host = torch.empty(src.size, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host.numpy()[:] = src
    return host.to(device, non_blocking=True) if device.type == "cuda" else host


class _DeviceOneBit:
    #: its wire_nbytes() is exact and equals its host twin's
    wire_static = True

    def __init__(self, size: int, scaling: bool) -> None:
        self.size = size
        self.scaling = scaling

    def wire_nbytes(self) -> int:
        """Exact wire payload size: the f32 scale plus the sign words."""
        return ob.wire_nbytes(self.size)

    def compress(self, dev_flat: torch.Tensor) -> np.ndarray:
        return _to_host(ob.onebit_payload_device(dev_flat, scaling=self.scaling))

    def decompress(self, payload, n: int, device: torch.device) -> torch.Tensor:
        """Decode a pulled payload into float32[n] on ``device``."""
        scale, words = ob.split_payload(_to_device(payload, device))
        return ob.onebit_decompress_device(scale, words, n)


class _DeviceTopK:
    #: its wire_nbytes() is exact and equals its host twin's
    wire_static = True

    def __init__(self, size: int, k: int) -> None:
        self.size = size
        self.k = max(1, min(int(k), size))

    def wire_nbytes(self) -> int:
        """Exact wire payload size: k (i32 index, f32 value) pairs."""
        return 8 * self.k

    def compress(self, dev_flat: torch.Tensor) -> np.ndarray:
        return _to_host(cd.topk_payload_device(dev_flat, self.k))

    def decompress(self, payload, n: int, device: torch.device) -> torch.Tensor:
        return cd.topk_decompress_device(_to_device(payload, device), n)


class _DeviceDithering:
    #: its wire_nbytes() is exact and equals its host twin's
    wire_static = True

    def __init__(self, size: int, s: int, natural: bool, l2: bool, seed: int) -> None:
        self.size = size
        self.s = s
        self.natural = natural
        self.l2 = l2
        self._seed = seed or 0x5EED
        self._round = 0
        self._gen: Optional[torch.Generator] = None

    def wire_nbytes(self) -> int:
        """Exact wire payload size: the f32 norm plus one i8 level an
        element."""
        return 4 + self.size

    def compress(self, dev_flat: torch.Tensor) -> np.ndarray:
        # a fresh stream every round: stochastic rounding must not reuse
        # draws across steps (the host codec's stream is per call too)
        if self._gen is None or self._gen.device != dev_flat.device:
            self._gen = torch.Generator(device=dev_flat.device)
        self._gen.manual_seed(((self._seed << 32) + self._round) & 0xFFFFFFFFFFFFFFFF)
        self._round += 1
        return _to_host(cd.dithering_payload_device(
            dev_flat, self._gen, s=self.s, natural=self.natural, l2=self.l2))

    def decompress(self, payload, n: int, device: torch.device) -> torch.Tensor:
        return cd.dithering_decompress_device(_to_device(payload, device), n,
                                              s=self.s, natural=self.natural)


def device_codec_for(kwargs: Dict[str, str], size: int) -> Optional[object]:
    """The device adapter for a codec config, or None (host lane).  Parsing
    is the registry's, so this and ``create_compressor`` cannot disagree on
    what a config means."""
    cfg = parse_codec_config(kwargs, size)
    if cfg is None or cfg["ef"] or cfg["momentum"]:
        return None
    if cfg["ctype"] == "onebit":
        return _DeviceOneBit(size, cfg["scaling"])
    if cfg["ctype"] == "topk":
        return _DeviceTopK(size, cfg["k"])
    if cfg["ctype"] == "dithering":
        return _DeviceDithering(size, cfg["k"], cfg["natural"], cfg["l2"], cfg["seed"])
    return None
