"""Device-side codec adapters of the engine (``byteps_tpu.core.device_codec``).

The reference compresses on the CPU after staging the whole float32
gradient to the host (core_loops.cc:498-536).  Here the order is
inverted, as in ``byteps_tpu``: the packer runs on the device before the
device -> host copy, so COPYD2H moves only the wire payload (32 times less
for onebit), and the pulled payload moves host -> device compressed and is
decoded there.

On a CUDA tensor ``compress`` runs K4 on the caller's current stream (the
engine's side stream) and copies exactly ``wire_nbytes()`` bytes into
pinned host memory, then waits on that copy's own event.  ``decompress``
moves the pulled payload through pinned memory to the device
(``non_blocking``) and decodes it on the current stream.  A CPU tensor
takes the plain versions with no copies.

Eligibility (:func:`device_codec_for`): bare onebit chains.  topk and
dithering adapters are not ported (ROADMAP.md Queue 1b item P9); for them
this returns None and the engine's host path raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from byteps_tpu_torch.compression.registry import parse_codec_config
from byteps_tpu_torch.ops import onebit_device as ob


class _DeviceOneBit:
    def __init__(self, size: int, scaling: bool) -> None:
        self.size = size
        self.scaling = scaling

    def wire_nbytes(self) -> int:
        """Exact wire payload size: the f32 scale plus the sign words."""
        return ob.wire_nbytes(self.size)

    def compress(self, dev_flat: torch.Tensor) -> np.ndarray:
        """The wire payload as host bytes (a uint8 array); on CUDA the only
        device -> host copy of the partition."""
        payload = ob.onebit_payload_device(dev_flat, scaling=self.scaling)
        if payload.device.type == "cpu":
            return payload.numpy()
        host = torch.empty(payload.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy()

    def decompress(self, payload, n: int, device: torch.device) -> torch.Tensor:
        """Decode a pulled payload into float32[n] on ``device``."""
        src = np.frombuffer(payload, dtype=np.uint8)
        host = torch.empty(src.size, dtype=torch.uint8, pin_memory=device.type == "cuda")
        host.numpy()[:] = src
        if device.type == "cuda":
            host = host.to(device, non_blocking=True)
        scale, words = ob.split_payload(host)
        return ob.onebit_decompress_device(scale, words, n)


def device_codec_for(kwargs: Dict[str, str], size: int) -> Optional[_DeviceOneBit]:
    """The device adapter for a codec config, or None (host path).  Parsing
    is the registry's, so this and ``create_compressor`` cannot disagree on
    what a config means."""
    cfg = parse_codec_config(kwargs, size)
    if cfg is None or cfg["ef"] or cfg["momentum"]:
        return None
    if cfg["ctype"] == "onebit":
        return _DeviceOneBit(size, cfg["scaling"])
    return None
