"""Onebit compression on the device: the sign packer K4, its plain PyTorch
version, and the decoder.

The reference packs sign bits on the device so that only the 4-byte scale
and n/32 words cross to the host (``byteps_tpu/ops/onebit_device.py``).
The port keeps that order: ``onebit_payload_device`` runs K4
(``csrc/onebit.cu``, replacing ``_pack_kernel``) on a CUDA tensor and
leaves the wire payload ``[f32 scale][u32 words]`` in one contiguous device
buffer, so the copy to the host is one copy of exactly
``4 + 4*ceil(n/32)`` bytes.  The payload is byte for byte the host codec's
(``compression/impl.py``) and the reference's.

K4 is one launch a call, reading x in 16-byte loads (any contiguous
view: a start that is not 16-byte aligned and a ragged end take a scalar
path in the same kernel), and the wrapper allocates only the payload: the
kernel's scratch (one float64 partial a block and the ticket that tells
the last block to finish) is a workspace kept per (device, stream),
zeroed once when it is made (:func:`_workspace`).

Dispatch is by where the tensor lies: a CPU tensor takes the plain
version, :func:`_plain_payload`; a CUDA tensor launches K4 or raises.
There is no fallback from one to the other.  Both compute the scale as a
float64 sum rounded once to float32; the reference sums in float32, so
its scale may differ in the last place (``test_ops.py:80-99`` allows rtol
1e-6), while the sign words are bit-exact.

The decoder, :func:`onebit_decompress_device`, is plain torch, as the
reference's is plain jnp (``onebit_device.py:104-110``); it does its bit
tests in int32, since torch.uint32 has partial support.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from byteps_tpu_torch.ops._build import load_library

#: K4 launches since the last :func:`reset_launches`; the wrapper adds one
#: where it launches the kernel and nowhere else
launches = {"onebit_pack": 0}

#: blocks of the packing launch: a fixed function of n, never of the
#: card, so the partial sums and their order (and so the scale's bits)
#: depend on n and on x's offset past a 16-byte boundary alone.  A block
#: packs _BLOCK_ELEMS elements at a time (the kernel's kWarps warps of
#: kChunk); _MAX_BLOCKS is the kernel's kMaxBlocks, the partials its
#: workspace holds
_BLOCK_ELEMS, _MAX_BLOCKS = 8 * 1024, 1024

#: ctypes signature of ``bps_onebit_pack`` (csrc/onebit.cu): x, n, scaling,
#: out, workspace, nblocks, stream
_PACK_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def reset_launches() -> None:
    launches["onebit_pack"] = 0


def wire_nbytes(n: int) -> int:
    """Payload bytes for n elements: the f32 scale plus ceil(n/32) words."""
    return 4 + 4 * ((n + 31) // 32)


def _num_blocks(n: int) -> int:
    return max(1, min(-(-n // _BLOCK_ELEMS), _MAX_BLOCKS))


# ---------------------------------------------------------------------------
# plain version (CPU tensors, and the reference K4 is held to)
# ---------------------------------------------------------------------------


def _plain_payload(flat: torch.Tensor, scaling: bool) -> torch.Tensor:
    """What K4 computes, in torch ops on any device: the uint8 payload."""
    flat = flat.reshape(-1).float()
    n = flat.numel()
    if scaling and n:
        scale = (flat.abs().sum(dtype=torch.float64) / n).float()
    else:
        scale = torch.ones((), dtype=torch.float32, device=flat.device)
    nwords = (n + 31) // 32
    bits = torch.zeros(nwords * 32, dtype=torch.int64, device=flat.device)
    bits[:n] = torch.signbit(flat).long()
    shifts = torch.arange(32, dtype=torch.int64, device=flat.device)
    words = (bits.view(nwords, 32) << shifts).sum(1)
    # values < 2^32 as int64 -> the same 32 bits as int32 (two's complement)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.cat([scale.reshape(1).view(torch.uint8), words.view(torch.uint8)])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = load_library("onebit")
        lib.bps_onebit_pack.argtypes = _PACK_ARGTYPES
        lib.bps_onebit_pack.restype = ctypes.c_int
        lib.bps_onebit_workspace_bytes.argtypes = []
        lib.bps_onebit_workspace_bytes.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


#: K4's workspace per (device index, stream handle): launches on one stream
#: run in order, so they can share it; two streams never do
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """The workspace of K4's launches on ``stream``, made (zeroed, on that
    stream) at its first launch."""
    key = (device.index, stream.cuda_stream)
    ws = _workspaces.get(key)
    if ws is None:
        nbytes = _lib().bps_onebit_workspace_bytes()
        ws = _workspaces.setdefault(key, torch.zeros(nbytes, dtype=torch.uint8, device=device))
    return ws


def onebit_payload_device(grad: torch.Tensor, scaling: bool = True) -> torch.Tensor:
    """The onebit wire payload of ``grad`` as a uint8 tensor of
    ``wire_nbytes(numel)`` bytes on ``grad``'s device.  CUDA: K4 on the
    current stream (float32 only); CPU: the plain version."""
    if grad.device.type == "cpu":
        return _plain_payload(grad, scaling)
    if grad.device.type != "cuda":
        raise ValueError(f"onebit packer: unsupported device {grad.device}")
    if grad.dtype != torch.float32:
        raise TypeError(f"onebit packer (K4) takes float32, got {grad.dtype}")
    flat = grad.reshape(-1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    n = flat.numel()
    if n == 0:
        raise ValueError("onebit packer: empty tensor")
    stream = torch.cuda.current_stream(flat.device)
    ws = _workspace(flat.device, stream)
    out = torch.empty(wire_nbytes(n), dtype=torch.uint8, device=flat.device)
    err = _lib().bps_onebit_pack(
        flat.data_ptr(), n, int(bool(scaling)), out.data_ptr(), ws.data_ptr(),
        _num_blocks(n), stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"onebit_pack kernel launch failed: cudaError {err}")
    launches["onebit_pack"] += 1
    return out


def split_payload(payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, words) views of a uint8 payload tensor: a 0-dim float32 and
    int32 words holding the u32 bit patterns."""
    return payload[:4].view(torch.float32)[0], payload[4:].view(torch.int32)


def onebit_compress_device(grad: torch.Tensor, scaling: bool = True):
    """(scale, words) of ``grad``: the reference's return shape, on the
    device, with the words as int32 bit patterns."""
    return split_payload(onebit_payload_device(grad, scaling))


def onebit_payload(scale: torch.Tensor, words: torch.Tensor) -> bytes:
    """Frame device-compressed pieces as the host wire format."""
    return (scale.detach().reshape(1).float().cpu().view(torch.uint8).numpy().tobytes()
            + words.detach().to(torch.int32).cpu().view(torch.uint8).numpy().tobytes())


_shifts: dict = {}


def onebit_decompress_device(scale: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse, on the words' device: float32[n] of -scale where the
    bit is set, else scale.  In bits: bit i of word j is moved to bit 31
    and XORed into the scale's bits, which is IEEE negation; three
    elementwise launches, since each launch costs the engine's decode
    thread a round trip through the interpreter lock."""
    w = words.view(torch.int32) if words.dtype != torch.int32 else words
    shifts = _shifts.get(w.device)
    if shifts is None:
        shifts = _shifts[w.device] = 31 - torch.arange(32, dtype=torch.int32, device=w.device)
    signs = (w[:, None] << shifts) & torch.iinfo(torch.int32).min
    bits = scale.to(device=w.device, dtype=torch.float32).view(torch.int32)
    return (signs.reshape(-1)[:n] ^ bits).view(torch.float32)
