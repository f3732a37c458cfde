"""Block-quantized ring all-reduce over the host's group (EQuARX-style).

The port of ``byteps_tpu/ops/quantized_allreduce.py``: for a
bandwidth-bound all-reduce, each ring hop carries int8 with one f32 scale
per block instead of f32, ~4x fewer bytes, at the cost of quantization
noise that grows with the reduce-scatter's hop count.

Two-phase ring, each hop a ``batch_isend_irecv`` to the right-hand
neighbour (rank + 1) and from the left-hand one:

- reduce-scatter: N-1 hops; each hop quantizes the chunk it forwards
  (int8, scale max|x|/127 per block of ``block`` elements, a zero scale
  taken as 1), the receiver dequantizes and adds into its f32 chunk;
- all-gather: each member quantizes its finished chunk once and the int8
  payload circulates unchanged, so every member decodes the same bytes
  and the replicas stay bitwise identical.

The reference leaves quantize and dequantize to XLA; here they are plain
torch ops (``torch.round`` rounds half to even, as ``jnp.round`` does), on
the device of the tensor.  A group of one is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.mesh import Mesh, require_mesh


def quantize(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32[n], n a multiple of ``block`` -> (int8[n], f32 scales[n / block])."""
    amax = x.reshape(-1, block).abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA kernel multiplies by the reciprocal of
    # a Python scalar one, which rounds otherwise than the reference's division
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x.reshape(-1, block) / safe), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int = 256) -> torch.Tensor:
    return (q.reshape(-1, block).to(torch.float32) * scale.reshape(-1, 1)).reshape(-1)


def _hop(mesh: Mesh, payload: List[torch.Tensor]) -> List[torch.Tensor]:
    """Send ``payload`` to the right-hand neighbour and receive the
    left-hand one's, of the same shapes and dtypes."""
    right, left = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    got = [torch.empty_like(t) for t in payload]
    ops = [dist.P2POp(dist.isend, t, right, mesh.group) for t in payload]
    ops += [dist.P2POp(dist.irecv, t, left, mesh.group) for t in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def quantized_psum(
    x: torch.Tensor,
    axis_size: Optional[int] = None,
    block: int = 256,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """The SUM of ``x`` over the host's group with int8-quantized ring
    hops: f32 of ``x``'s shape, identical on every member.  ``axis_size``,
    when given, must be the group's size (a mismatch would mis-wire the
    ring)."""
    mesh = mesh or require_mesh()
    n = mesh.size
    if axis_size is not None and axis_size != n:
        raise ValueError(f"axis_size={axis_size} but the group has {n} members")
    if n == 1:
        return x.detach().to(torch.float32, copy=True)
    flat = x.detach().reshape(-1).to(torch.float32)
    m = flat.numel()
    # pad so the chunk count divides evenly and chunks divide into blocks
    chunk = -(-m // n)
    chunk = -(-chunk // block) * block
    chunks = flat.new_zeros(n * chunk)
    chunks[:m] = flat
    chunks = chunks.view(n, chunk)
    idx = mesh.rank

    # reduce-scatter: after N-1 hops member i holds the reduced chunk (i+1) % N
    for step in range(n - 1):
        q, s = _hop(mesh, list(quantize(chunks[(idx - step) % n], block)))
        chunks[(idx - step - 1) % n] += dequantize(q, s, block)

    # all-gather: one quantization of each finished chunk circulates unchanged
    fin = (idx + 1) % n
    q, s = quantize(chunks[fin], block)
    out = torch.zeros_like(chunks)
    out[fin] = dequantize(q, s, block)
    for step in range(1, n):
        q, s = _hop(mesh, [q, s])
        # received after `step` hops: member (idx - step)'s finished chunk
        out[(idx - step + 1) % n] = dequantize(q, s, block)
    return out.reshape(-1)[:m].reshape(x.shape)
