"""DistributedDataParallel over the PS plane
(``byteps_tpu.torch.parallel``; the reference's
byteps/torch/parallel/distributed.py:13-287).

Wrap an ``nn.Module``: each parameter's post-accumulate-grad hook counts
down its bucket, and the last gradient of a bucket starts one push_pull of
the bucket's gradients concatenated on their device; ``grad_sync()`` waits
for every bucket and writes the averaged gradients back; ``no_sync()``
suspends communication for gradient accumulation.

    model = bps.parallel.DistributedDataParallel(net)
    for x, y in loader:
        loss = loss_fn(model(x), y)
        loss.backward()
        model.grad_sync()
        optimizer.step(); optimizer.zero_grad()

Buckets are the reference's exactly, so one fleet serves workers of both
packages: parameters in reverse declaration order (gradients arrive back
to front), a bucket closed once it holds ``bucket_bytes``, named
``DDP.<instance>.bucket.<i>`` with priority i.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import torch

from byteps_tpu_torch.api import declare_tensor, push_pull_async, synchronize
from byteps_tpu_torch.optim import weak_hook


class DistributedDataParallel(torch.nn.Module):
    """Gradient-averaging module wrapper.  Every worker must construct its
    wrappers in the same order: names are scoped by instance index."""

    _instances = 0

    def __init__(self, module: torch.nn.Module, bucket_bytes: int = 1 << 20) -> None:
        super().__init__()
        self.module = module
        self._sync_enabled = True
        self._handles: List[tuple] = []
        self._buckets: List[List[tuple]] = []
        self._iid = DistributedDataParallel._instances
        DistributedDataParallel._instances += 1

        bucket: List[tuple] = []
        size = 0
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        for name, p in reversed(named):
            bucket.append((name, p))
            size += p.numel() * p.element_size()
            if size >= bucket_bytes:
                self._buckets.append(bucket)
                bucket, size = [], 0
        if bucket:
            self._buckets.append(bucket)
        for bi in range(len(self._buckets)):
            declare_tensor(self._bucket_name(bi))
        self._pending: Dict[int, int] = {}  # bucket index -> gradients still to come
        for bi, bucket in enumerate(self._buckets):
            for _, p in bucket:
                p.register_post_accumulate_grad_hook(weak_hook(self, "_on_grad", bi))

    def _bucket_name(self, bi: int) -> str:
        return f"DDP.{self._iid}.bucket.{bi}"

    def forward(self, *args, **kwargs):
        self._pending = {bi: len(b) for bi, b in enumerate(self._buckets)}
        self._handles = []
        return self.module(*args, **kwargs)

    def _on_grad(self, p: torch.nn.Parameter, bi: int) -> None:
        if not self._sync_enabled:
            return
        remaining = self._pending.get(bi)
        if remaining is None:
            return
        self._pending[bi] = remaining - 1
        if remaining == 1:
            self._launch_bucket(bi)

    def _launch_bucket(self, bi: int) -> None:
        flat = torch.cat([p.grad.detach().reshape(-1) for _, p in self._buckets[bi]])
        handle = push_pull_async(flat, name=self._bucket_name(bi), average=True, priority=bi)
        self._handles.append((bi, handle))

    def grad_sync(self) -> None:
        """Wait for every launched bucket and write the averaged gradients
        back.  Raises if a parameter got no gradient this iteration: its
        bucket was never communicated, and the workers would drift apart."""
        if self._sync_enabled:
            stranded = [bi for bi, left in self._pending.items() if left > 0]
            if stranded:
                names = [n for bi in stranded for n, p in self._buckets[bi] if p.grad is None]
                raise RuntimeError(
                    "DistributedDataParallel: parameters received no gradient this "
                    f"iteration (unused in forward?): {names}; their buckets were "
                    "never communicated"
                )
        with torch.no_grad():
            for bi, handle in self._handles:
                flat = synchronize(handle)
                off = 0
                for _, p in self._buckets[bi]:
                    n = p.grad.numel()
                    p.grad.copy_(flat[off: off + n].view_as(p.grad))
                    off += n
        self._handles = []

    @contextlib.contextmanager
    def no_sync(self) -> Iterator[None]:
        """Suspend gradient communication (gradient accumulation)."""
        old = self._sync_enabled
        self._sync_enabled = False
        try:
            yield
        finally:
            self._sync_enabled = old
