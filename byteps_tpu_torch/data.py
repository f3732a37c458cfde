"""Input utilities: worker sharding and device prefetch
(``byteps_tpu.data`` in torch idiom).

- :func:`shard_for_worker` / :class:`ShardedDataset`: a deterministic
  per-worker (and per-epoch shuffled) sharding of an index space, in numpy
  as in the reference, so that the indices are the reference's bit for bit.
  The defaults are this worker's ``rank()`` and the job's ``size()``.
- :func:`prefetch_to_device`: keeps ``size`` batches in flight on the
  device.  Each batch is copied from pinned host memory with
  ``non_blocking=True`` on a side CUDA stream; the consumer's stream waits
  on the batch's event and each tensor is ``record_stream``-ed to it, so
  that the next batch's H2D copy overlaps this step (the reference's CUDA
  copy streams, global.cc:253-268).  On the CPU the batches pass through
  as tensors.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["shard_for_worker", "ShardedDataset", "prefetch_to_device"]


def shard_for_worker(
    num_examples: int,
    worker_rank: Optional[int] = None,
    num_workers: Optional[int] = None,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
) -> np.ndarray:
    """Indices owned by this worker: shuffled globally (the same seed on
    every worker), then strided, so that the shards are disjoint and
    balanced."""
    from byteps_tpu_torch.api import rank, size

    rank_ = rank() if worker_rank is None else worker_rank
    world = size() if num_workers is None else num_workers
    idx = np.arange(num_examples)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if drop_remainder:
        idx = idx[: num_examples // world * world]
    return idx[rank_::world]


class ShardedDataset:
    """An epoch iterator over (x, y, ...) arrays, sharded per worker and
    reshuffled each epoch with seed ``seed + epoch``."""

    def __init__(self, arrays, batch_size: int, seed: int = 0,
                 worker_rank: Optional[int] = None, num_workers: Optional[int] = None) -> None:
        self.arrays = tuple(np.asarray(a) for a in arrays)
        n = {len(a) for a in self.arrays}
        if len(n) != 1:
            raise ValueError(f"arrays disagree on length: {n}")
        self.num_examples = n.pop()
        self.batch_size = batch_size
        self.seed = seed
        self.worker_rank = worker_rank
        self.num_workers = num_workers

    def epoch(self, epoch: int = 0) -> Iterator[tuple]:
        idx = shard_for_worker(self.num_examples, self.worker_rank, self.num_workers,
                               seed=self.seed + epoch)
        for i in range(0, len(idx) - self.batch_size + 1, self.batch_size):
            sel = idx[i: i + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)


def _map(batch: Any, fn) -> Any:
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(batch))
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(v, fn) for v in batch)
    return batch


def _tensors(batch: Any) -> list:
    out: list = []
    _map(batch, out.append)
    return out


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: Union[str, torch.device, None] = None) -> Iterator:
    """Yield the batches of ``iterator`` (arrays or tensors, or tuples,
    lists and dicts of them) on ``device`` (default: the one ``init()``
    bound), ``size`` of them in flight; ``size <= 0`` copies each batch
    when it is asked for."""
    if device is None:
        from byteps_tpu_torch.api import device as bound

        device = bound()
    device = torch.device(device)
    it = iter(iterator)
    if device.type == "cpu":
        for b in it:
            yield _map(b, lambda t: t)
        return
    if device.type != "cuda":
        raise ValueError(f"prefetch_to_device: no copy path to {device}")
    copy_stream = torch.cuda.Stream(device=device)

    def put(batch):
        host = _map(batch, lambda t: t if t.is_cuda or t.is_pinned() else t.pin_memory())
        with torch.cuda.stream(copy_stream):
            out = _map(host, lambda t: t.to(device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done, host  # the pinned source lives until the copy ends

    def hand_over(item):
        out, done, _ = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in _tensors(out):
            t.record_stream(consumer)
        return out

    if size <= 0:
        for b in it:
            yield hand_over(put(b))
        return
    queue: collections.deque = collections.deque()
    for b in it:
        queue.append(put(b))
        if len(queue) == size:
            break
    end = object()
    while queue:
        item = queue.popleft()
        nxt = next(it, end)
        if nxt is not end:
            queue.append(put(nxt))
        yield hand_over(item)
