"""The port's input utilities (``byteps_tpu_torch/data.py``) against
byteps_tpu's (``tests/test_data.py``):

- ``shard_for_worker``: the indices bitwise the reference's over sizes,
  worker counts, seeds, with and without shuffling and the remainder,
  and the shards disjoint;
- ``ShardedDataset``: every epoch's batches bitwise, reshuffled per epoch;
- ``prefetch_to_device`` on the CPU: the batches in order, as tensors,
  nested structures kept, for every depth (0 disables it, as in the
  reference); an unknown device raises.  Its CUDA path (pinned host
  copies on a side stream) runs on the card in ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from byteps_tpu import data as ref_data
from byteps_tpu_torch import data as port_data


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1001])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("seed, shuffle, drop", [(0, True, True), (5, True, False),
                                                 (3, False, True), (9, False, False)])
def test_shard_indices_are_the_reference_s(n, world, seed, shuffle, drop):
    shards = []
    for rank in range(world):
        got = port_data.shard_for_worker(n, rank, world, seed=seed, shuffle=shuffle,
                                         drop_remainder=drop)
        want = ref_data.shard_for_worker(n, rank, world, seed=seed, shuffle=shuffle,
                                         drop_remainder=drop)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        shards.append(got)
    flat = np.concatenate(shards)
    assert len(np.unique(flat)) == len(flat)


@pytest.mark.parametrize("world", [1, 3])
def test_sharded_dataset_epochs_are_the_reference_s(world):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    y = rng.integers(0, 10, 50)
    for rank in range(world):
        port = port_data.ShardedDataset((x, y), batch_size=4, seed=7, worker_rank=rank,
                                        num_workers=world)
        ref = ref_data.ShardedDataset((x, y), batch_size=4, seed=7, worker_rank=rank,
                                      num_workers=world)
        epochs = []
        for e in range(3):
            got, want = list(port.epoch(e)), list(ref.epoch(e))
            assert len(got) == len(want) > 0
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
            epochs.append(np.concatenate([b[1] for b in got]))
        assert not all(np.array_equal(epochs[0], e) for e in epochs[1:])
    with pytest.raises(ValueError, match="disagree on length"):
        port_data.ShardedDataset((x, y[:3]), batch_size=2)


@pytest.mark.parametrize("size", [-1, 0, 1, 2, 5])
def test_prefetch_on_the_cpu_passes_the_batches_through(size):
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((2, 3)).astype(np.float32), {"y": np.arange(i, i + 2)})
               for i in range(4)]
    got = list(port_data.prefetch_to_device(iter(batches), size=size, device="cpu"))
    want = list(ref_data.prefetch_to_device(iter(batches), size=size))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and isinstance(gy["y"], torch.Tensor)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy["y"].numpy(), np.asarray(wy["y"]))


def test_prefetch_to_an_unknown_device_raises():
    with pytest.raises(ValueError, match="no copy path"):
        next(port_data.prefetch_to_device(iter([np.zeros(2)]), device="meta"))
