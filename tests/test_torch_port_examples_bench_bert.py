"""The port's ``benchmark_ddp`` example against the JAX package's on
BERT-large: the example's own step construction (``bert_step``: seq 128,
bf16, dense attention, remat, AdamW 1e-4, ``init_params(cfg, seed=0)``)
cut to 2 layers through the config's ``n_layers``, batch 2: its first two
losses within bf16's tolerance (2e-2) of the reference's step built as the
JAX example builds it (``torch_port_bench_ref``).  The rate is not
compared."""

import numpy as np
import pytest

import byteps_tpu_torch as bps
import torch_port_bench_ref as ref
import torch_port_kits as kits
from byteps_tpu_torch.examples.benchmark_ddp import bert_step


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def test_the_first_losses_are_the_reference_s():
    want = ref.bert_losses(2)
    bps.init(device="cpu")
    step, tokens, targets = bert_step(ref.BATCH, n_layers=2)
    assert tokens.shape == (ref.BATCH, 128)
    got = [float(step(tokens, targets)) for _ in range(ref.STEPS)]
    assert all(np.isfinite(got)) and got[1] < got[0]
    np.testing.assert_allclose(got, want, rtol=ref.TOL, atol=ref.TOL)
