"""The port's ``benchmark_ddp`` example against the JAX package's on
VGG-16: the example's own step construction
(``conv_step``: bf16, the batch-statistics step, SGD momentum 0.9) at
32x32 and batch 2, on the reference's flax variables carried across by
``models/convert.conv_params_from_jax``, its first two losses within
bf16's tolerance (2e-2) of the reference's step built as the JAX
example builds it (``torch_port_bench_ref``).  The rate is not
compared."""

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
import torch_port_bench_ref as ref
import torch_port_kits as kits
from byteps_tpu_torch.examples.benchmark_ddp import conv_step
from byteps_tpu_torch.models.convert import conv_params_from_jax
from byteps_tpu_torch.models.resnet import ResNet50
from byteps_tpu_torch.models.vgg import VGG16


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def test_the_first_losses_are_the_reference_s():
    variables, want = ref.conv_losses("vgg16")
    bps.init(device="cpu")
    names = VGG16(dtype=torch.bfloat16, image=ref.HW)
    step, data = conv_step("vgg16", ref.BATCH, hw=ref.HW,
                           state_dict=conv_params_from_jax(variables, names))
    got = [float(step(data)) for _ in range(ref.STEPS)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=ref.TOL, atol=ref.TOL)
