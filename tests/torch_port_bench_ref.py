"""The JAX package's ``examples/benchmark_ddp.py`` steps, built as that
example builds them but on one device of conftest's CPU mesh, for the
port's ``benchmark_ddp`` tests (``test_torch_port_examples_bench_*.py``):
the first losses of each at a small size."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

TOL = 2e-2  # bf16 compute: chip_smoke.py's TOL["bfloat16"]
HW, BATCH, STEPS = 32, 2, 2
#: ResNet-50's batch: at 32x32 its last stage is 1x1, and batch statistics
#: over 2 values a channel make the second step ill-conditioned (in f32
#: the packages' first losses agree to 1e-5 and their second ones only to
#: 0.3%; at 64x64, or over 4 values, the second agrees as the first)
RESNET_BATCH = 4


def conv_losses(model_name: str, batch: int = BATCH):
    """(the reference's flax variables, its first STEPS losses) of
    ``bench_conv``'s step at HW x HW, ``batch``."""
    from byteps_tpu.models.resnet import ResNet50
    from byteps_tpu.models.vgg import VGG16
    from byteps_tpu.optim import build_flax_data_parallel_step

    model = ResNet50(dtype=jnp.bfloat16) if model_name == "resnet50" else VGG16(dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(batch, HW, HW, 3)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 1000, size=(batch,)).astype(np.int32))
    variables = model.init(jax.random.PRNGKey(0), x[:1], train=True)
    tx = optax.sgd(0.1, momentum=0.9)
    opt_state = jax.jit(tx.init)(variables["params"])
    step = build_flax_data_parallel_step(
        model.apply,
        lambda lg, lb: optax.softmax_cross_entropy_with_integer_labels(lg, lb).mean(),
        tx, mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)), donate=False)
    losses, v = [], variables
    for _ in range(STEPS):
        v, opt_state, loss = step(v, opt_state, (x, y))
        losses.append(float(loss))
    return variables, losses


def bert_losses(n_layers: int):
    """The first STEPS losses of ``bench_bert``'s step at ``n_layers``,
    batch BATCH, on one device."""
    from byteps_tpu.models.transformer import (
        bert_large, build_train_step, init_params, shard_params,
    )
    from byteps_tpu.parallel.mesh_utils import make_training_mesh

    cfg = dataclasses.replace(bert_large(max_seq=128, compute_dtype=jnp.bfloat16),
                              n_layers=n_layers)
    mesh = make_training_mesh(1, {"dp": 1, "pp": 1, "sp": 1, "tp": 1})
    params = shard_params(init_params(cfg), cfg, mesh)
    tx = optax.adamw(1e-4)
    opt_state = jax.jit(tx.init)(params)
    step = build_train_step(cfg, mesh, tx)
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(BATCH, 128)).astype(np.int32))
    targets = jnp.asarray(np.roll(np.asarray(tokens), -1, 1))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    return losses
