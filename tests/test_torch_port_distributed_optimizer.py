"""``byteps_tpu_torch.distributed_optimizer`` on a {dp:2} gloo group of two
CPU processes against ``byteps_tpu.optim.distributed_optimizer(optax.sgd)``
under ``shard_map`` on a dp:2 mesh of forced CPU devices: the MLP of
tests/test_hybrid_topology.py, each rank (device) on its rows of every
step's global batch, three steps, with ``average`` on and off.  Each
step's local loss and the parameters after it within rtol 1e-6; an axis
the mesh lacks raises at ``step()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from byteps_tpu.optim import distributed_optimizer as ref_distributed_optimizer


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_opt"))
    return ranks.collect(ranks.spawn_group("dist_opt", 2, out), "dist_opt", 2, out)


def _reference(average):
    """(per-device losses a step, the parameters after each step)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    tx = ref_distributed_optimizer(optax.sgd(ranks.BUILDER_LR), ("dp",), average)

    def step(p, s, x, y):
        def loss_fn(q):
            return jnp.mean((jnp.tanh(x @ q["w1"]) @ q["w2"] - y) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss[None]

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), P("dp"), P("dp")),
                               out_specs=(P(), P(), P("dp")), check_vma=False))
    params = {k: jnp.asarray(v) for k, v in ranks.mlp_params().items()}
    state = tx.init(params)
    x, y = ranks.builder_data()
    losses, after = [], []
    for s in range(ranks.BUILDER_STEPS):
        params, state, loss = fn(params, state, x[s], y[s])
        losses.append(np.asarray(loss))
        after.append({k: np.asarray(v) for k, v in params.items()})
    return np.stack(losses, axis=1), after


@pytest.mark.parametrize("average", ranks.DIST_OPT_AVERAGE)
def test_distributed_optimizer_is_the_references(ranks_out, average):
    want_losses, want_params = _reference(average)
    for r, res in enumerate(ranks_out):
        got = res[average]
        np.testing.assert_allclose(got["losses"], want_losses[r], rtol=1e-6)
        for step, (g, w) in enumerate(zip(got["params"], want_params)):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=f"step {step} {k}")
    # the sum over two ranks steps twice as far as the mean
    assert not np.allclose(ranks_out[0][True]["params"][0]["w1"],
                           ranks_out[0][False]["params"][0]["w1"])


def test_an_axis_the_mesh_lacks_raises(ranks_out):
    for res in ranks_out:
        assert "axes ['tp'] are not axes of the mesh" in res["unknown_axis"]
