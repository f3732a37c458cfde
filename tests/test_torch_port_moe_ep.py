"""The port's expert-parallel layer (``parallel.moe.moe_mlp`` with its
experts over an sp axis of two ranks, tokens routed by the tiled
all-to-all over sp and back) on a gloo group of two CPU processes,
against byteps_tpu's ``moe_mlp`` under shard_map at sp=2 on two forced CPU
devices, on the same numpy inputs: each rank's output and its gradients
of x, the router (summed over sp), w1, b1, w2 and b2, within rtol 1e-5
and atol 1e-6, top-1 and top-2, with and without drops.  The capacity is
per rank's tokens, as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from byteps_tpu.parallel.moe import moe_mlp

LABELS = [c[0] for c in ranks.MOE_EP_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_ep"))
    procs = ranks.spawn_group("moe_ep", 2, out)
    refs = {label: _reference(k, cf) for label, k, cf in ranks.MOE_EP_CASES}
    return ranks.collect(procs, "moe_ep", 2, out), refs


def _reference(k, cf):
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    x, router, w1, b1, w2, b2, w = (jnp.asarray(a) for a in ranks.moe_ep_inputs())

    def local(x, router, w1, b1, w2, b2, w):
        def loss(*a):
            y = moe_mlp(*a, axis_name="sp", axis_size=2, capacity_factor=cf, top_k=k)
            return jnp.sum(y * w), y
        (_, y), g = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
            x, router, w1, b1, w2, b2)
        return y, g

    sharded = P("sp")
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(sharded, P(), sharded, sharded, sharded, sharded, sharded),
        out_specs=(sharded, (sharded, P(), sharded, sharded, sharded, sharded)),
        check_vma=True))
    y, grads = fn(x, router, w1, b1, w2, b2, w)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("label", LABELS)
def test_each_rank_matches_the_reference(runs, label):
    got, refs = runs
    want_y, want_g = refs[label]
    t, e = ranks.MOE_EP_T, ranks.MOE_EP_E // 2
    for res in got:
        r = res[label]
        j = r["rank"]
        np.testing.assert_allclose(r["y"], want_y[j * t:(j + 1) * t], rtol=1e-5, atol=1e-6)
        blocks = [slice(j * t, (j + 1) * t), slice(None)] + [slice(j * e, (j + 1) * e)] * 4
        for name, g, want, block in zip(("x", "router", "w1", "b1", "w2", "b2"), r["grads"],
                                        want_g, blocks):
            np.testing.assert_allclose(g, want[block], rtol=1e-5, atol=1e-6, err_msg=name)


def test_drops_only_where_the_capacity_is_short(runs):
    got, _ = runs
    for res in got:
        for label, k, _ in ranks.MOE_EP_CASES:
            assert 0 <= res[label]["drops"] <= k * ranks.MOE_EP_T
    # capacity int(0.5 * 2 * 12 / 4) = 3 slots an expert for 24 assignments
    assert sum(res["top2_drops"]["drops"] for res in got) > 0
