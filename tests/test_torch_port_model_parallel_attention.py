"""Sequence-parallel attention of the port against byteps_tpu: dense ring
attention at sp 2 and 4, causal and not, and Ulysses at sp 2, over a gloo
group of 4 CPU processes, against the reference's ``ring_attention`` and
``ulysses_attention`` under shard_map on the forced CPU devices: every
rank's block of O and of dQ, dK, dV for the loss sum(O * w).

Tolerances: within rtol 1e-5 / atol 1e-6 of the reference in f32 (the
same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from byteps_tpu.parallel.ring_attention import ring_attention as jring
from byteps_tpu.parallel.ring_attention import ring_flash_attention as jring_flash
from byteps_tpu.parallel.ulysses import ulysses_attention as julysses

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_CASES = [(impl, sp, causal) for impl, sp in (("ring", 2), ("ring", 4), ("ulysses", 2))
              for causal in (True, False)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The attention group of 4, and the reference's results computed
    while it runs."""
    out = str(tmp_path_factory.mktemp("mp_attention"))
    attn = ranks.spawn_group("mp_attention", 4, out, host=0)
    want = {case: _smap_attn(_REF[case[0]], case[1], case[2]) for case in ATTN_CASES}
    return {"attention": ranks.collect(attn, "mp_attention", 4, out, host=0), "want": want}


def _smap_attn(fn, sp, causal):
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("sp",))
    body = jax.shard_map(lambda q, k, v: fn(q, k, v, "sp", sp, causal=causal), mesh=mesh,
                         in_specs=(P(None, None, "sp"),) * 3, out_specs=P(None, None, "sp"),
                         check_vma=False)
    q, k, v, w = (jnp.asarray(a) for a in ranks.attn_inputs(3))

    def loss(q, k, v):
        o = body(q, k, v)
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(a) for a in (o, *grads)]


_REF = {"ring": jring, "ring_flash": jring_flash, "ulysses": julysses}


@pytest.mark.parametrize("impl,sp,causal", ATTN_CASES)
def test_sequence_parallel_attention_and_its_gradients(groups, impl, sp, causal):
    """O, dQ, dK and dV of every rank's block against the reference's."""
    want = groups["want"][(impl, sp, causal)]
    s = ranks.ATTN_SHAPE[2] // sp
    for res in groups["attention"]:
        j, *got = res[(impl, sp, causal)]
        for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
            np.testing.assert_allclose(g, w[:, :, j * s:(j + 1) * s], err_msg=name, **ATTN_TOL)
