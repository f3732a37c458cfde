"""The port's ``long_context_ring`` example on a host's group of four
processes (each a gloo rank of ``tests/torch_port_ranks.py``'s
``example`` case), ring and Ulysses, causal, at seq 256: each rank's
output block within 1e-5 of the JAX package's ``ring_attention`` /
``ulysses_attention`` over a 4-device sp mesh on the same seeded q, k
and v, and the example's own check against dense attention passing on
every rank (max abs error below 1e-3, printed)."""

import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.parallel.ring_attention import ring_attention
from byteps_tpu.parallel.ulysses import ulysses_attention
from byteps_tpu_torch.examples.long_context_ring import qkv

SEQ, HEADS, DH, SP = 256, 8, 64, 4
IMPLS = ["ring", "ulysses"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = {}
    for impl in IMPLS:
        d = str(tmp_path_factory.mktemp(f"example_{impl}"))
        out[impl] = (d, ranks.spawn_group("example", SP, d, env={
            "EXAMPLE": "long_context_ring",
            "EXAMPLE_ARGV": json.dumps(["--seq", str(SEQ), "--impl", impl])}))
    return out


def _reference(impl: str) -> np.ndarray:
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    attend = ulysses_attention if impl == "ulysses" else ring_attention
    fn = jax.jit(jax.shard_map(
        lambda q, k, v: attend(q, k, v, "sp", SP, causal=True), mesh=mesh,
        in_specs=(P(None, None, "sp"),) * 3, out_specs=P(None, None, "sp"),
        check_vma=False))
    return np.asarray(fn(*qkv(1, HEADS, SEQ, DH)))


@pytest.mark.parametrize("impl", IMPLS)
def test_each_block_is_the_reference_s(spawned, impl):
    want = _reference(impl)
    d, procs = spawned[impl]
    s_local = SEQ // SP
    for r, res in enumerate(ranks.collect(procs, "example", SP, d, timeout=150)):
        (block,) = res["blocks"]
        np.testing.assert_allclose(block, want[:, :, r * s_local:(r + 1) * s_local],
                                   atol=1e-5, rtol=0, err_msg=f"rank {r}")
        tag = f"[local {r}/{SP}] "
        assert res["lines"][0] == f"{tag}{impl} over {SP} devices, {SEQ} total tokens, " \
                                  f"{s_local}/device"
        err = float(res["lines"][-1].rsplit(" ", 1)[1])
        assert res["lines"][-1].startswith(f"{tag}max abs err vs dense: ") and err < 1e-3
