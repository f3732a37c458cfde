"""The port's intra-host collectives and int8 ring (byteps_tpu_torch.comm.
collectives, byteps_tpu_torch.ops.quantized_allreduce) on gloo groups of 2
and 4 CPU processes, against byteps_tpu.comm.collectives and
quantized_psum under shard_map on 2- and 4-device CPU meshes, on the same
seeded per-member numpy inputs.

Each group is spawned once for the module (``torch_port_ranks.py``
runs every case in each process).  Tolerances: f32 results within 1e-6
(the same sums in another order); the int8 ring within one quantization
step of the reference's, its replicas bitwise equal to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from byteps_tpu.comm import collectives as jcoll
from byteps_tpu.ops import quantized_allreduce as jq
from byteps_tpu_torch.comm.mesh import Mesh as PortMesh
from byteps_tpu_torch.ops import quantized_allreduce as pq

SIZES = (2, 4)
F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{n: [rank 0's results, rank 1's, ...]} of one gloo group per size."""
    out = str(tmp_path_factory.mktemp("collectives"))
    procs = {n: ranks.spawn_group("collectives", n, out, host=n) for n in SIZES}
    return {n: ranks.collect(procs[n], "collectives", n, out, host=n) for n in SIZES}


def _smap(fn, n, out_spec=P()):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("dp"),), out_specs=out_spec,
                                 check_vma=False))


def _each(groups, n, key):
    return [g[key] for g in groups[n]]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("label", sorted(ranks.RAGGED))
@pytest.mark.parametrize("mode", ["psum", "scatter_gather"])
@pytest.mark.parametrize("average", [True, False])
def test_push_pull_matches_reference(groups, n, label, mode, average):
    i = list(ranks.RAGGED).index(label)
    xs = ranks.member_inputs(10 + i, n, ranks.RAGGED[label])
    want = _smap(lambda v: jcoll.push_pull(v[0], "dp", average=average, mode=mode,
                                           axis_size=n), n)(xs)
    for got in _each(groups, n, ("push_pull", label, mode, average)):
        assert got.shape == xs.shape[1:]
        np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("average", [True, False])
def test_reduce_scatter_matches_reference(groups, n, average):
    xs = ranks.member_inputs(20, n, (3 * n, 2))
    want = np.asarray(_smap(lambda v: jcoll.reduce_scatter(v[0], "dp", average=average), n,
                            P("dp"))(xs)).reshape(n, 3, 2)
    for r, got in enumerate(_each(groups, n, ("reduce_scatter", average))):
        np.testing.assert_allclose(got, want[r], **F32)


@pytest.mark.parametrize("n", SIZES)
def test_all_gather_and_broadcast_match_reference(groups, n):
    xs = ranks.member_inputs(21, n, (3, 2))
    want = _smap(lambda v: jcoll.all_gather(v[0], "dp"), n)(xs)
    for got in _each(groups, n, "all_gather"):
        np.testing.assert_array_equal(got, np.asarray(want))
    xs = ranks.member_inputs(22, n, (6,))
    for root in (0, n - 1):
        want = _smap(lambda v: jcoll.broadcast(v[0], "dp", root=root), n)(xs)
        for got in _each(groups, n, ("broadcast", root)):
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_push_pull_tree_matches_reference(groups, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    tree = {k: ranks.member_inputs(23 + i, n, s)
            for i, (k, s) in enumerate(ranks.TREE_DICT.items())}
    want = jcoll.jit_push_pull_tree(tree, mesh)
    for got in _each(groups, n, "tree_dict"):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **F32)
    tree = [ranks.member_inputs(25 + i, n, s) for i, s in enumerate(ranks.TREE_LIST)]
    want = jcoll.jit_push_pull_tree(tree, mesh, average=False)
    for got in _each(groups, n, "tree_list"):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **F32)


def test_host_level_push_pull_on_one_host(groups):
    """init() at local size n on one host: push_pull is the group's average
    (the sum without ``average``) on every rank; rank() and size() are the
    host's."""
    for n in SIZES:
        xs = ranks.member_inputs(40, n, (11,))
        for r, g in enumerate(groups[n]):
            np.testing.assert_allclose(g["host_level"], xs.mean(0), **F32)
            np.testing.assert_allclose(g["host_level_sum"], xs.sum(0), **F32)
            assert g["identity"] == (n, 1, r, n)  # BYTEPS_GLOBAL_RANK is n here


def test_quantize_is_bitwise_the_reference():
    """The same chunk quantizes to the same int8 words and scales, and
    dequantizes to the same floats; ties round half to even."""
    x = ranks.member_inputs(3, 1, (4096,))[0] * 10.0
    x[:4] = [0.5, 1.5, -2.5, 127.0]  # block 0's scale is 1.0: ties at 0.5, 1.5, 2.5
    x[256:512] = 0.0  # a zero block: scale 0, safe 1
    q, s = pq.quantize(torch.from_numpy(x))
    jq_, js = jq._quantize(jnp.asarray(x), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[:3].tolist() == [0, 2, -2]
    np.testing.assert_array_equal(pq.dequantize(q, s).numpy(),
                                  np.asarray(jq._dequantize(jq_, js, 256)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", ranks.RING, ids=[c[0] for c in ranks.RING])
def test_int8_ring_matches_reference(groups, n, case):
    """Within one quantization step of the reference's ring (the same hops
    in the same order; an f32 rounding may move one int8 word by one), and
    every replica bitwise the same."""
    label, shape, block = case
    i = ranks.RING.index(case)
    xs = ranks.member_inputs(30 + i, n, shape)
    want = np.asarray(_smap(lambda v: jq.quantized_psum(v[0], "dp", n, block=block), n,
                            P("dp"))(xs)).reshape(n, *shape)[0]
    got = _each(groups, n, ("ring", label))
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    # one step of the finished chunks' quantization, per block
    flat = np.abs(xs.sum(0)).reshape(-1)
    pad = (-flat.size) % block
    step = np.repeat(np.pad(flat, (0, pad)).reshape(-1, block).max(1) / 127.0 * 1.01, block)
    err = np.abs(got[0] - want).reshape(-1)
    assert np.all(err <= step[: err.size] + 1e-6), float((err - step[: err.size]).max())
    dense = xs.sum(0)
    rms = np.sqrt(((got[0] - dense) ** 2).mean()) / np.sqrt((dense ** 2).mean())
    assert rms < 0.03, rms  # the reference test's bound on int8 noise


@pytest.mark.parametrize("n", SIZES)
def test_int8_ring_zero_input_and_axis_size_mismatch(groups, n):
    for g in groups[n]:
        np.testing.assert_array_equal(g["ring_zero"], np.zeros(512, np.float32))
        assert g["ring_mismatch"] == f"axis_size={n + 1} but the group has {n} members"


def test_int8_ring_group_of_one_is_identity():
    x = torch.from_numpy(ranks.member_inputs(4, 1, (300,))[0])
    one = PortMesh(0, 1, torch.device("cpu"), "gloo")
    out = pq.quantized_psum(x, axis_size=1, mesh=one)
    assert out is not x
    np.testing.assert_array_equal(out.numpy(), x.numpy())


def test_a_cuda_tensor_never_goes_through_gloo():
    """The group's device kind is checked before any collective: a CUDA
    tensor is refused by a gloo group, a CPU tensor by an NCCL group."""
    from types import SimpleNamespace

    from byteps_tpu_torch.comm import collectives as pcoll

    gloo = PortMesh(0, 2, torch.device("cpu"), "gloo")
    nccl = PortMesh(0, 2, torch.device("cuda", 0), "nccl")
    on_card = SimpleNamespace(device=torch.device("cuda", 0))  # no card here
    with pytest.raises(ValueError, match="a cuda tensor on the host's gloo group"):
        pcoll.push_pull(on_card, mesh=gloo)
    with pytest.raises(ValueError, match="a cpu tensor on the host's nccl group"):
        pcoll.broadcast(torch.ones(2), mesh=nccl)


@pytest.mark.parametrize("spec,error,match", [
    # model axes and an expert axis lay the group out (they reach the
    # rendezvous)
    ("dp:1,tp:2", RuntimeError, "no rendezvous"),
    ("sp:2", RuntimeError, "no rendezvous"),
    ("dp:1,ep:2", RuntimeError, "no rendezvous"),
    ("dp:4", ValueError, "does not match the host's 2 processes"),
    ("", RuntimeError, "no rendezvous"),
])
def test_build_mesh_refuses_what_it_cannot_build(monkeypatch, spec, error, match):
    """Any product of dp, pp, sp, tp and ep that is the host's size lays
    the group out; without a rendezvous the group cannot come up.  Each
    raises before any process group."""
    import torch.distributed as dist

    from byteps_tpu_torch.comm import mesh as pmesh
    from byteps_tpu_torch.common import config as pconfig

    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    monkeypatch.delenv("BYTEPS_LOCAL_INIT_METHOD", raising=False)
    pconfig.clear_config()
    try:
        with pytest.raises(error, match=match):
            pmesh.build_mesh(spec, device="cpu")
    finally:
        pconfig.clear_config()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no local group"):
        pmesh.dp_size()
    assert pmesh.dp_size(PortMesh(1, 4, torch.device("cpu"), "gloo")) == 4
