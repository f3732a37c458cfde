"""The keys HybridDataParallel pushes for the transformer, against
byteps_tpu's: the reference's hybrid on a mesh of forced CPU devices
declares one key per leaf of ``init_params(cfg, pp_size=pp)``, in the
tree's sorted order, each layer parameter stacked (pp, layers a stage,
...); the port's hybrid on the same mesh, at every rank of it (each rank
holding its shards and its stage's layers), declares the same names,
shapes and order.  A module that gives no such tree still raises on a
pp > 1 mesh, and the port's public names cover the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import byteps_tpu as rbps
import byteps_tpu_torch as bps
import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.hybrid import HybridDataParallel as RefHybrid
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.comm.mesh import AXES, Mesh
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.parallel import HybridDataParallel

#: (label, mesh axes, tiny_test kwargs)
MESHES = [
    ("dp2_tp2", {"dp": 2, "tp": 2}, {}),
    ("dp2_sp2_moe", {"dp": 2, "sp": 2}, {"moe": True}),
    ("dp2_pp2", {"dp": 2, "pp": 2}, {"microbatches": 2}),
]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _reference_keys(axes, kw):
    cfg = jt.tiny_test(**kw)
    sizes = {ax: axes.get(ax, 1) for ax in AXES}
    mesh = make_training_mesh(n_devices=4, axis_sizes=sizes)
    rbps.init()
    try:
        with kits.ref_hybrids_from_zero():
            hdp = RefHybrid(lambda p, b: jnp.zeros(()),
                            jt.init_params(cfg, seed=ranks.MP_SEED, pp_size=sizes["pp"]),
                            optax.sgd(0.1), mesh=mesh, param_specs=jt.param_specs(cfg),
                            batch_spec=P("dp", "sp"))
        return [(n, tuple(v.shape)) for n, v in
                zip(hdp._names, jax.tree_util.tree_leaves(hdp.params))]
    finally:
        rbps.shutdown()


def _port_mesh(rank, axes):
    return Mesh(rank, 4, torch.device("cpu"), "gloo",
                ranks=np.arange(4).reshape([axes.get(ax, 1) for ax in AXES]), axis_names=AXES)


@pytest.mark.parametrize("label,axes,kw", MESHES, ids=[m[0] for m in MESHES])
def test_the_transformers_keys_are_the_references(label, axes, kw):
    want = _reference_keys(axes, kw)
    assert len(want) == len(jt.param_specs(jt.tiny_test(**kw)))
    for rank in range(4):
        mesh = _port_mesh(rank, axes)
        model = tt.Transformer(tt.tiny_test(**kw), device="meta", mesh=mesh)
        hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1), mesh=mesh,
                                 param_specs=model.param_specs(),
                                 grad_sync_axes=model.grad_sync_axes())
        got = [(name[name.index("["):], shape) for name, shape in hdp.keys]
        assert got == want, (label, rank)
        assert all(name.startswith(f"Hybrid.{hdp._iid}[") for name, _ in hdp.keys)


def test_the_stacked_keys_cover_the_stages_layers():
    """Stage 1 of {pp:2, tp:2} (rank 2) fills each layer key with layers 2
    and 3 of 4, a global key with the parameter itself."""
    model = tt.Transformer(tt.tiny_test(), device="meta", mesh=_port_mesh(2, {"pp": 2,
                                                                             "tp": 2}))
    layout = {name: (shape, members) for name, shape, members in model.stacked_keys()}
    assert list(layout) == sorted(tt.param_shapes(tt.tiny_test()))
    assert layout["wq"] == ((2, 2, 16, 4, 4), ["layers.2.wq", "layers.3.wq"])
    assert layout["embed"] == ((64, 16), ["embed"])


def test_a_module_without_the_tree_raises_on_a_pp_mesh():
    model = ranks.MLP(ranks.mlp_params())
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="gives no reference parameter tree"):
        HybridDataParallel(model, opt, mesh=_port_mesh(0, {"dp": 2, "pp": 2}))
    hdp = HybridDataParallel(model, opt, mesh=_port_mesh(0, {"dp": 4}))
    assert [n[n.index("["):] for n, _ in hdp.keys] == ["['w1']", "['w2']"]


def test_a_stacked_key_refuses_parameters_of_another_shape():
    """Without the model's specs the tp shards would be pushed as if whole."""
    mesh = _port_mesh(0, {"dp": 2, "tp": 2})
    model = tt.Transformer(tt.tiny_test(), device="meta", mesh=mesh)
    with pytest.raises(ValueError, match=r"key \['b1'\] is \(1, 4, 32\)"):
        HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1), mesh=mesh)


def test_the_public_names_cover_the_references():
    assert sorted(set(rbps.__all__) - set(bps.__all__)) == []
    assert bps.reset_config is not None and callable(bps.distributed_optimizer)
