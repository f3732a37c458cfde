"""The port's mesh against byteps_tpu: ``parallel.mesh_utils``
(factorize_mesh, the rank-to-coordinate map of the training and hybrid
meshes against the reference's on the 8 forced CPU devices), the axis
lines, ``validate_mesh``'s errors, ``build_mesh``'s specs, a mesh with a
model axis built on two CPU processes, and a CUDA group whose two ranks
share a device.
"""

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel import mesh_utils as jmu
from byteps_tpu_torch.comm import mesh as pmesh
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.parallel import mesh_utils as pmu


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two processes that name one CUDA device, then build a CPU mesh."""
    out = str(tmp_path_factory.mktemp("mp"))
    clash = ranks.spawn_group("cuda_clash", 2, out, host=1, env={"CUDA_VISIBLE_DEVICES": ""})
    return {"clash": ranks.collect(clash, "cuda_clash", 2, out, host=1)}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 30, 49, 97])
@pytest.mark.parametrize("want", [("dp",), ("dp", "tp", "sp", "pp"), ("tp", "pp"),
                                  ("pp", "dp", "sp")])
def test_factorize_mesh_is_the_reference(n, want):
    assert pmu.factorize_mesh(n, want) == jmu.factorize_mesh(n, want)


@pytest.fixture(autouse=True)
def _layouts_without_groups(monkeypatch):
    """No process group in this process: a layout makes no subgroups."""
    monkeypatch.setattr(pmesh.Mesh, "make_axis_groups", lambda self: None)


def _base(n):
    return pmesh.Mesh(0, n, torch.device("cpu"), "gloo")


def _port_layout(mesh):
    return mesh.axis_names, {int(r): tuple(int(c) for c in np.argwhere(mesh.ranks == r)[0])
                             for r in range(mesh.size)}


def _ref_layout(mesh):
    return mesh.axis_names, {d.id: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0])
                             for d in mesh.devices.flat}


@pytest.mark.parametrize("sizes", [{"dp": 8}, {"pp": 2, "tp": 4}, {"dp": 2, "pp": 2, "sp": 2},
                                   {"sp": 2, "tp": 2}, {"dp": 2, "tp": 2}])
def test_training_mesh_puts_each_rank_where_the_reference_puts_its_device(sizes):
    n = int(np.prod(list(sizes.values())))
    mesh = pmu.make_training_mesh(n, axis_sizes=sizes, base=_base(n))
    ref = jmu.make_training_mesh(n_devices=n, axis_sizes=sizes)
    assert _port_layout(mesh) == _ref_layout(ref)
    assert mesh.shape == dict(ref.shape)


@pytest.mark.parametrize("ici", [{"dp": 2, "tp": 4}, {"pp": 2, "sp": 2, "tp": 2}, {"tp": 8}])
def test_hybrid_mesh_puts_each_rank_where_the_reference_puts_its_device(ici):
    mesh = pmu.make_hybrid_mesh(ici, {}, base=_base(8))
    assert _port_layout(mesh) == _ref_layout(jmu.make_hybrid_mesh(ici, {}))


def test_hybrid_mesh_lays_dcn_factors_outside_ici():
    """Two granules of 4 (hosts), the dcn factor outside the ici one: the
    reference's np.block layout."""
    mesh = pmu.make_hybrid_mesh({"tp": 4}, {"dp": 2}, base=_base(8))
    assert mesh.shape == {"dp": 2, "tp": 4}
    np.testing.assert_array_equal(mesh.ranks, np.arange(8).reshape(2, 4))
    mesh = pmu.make_hybrid_mesh({"dp": 2, "tp": 2}, {"dp": 2}, base=_base(8))
    np.testing.assert_array_equal(mesh.ranks, [[0, 1], [2, 3], [4, 5], [6, 7]])
    with pytest.raises(ValueError, match="wants 16 devices, have 8"):
        pmu.make_hybrid_mesh({"tp": 8}, {"dp": 2}, base=_base(8))


def test_mesh_axis_lines_and_indices():
    mesh = pmesh.Mesh(5, 8, torch.device("cpu"), "gloo", ranks=np.arange(8).reshape(2, 2, 2),
                      axis_names=("pp", "sp", "tp"))
    assert mesh.shape == {"pp": 2, "sp": 2, "tp": 2}
    assert [mesh.axis_index(a) for a in ("pp", "sp", "tp", "dp")] == [1, 0, 1, 0]
    assert mesh.axis_ranks("pp") == [1, 5]
    assert mesh.axis_ranks("sp") == [5, 7]
    assert mesh.axis_ranks("tp") == [4, 5]
    assert mesh.axis_ranks("dp") == [5] and mesh.axis_size("dp") == 1
    assert pmesh.dp_size(mesh) == 1
    assert pmesh.model_axes(mesh) == {"pp": 2, "sp": 2, "tp": 2}
    with pytest.raises(RuntimeError, match="no group for axis 'tp'"):
        mesh.axis_group("tp")


def test_ulysses_refuses_heads_that_do_not_divide():
    mesh = pmesh.Mesh(0, 3, torch.device("cpu"), "gloo", ranks=np.arange(3), axis_names=("sp",))
    q = torch.zeros((1, 2, 4, 4))
    from byteps_tpu_torch.parallel.ulysses import ulysses_attention

    with pytest.raises(ValueError, match=r"ulysses needs heads \(2\) divisible by the sp axis"):
        ulysses_attention(q, q, q, "sp", 3, mesh=mesh)


@pytest.mark.parametrize("kw", [dict(), dict(attn_bias=True, n_kv_heads=2),
                                dict(pos_emb="rope"), dict(moe=True, n_experts=4)])
def test_layout_table_is_the_reference(kw):
    """param_specs and grad_sync_axes name the reference's parameters with
    its specs and sync axes; a module's specs drop the stacked (pp, layers)
    dims and cover every dimension."""
    jcfg, pcfg = jt.tiny_test(**kw), tt.tiny_test(**kw)
    want = {k: tuple(v) for k, v in jt.param_specs(jcfg).items()}
    assert list(tt.param_specs(pcfg)) == list(want)
    assert tt.param_specs(pcfg) == want
    assert tt.grad_sync_axes(pcfg) == jt.grad_sync_axes(jcfg)
    mesh = pmesh.Mesh(3, 4, torch.device("cpu"), "gloo", ranks=np.arange(4).reshape(1, 2, 1, 2),
                      axis_names=pmesh.AXES)
    model = tt.Transformer(pcfg, device="meta", mesh=mesh)
    specs, sync = model.param_specs(), model.grad_sync_axes()
    for name, p in model.named_parameters():
        base = name.rsplit(".", 1)[-1]
        stacked = want[base][2:] if tt.is_layer_param(base) else want[base]
        assert specs[name][:len(stacked)] == stacked and len(specs[name]) == p.dim()
        assert sync[name] == jt.grad_sync_axes(jcfg)[base]
    assert [n for n, _ in model.named_parameters() if n.startswith("layers.")][0] == \
        "layers.2.ln1_s"  # stage 1 of 2 holds layers 2 and 3, by their global index


@pytest.mark.parametrize("cfg_kw,axes", [
    (dict(n_heads=4, n_kv_heads=None), {"tp": 3}),
    (dict(n_heads=4, n_kv_heads=2), {"tp": 4}),
])
def test_validate_mesh_raises_the_reference_errors(cfg_kw, axes):
    jmesh = jmu.make_training_mesh(n_devices=int(np.prod(list(axes.values()))),
                                   axis_sizes=axes)
    with pytest.raises(ValueError) as ref:
        jt.validate_mesh(jt.tiny_test(**cfg_kw), jmesh)
    with pytest.raises(ValueError) as port:
        tt.validate_mesh(tt.tiny_test(**cfg_kw), axes)
    assert str(port.value) == str(ref.value)


def test_validate_mesh_checks_the_feed_forward_and_stages():
    tt.validate_mesh(tt.tiny_test(), {"dp": 4, "tp": 2, "pp": 2})
    with pytest.raises(ValueError, match="d_ff 30 not divisible by tp=4"):
        tt.validate_mesh(tt.tiny_test(d_ff=30), {"tp": 4})
    with pytest.raises(ValueError, match="n_layers 4 not divisible by pp 3"):
        tt.validate_mesh(tt.tiny_test(), {"pp": 3})


def test_a_cuda_group_sharing_a_device_needs_the_staged_transport(groups):
    """Both ranks raise, name the option and leave no process group."""
    for res in groups["clash"]:
        assert "share a CUDA device" in res["raised"]
        assert 'transport="staged"' in res["raised"] and "BYTEPS_MESH_TRANSPORT" in res["raised"]
        assert res["initialized"] is False


def test_a_spec_with_model_axes_builds_the_group(groups):
    """build_mesh("dp=1,tp=2") on two processes: the layout, each rank's
    tp index, and a sum over the tp axis's subgroup."""
    assert [res["built"] for res in groups["clash"]] == [
        ({"dp": 1, "tp": 2}, 0, 3.0), ({"dp": 1, "tp": 2}, 1, 3.0)]


@pytest.mark.parametrize("spec,axes", [
    ("dp:2,tp:2", {"dp": 2, "tp": 2}),
    ("dp:2,ep:2", {"dp": 2, "ep": 2}),
    ("dp=1,pp=2,sp=1,tp=2", {"dp": 1, "pp": 2, "sp": 1, "tp": 2}),
    ("", {"dp": 4}),
])
def test_mesh_specs_name_any_product_of_the_group(spec, axes):
    assert pmesh._axes_of(spec, 4) == axes


@pytest.mark.parametrize("spec,match", [("dp:2,tp:3", "does not match the host's 4"),
                                        ("dp:2,fsdp:2", "axes must be distinct names"),
                                        ("tp:2,tp:2", "axes must be distinct names")])
def test_mesh_specs_that_cannot_lay_out_the_group(spec, match):
    with pytest.raises(ValueError, match=match):
        pmesh._axes_of(spec, 4)
