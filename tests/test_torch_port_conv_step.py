"""The port's batch-statistics data-parallel step
(``byteps_tpu_torch.optim.build_batchnorm_data_parallel_step``) against
byteps_tpu's ``build_flax_data_parallel_step``, and the host group's
layout knob, on the same numpy inputs:

- three SGD-momentum steps (``optax.sgd(0.1, momentum=0.9)``, torch's
  ``SGD(momentum=0.9, dampening=0)``) of ``ResNetTiny`` on one process
  against the reference's on one device, and two on a gloo group of 2
  against the reference's on a 2-device CPU mesh (each rank normalizes
  with its own half of the batch; the running statistics are averaged
  beside the gradients): losses within 1e-5, parameters and running
  statistics within 2e-5, the two ranks bitwise equal;
- ``BYTEPS_TPU_MESH`` (ROADMAP F10) lays out the port's host group as the
  reference lays out its devices, and a spec that does not fit raises.

The group's processes run ``tests/torch_port_ranks.py`` cases ``bn_step``
and ``mesh_env`` (gloo, listeners on port 0), started once per module."""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.comm.mesh import build_mesh as ref_build_mesh
from byteps_tpu.models import resnet as jr
from byteps_tpu.optim import build_flax_data_parallel_step
from byteps_tpu_torch.comm.mesh import Mesh as PortMesh
from byteps_tpu_torch.models import resnet as tr
from byteps_tpu_torch.models.convert import conv_params_from_jax, conv_params_to_jax
from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _ref_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def _ref_variables(x):
    init = jax.jit(lambda k, a: jr.ResNetTiny().init(k, a, train=True))
    return init(jax.random.PRNGKey(0), x[:1])


def _close_trees(got, want, atol):
    gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The gloo groups of 2, started at the module's first test so that
    they run beside it: the batch-statistics step on the reference's
    ResNetTiny weights, and the mesh knob."""
    out = str(tmp_path_factory.mktemp("conv_groups"))
    x, _ = ranks.bn_data()
    variables = _ref_variables(x[0])
    torch.save(conv_params_from_jax(variables, tr.ResNetTiny()), f"{out}/bn_weights.pt")
    return out, variables, {case: ranks.spawn_group(case, 2, out)
                            for case in ("bn_step", "mesh_env")}


@pytest.fixture(scope="module")
def groups(spawned):
    """Each rank's results of the groups."""
    out, variables, procs = spawned
    return variables, {case: ranks.collect(p, case, 2, out) for case, p in procs.items()}


def _ref_steps(variables, mesh, xs, ys):
    tx = optax.sgd(ranks.BN_LR, momentum=0.9)
    step = build_flax_data_parallel_step(jr.ResNetTiny().apply, _ref_loss, tx, mesh=mesh,
                                         donate=False)
    opt_state, losses = tx.init(variables["params"]), []
    for x, y in zip(xs, ys):
        variables, opt_state, loss = step(variables, opt_state, (x, y.astype(np.int32)))
        losses.append(float(loss))
    return variables, losses


def test_sgd_momentum_steps_on_one_process_are_the_reference_s(spawned):
    r = np.random.default_rng(5)
    x = r.normal(size=(4, ranks.BN_IMAGE, ranks.BN_IMAGE, 3)).astype(np.float32)
    y = r.integers(0, 10, 4)
    xs, ys = [x, x[::-1].copy(), x], [y, y[::-1].copy(), y]
    variables = _ref_variables(x)
    model = tr.ResNetTiny()
    model.load_state_dict(conv_params_from_jax(variables, model))
    opt = torch.optim.SGD(model.parameters(), lr=ranks.BN_LR, momentum=0.9, dampening=0)
    step = build_batchnorm_data_parallel_step(ranks.bn_loss, model, opt,
                                              mesh=PortMesh(0, 1, torch.device("cpu"), "gloo"))
    losses = [float(step((torch.from_numpy(a), torch.from_numpy(b)))) for a, b in zip(xs, ys)]
    want, ref_losses = _ref_steps(variables, Mesh(np.array(jax.devices()[:1]), ("dp",)), xs, ys)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _close_trees(conv_params_to_jax(model.state_dict(), model),
                 jax.tree_util.tree_map(np.asarray, want), atol=2e-5)


def test_the_step_on_a_group_of_two_is_the_reference_s_on_two_devices(groups):
    variables, results = groups
    x, y = ranks.bn_data()
    want, ref_losses = _ref_steps(variables, Mesh(np.array(jax.devices()[:2]), ("dp",)),
                                  list(x), list(y))
    r0, r1 = results["bn_step"]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref_losses, rtol=1e-5)
    for k in r0["state"]:  # the ranks agree bitwise, running statistics too
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k])
    model = tr.ResNetTiny()
    got = conv_params_to_jax({k: torch.from_numpy(v) for k, v in r0["state"].items()}, model)
    _close_trees(got, jax.tree_util.tree_map(np.asarray, want), atol=2e-5)


def test_the_mesh_knob_lays_out_the_host_group_as_the_reference(groups):
    _, results = groups
    ref = ref_build_mesh("dp:1,tp:2", devices=jax.devices()[:2])
    ref_ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, res in enumerate(results["mesh_env"]):
        assert "does not match the host's 2 processes" in res["raised"]
        assert not res["initialized_after_raise"]
        assert res["shape"] == {"dp": 1, "tp": 2} == dict(ref.shape)
        np.testing.assert_array_equal(res["ranks"], ref_ids - ref_ids.min())
        assert res["tp"] == r and res["psum"] == 3.0
    with pytest.raises(ValueError, match="wants 3 devices"):
        ref_build_mesh("dp:3", devices=jax.devices()[:2])
