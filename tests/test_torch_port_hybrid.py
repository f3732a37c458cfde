"""The port's multi-GPU worker on the CPU: HybridDataParallel (the host's
gloo group, then the PS across hosts), the host-level push_pull and
broadcast_parameters across hosts, and the step builders
(build_data_parallel_step, build_zero1_step, allreduce_gradients), each
against byteps_tpu on the same seeded inputs.

- The hybrid: 2 hosts x local size 2 (4 gloo processes) with an in-process
  port scheduler and server train tests/test_hybrid_topology.py's MLP (D 8,
  H 16, B 8, 4 steps, SGD 0.2, dp only) and are held to that test's pure-jax
  combined-batch baseline at its rtol 2e-4 / atol 2e-5.
- The builders: a group of 4 against byteps_tpu's builders on a 4-device
  CPU mesh.  SGD within rtol 1e-5 / atol 1e-6 (the same f32 arithmetic in
  another order), Adam within rtol 1e-4 / atol 1e-5 (optax and torch
  divide by sqrt(v) + eps in another order); the int8 ring's step within
  what one int8 step of the gradient moves a parameter.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.optim import build_data_parallel_step as ref_dp_step
from byteps_tpu.optim import build_zero1_step as ref_zero1_step
from byteps_tpu_torch.comm.rendezvous import Scheduler
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.optim import build_data_parallel_step
from byteps_tpu_torch.server.server import PSServer

SGD_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    # HybridDataParallel declares its keys in the process's registry: a
    # later file on the same worker would number its tensors after them
    yield from kits.reset_runtime(monkeypatch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The hybrid's two hosts (each [local rank 0, local rank 1]) and the
    builders' group of 4, started together."""
    out = str(tmp_path_factory.mktemp("hybrid"))
    sched = Scheduler(2, 1, host="127.0.0.1")
    sched.start()
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
           "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1"}
    cfg = Config(num_worker=2, num_server=1, ps_root_uri="127.0.0.1", ps_root_port=sched.port)
    srv = PSServer(cfg)
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        hosts = {h: ranks.spawn_group("hybrid", 2, out, env=env, host=h) for h in (0, 1)}
        builders = ranks.spawn_group("builders", ranks.BUILDER_N, out, host=9)
        yield {"hybrid": {h: ranks.collect(p, "hybrid", 2, out, host=h)
                          for h, p in hosts.items()},
               "builders": ranks.collect(builders, "builders", ranks.BUILDER_N, out, host=9)}
    finally:
        srv.stop()
        sched.stop()


def _combined_batch_baseline():
    """tests/test_hybrid_topology.py's baseline: pure jax on both workers'
    data at once, no mesh, no PS."""
    bp = {k: jnp.asarray(v) for k, v in ranks.mlp_params().items()}

    def base_loss(p, batch):
        x, y = batch
        o = jnp.tanh(x @ p["w1"]) @ p["w2"]
        return jnp.mean((o - y) ** 2)

    gfn = jax.jit(jax.value_and_grad(base_loss))
    (x0, y0), (x1, y1) = ranks.mlp_data(0), ranks.mlp_data(1)
    losses = []
    for _ in range(ranks.STEPS):
        xb, yb = jnp.concatenate([x0[0], x1[0]]), jnp.concatenate([y0[0], y1[0]])
        loss, g = gfn(bp, (xb, yb))
        losses.append(float(loss))
        bp = {k: v - ranks.LR * g[k] for k, v in bp.items()}
    return {k: np.asarray(v) for k, v in bp.items()}, losses


def test_hybrid_equals_the_combined_batch_baseline(runs):
    want, base_losses = _combined_batch_baseline()
    for h, host in runs["hybrid"].items():
        for r, res in enumerate(host):
            for k in want:
                np.testing.assert_allclose(res["params"][k], want[k], rtol=2e-4, atol=2e-5)
            # the loss is the host's mean over its local group, and it fell
            assert res["losses"][-1] < res["losses"][0], res["losses"]
            assert res["losses"] == host[0]["losses"]
    assert base_losses[-1] < base_losses[0]
    # every process holds the same parameters, bit for bit
    first = runs["hybrid"][0][0]["params"]
    for host in runs["hybrid"].values():
        for res in host:
            for k in first:
                np.testing.assert_array_equal(res["params"][k], first[k])


def test_host_level_push_pull_and_broadcast_across_hosts(runs):
    """push_pull under 2 hosts x 2 local ranks is the plain average of the
    4 processes' tensors; rank() and size() are the host's worker rank and
    the number of hosts; broadcast_parameters leaves worker 0's local
    root's values everywhere."""
    xs = ranks.member_inputs(50, 4, (11,))
    ident = {}
    for h, host in runs["hybrid"].items():
        for r, res in enumerate(host):
            np.testing.assert_allclose(res["host_level"], xs.mean(0), rtol=1e-6, atol=1e-6)
            rank, size, local_rank, local_size = res["identity"]
            assert (size, local_rank, local_size) == (2, r, 2)
            ident[(h, r)] = rank
    assert ident[(0, 0)] == ident[(0, 1)] and ident[(1, 0)] == ident[(1, 1)]
    assert {ident[(0, 0)], ident[(1, 0)]} == {0, 1}
    root = next(h for h in (0, 1) if ident[(h, 0)] == 0) * 2  # its local rank 0
    for host in runs["hybrid"].values():
        for res in host:
            me, w = res["broadcast"]
            np.testing.assert_array_equal(w, np.full(3, float(root), np.float32))


def _reference_builder(kind, kw):
    mesh = Mesh(np.array(jax.devices()[: ranks.BUILDER_N]), ("dp",))
    tx = optax.sgd(ranks.BUILDER_LR) if kind == "sgd" else optax.adam(ranks.BUILDER_LR)

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    return mesh, tx, loss_fn


def _reference_dp(kind, kw):
    mesh, tx, loss_fn = _reference_builder(kind, kw)
    step = ref_dp_step(loss_fn, tx, mesh=mesh, donate=False, **kw)
    params = {k: jnp.asarray(v) for k, v in ranks.mlp_params().items()}
    state = step.optimizer.init(params)
    x, y = ranks.builder_data()
    losses = []
    for s in range(ranks.BUILDER_STEPS):
        params, state, loss = step(params, state, (x[s], y[s]))
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in params.items()}, losses


@pytest.mark.parametrize("case", ranks.BUILDER_CASES, ids=[c[0] for c in ranks.BUILDER_CASES])
def test_data_parallel_step_matches_reference(runs, case):
    label, kind, kw = case
    want, want_losses = _reference_dp(kind, kw)
    tol = SGD_TOL if kind == "sgd" else ADAM_TOL
    if kw.get("grad_quant_bits"):
        # the two rings quantize gradients that differ in the last f32 place,
        # so a word may round the other way: one int8 step, max|g|/127 a block
        # (the MLP's gradients stay below 1), moves a parameter by at most lr
        # times that a step
        tol = dict(rtol=0, atol=ranks.BUILDER_LR * ranks.BUILDER_STEPS / 127)
    for res in runs["builders"]:
        params, losses = res[("dp", label)]
        for k in want:
            np.testing.assert_allclose(params[k], want[k], **tol)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    # the replicas stay bitwise equal, the int8 ring's too
    first = runs["builders"][0][("dp", label)][0]
    for res in runs["builders"][1:]:
        for k in first:
            np.testing.assert_array_equal(res[("dp", label)][0][k], first[k])


def test_accumulate_steps_applies_the_mean_not_the_sum(runs):
    """With SGD the step is linear in the gradient: the port's accumulated
    step moves the parameters half as far as a summed gradient would."""
    init = ranks.mlp_params()
    acc, _ = runs["builders"][0][("dp", "sgd_accumulate2")]
    want, _ = _reference_dp("sgd", {"accumulate_steps": 2})
    summed = {k: init[k] + 2 * (want[k] - init[k]) for k in init}
    for k in init:
        assert np.abs(acc[k] - want[k]).max() < 0.01 * np.abs(summed[k] - want[k]).max()


@pytest.mark.parametrize("kind", ranks.ZERO1_CASES)
def test_zero1_step_matches_reference_and_shards_the_state(runs, kind):
    mesh, tx, loss_fn = _reference_builder(kind, {})
    init_fn, step = ref_zero1_step(loss_fn, tx, mesh=mesh, donate=False)
    params = {k: jnp.asarray(v) for k, v in ranks.mlp_params().items()}
    state = init_fn(params)
    x, y = ranks.builder_data()
    want_losses = []
    for s in range(ranks.BUILDER_STEPS):
        params, state, loss = step(params, state, (x[s], y[s]))
        want_losses.append(float(loss))
    tol = SGD_TOL if kind == "sgd" else ADAM_TOL
    total = sum(v.size for v in ranks.mlp_params().values())
    shard = (total + (-total) % ranks.BUILDER_N) // ranks.BUILDER_N
    for res in runs["builders"]:
        got, losses, state_sizes = res[("zero1", kind)]
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(params[k]), **tol)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
        # the optimizer state of a rank is 1/n: Adam's two moments of the shard
        assert state_sizes == ([] if kind == "sgd" else [shard, shard])


def test_allreduce_gradients_averages_every_grad(runs):
    n = ranks.BUILDER_N
    shapes = [v.shape for _, v in sorted(ranks.mlp_params().items())]
    for res in runs["builders"]:
        for i, (g, shape) in enumerate(zip(res["allreduce_gradients"], shapes)):
            want = ranks.member_inputs(60 + i, n, shape).mean(0)
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


def test_builders_raise_the_reference_value_errors():
    """byteps_tpu.optim.build_data_parallel_step's ValueError cases."""
    model = ranks.MLP(ranks.mlp_params())
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for kw, match in (({"grad_quant_bits": 4}, "only 8"),
                      ({"grad_quant_bits": 8, "accumulate_steps": 2}, "cannot combine")):
        with pytest.raises(ValueError, match=match):
            build_data_parallel_step(ranks.mlp_loss, model, opt, **kw)
        with pytest.raises(ValueError, match=match):
            ref_dp_step(lambda p, b: 0.0, optax.sgd(0.1), **kw)


def test_hybrid_refuses_sharded_param_specs():
    """A hybrid shards parameters over tp (tests/test_torch_port_model_
    parallel_hybrid.py trains it) and sp (a transformer's experts:
    tests/test_torch_port_model_parallel_moe_tp.py); over dp or pp it is
    no hybrid's; and a hybrid needs a mesh."""
    from byteps_tpu_torch.comm.mesh import Mesh as PortMesh
    from byteps_tpu_torch.parallel import HybridDataParallel

    model = ranks.MLP(ranks.mlp_params())
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    one = PortMesh(0, 1, torch.device("cpu"), "gloo")
    hdp = HybridDataParallel(model, opt, mesh=one, param_specs={"w1": (None, "sp")})
    assert [shape for _, shape in hdp.keys] == [(ranks.D, ranks.H), (ranks.H, ranks.D)]
    with pytest.raises(ValueError, match="shards parameters over tp and sp only"):
        HybridDataParallel(model, opt, mesh=one, param_specs={"w1": ("pp", None)})
    with pytest.raises(RuntimeError, match="no mesh"):
        HybridDataParallel(model, opt)


def test_the_model_takes_any_dp_size_and_no_model_axis():
    """dp shards the batch; the model axes shard the model (the layouts a
    mesh can take, tests/test_torch_port_model_parallel*.py), the experts
    of an expert layer over sp, which must divide their count."""
    from byteps_tpu_torch.models import transformer as tt

    tt.validate_mesh(tt.tiny_test(), {"dp": 4, "tp": 1})
    tt.validate_mesh(tt.tiny_test(), {"dp": 4, "pp": 2, "sp": 2, "tp": 2})
    tt.validate_mesh(tt.tiny_test(moe=True), {"dp": 2, "sp": 4})
    with pytest.raises(ValueError, match="n_experts 8 not divisible by sp=3"):
        tt.validate_mesh(tt.tiny_test(moe=True), {"sp": 3})
    model = tt.Transformer(tt.tiny_test(moe=True), device="meta")
    assert tuple(model.layers[0].ew1.shape) == (8, 16, 32)
