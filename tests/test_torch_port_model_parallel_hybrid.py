"""HybridDataParallel over sharded parameters: two hosts, each a {dp:2,
tp:2} gloo group of four CPU processes, train tests/test_hybrid_topology.py's
MLP (w1 split on columns, w2 on rows over tp) through an in-process port
scheduler and server, against the reference's set-up of that test (its
HybridDataParallel on a {dp:2, tp:2} mesh of forced CPU devices, one per
host, averaged as its PS hop averages them):

- the keys the port declares and their shapes are the reference's (one
  key per parameter, at its full shape);
- every pull the root's PS hop brings back equals the average of the
  reference hosts' level-1 gradients, step by step on the reference's
  trajectory, within rtol 1e-6 (atol 1e-6 times the largest element);
- every rank ends on its shard of the reference's parameters (rtol 2e-4,
  atol 2e-5, test_hybrid_topology's tolerance), the tp replicas of a
  host bitwise equal.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import byteps_tpu as rbps
import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.parallel.hybrid import HybridDataParallel as RefHybrid
from byteps_tpu_torch.comm.rendezvous import Scheduler
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.server.server import PSServer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_hybrid"))
    sched = Scheduler(2, 1, host="127.0.0.1")
    sched.start()
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
           "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1"}
    srv = PSServer(Config(num_worker=2, num_server=1, ps_root_uri="127.0.0.1",
                          ps_root_port=sched.port))
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        hosts = {h: ranks.spawn_group("mp_hybrid", 4, out, env=env, host=h) for h in (0, 1)}
        ref = _reference()
        return {"hosts": {h: ranks.collect(p, "mp_hybrid", 4, out, host=h)
                          for h, p in hosts.items()}, "ref": ref}
    finally:
        srv.stop()
        sched.stop()


def _reference():
    """The reference hybrid's keys, and its trajectory with the PS hop's
    average of the two hosts' level-1 gradients."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((lax.psum(jnp.tanh(x @ p["w1"]) @ p["w2"], "tp") - y) ** 2)

    specs = {k: P(*v) for k, v in ranks.MP_HYBRID_SPECS.items()}
    rbps.init()
    try:
        with kits.ref_hybrids_from_zero():
            hdp = RefHybrid(loss_fn, ranks.mlp_params(), optax.sgd(ranks.LR), mesh=mesh,
                            param_specs=specs, batch_spec=(P("dp"), P("dp")))
        keys = [(hdp._prefix + n, tuple(v.shape)) for n, v in
                zip(hdp._names, jax.tree_util.tree_leaves(hdp.params))]
        params, pulls = hdp.params, []
        data = [ranks.mlp_data(h) for h in (0, 1)]
        for _ in range(ranks.STEPS):
            grads = [hdp._grad(params, (x[0], y[0]))[1] for x, y in data]
            avg = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
            pulls.append([np.asarray(v) for v in jax.tree_util.tree_leaves(avg)])
            params = jax.tree.map(lambda p, g: p - ranks.LR * g, params, avg)
    finally:
        rbps.shutdown()
    return {"keys": keys, "pulls": pulls,
            "params": {k: np.asarray(v) for k, v in params.items()}}


def test_keys_and_shapes_are_the_reference(runs):
    for host in runs["hosts"].values():
        for res in host:
            assert [(k, tuple(s)) for k, s in res["keys"]] == runs["ref"]["keys"]


def test_pulls_are_the_reference_hosts_average(runs):
    want = runs["ref"]["pulls"]
    for host in runs["hosts"].values():
        for res in host:
            got = res["pulls"]
            assert len(got) == len(want) * len(want[0])
            for step, per_key in enumerate(want):
                for i, w in enumerate(per_key):
                    g = got[step * len(per_key) + i]
                    assert g.shape == w.shape
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                               err_msg=f"step {step} key {i}")


def test_every_rank_ends_on_its_shard(runs):
    want = runs["ref"]["params"]
    tp = ranks.MP_HYBRID_AXES["tp"]
    for host in runs["hosts"].values():
        for res in host:
            _, t = res["coords"]
            n = ranks.H // tp
            np.testing.assert_allclose(res["params"]["w1"], want["w1"][:, t * n:(t + 1) * n],
                                       rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(res["params"]["w2"], want["w2"][t * n:(t + 1) * n],
                                       rtol=2e-4, atol=2e-5)
            assert res["losses"][-1] < res["losses"][0]
        # the dp replicas of a tp shard hold the same values, bit for bit
        by_shard = {}
        for res in host:
            by_shard.setdefault(res["coords"][1], []).append(res["params"])
        for same in by_shard.values():
            for k in same[0]:
                np.testing.assert_array_equal(same[0][k], same[1][k])
