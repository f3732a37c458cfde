"""HybridDataParallel over pipeline stages: two hosts, each a {pp:2} gloo
group of two CPU processes, train tiny_test (two microbatches) through an
in-process port scheduler and server, each host on its own batch,
against the reference's HybridDataParallel on a {pp:2} mesh of forced
CPU devices, one per host, averaged as its PS hop averages them.  Each
step starts from the reference's parameters of that step, as
``torch_port_mp_ref``'s do (tiny_test's f32 loss is chaotic: free
trajectories part by 1.6e-4 in the embedding after three steps).

- the keys the port declares are the reference's: one key per leaf of
  ``init_params(cfg, pp_size=2)`` in sorted order, each layer parameter
  stacked (2, 2, ...) over both stages;
- every pull the root's PS hop brings back equals the average of the
  reference hosts' level-1 gradients, step by step, within
  ``torch_port_mp_ref``'s gradient tolerance (rtol 1e-4, atol 1e-4 times
  the step's largest gradient): XLA's and torch's f32 sums through four
  layers part by up to 3.0e-5 of a key's largest element (2.1e-5 of the
  step's largest gradient), so the MLP's 1e-6
  (tests/test_torch_port_model_parallel_hybrid.py) cannot hold here;
- every rank ends on its stage's block of the reference's parameters
  after the last step (rtol 2e-4, atol 2e-5), the two hosts bitwise equal.
"""

import os
import pickle
import threading

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import byteps_tpu as rbps
import torch_port_kits as kits
import torch_port_mp_ref as mpref
import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.hybrid import HybridDataParallel as RefHybrid
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.comm.rendezvous import Scheduler
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.server.server import PSServer

HOSTS = (0, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_hybrid_pp"))
    sched = Scheduler(2, 1, host="127.0.0.1")
    sched.start()
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
           "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1"}
    srv = PSServer(Config(num_worker=2, num_server=1, ps_root_uri="127.0.0.1",
                          ps_root_port=sched.port))
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        hosts = {h: ranks.spawn_group("mp_hybrid_pp", 2, out, env=env, host=h) for h in HOSTS}
        ref = _reference()
        path = os.path.join(out, "ref.mp_hybrid_pp.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(ref["before"], f)
        os.replace(path + ".tmp", path)
        return {"hosts": {h: ranks.collect(p, "mp_hybrid_pp", 2, out, host=h)
                          for h, p in hosts.items()}, "ref": ref}
    finally:
        srv.stop()
        sched.stop()


def _reference():
    """The reference hybrid's keys, and its trajectory with the PS hop's
    average of the two hosts' level-1 gradients: the pulls of each step and
    the parameters before each step and after the last."""
    cfg = jt.tiny_test(**ranks.MP_HYBRID_PP_CFG)
    pp = ranks.MP_HYBRID_PP_AXES["pp"]
    mesh = make_training_mesh(n_devices=pp, axis_sizes=ranks.MP_HYBRID_PP_AXES)
    rbps.init()
    try:
        with kits.ref_hybrids_from_zero():
            hdp = RefHybrid(lambda p, b: mpref.replica_loss(cfg, mesh, p, *b),
                            jt.init_params(cfg, seed=ranks.MP_SEED, pp_size=pp),
                            optax.sgd(ranks.MP_LR), mesh=mesh,
                            param_specs=jt.param_specs(cfg),
                            batch_spec=(P("dp", "sp"), P("dp", "sp")))
        keys = [(hdp._prefix + n, tuple(v.shape)) for n, v in
                zip(hdp._names, jax.tree_util.tree_leaves(hdp.params))]
        params, pulls, before = hdp.params, [], []
        data = [ranks.mp_data(cfg.vocab_size, cfg.max_seq, seed=ranks.MP_SEED + 1 + h)
                for h in HOSTS]
        for _ in range(ranks.MP_HYBRID_PP_STEPS):
            before.append({k: np.asarray(v) for k, v in params.items()})
            grads = [hdp._grad(params, batch)[1] for batch in data]
            avg = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
            pulls.append([np.asarray(v) for v in jax.tree_util.tree_leaves(avg)])
            params = jax.tree.map(lambda p, g: p - ranks.MP_LR * g, params, avg)
    finally:
        rbps.shutdown()
    before.append({k: np.asarray(v) for k, v in params.items()})
    return {"keys": keys, "pulls": pulls, "before": before}


def test_keys_are_the_references_stacked_tree(runs):
    want = runs["ref"]["keys"]
    assert ("Hybrid.0['wq']", (2, 2, 16, 4, 4)) in want
    for host in runs["hosts"].values():
        for res in host:
            assert [(k[k.index("["):], tuple(s)) for k, s in res["keys"]] == \
                [(k[k.index("["):], s) for k, s in want]


def test_pulls_are_the_reference_hosts_average(runs):
    want = runs["ref"]["pulls"]
    for host in runs["hosts"].values():
        for res in host:
            got = res["pulls"]
            assert len(got) == len(want) * len(want[0])
            for step, per_key in enumerate(want):
                gmax = max(float(np.abs(w).max()) for w in per_key)
                for i, w in enumerate(per_key):
                    g = got[step * len(per_key) + i]
                    assert g.shape == w.shape
                    np.testing.assert_allclose(g, w, rtol=mpref.GRAD_RTOL,
                                               atol=mpref.GRAD_ATOL * gmax,
                                               err_msg=f"step {step} key {i}")


def test_every_rank_ends_on_its_stages_block(runs):
    want = runs["ref"]["before"][-1]
    for host in runs["hosts"].values():
        for res in host:
            coords = {"dp": 0, "pp": res["stage"], "sp": 0, "tp": 0, "sp_size": 1, "tp_size": 1}
            for name, v in res["params"].items():
                np.testing.assert_allclose(
                    v, mpref.shard_of(want, name, coords, ranks.MP_HYBRID_PP_CFG),
                    rtol=2e-4, atol=2e-5, err_msg=f"stage {res['stage']} {name}")
            assert np.isfinite(res["losses"]).all()
    # the hosts hold the same values, bit for bit, rank by rank
    for a, b in zip(*runs["hosts"].values()):
        assert a["stage"] == b["stage"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
