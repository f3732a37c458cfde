"""The reference side of the port's model-parallel training tests: the
cases of ``torch_port_ranks.MP_TRAIN`` run through byteps_tpu's own
``_local_loss`` under ``shard_map`` on its mesh of forced CPU devices
(built as tests/test_transformer.py builds them), with the gradients the
reference's ``build_train_step`` takes, and the comparison of a rank's
steps with them.

Each of the port's steps starts from the reference's parameters of that
step (``torch_port_ranks.case_mp_train``): tiny_test's loss is chaotic in
f32 (its embeddings start at std 0.02 under a layer norm), so that the
reference's own loss after three steps moves by 1e-4 when its initial
parameters move by 1e-7.  Tolerances: the loss of a step within rtol
1e-5; build_forward's logits within rtol 1e-5 and atol 1e-5 times the
largest; a gradient shard within rtol 1e-4 and atol 1e-4 times the largest
gradient of the step; the parameters after a step within the update of
such a gradient difference (rtol 1e-5, atol 1e-4 * lr times the largest
gradient).

A case of ``torch_port_ranks.MP_HYBRID_TRAIN`` trains through the port's
HybridDataParallel, and its reference is byteps_tpu's hybrid's level 1:
the gradient of a dp replica's loss (:func:`replica_loss`) summed over dp
by shard_map's AD and divided by dp, the loss averaged over dp.

The reference runs without remat: recomputing a layer changes no value,
and the port's ranks run with it (each case's config), so their
checkpointed layers recompute every collective in backward.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import make_training_mesh

LOSS_RTOL = 1e-5
#: build_forward's logits: f32 sums in other orders over a few layers
LOGITS_RTOL, LOGITS_ATOL = 1e-5, 1e-5
#: a gradient shard: rtol, and atol times the step's largest gradient
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4

CASES = {label: (axes, kw) for label, axes, kw in ranks.MP_TRAIN}


def spawn(labels, n, out, host):
    return ranks.spawn_group("mp_train", n, out, host=host,
                             env={"MP_LABELS": ",".join(labels), "MP_REF_DIR": out})


def publish(label, ref, out):
    """Hand the ranks the reference's parameters of every step."""
    path = os.path.join(out, f"ref.{label}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(ref[2], f)
    os.replace(path + ".tmp", path)


def run(two, four, out):
    """Spawn the 2- and 4-rank groups, compute and publish the reference
    of each case while they start, and collect: {label: (ranks, ref)}."""
    procs = {}
    if two:
        procs[2] = spawn(two, 2, out, host=0)
    if four:
        procs[4] = spawn(four, 4, out, host=1)
    refs = {}
    for label in two + four:
        refs[label] = reference(label)
        publish(label, refs[label], out)
    got = {n: ranks.collect(p, "mp_train", n, out, host=0 if n == 2 else 1)
           for n, p in procs.items()}
    return {label: (got[2] if label in two else got[4], refs[label]) for label in two + four}


def reference(label):
    """(losses, per-step gradients, the parameters before each step and
    after the last, build_forward's logits at the first step's parameters
    in the batch's row order) of the reference on the case's mesh: global
    arrays as numpy."""
    axes, kw = CASES[label]
    cfg = dataclasses.replace(jt.tiny_test(**kw), remat=False)
    sizes = {ax: axes.get(ax, 1) for ax in ("dp", "pp", "sp", "tp")}
    mesh = make_training_mesh(n_devices=int(np.prod(list(sizes.values()))), axis_sizes=sizes)
    specs = jt.param_specs(cfg)
    params = jt.shard_params(jt.init_params(cfg, seed=ranks.MP_SEED, pp_size=sizes["pp"]),
                             cfg, mesh)
    tokens, targets = (jnp.asarray(a) for a in ranks.mp_data(cfg.vocab_size, cfg.max_seq))

    def loss_and_grad(p, t, y):
        if label not in ranks.MP_HYBRID_TRAIN:
            return jax.value_and_grad(lambda q: jt._local_loss(cfg, mesh, q, t, y))(p)
        # byteps_tpu.parallel.hybrid's level 1 on a dp replica's loss
        loss, g = jax.value_and_grad(lambda q: replica_loss(cfg, mesh, q, t, y))(p)
        return lax.pmean(loss, "dp"), jax.tree.map(lambda a: a / sizes["dp"], g)

    fn = jax.jit(jax.shard_map(loss_and_grad, mesh=mesh,
                               in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
                               out_specs=(P(), specs), check_vma=True))
    sgd = jax.jit(lambda p, g: jax.tree.map(lambda a, b: a - ranks.MP_LR * b, p, g))
    # (M, dp x Bmb, S, V), dim 1 dp-shard-major: back to the input's rows
    m, dp = cfg.microbatches or sizes["pp"], sizes["dp"]
    logits = np.asarray(jt.build_forward(cfg, mesh)(params, tokens))
    logits = logits.reshape(m, dp, -1, *logits.shape[2:]).transpose(1, 0, 2, 3, 4)
    logits = logits.reshape(-1, *logits.shape[3:])
    losses, grads, before = [], [], []
    for _ in range(ranks.MP_STEPS):
        before.append({k: np.asarray(v) for k, v in params.items()})
        loss, g = fn(params, tokens, targets)
        losses.append(float(loss))
        grads.append({k: np.asarray(v) for k, v in g.items()})
        params = sgd(params, g)
    before.append({k: np.asarray(v) for k, v in params.items()})
    return losses, grads, before, logits


def replica_loss(cfg, mesh, params, tokens, targets):
    """``jt._local_loss`` of one dp replica: its sums (and the MoE aux
    term) over pp and sp only, the loss a hybrid's loss_fn returns."""
    pp = mesh.shape.get("pp", 1)
    logits, aux = jt._local_forward(cfg, mesh, params, tokens)
    tgt = targets.reshape(logits.shape[0], -1, targets.shape[-1])
    valid = (tgt >= 0).astype(jnp.float32)
    lg = logits.astype(jnp.float32)
    gold = jnp.take_along_axis(lg, jnp.maximum(tgt, 0)[..., None], axis=-1)[..., 0]
    is_last = lax.axis_index("pp") == pp - 1
    total = jnp.where(is_last, jnp.sum((jax.nn.logsumexp(lg, axis=-1) - gold) * valid), 0.0)
    count = jnp.where(is_last, jnp.sum(valid), 0.0)
    for ax in ("pp", "sp"):
        total, count, aux = (lax.psum(v, ax) for v in (total, count, aux))
    loss = total / count
    if cfg.moe:
        loss = loss + cfg.moe_aux_coef * aux.astype(jnp.float32)
    return loss


def shard_of(global_arrays, name, coords, cfg_kw):
    """The block of the reference's global array that the port's parameter
    ``name`` (``layers.<i>.<p>`` or a global name) holds at ``coords``."""
    from byteps_tpu_torch.models import transformer as tt

    cfg = tt.tiny_test(**cfg_kw)
    base = name.rsplit(".", 1)[-1]
    arr = global_arrays[base]
    shape = tt.param_shapes(cfg)[base]
    if tt.is_layer_param(base):
        arr = arr.reshape((cfg.n_layers,) + shape)[int(name.split(".")[1])]
    for dim, ax in enumerate(tt.local_spec(cfg, base)):
        if ax is not None:
            n = arr.shape[dim] // coords[f"{ax}_size"]
            arr = np.take(arr, range(coords[ax] * n, (coords[ax] + 1) * n), axis=dim)
    return arr


def check(label, port_ranks, ref):
    """Every rank's loss, gradient shards and updated parameters of every
    step against the reference."""
    axes, kw = CASES[label]
    want_losses, want_grads, want_params, want_logits = ref
    for res in port_ranks:
        got = res[label]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        coords = dict(got["coords"], tp_size=axes.get("tp", 1), sp_size=axes.get("sp", 1))
        b, s = (want_logits.shape[i] // axes.get(ax, 1) for i, ax in enumerate(("dp", "sp")))
        block = want_logits[coords["dp"] * b:(coords["dp"] + 1) * b,
                            coords["sp"] * s:(coords["sp"] + 1) * s]
        np.testing.assert_allclose(got["logits"], block, rtol=LOGITS_RTOL,
                                   atol=LOGITS_ATOL * float(np.abs(block).max()))
        for step, (g_port, g_ref) in enumerate(zip(got["grads"], want_grads)):
            gmax = max(float(np.abs(v).max()) for v in g_ref.values())
            assert set(k.rsplit(".", 1)[-1] for k in g_port) == set(g_ref)
            for name, g in g_port.items():
                want = shard_of(g_ref, name, coords, kw)
                assert g.shape == want.shape, (name, g.shape, want.shape)
                np.testing.assert_allclose(
                    g, want, rtol=GRAD_RTOL, atol=GRAD_ATOL * gmax,
                    err_msg=f"{label} step {step} {name} at {got['coords']}")
            after, want_after = got["after"][step], want_params[step + 1]
            assert set(after) == set(want_after)
            for k in want_after:
                assert after[k].shape == want_after[k].shape, k
                np.testing.assert_allclose(
                    after[k], want_after[k], rtol=1e-5,
                    atol=GRAD_ATOL * ranks.MP_LR * gmax, err_msg=f"{label} step {step} {k}")
