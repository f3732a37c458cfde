"""Worker processes of the port's multi-process CPU tests.

``python tests/torch_port_ranks.py <case> <out_dir>`` runs one local rank:
``BYTEPS_LOCAL_RANK``, ``BYTEPS_LOCAL_SIZE`` and
``BYTEPS_LOCAL_INIT_METHOD`` say which (``spawn_group`` sets them, as the
launcher does).  It brings up the port on the CPU (a gloo group), runs the
case and pickles what the case returns to
``<out_dir>/<case>.<host>.<local rank>.pkl``, where ``<host>`` is
``BYTEPS_GLOBAL_RANK`` (0 when unset).  The test modules import this file
for the inputs and models the processes use, so both sides make them the
same way.  It imports torch, numpy and the port only.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- inputs ---------------------------------------------------------------

#: ragged shapes for push_pull (neither divides by 2 or 4 members)
RAGGED = {"vec7": (7,), "mat3x5": (3, 5)}
TREE_DICT = {"a": (5,), "b": (2, 3)}
TREE_LIST = [(4,), (1, 2)]
#: the int8 ring's cases: (label, shape, block)
RING = [("flat5000", (5000,), 256), ("mat37x7", (37, 7), 64)]


def member_inputs(seed: int, n: int, shape) -> np.ndarray:
    """Every member's input, (n, *shape) float32 from one seed: member i
    takes row i, the reference's shard_map takes the whole."""
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


# the MLP of tests/test_hybrid_topology.py, dp only: tanh(x @ w1) @ w2
D, H, B, STEPS, LR = 8, 16, 8, 4, 0.2


def mlp_params() -> Dict[str, np.ndarray]:
    r = np.random.default_rng(7)
    return {
        "w1": r.normal(0, 0.3, (D, H)).astype(np.float32),
        "w2": r.normal(0, 0.3, (H, D)).astype(np.float32),
    }


def mlp_data(worker: int):
    r = np.random.default_rng(100 + worker)
    x = r.normal(size=(STEPS, B, D)).astype(np.float32)
    y = r.normal(size=(STEPS, B, D)).astype(np.float32)
    return x, y


class MLP(torch.nn.Module):
    def __init__(self, params: Dict[str, np.ndarray]) -> None:
        super().__init__()
        for k in sorted(params):  # the reference ravels a dict in key order
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(params[k].copy())))


def mlp_loss(model: MLP, batch) -> torch.Tensor:
    x, y = batch
    return ((torch.tanh(x @ model.w1) @ model.w2 - y) ** 2).mean()


# the step builders: group of 4, the global batch of each step split in 4
BUILDER_N, BUILDER_STEPS, BUILDER_LR = 4, 3, 0.05
#: (label, optimizer, build_data_parallel_step kwargs)
BUILDER_CASES = [
    ("sgd", "sgd", {}),
    ("adam", "adam", {}),
    ("sgd_accumulate2", "sgd", {"accumulate_steps": 2}),
    ("adam_accumulate2", "adam", {"accumulate_steps": 2}),
    ("sgd_int8", "sgd", {"grad_quant_bits": 8}),
]
ZERO1_CASES = ["sgd", "adam"]


def builder_data():
    """(steps, global batch, D) inputs and targets of the step builders."""
    r = np.random.default_rng(31)
    x = r.normal(size=(BUILDER_STEPS, 4 * BUILDER_N, D)).astype(np.float32)
    y = r.normal(size=(BUILDER_STEPS, 4 * BUILDER_N, D)).astype(np.float32)
    return x, y


def torch_optimizer(kind: str, params) -> torch.optim.Optimizer:
    if kind == "sgd":
        return torch.optim.SGD(params, lr=BUILDER_LR)
    return torch.optim.Adam(params, lr=BUILDER_LR, foreach=False)


# --- cases, one per process group -----------------------------------------


def case_collectives() -> dict:
    """The collectives and the int8 ring on every member's seeded input,
    and the host-level push_pull of a group on one host."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import collectives as C
    from byteps_tpu_torch.comm.mesh import require_mesh
    from byteps_tpu_torch.ops.quantized_allreduce import quantized_psum

    bps.init(device="cpu")
    mesh = require_mesh()
    r, n = mesh.rank, mesh.size
    out = {}
    for i, (label, shape) in enumerate(RAGGED.items()):
        x = torch.from_numpy(member_inputs(10 + i, n, shape)[r])
        for mode in ("psum", "scatter_gather"):
            for average in (True, False):
                out[("push_pull", label, mode, average)] = C.push_pull(
                    x, average=average, mode=mode).numpy()
    x = torch.from_numpy(member_inputs(20, n, (3 * n, 2))[r])
    for average in (True, False):
        out[("reduce_scatter", average)] = C.reduce_scatter(x, average=average).numpy()
    out["all_gather"] = C.all_gather(torch.from_numpy(member_inputs(21, n, (3, 2))[r])).numpy()
    x = torch.from_numpy(member_inputs(22, n, (6,))[r])
    for root in (0, n - 1):
        out[("broadcast", root)] = C.broadcast(x, root=root).numpy()
    tree = {k: torch.from_numpy(member_inputs(23 + i, n, s)[r])
            for i, (k, s) in enumerate(TREE_DICT.items())}
    out["tree_dict"] = {k: v.numpy() for k, v in C.push_pull_tree(tree).items()}
    tree = [torch.from_numpy(member_inputs(25 + i, n, s)[r]) for i, s in enumerate(TREE_LIST)]
    out["tree_list"] = [v.numpy() for v in C.push_pull_tree(tree, average=False)]
    for i, (label, shape, block) in enumerate(RING):
        x = torch.from_numpy(member_inputs(30 + i, n, shape)[r])
        out[("ring", label)] = quantized_psum(x, axis_size=n, block=block).numpy()
    out["ring_zero"] = quantized_psum(torch.zeros(512)).numpy()
    try:
        quantized_psum(torch.ones(256), axis_size=n + 1)
    except ValueError as e:
        out["ring_mismatch"] = str(e)
    x = torch.from_numpy(member_inputs(40, n, (11,))[r])
    out["host_level"] = bps.push_pull(x, name="host.level").numpy()
    out["host_level_sum"] = bps.push_pull(x, name="host.level.sum", average=False).numpy()
    out["identity"] = (bps.rank(), bps.size(), bps.local_rank(), bps.local_size())
    bps.shutdown()
    return out


def case_hybrid() -> dict:
    """One host of the hybrid run: HybridDataParallel on the MLP, its part
    of the host's batch; then the host-level push_pull and
    broadcast_parameters across the hosts."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel import HybridDataParallel

    bps.init(device="cpu")
    host, r, n = int(os.environ["BYTEPS_GLOBAL_RANK"]), bps.local_rank(), bps.local_size()
    model = MLP(mlp_params())
    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=LR))
    x, y = mlp_data(host)
    rows = slice(r * B // n, (r + 1) * B // n)
    batch = (torch.from_numpy(x[0][rows]), torch.from_numpy(y[0][rows]))
    losses = [hdp.step(batch, mlp_loss) for _ in range(STEPS)]
    out = {"losses": losses, "params": {k: v.detach().numpy().copy()
                                        for k, v in model.named_parameters()}}
    me = host * n + r
    v = torch.from_numpy(member_inputs(50, 2 * n, (11,))[me])
    out["host_level"] = bps.push_pull(v, name="hybrid.host.level").numpy()
    out["identity"] = (bps.rank(), bps.size(), bps.local_rank(), bps.local_size())
    own = {"w": torch.full((3,), float(me))}
    bps.broadcast_parameters(own, root_rank=0)
    out["broadcast"] = (me, own["w"].numpy())
    bps.shutdown()
    return out


def case_builders() -> dict:
    """The step builders at group size BUILDER_N, each rank on its rows of
    every step's global batch; ZeRO-1's state size; allreduce_gradients."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.optim import (allreduce_gradients, build_data_parallel_step,
                                        build_zero1_step)

    bps.init(device="cpu")
    r, n = bps.local_rank(), bps.local_size()
    x, y = builder_data()
    per = x.shape[1] // n
    batches = [(torch.from_numpy(x[s][r * per:(r + 1) * per]),
                torch.from_numpy(y[s][r * per:(r + 1) * per])) for s in range(BUILDER_STEPS)]

    def params(model):
        return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}

    out = {}
    for label, kind, kw in BUILDER_CASES:
        model = MLP(mlp_params())
        step = build_data_parallel_step(mlp_loss, model, torch_optimizer(kind, model.parameters()),
                                        **kw)
        losses = [float(step(b)) for b in batches]
        out[("dp", label)] = (params(model), losses)
    for kind in ZERO1_CASES:
        model = MLP(mlp_params())
        init_fn, step = build_zero1_step(mlp_loss, model,
                                         lambda ps, kind=kind: torch_optimizer(kind, ps))
        opt = init_fn()
        losses = [float(step(b)) for b in batches]
        state = [t.numel() for s in opt.state.values() for t in s.values()
                 if torch.is_tensor(t) and t.dim() > 0]
        out[("zero1", kind)] = (params(model), losses, state)
    model = MLP(mlp_params())
    for i, p in enumerate(model.parameters()):
        p.grad = torch.from_numpy(member_inputs(60 + i, n, tuple(p.shape))[r])
    allreduce_gradients(model.parameters())
    out["allreduce_gradients"] = [p.grad.numpy().copy() for p in model.parameters()]
    bps.shutdown()
    return out


#: distributed_optimizer: SGD over the group's dp axis, BUILDER_STEPS steps
#: of the step builders' batches, averaged and summed
DIST_OPT_AVERAGE = (True, False)


def case_dist_opt() -> dict:
    """``optim.distributed_optimizer(SGD)`` over the global mesh's dp axis,
    each rank on its rows of every step's global batch: the losses and
    the parameters after each step, with ``average`` on and off."""
    import byteps_tpu_torch as bps

    bps.init(device="cpu")
    r, n = bps.local_rank(), bps.local_size()
    x, y = builder_data()
    per = x.shape[1] // n
    out = {}
    for average in DIST_OPT_AVERAGE:
        model = MLP(mlp_params())
        opt = bps.distributed_optimizer(torch.optim.SGD(model.parameters(), lr=BUILDER_LR),
                                        axis_names=("dp",), average=average)
        losses, params = [], []
        for s in range(BUILDER_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = mlp_loss(model, (torch.from_numpy(x[s][r * per:(r + 1) * per]),
                                    torch.from_numpy(y[s][r * per:(r + 1) * per])))
            loss.backward()
            opt.step()
            losses.append(float(loss))
            params.append({k: v.detach().numpy().copy() for k, v in model.named_parameters()})
        out[average] = {"losses": losses, "params": params}
    try:
        bps.distributed_optimizer(torch.optim.SGD(model.parameters(), lr=BUILDER_LR),
                                  axis_names=("tp",)).step()
    except ValueError as e:
        out["unknown_axis"] = str(e)
    torch.distributed.barrier()
    bps.shutdown()
    return out


#: the host-level degraded case: one host of two local ranks, its root's
#: pushes dropped by the chaos van (one partition a tensor)
DEGRADED_N = 300


def case_degraded() -> dict:
    """One host (two local ranks, one PS worker) whose root's PS pushes are
    lost: with the in-place heal off, the root's push_pull degrades and
    every local rank raises DegradedError, none waits in the broadcast;
    the next push_pull goes through the init barrier again.  Then with
    degraded-step retries and the client's heal failing once, the
    api-level heal mends the step on the root and every rank gets the
    fault-free result."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import chaos
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.types import DegradedError
    from byteps_tpu_torch.core.state import get_state
    from byteps_tpu_torch.core.telemetry import counters

    bps.init(device="cpu")
    r = bps.local_rank()
    x = torch.from_numpy(member_inputs(60, 2, (DEGRADED_N,))[r])
    out = {"clean": bps.push_pull(x, name="deg.a").numpy()}
    if r == 0:
        chaos.reset_fault_budget(2)  # the push and its one retry
    try:
        bps.push_pull(x + 1, name="deg.a")
        out["raised"] = None
    except DegradedError as e:
        out["raised"] = str(e)
    out["after"] = bps.push_pull(x + 1, name="deg.a").numpy()
    cfg = get_config()
    cfg.degraded_step_retries, cfg.resync_deadline_s = 2, 5.0
    if r == 0:
        client = get_state().ps_client
        real, calls = client._heal_in_place, []

        def fails_once(key, sid):
            calls.append(key)
            return len(calls) > 1 and real(key, sid)

        client._heal_in_place = fails_once
        chaos.reset_fault_budget(2)
        counters().reset()
    out["healed"] = bps.push_pull(x + 2, name="deg.a").numpy()
    out["counters"] = counters().snapshot()
    out["reinit"] = (sorted(get_state().engine._reinit_names)
                     if get_state().engine is not None else None)
    # the root's shutdown (its PS client's resend pool) outlasts the other
    # rank's: a gloo group torn down that far apart may abort at exit
    torch.distributed.barrier(group=get_state().mesh.group)
    bps.shutdown()
    return out


#: the host-level elastic case: one host of two local ranks against a live
#: cluster of one worker slot
ELASTIC_N = 300


def case_elastic() -> dict:
    """One host (two local ranks, one PS worker) suspends and resumes as a
    whole: every rank calls suspend() and resume(), only the root
    re-registers (a rejoin by its uid, its barrier released at once), the
    declared keys stay, and the host-level push_pull goes on."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core.state import get_state

    bps.init(device="cpu")
    r = bps.local_rank()
    x = torch.from_numpy(member_inputs(70, 2, (ELASTIC_N,))[r])
    keys_before = {n: bps.declare_tensor(n) for n in ("el.a", "el.b")}
    outs = [bps.push_pull(x, name="el.a", average=False).numpy()]
    bps.suspend()
    bps.resume(num_workers=1)
    keys_after = {n: bps.declare_tensor(n) for n in ("el.a", "el.b")}
    outs.append(bps.push_pull(x, name="el.a", average=False).numpy())
    outs.append(bps.push_pull(x, name="el.b", average=False).numpy())
    out = {"keys_before": keys_before, "keys_after": keys_after, "outs": outs,
           "size": bps.size()}
    torch.distributed.barrier(group=get_state().mesh.group)
    bps.shutdown()
    return out


# --- model parallelism ----------------------------------------------------

#: the attention cases: q/k/v (B, H, S, dh) and the sp sizes
ATTN_SHAPE, ATTN_SP = (2, 2, 16, 8), (2, 4)
#: tiny_test trained for MP_STEPS SGD steps at each mesh: (label, axis
#: sizes, config kwargs)
MP_LR, MP_STEPS, MP_BATCH, MP_SEED = 0.1, 3, 4, 0
MP_TRAIN = [
    ("tp2", {"tp": 2}, {}),
    ("pp2", {"pp": 2}, {"microbatches": 2}),
    ("sp2_ring", {"sp": 2}, {"causal": True}),
    ("sp2_ring_flash", {"sp": 2}, {"causal": True, "use_flash": True, "pos_emb": "rope"}),
    ("sp2_ulysses", {"sp": 2}, {"causal": True, "seq_parallel_impl": "ulysses"}),
    ("pp2_tp2", {"pp": 2, "tp": 2}, {"causal": True, "attn_bias": True}),
    ("dp2_sp2", {"dp": 2, "sp": 2}, {"use_flash": True}),
    # expert layers: the experts over sp (4 a rank of 8), the aux term
    # summed over the mesh and, at pp 2, over the microbatches
    ("moe_sp2", {"sp": 2}, {"moe": True, "causal": True}),
    ("moe_pp2", {"pp": 2}, {"moe": True, "microbatches": 2, "moe_top_k": 1}),
    ("moe_sp2_tp2", {"sp": 2, "tp": 2}, {"moe": True, "n_kv_heads": 2, "use_flash": True}),
    ("moe_dp2_sp2_hybrid", {"dp": 2, "sp": 2}, {"moe": True, "causal": True}),
    # the hybrid over pipeline stages: the reference's stacked layer keys
    ("dp2_pp2_hybrid", {"dp": 2, "pp": 2}, {"microbatches": 2}),
    ("pp2_tp2_hybrid", {"pp": 2, "tp": 2}, {"causal": True, "attn_bias": True,
                                            "microbatches": 2}),
]
#: the MP_TRAIN cases that train through HybridDataParallel (one host, no
#: PS: its hop is the identity at one worker), each rank's loss that of its
#: dp replica, averaged over dp as the reference's hybrid averages it
MP_HYBRID_TRAIN = {"moe_dp2_sp2_hybrid", "dp2_pp2_hybrid", "pp2_tp2_hybrid"}


def attn_inputs(seed: int):
    """q, k, v and the output cotangent w of the attention cases."""
    r = np.random.default_rng(seed)
    return [r.normal(size=ATTN_SHAPE).astype(np.float32) for _ in range(4)]


def mp_data(vocab: int, seq: int, seed: int = MP_SEED):
    """(tokens, targets) of the training cases: next-token targets, a few
    ignored (< 0)."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, size=(MP_BATCH, seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[:, -1] = -1
    targets[0, 3] = -1
    return tokens, targets


def case_mp_attention() -> dict:
    """Ring attention (dense and flash hops) at every sp of ATTN_SP, causal
    and not, and Ulysses at sp 2: each rank's block of O and of dQ, dK, dV
    for the loss sum(O * w)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh
    from byteps_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
    from byteps_tpu_torch.parallel.ulysses import ulysses_attention

    bps.init(device="cpu")
    n = bps.local_size()
    out = {}
    fns = {"ring": ring_attention, "ring_flash": ring_flash_attention,
           "ulysses": ulysses_attention}
    for sp in ATTN_SP:
        mesh = make_training_mesh(axis_sizes={"dp": n // sp, "sp": sp})
        j, s = mesh.axis_index("sp"), ATTN_SHAPE[2] // sp
        for causal in (True, False):
            for impl, fn in fns.items():
                if impl == "ulysses" and sp != 2:
                    continue
                q, k, v, w = (torch.from_numpy(a[:, :, j * s:(j + 1) * s].copy())
                              for a in attn_inputs(3))
                for t in (q, k, v):
                    t.requires_grad_(True)
                o = fn(q, k, v, "sp", sp, causal=causal, mesh=mesh)
                (o * w).sum().backward()
                out[(impl, sp, causal)] = (j, o.detach().numpy(), q.grad.numpy(),
                                           k.grad.numpy(), v.grad.numpy())
    bps.shutdown()
    return out


def wait_for(path: str, timeout: float = 150.0):
    """Load the pickle the test process writes to ``path`` (atomically)."""
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def case_mp_train() -> dict:
    """Each MP_TRAIN mesh ``MP_LABELS`` names (comma-separated), trained
    for MP_STEPS SGD steps, each step taken from the reference's
    parameters of that step (``<MP_REF_DIR>/ref.<label>.pkl``, global
    arrays): tiny_test's loss is chaotic enough in f32 that two exact
    trajectories part by more than rounding after a step or two, so each
    step starts where the reference's did.  Per step: the loss, every
    gradient shard, and the parameters after the step gathered into the
    reference's layout; build_forward's logits at the first step's
    parameters; and the rank's coordinates."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tt
    from byteps_tpu_torch.models.convert import params_to_jax, shard_params_from_jax
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device="cpu")
    labels = os.environ["MP_LABELS"].split(",")
    out = {}
    for label, axes, kw in MP_TRAIN:
        if label not in labels:
            continue
        mesh = make_training_mesh(axis_sizes=axes)
        cfg = tt.tiny_test(**kw)
        pp = mesh.axis_size("pp")
        model = tt.Transformer(cfg, device="cpu", mesh=mesh)
        opt = torch.optim.SGD(model.parameters(), lr=MP_LR)
        if label in MP_HYBRID_TRAIN:
            from byteps_tpu_torch.parallel import HybridDataParallel

            hdp = HybridDataParallel(model, opt, mesh=mesh, param_specs=model.param_specs(),
                                     grad_sync_axes=model.grad_sync_axes())

            def step(t, y):
                return hdp.step((t, y), lambda m, b: m.loss(*b, over=("pp", "sp")))
        else:
            step = tt.build_train_step(model, opt)
        tokens, targets = (tt.shard_batch(torch.from_numpy(a), mesh)
                           for a in mp_data(cfg.vocab_size, cfg.max_seq))
        ref_params = wait_for(os.path.join(os.environ["MP_REF_DIR"], f"ref.{label}.pkl"))
        losses, grads, after = [], [], []
        for k in range(MP_STEPS):
            model.load_state_dict(shard_params_from_jax(ref_params[k], cfg, mesh))
            if k == 0:
                logits = tt.build_forward(model)(tokens.long()).numpy()
            losses.append(float(step(tokens.long(), targets)))
            grads.append({n: p.grad.numpy().copy() for n, p in model.named_parameters()})
            after.append(params_to_jax(model.state_dict(), cfg, pp_size=pp, mesh=mesh))
        coords = {ax: mesh.axis_index(ax) for ax in ("dp", "pp", "sp", "tp")}
        out[label] = {"losses": losses, "grads": grads, "after": after, "coords": coords,
                      "logits": logits}
    bps.shutdown()
    return out


#: cached (and recompute) decoding on meshes: (label, axis sizes, causal
#: tiny_test kwargs), the prompt and the new tokens of the reference's tests
MP_GENERATE = [
    ("gen_pp2", {"pp": 2}, {"microbatches": 2}),
    ("gen_sp2_moe", {"sp": 2}, {"moe": True, "n_experts": 4}),
    ("gen_dp2_tp2_gqa", {"dp": 2, "tp": 2}, {"n_kv_heads": 2, "microbatches": 2}),
]
GEN_PROMPT = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [3, 1, 2]], np.int64)
GEN_NEW, GEN_SEED = 5, 3


def case_mp_generate() -> dict:
    """Each MP_GENERATE mesh whose group size is this group's: the shards
    of ``init_params(seed=GEN_SEED)``, greedy tokens of both builders, the
    cached builder's cache shapes, and two sampled decodes of four copies
    of one prompt (the same seed twice)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tt
    from byteps_tpu_torch.models.convert import shard_params_from_jax
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device="cpu")
    out = {}
    for label, axes, kw in MP_GENERATE:
        if int(np.prod(list(axes.values()))) != bps.local_size():
            continue
        mesh = make_training_mesh(axis_sizes=axes)
        cfg = tt.tiny_test(causal=True, **kw)
        model = tt.Transformer(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(shard_params_from_jax(
            tt.init_params(cfg, seed=GEN_SEED, pp_size=mesh.axis_size("pp")), cfg, mesh))
        cached = tt.build_generate_cached(model)
        same = np.repeat(GEN_PROMPT[:1], 4, axis=0)
        out[label] = {
            "cached": cached(GEN_PROMPT, GEN_NEW),
            "recompute": tt.build_generate(model)(GEN_PROMPT, GEN_NEW),
            "cache_shapes": cached.cache_shapes,
            "sampled": [cached(same, 8, temperature=3.0, seed=7) for _ in range(2)],
            "coords": {ax: mesh.axis_index(ax) for ax in ("dp", "pp", "sp", "tp")},
        }
    bps.shutdown()
    return out


#: the GPT-2 import on a mesh: the checkpoint the test side saves (its
#: config's fields and HF state dict as numpy), the mesh, the prompts
HF_CKPT, HF_AXES = "hf_gpt2.pkl", {"pp": 2, "tp": 2}
HF_PROMPT, HF_NEW = np.array([[5, 17, 42, 7], [9, 3, 88, 21]], np.int64), 6


def hf_duck(config: dict, state: dict):
    """A GPT-2 model as the importer reads one, with no ``transformers``
    behind it: a namespace ``config`` and a ``state_dict()`` of tensors."""
    import types

    return types.SimpleNamespace(config=types.SimpleNamespace(**config),
                                 state_dict=lambda: {k: torch.from_numpy(v)
                                                     for k, v in state.items()})


def case_hf_generate() -> dict:
    """The saved checkpoint imported at pp_size=2 through ``hf_duck``, this
    rank's shards on HF_AXES cut by ``shard_params_from_jax``: the cached
    builder's greedy tokens."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tt
    from byteps_tpu_torch.models.convert import shard_params_from_jax
    from byteps_tpu_torch.models.hf_import import load_gpt2_weights
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    with open(os.path.join(sys.argv[2], HF_CKPT), "rb") as f:
        ckpt = pickle.load(f)
    bps.init(device="cpu")
    mesh = make_training_mesh(axis_sizes=HF_AXES)
    cfg, params = load_gpt2_weights(hf_duck(**ckpt), pp_size=HF_AXES["pp"])
    model = tt.Transformer(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(shard_params_from_jax(params, cfg, mesh))
    out = {"cached": tt.build_generate_cached(model)(HF_PROMPT, HF_NEW),
           "coords": {ax: mesh.axis_index(ax) for ax in ("dp", "pp", "sp", "tp")}}
    bps.shutdown()
    return out


#: the expert-parallel layer alone: (label, top_k, capacity factor), on
#: T tokens a rank, D wide, F hidden, E experts in all
MOE_EP_CASES = [("top1", 1, 2.0), ("top2", 2, 2.0), ("top2_drops", 2, 0.5)]
MOE_EP_T, MOE_EP_D, MOE_EP_F, MOE_EP_E = 12, 6, 10, 4


def moe_ep_inputs(seed: int = 9):
    """x (sp·T, D), router (D, E), w1, b1, w2, b2 over all E experts, and
    the output cotangent (sp·T, D), for sp = 2."""
    r = np.random.default_rng(seed)
    t, d, f, e = 2 * MOE_EP_T, MOE_EP_D, MOE_EP_F, MOE_EP_E
    return [r.normal(size=s).astype(np.float32) * c for s, c in (
        ((t, d), 1.0), ((d, e), 1.0), ((e, d, f), 0.3), ((e, f), 0.1), ((e, f, d), 0.3),
        ((e, d), 0.1), ((t, d), 1.0))]


def case_moe_ep() -> dict:
    """moe_mlp with its experts over an sp axis of this group's ranks:
    each rank's tokens and experts, the output and the gradients of the
    loss sum(y * w) (the router's summed over sp, as the reference's
    replicated router's is), and the drops."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import collectives as C
    from byteps_tpu_torch.parallel import moe
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device="cpu")
    mesh = make_training_mesh(axis_sizes={"sp": bps.local_size()})
    j, n = mesh.axis_index("sp"), mesh.axis_size("sp")
    x, router, w1, b1, w2, b2, w = moe_ep_inputs()
    tok, exp = slice(j * MOE_EP_T, (j + 1) * MOE_EP_T), slice(j * MOE_EP_E // n,
                                                                (j + 1) * MOE_EP_E // n)
    out = {}
    for label, k, cf in MOE_EP_CASES:
        ts = [torch.tensor(a, requires_grad=True)
              for a in (x[tok], router, w1[exp], b1[exp], w2[exp], b2[exp])]
        with moe.count_drops() as drops:
            y = moe.moe_mlp(*ts, axis_name="sp", axis_size=n, capacity_factor=cf, top_k=k,
                            mesh=mesh)
        (y * torch.from_numpy(w[tok])).sum().backward()
        grads = [t.grad for t in ts]
        grads[1] = C.all_reduce_axis(grads[1], "sp", mesh)
        out[label] = {"y": y.detach().numpy(), "grads": [g.numpy() for g in grads],
                      "drops": int(drops[0]), "rank": j}
    bps.shutdown()
    return out


def case_dryrun() -> dict:
    """``byteps_tpu_torch.dryrun.dryrun_multichip`` at this group's size,
    then each of its meshes again for the loss and the decoded tokens."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch import dryrun

    bps.init(device="cpu")
    n = bps.local_size()
    out = {"lines": dryrun.dryrun_multichip(n),
           "runs": [dryrun.dryrun_one_mesh(sizes)[1] for sizes in dryrun.mesh_configs(n)]}
    bps.shutdown()
    return out


#: the sharded hybrid: each host a {dp:2, tp:2} mesh, the MLP's w1 split
#: on columns and w2 on rows (tests/test_hybrid_topology.py's specs)
MP_HYBRID_AXES = {"dp": 2, "tp": 2}
MP_HYBRID_SPECS = {"w1": (None, "tp"), "w2": ("tp", None)}


def case_mp_hybrid() -> dict:
    """One host of the sharded hybrid: HybridDataParallel on the MLP's tp
    shards, this rank's dp rows of the host's batch, the row-parallel
    product summed over tp.  The keys it declared, every pull the root's
    PS hop brought back (whole), the losses and the final shards."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import collectives as C
    from byteps_tpu_torch.parallel import HybridDataParallel
    from byteps_tpu_torch.parallel import hybrid as hybrid_mod
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device="cpu")
    host = int(os.environ["BYTEPS_GLOBAL_RANK"])
    mesh = make_training_mesh(axis_sizes=MP_HYBRID_AXES)
    t, tp = mesh.axis_index("tp"), mesh.axis_size("tp")
    full = mlp_params()
    cols = slice(t * H // tp, (t + 1) * H // tp)
    model = MLP({"w1": full["w1"][:, cols], "w2": full["w2"][cols, :]})

    def loss_fn(m, batch):
        x, y = batch
        return ((C.psum(torch.tanh(x @ m.w1) @ m.w2, "tp", mesh) - y) ** 2).mean()

    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh,
                             param_specs=MP_HYBRID_SPECS)
    pulls = []
    real = hybrid_mod.synchronize

    def tap(handle):
        out = real(handle)
        pulls.append(out.numpy().copy())
        return out

    hybrid_mod.synchronize = tap
    x, y = mlp_data(host)
    d, dp = mesh.axis_index("dp"), mesh.axis_size("dp")
    rows = slice(d * B // dp, (d + 1) * B // dp)
    batch = (torch.from_numpy(x[0][rows]), torch.from_numpy(y[0][rows]))
    losses = [hdp.step(batch, loss_fn) for _ in range(STEPS)]
    out = {"keys": hdp.keys, "pulls": pulls, "losses": losses, "coords": (d, t),
           "params": {k: v.detach().numpy().copy() for k, v in model.named_parameters()}}
    torch.distributed.barrier()
    bps.shutdown()
    return out


#: the hybrid over pipeline stages on two hosts: each a {pp:2} group,
#: tiny_test at two microbatches, its batch from seed MP_SEED + 1 + host
MP_HYBRID_PP_AXES, MP_HYBRID_PP_CFG, MP_HYBRID_PP_STEPS = {"pp": 2}, {"microbatches": 2}, 3


def case_mp_hybrid_pp() -> dict:
    """One host of the hybrid over pipeline stages: HybridDataParallel on
    this rank's stage of tiny_test, the host's batch, each step from the
    reference's parameters of that step (``<out>/ref.mp_hybrid_pp.pkl``:
    tiny_test's f32 loss is chaotic, see ``case_mp_train``).  The keys it
    declared, every pull the root's PS hop brought back (whole, stacked),
    the losses, the rank's stage and its parameters after the last step."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tt
    from byteps_tpu_torch.models.convert import shard_params_from_jax
    from byteps_tpu_torch.parallel import HybridDataParallel
    from byteps_tpu_torch.parallel import hybrid as hybrid_mod
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device="cpu")
    host = int(os.environ["BYTEPS_GLOBAL_RANK"])
    mesh = make_training_mesh(axis_sizes=MP_HYBRID_PP_AXES)
    cfg = tt.tiny_test(**MP_HYBRID_PP_CFG)
    model = tt.Transformer(cfg, device="cpu", mesh=mesh)
    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=MP_LR), mesh=mesh,
                             param_specs=model.param_specs(),
                             grad_sync_axes=model.grad_sync_axes())
    pulls = []
    real = hybrid_mod.synchronize

    def tap(handle):
        out = real(handle)
        pulls.append(out.numpy().copy())
        return out

    hybrid_mod.synchronize = tap
    tokens, targets = (torch.from_numpy(a) for a in
                       mp_data(cfg.vocab_size, cfg.max_seq, seed=MP_SEED + 1 + host))
    ref_params = wait_for(os.path.join(sys.argv[2], "ref.mp_hybrid_pp.pkl"))
    losses = []
    for k in range(MP_HYBRID_PP_STEPS):
        model.load_state_dict(shard_params_from_jax(ref_params[k], cfg, mesh))
        losses.append(hdp.step((tokens.long(), targets),
                               lambda m, b: m.loss(*b, over=("pp", "sp"))))
    out = {"keys": hdp.keys, "pulls": pulls, "losses": losses, "stage": mesh.axis_index("pp"),
           "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}
    torch.distributed.barrier()
    bps.shutdown()
    return out


def case_cuda_clash() -> dict:
    """Two ranks that name one CUDA device, no staged transport: build_mesh
    raises before any process group comes up.  Then the same two ranks
    build a CPU mesh from the spec "dp=1,tp=2" (a rendezvous of its own)
    and sum their ranks over tp."""
    from byteps_tpu_torch.comm import collectives
    from byteps_tpu_torch.comm.mesh import build_mesh

    out = {"raised": None}
    try:
        build_mesh(device="cuda:0")
    except ValueError as e:
        out = {"raised": str(e), "initialized": torch.distributed.is_initialized()}
    mesh = build_mesh("dp=1,tp=2", device="cpu",
                      init_method=os.environ["BYTEPS_LOCAL_INIT_METHOD"] + ".cpu")
    out["built"] = (mesh.shape, mesh.axis_index("tp"), float(collectives.psum(
        torch.tensor(float(mesh.rank + 1)), "tp", mesh)))
    mesh.destroy()
    return out


#: the batch-statistics step's case: SGD with momentum, two steps, the
#: global batch of BN_BATCH split over the group's ranks in order
BN_STEPS, BN_BATCH, BN_IMAGE, BN_LR = 2, 8, 16, 0.1


def bn_data():
    """(steps, BN_BATCH, H, W, 3) NHWC images and (steps, BN_BATCH) labels."""
    r = np.random.default_rng(31)
    x = r.normal(size=(BN_STEPS, BN_BATCH, BN_IMAGE, BN_IMAGE, 3)).astype(np.float32)
    return x, r.integers(0, 10, (BN_STEPS, BN_BATCH))


def bn_loss(model, batch) -> torch.Tensor:
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def case_bn_step() -> dict:
    """ResNetTiny from the reference's weights (``bn_weights.pt`` in the
    out dir), each rank on its rows of each step's batch, through
    ``build_batchnorm_data_parallel_step``: the losses, and every
    parameter and running statistic after the steps."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models.resnet import ResNetTiny
    from byteps_tpu_torch.optim import build_batchnorm_data_parallel_step

    from byteps_tpu_torch.comm.mesh import require_mesh

    bps.init(device="cpu")
    mesh = require_mesh()
    model = ResNetTiny()
    model.load_state_dict(torch.load(os.path.join(sys.argv[2], "bn_weights.pt")))
    opt = torch.optim.SGD(model.parameters(), lr=BN_LR, momentum=0.9)
    step = build_batchnorm_data_parallel_step(bn_loss, model, opt, mesh=mesh)
    x, y = bn_data()
    n = BN_BATCH // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    losses = [float(step((torch.from_numpy(x[s][rows]), torch.from_numpy(y[s][rows]))))
              for s in range(BN_STEPS)]
    out = {"losses": losses,
           "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}
    torch.distributed.barrier()
    bps.shutdown()
    return out


def case_mesh_env() -> dict:
    """``BYTEPS_TPU_MESH`` lays out the host's group at ``init()``: a spec
    whose sizes do not multiply to the group's size raises before any
    group comes up; "dp:1,tp:2" gives the group that layout."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import collectives
    from byteps_tpu_torch.comm.mesh import get_global_mesh

    out = {}
    os.environ["BYTEPS_TPU_MESH"] = "dp:3"
    try:
        bps.init(device="cpu")
    except ValueError as e:
        out["raised"] = str(e)
    out["initialized_after_raise"] = torch.distributed.is_initialized()
    os.environ["BYTEPS_TPU_MESH"] = "dp:1,tp:2"
    bps.init(device="cpu")
    mesh = get_global_mesh()
    out.update(shape=dict(mesh.shape), ranks=mesh.ranks.copy(), tp=mesh.axis_index("tp"),
               psum=float(collectives.psum(torch.tensor(float(mesh.rank + 1)), "tp", mesh)))
    torch.distributed.barrier()
    bps.shutdown()
    return out


CASES = {"bn_step": case_bn_step, "mesh_env": case_mesh_env,
         "collectives": case_collectives, "dist_opt": case_dist_opt, "hybrid": case_hybrid,
         "builders": case_builders, "degraded": case_degraded, "elastic": case_elastic,
         "mp_attention": case_mp_attention, "mp_train": case_mp_train,
         "mp_generate": case_mp_generate, "dryrun": case_dryrun,
         "hf_generate": case_hf_generate,
         "moe_ep": case_moe_ep,
         "mp_hybrid": case_mp_hybrid, "mp_hybrid_pp": case_mp_hybrid_pp,
         "cuda_clash": case_cuda_clash}


# --- the test side --------------------------------------------------------


def spawn_group(case: str, n: int, out_dir: str, env: Dict[str, str] = None,
                host: int = 0) -> List[subprocess.Popen]:
    """Start the ``n`` local ranks of one host running ``case``, its group's
    rendezvous a file under ``out_dir``."""
    base = {**os.environ, **(env or {}), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
            "BYTEPS_LOCAL_SIZE": str(n), "BYTEPS_GLOBAL_RANK": str(host),
            "BYTEPS_LOCAL_INIT_METHOD": "file://" + os.path.join(out_dir, f"{case}.{host}.store")}
    procs = []
    for r in range(n):
        log = open(os.path.join(out_dir, f"{case}.{host}.{r}.log"), "w")
        with log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, out_dir],
                env={**base, "BYTEPS_LOCAL_RANK": str(r)}, cwd=REPO,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs: List[subprocess.Popen], case: str, n: int, out_dir: str,
            host: int = 0, timeout: float = 120) -> List[dict]:
    """Wait for a group's processes and load what each rank returned;
    raises with the logs when one failed."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"{case}.{host}.{r}")
        if p.returncode != 0:
            with open(path + ".log") as f:
                raise RuntimeError(f"{case} host {host} rank {r} exited {p.returncode}:\n"
                                   + f.read()[-4000:])
        with open(path + ".pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def main(case: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    result = CASES[case]()
    host = os.environ.get("BYTEPS_GLOBAL_RANK") or "0"
    path = os.path.join(out_dir, f"{case}.{host}.{os.environ['BYTEPS_LOCAL_RANK']}.pkl")
    with open(path, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
