"""The port's transformer (byteps_tpu_torch.models.transformer) against
byteps_tpu's on a 1-device mesh, in f32, on the same numpy parameters and
tokens: logits, loss and gradients, and three DistributedOptimizer(AdamW)
steps against build_train_step(optax.adamw).

Tolerances (f32): logits rtol 1e-4 / atol 1e-5, loss rtol 1e-5, gradients
rtol 1e-4 / atol 1e-5 times the largest gradient of the tensor (the
embedding's reach ~5) — the same math, reduced in other orders by XLA and
by torch.  After three AdamW steps, parameters atol 0.1·lr: Adam divides by
sqrt(v), so the update of a gradient that is rounding noise can take
another direction (the typical element has moved by ~3·lr by then).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import byteps_tpu_torch as bps
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax

LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the cores to
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# each flag of the slice at least once, remat on and off
VARIANTS = {
    "dense": dict(),
    "causal-flash-rope-gqa": dict(causal=True, use_flash=True, pos_emb="rope",
                                  n_kv_heads=2, remat=False),
    "flash-bias": dict(use_flash=True, attn_bias=True),
    "causal-dense-bias-gqa": dict(causal=True, attn_bias=True, n_kv_heads=2,
                                  remat=False),
    # expert layers, top-2 with remat (more: tests/test_torch_port_moe.py)
    "moe-causal-top2": dict(moe=True, n_experts=4, causal=True),
}


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


def _configs(name):
    kw = VARIANTS[name]
    return jt.tiny_test(**kw), tt.tiny_test(**kw)


def _mesh():
    return make_training_mesh(1, {"dp": 1, "pp": 1, "sp": 1, "tp": 1})


def _data(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, cfg.max_seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[0, -1] = -1  # every negative target is ignored, not only -100
    targets[1, 3] = -7
    return tokens, targets


def _port_model(tcfg, np_params):
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return model


def _jax_loss_and_grads(jcfg, mesh, params, tokens, targets):
    specs = jt.param_specs(jcfg)
    fn = jax.jit(jax.shard_map(
        lambda p, t, y: jax.value_and_grad(
            lambda p: jt._local_loss(jcfg, mesh, p, t, y))(p),
        mesh=mesh, in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), specs), check_vma=True,
    ))
    loss, grads = fn(params, jnp.asarray(tokens), jnp.asarray(targets))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_grads_match_byteps_tpu(variant):
    jcfg, tcfg = _configs(variant)
    mesh = _mesh()
    np_params = jt.init_params(jcfg, seed=1)
    tokens, targets = _data(jcfg)
    jparams = jt.shard_params(np_params, jcfg, mesh)

    # (microbatches, rows a microbatch, S, V): the rows in the input's order
    want_logits = np.asarray(jt.build_forward(jcfg, mesh)(jparams, jnp.asarray(tokens)))
    want_logits = want_logits.reshape(-1, *want_logits.shape[2:])
    want_loss, want_grads = _jax_loss_and_grads(jcfg, mesh, jparams, tokens, targets)

    model = _port_model(tcfg, np_params)
    tok = torch.as_tensor(tokens).long()
    logits = model(tok)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-4, atol=1e-5)
    loss = model.loss(tok, torch.as_tensor(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()}, tcfg)
    for name, g in grads.items():
        w = want_grads[name]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("variant", ["dense", "causal-flash-rope-gqa"])
def test_adamw_steps_match_build_train_step(variant):
    """Three steps through init → broadcast_parameters →
    DistributedOptimizer(AdamW) against build_train_step(optax.adamw)."""
    jcfg, tcfg = _configs(variant)
    mesh = _mesh()
    np_params = jt.init_params(jcfg, seed=2)
    tokens, targets = _data(jcfg, seed=3)

    # optax.adamw's weight decay defaults to 1e-4, torch.optim.AdamW's to
    # 1e-2: both sides are given it explicitly
    step = jt.build_train_step(jcfg, mesh, optax.adamw(LR, weight_decay=WD), donate=False)
    jparams = jt.shard_params(np_params, jcfg, mesh)
    opt_state = optax.adamw(LR, weight_decay=WD).init(jparams)
    want = []
    for _ in range(3):
        jparams, opt_state, loss = step(jparams, opt_state, jnp.asarray(tokens),
                                        jnp.asarray(targets))
        want.append(float(loss))

    bps.init(device="cpu")
    model = _port_model(tcfg, np_params)
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
        named_parameters=model.named_parameters(),
    )
    train = tt.build_train_step(model, opt)
    tok, tgt = torch.as_tensor(tokens).long(), torch.as_tensor(targets)
    got = [float(train(tok, tgt)) for _ in range(3)]

    np.testing.assert_allclose(got, want, rtol=1e-5)
    final = params_to_jax(model.state_dict(), tcfg)
    for name, arr in final.items():
        np.testing.assert_allclose(arr, np.asarray(jparams[name]), atol=0.1 * LR,
                                   err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_draws_match(variant):
    jcfg, tcfg = _configs(variant)
    want = jt.init_params(jcfg, seed=4, pp_size=2)
    got = tt.init_params(tcfg, seed=4, pp_size=2)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_trap_layernorm_uses_population_variance():
    x = np.random.default_rng(0).normal(3.0, 2.0, size=(2, 5, 8)).astype(np.float32)
    s = np.linspace(0.5, 1.5, 8).astype(np.float32)
    b = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(jt._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tt._ln(*map(torch.tensor, (x, s, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_trap_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the port's MLP must match it,
    not torch's exact (erf) default."""
    cfg = tt.tiny_test()
    layer = tt.TransformerLayer(cfg, torch.device("cpu"))
    np_params = tt.init_params(cfg, seed=5)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np_params[name][0, 0]))
    x = np.random.default_rng(1).normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    got = tt._dense_mlp(cfg, torch.tensor(x), layer).detach().numpy()
    lp = {k: jnp.asarray(np_params[k][0, 0]) for k in ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")}
    g = jt._ln(jnp.asarray(x), lp["ln2_s"], lp["ln2_b"])
    want = np.asarray(x + jax.nn.gelu(g @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = np.asarray(x + jax.nn.gelu(g @ lp["w1"] + lp["b1"], approximate=False) @ lp["w2"]
                     + lp["b2"])
    assert np.abs(got - erf).max() > 1e-5


def test_trap_every_negative_target_is_ignored():
    logits = torch.randn(2, 6, 10, generator=torch.Generator().manual_seed(0))
    targets = torch.tensor([[1, -1, 3, -5, 2, 9], [-100, 0, 4, 4, -2, 7]])
    keep = targets >= 0
    want = torch.nn.functional.cross_entropy(logits[keep], targets[keep])
    torch.testing.assert_close(tt.token_loss(logits, targets), want)
    with pytest.raises(IndexError):  # ignore_index=-100 would not ignore -1
        torch.nn.functional.cross_entropy(logits.reshape(-1, 10), targets.reshape(-1))


def test_trap_adamw_weight_decay_defaults_differ():
    """Why every comparison passes the weight decay explicitly."""
    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == 1e-4
    assert torch.optim.AdamW([torch.zeros(1)]).defaults["weight_decay"] == 1e-2


@pytest.mark.parametrize("remat", [True, False])
def test_trap_remat_recomputes_each_layer_in_backward(remat, monkeypatch):
    """Remat is torch.utils.checkpoint per layer: the backward pass runs
    each layer's body once more (module hooks do not fire on recompute, so
    the body itself is counted)."""
    cfg = tt.tiny_test(remat=remat)
    model = _port_model(cfg, tt.init_params(cfg))
    calls = []
    mlp = tt._dense_mlp
    monkeypatch.setattr(tt, "_dense_mlp", lambda *a: calls.append(1) or mlp(*a))
    tokens, targets = _data(cfg)
    model.loss(torch.as_tensor(tokens).long(), torch.as_tensor(targets)).backward()
    assert len(calls) == cfg.n_layers * (2 if remat else 1)


@pytest.mark.parametrize("kw", [dict(), dict(moe=True, n_experts=4)])
def test_trap_the_loss_runs_through_the_modules_call(kw):
    """model.loss goes through the module's __call__, as model(tokens)
    does: CrossBarrier's forward pre-hook on the model waits there for the
    embedding's and the head's pending updates before they are read."""
    cfg = tt.tiny_test(**kw)
    model = _port_model(cfg, tt.init_params(cfg))
    calls = []
    model.register_forward_pre_hook(lambda module, args: calls.append(args[0].shape))
    tokens, targets = _data(cfg)
    tok, tgt = torch.as_tensor(tokens).long(), torch.as_tensor(targets)
    loss = model.loss(tok, tgt)
    model(tok)
    assert calls == [tok.shape, tok.shape]  # once for the loss, once for the logits
    want = tt.token_loss(model(tok), tgt)
    if cfg.moe:  # plus the load-balancing terms, positive
        assert float(loss) > float(want)
    else:
        assert float(loss) == float(want)


def test_trap_bf16_casts_follow_the_jax_code():
    """The residual stream is in compute dtype after the embedding, logits
    are in compute dtype, parameters and their gradients stay f32; and the
    bf16 logits agree with byteps_tpu's bf16 logits to bf16 precision."""
    kw = dict(use_flash=True)
    jcfg = jt.tiny_test(compute_dtype=jnp.bfloat16, **kw)
    tcfg = tt.tiny_test(compute_dtype=torch.bfloat16, **kw)
    np_params = jt.init_params(jcfg, seed=6)
    tokens, targets = _data(jcfg)
    mesh = _mesh()
    want = np.asarray(
        jt.build_forward(jcfg, mesh)(jt.shard_params(np_params, jcfg, mesh),
                                     jnp.asarray(tokens))[0].astype(jnp.float32))

    model = _port_model(tcfg, np_params)
    dtypes = []
    for layer in model.layers:
        layer.register_forward_pre_hook(lambda _, args: dtypes.append(args[0].dtype))
    logits = model(torch.as_tensor(tokens).long())
    assert dtypes == [torch.bfloat16] * tcfg.n_layers
    assert logits.dtype == torch.bfloat16
    # XLA fuses elementwise chains and rounds to bf16 once per fusion, torch
    # rounds after every op; over 4 layers that is a few bf16 ulps (2^-7
    # at logits ~1-2) on average, and at most ~11
    diff = np.abs(logits.float().detach().numpy() - want)
    assert diff.max() < 0.125 and diff.mean() < 0.025, (diff.max(), diff.mean())
    model.loss(torch.as_tensor(tokens).long(), torch.as_tensor(targets)).backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_unported_features_raise(monkeypatch):
    """No plane is left unported: the van's link shaping, the last, shapes
    (tests/test_torch_port_shaping.py) where its knobs raised; the flight
    recorder's upload and slo trigger are ported
    (tests/test_torch_port_flight_rules.py), and mixture-of-experts layers,
    both generation builders and their specs build and run
    (tests/test_torch_port_moe.py, _generate.py)."""
    import socket

    from byteps_tpu_torch.comm import shaping

    assert port_config.UNPORTED == {} and port_config._UNPORTED_KNOBS == ()
    for knob in ("BYTEPS_VAN_DELAY_MS", "BYTEPS_VAN_RATE_MBYTES_S", "BYTEPS_VAN_RATE_MBPS"):
        monkeypatch.setenv(knob, "5")
        port_config.check_unported_env()
        assert shaping.shaping_enabled()
        a, b = socket.socketpair()
        shaped = shaping.maybe_shape(a)
        try:
            assert isinstance(shaped, shaping.ShapedSocket)
        finally:
            shaped.close()
            b.close()
        monkeypatch.delenv(knob)
    assert not shaping.shaping_enabled()
    cfg = tt.tiny_test(moe=True, causal=True)
    model = tt.Transformer(cfg, device="cpu")
    assert {"router", "ew1", "eb1", "ew2", "eb2"} <= set(tt.param_specs(cfg))
    model.load_state_dict(params_from_jax(tt.init_params(cfg, seed=0), cfg))
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    for build in (tt.build_generate, tt.build_generate_cached):
        assert build(model)(prompt, 2).shape == (2, 5)


def test_config_validation_matches_reference():
    for bad in (dict(n_kv_heads=3), dict(pos_emb="alibi"), dict(pos_emb="rope", d_head=5)):
        with pytest.raises(ValueError):
            jt.tiny_test(**bad)
        with pytest.raises(ValueError):
            tt.tiny_test(**bad)
    jb, tb = jt.bert_large(), tt.bert_large()
    for field in dataclasses.fields(tb):
        if field.name != "compute_dtype":
            assert getattr(tb, field.name) == getattr(jb, field.name), field.name
    assert dataclasses.asdict(tt.gpt2_medium())["vocab_size"] == jt.gpt2_medium().vocab_size
