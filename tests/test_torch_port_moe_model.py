"""tiny_test with expert layers, trained by the port in one process,
against byteps_tpu's one-device step on the same numpy parameters and
tokens (the layer itself: tests/test_torch_port_moe.py; on meshes:
tests/test_torch_port_model_parallel_moe.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: tiny_test with expert layers: (label, config kwargs)
MODELS = [
    ("top1-microbatches-flash", dict(moe=True, n_experts=4, moe_top_k=1, microbatches=2,
                                     n_layers=2, remat=False, use_flash=True)),
    ("top2-rope-gqa-remat", dict(moe=True, causal=True, pos_emb="rope", n_kv_heads=2,
                                 n_layers=2)),
]


@pytest.mark.parametrize("label,kw", MODELS, ids=[m[0] for m in MODELS])
def test_expert_model_matches_the_reference(label, kw):
    """tiny_test with expert layers in one process against the reference's
    one-device step: logits (rtol 1e-4, atol 1e-5), the loss with its
    load-balancing term (rtol 1e-5) and every gradient within
    torch_port_mp_ref's tolerance (rtol 1e-4, atol 1e-4 times the largest
    gradient).  Not the 1e-5 of test_torch_port_transformer.py: with two
    microbatches the reference's f32 gradient of the position table is
    2.7e-4 from a float64 run of the same math (largest element 13), the
    port's 5.9e-5.  A microbatch routes alone, as the reference's."""
    from jax.sharding import PartitionSpec as P

    from byteps_tpu.models import transformer as jt
    from byteps_tpu.parallel.mesh_utils import make_training_mesh
    from byteps_tpu_torch.models import transformer as tt
    from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax

    jcfg, tcfg = jt.tiny_test(**kw), tt.tiny_test(**kw)
    mesh = make_training_mesh(1, {"dp": 1, "pp": 1, "sp": 1, "tp": 1})
    np_params = jt.init_params(jcfg, seed=1)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, jcfg.max_seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    targets[0, -1] = -1
    jparams = jt.shard_params(np_params, jcfg, mesh)
    want_logits = np.asarray(jt.build_forward(jcfg, mesh)(jparams, jnp.asarray(tokens)))
    want_logits = want_logits.reshape(-1, *want_logits.shape[2:])
    specs = jt.param_specs(jcfg)
    fn = jax.jit(jax.shard_map(
        lambda p, t, y: jax.value_and_grad(lambda q: jt._local_loss(jcfg, mesh, q, t, y))(p),
        mesh=mesh, in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), specs), check_vma=True))
    want_loss, want_grads = fn(jparams, jnp.asarray(tokens), jnp.asarray(targets))

    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg))
    tok = torch.as_tensor(tokens).long()
    np.testing.assert_allclose(model(tok).detach().numpy(), want_logits, rtol=1e-4, atol=1e-5)
    loss = model.loss(tok, torch.as_tensor(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()}, tcfg)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in want_grads.values())
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(want_grads[name]), rtol=1e-4,
                                   atol=1e-4 * gmax, err_msg=name)
