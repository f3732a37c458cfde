"""The port's generation builders in one process against byteps_tpu's on a
1-device mesh, on the same numpy parameters and prompts:
``build_generate`` (recompute on the max_seq window) and
``build_generate_cached`` (KV cache), greedy tokens exactly equal, with
learned positions and rope, multi-head and grouped-query attention, dense
and expert layers; the cache's kv-head shape; the reference's argument
errors; and sampling: deterministic for a seed, inside top_k,
temperature 0 is greedy, and a draw per row, dp shard and step from a
torch.Generator (ROADMAP Queue 3, the fifteenth divergence: not JAX's
threefry draws).
"""

import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.comm.mesh import Mesh
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax

PROMPT = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [3, 1, 2]], np.int32)
N_NEW = 5

#: (label, config kwargs): causal tiny_test variants
CONFIGS = [
    ("learned-mha", dict()),
    ("rope-gqa", dict(pos_emb="rope", n_kv_heads=2)),
    ("bias-gqa-flash", dict(attn_bias=True, n_kv_heads=2, use_flash=True)),
    ("moe-top2", dict(moe=True, n_experts=4)),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return make_training_mesh(1, {"dp": 1, "pp": 1, "sp": 1, "tp": 1})


def _model(kw, seed=3):
    cfg = tt.tiny_test(causal=True, **kw)
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tt.init_params(cfg, seed=seed), cfg))
    return model


@pytest.mark.parametrize("label,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_greedy_tokens_are_the_reference(label, kw):
    jcfg = jt.tiny_test(causal=True, **kw)
    mesh = _mesh()
    params = jt.shard_params(jt.init_params(jcfg, seed=3), jcfg, mesh)
    want_cached = np.asarray(jt.build_generate_cached(jcfg, mesh)(params, PROMPT, n_new=N_NEW))
    want = np.asarray(jt.build_generate(jcfg, mesh)(params, PROMPT, N_NEW))
    model = _model(kw)
    cached = tt.build_generate_cached(model)
    got_cached = cached(PROMPT, N_NEW)
    got = tt.build_generate(model)(PROMPT, N_NEW)
    np.testing.assert_array_equal(got_cached, want_cached)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :3], PROMPT)
    # the cache holds kv heads only: (rows, n_kv_heads, max_seq, d_head) a layer
    cfg = model.cfg
    assert cached.cache_shapes == [(4, cfg.kv_heads, cfg.max_seq, cfg.d_head)] * cfg.n_layers
    assert int(np.prod(cached.cache_shapes[0])) * cfg.n_heads // cfg.kv_heads == \
        4 * cfg.n_heads * cfg.max_seq * cfg.d_head


def test_generation_raises_the_reference_errors():
    with pytest.raises(ValueError, match="generation requires a causal config"):
        tt.build_generate(tt.Transformer(tt.tiny_test(), device="cpu"))
    with pytest.raises(ValueError, match="generation requires a causal config"):
        tt.build_generate_cached(tt.Transformer(tt.tiny_test(), device="cpu"))
    model = _model({})
    for build in (tt.build_generate, tt.build_generate_cached):
        with pytest.raises(ValueError, match=r"3\+14 exceeds max_seq 16"):
            build(model)(PROMPT, 14)
    with pytest.raises(ValueError, match="top_k=65 exceeds vocab_size 64"):
        tt.build_generate_cached(model)(PROMPT, 2, temperature=1.0, top_k=65)
    # a dp axis of 2 (no group is needed to refuse 3 rows)
    on_dp = tt.Transformer(tt.tiny_test(causal=True), device="cpu",
                           mesh=Mesh(0, 2, torch.device("cpu"), "gloo"))
    for build in (tt.build_generate, tt.build_generate_cached):
        with pytest.raises(ValueError, match="batch 3 not divisible by dp=2"):
            build(on_dp)(PROMPT[:3], 2)


def test_sampling_is_deterministic_for_a_seed_and_greedy_at_temperature_0():
    gen = tt.build_generate_cached(_model({}))
    greedy = gen(PROMPT, 8)
    np.testing.assert_array_equal(gen(PROMPT, 8, temperature=0.0, top_k=5, seed=9), greedy)
    a = gen(PROMPT, 8, temperature=1.5, seed=11)
    np.testing.assert_array_equal(gen(PROMPT, 8, temperature=1.5, seed=11), a)
    assert not np.array_equal(gen(PROMPT, 8, temperature=1.5, seed=12), a)
    assert not np.array_equal(a, greedy)
    # top_k=1 leaves one candidate: greedy
    np.testing.assert_array_equal(gen(PROMPT, 8, temperature=1.5, top_k=1, seed=11), greedy)


def test_sampled_tokens_lie_in_the_top_k():
    model = _model({})
    out = tt.build_generate_cached(model)(PROMPT, 8, temperature=2.0, top_k=3, seed=4)
    with torch.no_grad():
        logits = model(torch.as_tensor(out[:, :-1]).long())  # causal: every prefix at once
    top = torch.topk(logits[:, 2:], 3, dim=-1).indices.numpy()  # the steps' logits
    new = out[:, 3:]
    assert all(new[b, j] in top[b, j] for b in range(4) for j in range(8))


def test_a_draw_per_row_shard_and_step():
    """The fifteenth divergence, pinned: the first sampled token of each
    row is the Gumbel-max draw of a torch.Generator seeded with
    ``_sample_seed(seed, dp shard, step)``, so identical prompts in one
    shard draw independently, and the same rows on another dp shard draw
    from another stream."""
    model = _model({})
    same = np.repeat(PROMPT[:1], 4, axis=0)
    out = tt.build_generate_cached(model)(same, 1, temperature=3.0, seed=5)
    assert len(set(out[:, 3].tolist())) > 1
    with torch.no_grad():
        logits = model(torch.as_tensor(same).long())[:, -1].float() / torch.tensor(3.0)
    gen = torch.Generator().manual_seed(tt._sample_seed(5, 0, 0))
    u = torch.rand(logits.shape, generator=gen)
    want = (logits - torch.log(-torch.log(u))).argmax(-1).numpy()
    np.testing.assert_array_equal(out[:, 3], want)
    seeds = {tt._sample_seed(5, shard, step) for shard in range(4) for step in range(8)}
    assert len(seeds) == 32
    # threefry's draws are another stream: the reference samples other tokens
    jcfg = jt.tiny_test(causal=True)
    mesh = _mesh()
    params = jt.shard_params(jt.init_params(jcfg, seed=3), jcfg, mesh)
    ref = np.asarray(jt.build_generate_cached(jcfg, mesh)(params, same, 1, temperature=3.0,
                                                         seed=5))
    assert ref.shape == out.shape and not np.array_equal(ref, out)


def test_prefill_capacity_factor_bounds_the_prefill_as_the_reference():
    """A finite prefill_capacity_factor routes the prompt at training
    capacity (drops allowed), as the reference's: the tokens stay its."""
    kw = dict(moe=True, n_experts=4, prefill_capacity_factor=0.5, causal=True)
    jcfg = jt.tiny_test(**kw)
    mesh = _mesh()
    params = jt.shard_params(jt.init_params(jcfg, seed=3), jcfg, mesh)
    want = np.asarray(jt.build_generate_cached(jcfg, mesh)(params, PROMPT, n_new=N_NEW))
    cfg = tt.tiny_test(**kw)
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tt.init_params(cfg, seed=3), cfg))
    np.testing.assert_array_equal(tt.build_generate_cached(model)(PROMPT, N_NEW), want)
