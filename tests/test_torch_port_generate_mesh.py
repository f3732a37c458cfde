"""The port's generation on meshes, on gloo groups of CPU processes:
KV-cached decoding on {pp:2} (stages in turns), {sp:2} with expert
layers (the dispatch over sp on replicated tokens) and {dp:2, tp:2} with
GQA and microbatches (the reference's tests/test_transformer.py:186, :306,
:630), each rank's tokens exactly equal to one process's and to the
reference's on one device and on the same mesh of forced CPU devices; the
recompute builder's tokens equal to the reference's on the same mesh
(expert layers route at training capacity there, per the local tokens);
the caches hold each rank's tp-local kv heads and its stage's layers; and
sampled rows drawn per dp shard: deterministic for a seed, and four copies
of one prompt give four rows.
"""

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax

CASES = {label: (axes, kw) for label, axes, kw in ranks.MP_GENERATE}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_gen"))
    procs = {n: ranks.spawn_group("mp_generate", n, out, host=h)
             for h, n in enumerate((2, 4))}
    refs = {label: _reference(label) for label in CASES}
    got = {n: ranks.collect(p, "mp_generate", n, out, host=h)
           for h, (n, p) in enumerate(procs.items())}
    return {label: (got[int(np.prod(list(CASES[label][0].values())))], refs[label])
            for label in CASES}


def _mesh(axes):
    sizes = {ax: axes.get(ax, 1) for ax in ("dp", "pp", "sp", "tp")}
    return make_training_mesh(int(np.prod(list(sizes.values()))), sizes), sizes["pp"]


def _reference(label):
    axes, kw = CASES[label]
    cfg = jt.tiny_test(causal=True, **kw)
    one, _ = _mesh({})
    mesh, pp = _mesh(axes)
    p1 = jt.shard_params(jt.init_params(cfg, seed=ranks.GEN_SEED), cfg, one)
    pn = jt.shard_params(jt.init_params(cfg, seed=ranks.GEN_SEED, pp_size=pp), cfg, mesh)
    tcfg = tt.tiny_test(causal=True, **kw)
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tt.init_params(tcfg, seed=ranks.GEN_SEED), tcfg))
    with torch.no_grad():
        torch.set_num_threads(1)
        port_one = tt.build_generate_cached(model)(ranks.GEN_PROMPT, ranks.GEN_NEW)
    return {
        "one": np.asarray(jt.build_generate_cached(cfg, one)(p1, ranks.GEN_PROMPT,
                                                             n_new=ranks.GEN_NEW)),
        "mesh": np.asarray(jt.build_generate_cached(cfg, mesh)(pn, ranks.GEN_PROMPT,
                                                               n_new=ranks.GEN_NEW)),
        "recompute": np.asarray(jt.build_generate(cfg, mesh)(pn, ranks.GEN_PROMPT,
                                                             ranks.GEN_NEW)),
        "port_one": port_one,
    }


@pytest.mark.parametrize("label", list(CASES))
def test_cached_tokens_equal_one_process_and_the_reference(runs, label):
    got, ref = runs[label]
    np.testing.assert_array_equal(ref["mesh"], ref["one"])
    np.testing.assert_array_equal(ref["port_one"], ref["one"])
    for res in got:
        np.testing.assert_array_equal(res[label]["cached"], ref["one"],
                                      err_msg=str(res[label]["coords"]))


@pytest.mark.parametrize("label", list(CASES))
def test_recompute_tokens_equal_the_reference_on_the_mesh(runs, label):
    got, ref = runs[label]
    for res in got:
        np.testing.assert_array_equal(res[label]["recompute"], ref["recompute"],
                                      err_msg=str(res[label]["coords"]))


@pytest.mark.parametrize("label", list(CASES))
def test_caches_hold_the_ranks_kv_heads_and_layers(runs, label):
    axes, kw = CASES[label]
    cfg = tt.tiny_test(causal=True, **kw)
    rows = 4 // axes.get("dp", 1)
    kv = cfg.kv_heads // axes.get("tp", 1)
    want = [(rows, kv, cfg.max_seq, cfg.d_head)] * (cfg.n_layers // axes.get("pp", 1))
    for res in runs[label][0]:
        assert res[label]["cache_shapes"] == want


@pytest.mark.parametrize("label", list(CASES))
def test_sampled_rows_are_drawn_per_shard(runs, label):
    got, _ = runs[label]
    first = got[0][label]["sampled"][0]
    for res in got:
        a, b = res[label]["sampled"]
        np.testing.assert_array_equal(a, b)  # deterministic for a seed
        np.testing.assert_array_equal(a, first)  # every rank returns every row
    np.testing.assert_array_equal(first[:, :3], np.repeat(ranks.GEN_PROMPT[:1], 4, axis=0))
    assert len({tuple(r) for r in first[:, 3:].tolist()}) == 4
