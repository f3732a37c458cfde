"""``byteps_tpu_torch.dryrun`` against the repository's
``__graft_entry__``: ``dryrun_multichip(4)`` on a gloo group of four CPU
processes, held to the reference's ``_dryrun_one_mesh`` on the same two
meshes of forced CPU devices ({dp:2, pp:2} and {dp:2, sp:2}): the same
meshes and summary lines, each mesh's train-step loss within rtol 1e-5
(torch_port_mp_ref's), and the KV-cached decode's tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_port_ranks as ranks
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import factorize_mesh, make_training_mesh
from byteps_tpu_torch import dryrun


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    procs = ranks.spawn_group("dryrun", 4, out)
    refs = [_reference(sizes) for sizes in dryrun.mesh_configs(4)]
    return ranks.collect(procs, "dryrun", 4, out), refs


def _reference(sizes):
    """``__graft_entry__._dryrun_one_mesh``'s run, its loss unrounded and
    its tokens kept."""
    n = int(np.prod(list(sizes.values())))
    mesh = make_training_mesh(n, sizes)
    dp, pp, sp = mesh.shape["dp"], mesh.shape["pp"], mesh.shape["sp"]
    cfg = jt.TransformerConfig(
        vocab_size=128, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        n_layers=2 * pp, max_seq=8 * max(sp, 1), causal=True, moe=True,
        n_experts=2 * max(sp, 1), compute_dtype=jnp.float32, microbatches=2 * pp)
    params = jt.shard_params(jt.init_params(cfg, seed=0, pp_size=pp), cfg, mesh)
    tx = optax.adamw(1e-3)
    opt_state = jax.jit(tx.init)(params)
    step = jt.build_train_step(cfg, mesh, tx, donate=False)
    batch = 2 * dp * cfg.microbatches
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(batch, cfg.max_seq))
                         .astype(np.int32))
    targets = jnp.asarray(np.roll(np.asarray(tokens), -1, axis=1))
    params, opt_state, loss = step(params, opt_state, tokens, targets)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2 * dp, 3)).astype(np.int32))
    toks = np.asarray(jt.build_generate_cached(cfg, mesh)(params, prompt, n_new=4))
    line = (f"mesh={dict(mesh.shape)} layers={cfg.n_layers} experts={cfg.n_experts} "
            f"seq={cfg.max_seq} microbatches={cfg.microbatches} loss={float(loss):.4f} "
            f"decode_rows={toks.shape[0]}")
    return {"loss": float(loss), "tokens": toks, "line": line}


def test_the_meshes_are_the_references():
    """The reference's two priority orders on 4 and 8 devices."""
    for n, want in ((4, [{"dp": 2, "pp": 2, "sp": 1, "tp": 1},
                         {"dp": 2, "pp": 1, "sp": 2, "tp": 1}]),
                    (8, [{"dp": 2, "pp": 2, "sp": 1, "tp": 2},
                         {"dp": 2, "pp": 1, "sp": 2, "tp": 2}])):
        assert dryrun.mesh_configs(n) == want
        for sizes, order in zip(want, (("dp", "pp", "tp", "sp"), ("dp", "sp", "tp", "pp"))):
            got = factorize_mesh(n, want=order)
            assert {ax: got.get(ax, 1) for ax in sizes} == sizes


def test_every_rank_prints_the_references_lines(runs):
    got, refs = runs
    for res in got:
        assert res["lines"] == [r["line"] for r in refs]


@pytest.mark.parametrize("mesh", [0, 1])
def test_losses_and_tokens_match_the_reference(runs, mesh):
    got, refs = runs
    for res in got:
        run, ref = res["runs"][mesh], refs[mesh]
        np.testing.assert_allclose(run["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_array_equal(run["tokens"], ref["tokens"])

