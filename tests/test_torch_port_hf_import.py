"""The port's GPT-2 checkpoint import (``byteps_tpu_torch.models.hf_import``)
against byteps_tpu's and against HuggingFace's model itself, on a randomly
initialised ``GPT2LMHeadModel`` (the reference's tests/test_hf_import.py
config: no network):

- the config's fields and every array bitwise the reference importer's, at
  pp_size 1 and 2; both refuse pp_size 3;
- the port's model on the CPU in f32, loaded through ``params_from_jax``:
  logits within rtol 2e-4 and atol 2e-4 (the reference test's tolerance)
  of HF's and of the reference's ``build_forward``;
- ``build_generate`` and ``build_generate_cached``: exactly the greedy
  tokens of ``model.generate``, in one process and on a {pp:2, tp:2} gloo
  group of four CPU processes (the import at pp_size=2 through a
  duck-typed model, the shards cut by ``shard_params_from_jax``);
- a duck-typed model (a namespace ``config``, a ``state_dict()``) imports
  to the HF model's arrays, and the module imports without
  ``transformers``.
"""

import dataclasses
import importlib
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from byteps_tpu.models import hf_import as ref_hf
from byteps_tpu.models.transformer import build_forward, shard_params
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch import models
from byteps_tpu_torch.models import hf_import
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax

# the GPT-2 classes would import TensorFlow too where it is installed (~8 s
# here); only transformers reads this
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

#: the config fields the importer reads, and the two it holds the model to
CONFIG_FIELDS = ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "n_inner",
                 "layer_norm_epsilon", "activation_function")
PROMPT = np.array([[5, 17, 42, 7], [9, 3, 88, 21]], np.int64)


@pytest.fixture(scope="module")
def gpt2_small(tmp_path_factory):
    """The reference test's GPT-2; its checkpoint saved for the mesh's
    ranks, which start here and come up while the one-process tests run."""
    config = transformers.GPT2Config(
        vocab_size=96, n_positions=32, n_embd=48, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(config).eval()
    out = str(tmp_path_factory.mktemp("hf_generate"))
    with open(os.path.join(out, ranks.HF_CKPT), "wb") as f:
        pickle.dump(_checkpoint(model), f)
    procs = ranks.spawn_group("hf_generate", 4, out)
    yield model, procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _checkpoint(model) -> dict:
    return {"config": {k: getattr(model.config, k) for k in CONFIG_FIELDS},
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def _hf_greedy(model, prompt, n_new):
    with torch.no_grad():
        return model.generate(torch.from_numpy(prompt), max_new_tokens=n_new, do_sample=False,
                              pad_token_id=0).numpy()


def _port_model(model):
    cfg, params = hf_import.load_gpt2_weights(model)
    m = tt.Transformer(cfg, device="cpu")
    m.load_state_dict(params_from_jax(params, cfg))
    return m


@pytest.mark.parametrize("pp", [1, 2])
def test_arrays_and_config_are_the_references(gpt2_small, pp):
    cfg, got = hf_import.load_gpt2_weights(gpt2_small[0], pp_size=pp)
    rcfg, want = ref_hf.load_gpt2_weights(gpt2_small[0], pp_size=pp)
    fields = {f.name for f in dataclasses.fields(cfg)} - {"compute_dtype"}
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(rcfg, f) for f in fields}
    assert cfg.compute_dtype == torch.float32 and rcfg.compute_dtype == jnp.float32
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
    assert got["wq"].shape[:2] == (pp, 2 // pp)


def test_a_pp_size_that_does_not_divide_the_layers_raises(gpt2_small):
    for load in (hf_import.load_gpt2_weights, ref_hf.load_gpt2_weights):
        with pytest.raises(ValueError, match="not divisible by pp 3"):
            load(gpt2_small[0], pp_size=3)


def test_logits_match_hf_and_the_reference(gpt2_small):
    model = gpt2_small[0]
    tokens = np.random.default_rng(0).integers(0, 96, size=(2, 32))
    with torch.no_grad():
        ours = _port_model(model)(torch.from_numpy(tokens)).numpy()
        theirs = model(torch.from_numpy(tokens)).logits.numpy()
    rcfg, rparams = ref_hf.load_gpt2_weights(model)
    mesh = make_training_mesh(1, {"dp": 1, "pp": 1, "sp": 1, "tp": 1})
    ref = np.asarray(build_forward(rcfg, mesh)(shard_params(rparams, rcfg, mesh),
                                               jnp.asarray(tokens, jnp.int32)))[0]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("builder", ["build_generate", "build_generate_cached"])
def test_greedy_tokens_match_hf(gpt2_small, builder):
    m = _port_model(gpt2_small[0])
    got = getattr(tt, builder)(m)(PROMPT, 8)
    np.testing.assert_array_equal(got, _hf_greedy(gpt2_small[0], PROMPT, 8))


def test_a_duck_typed_model_imports_as_the_hf_model(gpt2_small):
    """The card's path: no ``transformers`` behind the object."""
    cfg, want = hf_import.load_gpt2_weights(gpt2_small[0])
    duck = ranks.hf_duck(**_checkpoint(gpt2_small[0]))
    assert not isinstance(duck, torch.nn.Module)
    got_cfg, got = hf_import.load_gpt2_weights(duck)
    assert got_cfg == cfg and list(got) == list(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


def test_the_module_imports_without_transformers(monkeypatch):
    name = "byteps_tpu_torch.models.hf_import"
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(models, "hf_import", hf_import)  # put back after the re-import
    with pytest.raises(ImportError):
        import transformers as _  # noqa: F401  (None in sys.modules blocks it)
    mod = importlib.import_module(name)
    assert mod is not hf_import and callable(mod.load_gpt2_weights)


@pytest.mark.parametrize("field,value,message", [
    ("layer_norm_epsilon", 1e-6, "the model computes 1e-05 and 'gelu_new'"),
    ("activation_function", "relu", "the model computes 1e-05 and 'gelu_new'"),
    ("scale_attn_weights", False,
     "scale_attn_weights=False: the model computes scale_attn_weights=True"),
    ("scale_attn_by_inverse_layer_idx", True, "scale_attn_by_inverse_layer_idx=True: the "
     "model computes scale_attn_by_inverse_layer_idx=False")])
def test_a_config_the_model_does_not_compute_is_refused(gpt2_small, field, value, message):
    ckpt = _checkpoint(gpt2_small[0])
    ckpt["config"][field] = value
    with pytest.raises(ValueError, match=message):
        hf_import.load_gpt2_weights(ranks.hf_duck(**ckpt))


def test_cached_greedy_on_pp2_tp2_matches_hf(gpt2_small):
    model, procs, out = gpt2_small
    want = _hf_greedy(model, ranks.HF_PROMPT, ranks.HF_NEW)
    for res in ranks.collect(procs, "hf_generate", 4, out):
        np.testing.assert_array_equal(res["cached"], want, err_msg=str(res["coords"]))
