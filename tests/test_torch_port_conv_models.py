"""The port's conv models (``byteps_tpu_torch/models/{resnet,vgg}.py``) and
their carry-over (``models/convert.py``) against byteps_tpu's flax models, on the same numpy inputs:

- flax's SAME padding, pad for pad (``lax.padtype_to_pads``);
- ``ResNetTiny`` and ``VGGTiny`` through the weight carry-over, f32, in
  train mode: logits, loss and every gradient within 2e-5, the updated
  running statistics within 1e-6, the running variance the biased one
  (``torch.nn.BatchNorm2d``'s unbiased update is pinned to differ); in
  eval mode the running statistics normalize; in bf16 the logits within
  bf16's tolerance (5e-2);
- the published models (ResNet-18/50/101, VGG-11/16) have the
  reference's names and shapes, and a name missing or extra raises.

The batch-statistics step is held to the reference's in
``tests/test_torch_port_conv_step.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

import torch_port_kits as kits
import torch_port_ranks as ranks
from byteps_tpu.models import resnet as jr
from byteps_tpu.models import vgg as jv
from byteps_tpu_torch.models import resnet as tr
from byteps_tpu_torch.models import vgg as tv
from byteps_tpu_torch.models.convert import conv_params_from_jax, conv_params_to_jax

TINY = {"resnet": (jr.ResNetTiny, tr.ResNetTiny), "vgg": (jv.VGGTiny, lambda **kw: tv.VGGTiny(
    image=ranks.BN_IMAGE, **kw))}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _ref_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def _inputs(seed: int = 0, batch: int = 4):
    r = np.random.default_rng(seed)
    x = r.normal(size=(batch, ranks.BN_IMAGE, ranks.BN_IMAGE, 3)).astype(np.float32)
    return x, r.integers(0, 10, batch)


def _ref_variables(kind: str, x):
    """The reference's initial variables (they depend on the input's shape
    alone), made once a kind: flax's init is slow op by op, so it is jitted."""
    key = (kind, x.shape[1:])
    if key not in _VARIABLES:
        init = jax.jit(lambda k, a: TINY[kind][0]().init(k, a, train=True))
        _VARIABLES[key] = init(jax.random.PRNGKey(0), x[:1])
    return _VARIABLES[key]


_VARIABLES: dict = {}


def _close_trees(got, want, atol, rtol=0.0):
    gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("n, k, s", [(224, 7, 2), (112, 3, 2), (56, 3, 2), (56, 1, 2),
                                     (56, 3, 1), (7, 3, 2), (15, 2, 2), (9, 7, 3), (1, 3, 2)])
def test_same_padding_is_flax_s(n, k, s):
    assert tr.same_pads(n, k, s) == tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("kind", sorted(TINY))
def test_a_tiny_model_s_logits_loss_and_gradients_carry_over(kind):
    x, y = _inputs()
    variables = _ref_variables(kind, x)
    model = TINY[kind][1]()
    model.load_state_dict(conv_params_from_jax(variables, model))

    def loss_fn(params):
        out, mutated = TINY[kind][0]().apply({**variables, "params": params}, x, train=True,
                                             mutable=["batch_stats"])
        return _ref_loss(out, y), (out, mutated)

    (ref_loss, (ref_logits, mutated)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model.train()
    logits = model(x)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=2e-5)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got = conv_params_to_jax({**model.state_dict(), **grads}, model)
    _close_trees(got["params"], ref_grads, atol=2e-5)
    if kind == "resnet":
        _close_trees(got["batch_stats"], mutated["batch_stats"], atol=1e-6)


def test_the_running_variance_is_updated_with_the_biased_variance():
    """flax updates ``var`` with the biased batch variance; torch's own
    BatchNorm2d would use the unbiased one, which is off by n/(n-1)."""
    x, _ = _inputs(batch=2)
    variables = _ref_variables("resnet", x)
    _, mutated = jr.ResNetTiny().apply(variables, x, train=True, mutable=["batch_stats"])
    model = tr.ResNetTiny()
    model.load_state_dict(conv_params_from_jax(variables, model))
    model.train()
    model(x)
    want = np.asarray(mutated["batch_stats"]["bn_init"]["var"])
    np.testing.assert_allclose(model.bn_init.var.numpy(), want, rtol=1e-6, atol=1e-7)
    bn = torch.nn.BatchNorm2d(8, momentum=0.1, eps=1e-5)
    h = model.conv_init(tr.to_nchw(x))
    bn.train()
    bn(h)
    # n = 2·8·8 values a channel: the unbiased update is off by 0.1·var/127
    assert np.abs(bn.running_var.detach().numpy() - want).min() > 3e-4


def test_eval_mode_normalizes_with_the_running_statistics():
    x, y = _inputs(seed=2)
    variables = _ref_variables("resnet", x)
    _, mutated = jr.ResNetTiny().apply(variables, x, train=True, mutable=["batch_stats"])
    variables = {**variables, **mutated}
    model = tr.ResNetTiny()
    model.load_state_dict(conv_params_from_jax(variables, model))
    model.eval()
    with torch.no_grad():
        got = model(x[:2]).numpy()
    want = np.asarray(jr.ResNetTiny().apply(variables, x[:2], train=False))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("kind", sorted(TINY))
def test_bf16_compute_follows_dtype_and_the_head_is_f32(kind):
    x, _ = _inputs(seed=3)
    variables = _ref_variables(kind, x)
    want = TINY[kind][0](dtype=jnp.bfloat16).apply(variables, x, train=True,
                                                   mutable=["batch_stats"])[0]
    model = TINY[kind][1](dtype=torch.bfloat16)
    model.load_state_dict(conv_params_from_jax(variables, model))
    model.train()
    got = model(x)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50", "ResNet101", "VGG16", "VGG11"])
def test_a_published_model_has_the_reference_s_names_and_shapes(name):
    ref = (getattr(jr, name) if name.startswith("Res") else getattr(jv, name))()
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                             train=True))
    with torch.device("meta"):
        model = (getattr(tr, name) if name.startswith("Res") else getattr(tv, name))(seed=None)
    want = {}
    for path, leaf in (jax.tree_util.tree_leaves_with_path(shapes["params"])
                       + jax.tree_util.tree_leaves_with_path(shapes.get("batch_stats", {}))):
        keys = [p.key for p in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            keys[-1], shape = "weight", (shape[::-1] if len(shape) == 2 else
                                         (shape[3], shape[2], shape[0], shape[1]))
        want[".".join(keys)] = tuple(shape)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_a_missing_or_extra_name_raises():
    x, _ = _inputs()
    variables = jax.tree_util.tree_map(np.asarray, _ref_variables("resnet", x))
    model = tr.ResNetTiny()
    del variables["params"]["Dense_0"]["bias"]
    with pytest.raises(ValueError, match="missing .*Dense_0.bias"):
        conv_params_from_jax(variables, model)
    sd = model.state_dict()
    with pytest.raises(ValueError, match="unexpected .*extra"):
        conv_params_to_jax({**sd, "extra": torch.zeros(1)}, model)
