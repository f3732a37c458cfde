"""The port's ``CrossBarrierOptimizer`` (``byteps_tpu_torch.cross_barrier``)
against byteps_tpu's (``byteps_tpu/cross_barrier.py:79-150``) on the same
numpy parameters and gradients:

- the parameters after several ``backward`` / ``step`` rounds, for sgd
  (momentum, weight decay), adam and rmsprop, within 1e-6 of the
  reference's, on one worker (the PS hop the identity) and through a
  fleet of two port servers;
- the declared names, in order, and each push_pull's name and priority;
- a second ``backward`` before ``wait`` applies the first gradient and
  does not drop it;
- an unknown ``opt_name`` raises the reference's ``ValueError``."""

import numpy as np
import pytest
import torch

import byteps_tpu
import byteps_tpu_torch
import torch_port_kits as kits
from byteps_tpu.common.registry import get_registry as ref_registry
from byteps_tpu.cross_barrier import CrossBarrierOptimizer as RefCBO
from byteps_tpu_torch.common.registry import get_registry as port_registry
from byteps_tpu_torch.cross_barrier import CrossBarrierOptimizer

SHAPES = {"w": (4, 3), "b": (3,), "head": (5,)}
OPTS = [("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
        ("adam", {"lr": 0.05, "weight_decay": 0.01}),
        ("rmsprop", {"lr": 0.02, "weight_decay": 0.01})]
ROUNDS = 4


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _params():
    r = np.random.default_rng(3)
    return {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(i: int):
    r = np.random.default_rng(100 + i)
    return {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _run(cls, opt, kwargs, double: bool = False):
    """ROUNDS rounds of backward then step (with ``double``, two backward
    passes before each step); the parameters as numpy arrays."""
    cbo = cls(_params(), opt, **kwargs)
    for i in range(ROUNDS):
        cbo.backward(_grads(i))
        if double:
            cbo.backward(_grads(i + 50))
        cbo.step()
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in cbo.params.items()}


def _reference(opt, kwargs, double: bool = False):
    byteps_tpu.init()
    try:
        return _run(RefCBO, opt, kwargs, double)
    finally:
        byteps_tpu.shutdown()


@pytest.mark.parametrize("hop", ["identity", "fleet"])
@pytest.mark.parametrize("opt,kwargs", OPTS, ids=[o for o, _ in OPTS])
def test_the_parameters_are_the_reference_s(monkeypatch, hop, opt, kwargs):
    want = _reference(opt, kwargs)
    if hop == "fleet":
        with kits.fleet(monkeypatch, "port"):
            byteps_tpu_torch.init(device="cpu")
            got = _run(CrossBarrierOptimizer, opt, kwargs)
            byteps_tpu_torch.shutdown()
    else:
        byteps_tpu_torch.init(device="cpu")
        got = _run(CrossBarrierOptimizer, opt, kwargs)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert got[k].dtype == np.float32


def _declared(registry) -> list:
    """(name, declared key) of every declaration, in order."""
    return [(n, registry.get(n).declared_key) for n in registry._order]


def test_names_and_priorities_are_the_reference_s(monkeypatch):
    seen = {"port": [], "ref": []}

    def spy(pkg, real):
        def push_pull_async(tensor, name, average=True, priority=0, version=0):
            seen[pkg].append((name, priority, average))
            return real(tensor, name=name, average=average, priority=priority)
        return push_pull_async

    from byteps_tpu_torch import cross_barrier as port_cb

    byteps_tpu.init()
    monkeypatch.setattr(byteps_tpu, "push_pull_async", spy("ref", byteps_tpu.push_pull_async))
    _run(RefCBO, "sgd", {"lr": 0.1})
    ref_declared = _declared(ref_registry())
    byteps_tpu.shutdown()
    byteps_tpu_torch.init(device="cpu")
    monkeypatch.setattr(port_cb, "push_pull_async", spy("port", port_cb.push_pull_async))
    _run(CrossBarrierOptimizer, "sgd", {"lr": 0.1})
    assert seen["port"] == seen["ref"]
    assert seen["port"][:3] == [("Gradient.w", 0, True), ("Gradient.b", -1, True),
                                ("Gradient.head", -2, True)]
    assert _declared(port_registry()) == ref_declared
    assert [n for n, _ in ref_declared] == ["Gradient.w", "Gradient.b", "Gradient.head"]


def test_the_parameters_are_float32_on_the_bound_device():
    byteps_tpu_torch.init(device="cpu")
    cbo = CrossBarrierOptimizer({k: v.astype(np.float64) for k, v in _params().items()}, lr=0.1)
    for k, v in cbo.params.items():
        assert v.dtype == torch.float32 and v.device == byteps_tpu_torch.device(), k
        np.testing.assert_array_equal(v.numpy(), _params()[k])


def test_a_second_backward_before_wait_applies_the_first_gradient(monkeypatch):
    want = _reference("sgd", {"lr": 0.1, "momentum": 0.5}, double=True)
    byteps_tpu_torch.init(device="cpu")
    got = _run(CrossBarrierOptimizer, "sgd", {"lr": 0.1, "momentum": 0.5}, double=True)
    # the same updates written out: each round applies both gradients in turn
    p, m = _params(), {}
    for i in range(ROUNDS):
        for g in (_grads(i), _grads(i + 50)):
            for k in SHAPES:
                m[k] = g[k] if k not in m else 0.5 * m[k] + g[k]
                p[k] = p[k] - 0.1 * m[k]
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], p[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_an_unknown_optimizer_raises_the_reference_s_error():
    byteps_tpu.init()
    with pytest.raises(ValueError) as ref:
        RefCBO(_params(), "lamb")
    byteps_tpu.shutdown()
    byteps_tpu_torch.init(device="cpu")
    with pytest.raises(ValueError) as port:
        CrossBarrierOptimizer(_params(), "lamb")
    assert str(port.value) == str(ref.value)
