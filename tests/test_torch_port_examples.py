"""The port's one-process examples (``byteps_tpu_torch/examples/``) against
the JAX package's (``examples/``), each run in this process as
``__main__`` with the same arguments, the reference's on conftest's CPU
mesh and the port's with ``--device cpu``:

- ``mnist_push_pull``: the data and the first loss within 1e-6, then the
  printed losses line by line within rtol 1e-5 (and one unit of the
  print's last digit);
- ``cross_barrier_torch``: the printed losses within 1e-6 (the reference's
  model is torch too), 0 handles outstanding;
- ``elastic_benchmark``: the printed lines, the keys declared in each
  generation and every push_pull's output, exact;
- an example started without a card and without ``--device cpu`` raises
  through ``init()``."""

import importlib
import sys

import numpy as np
import pytest
import torch

import byteps_tpu
import byteps_tpu_torch
import torch_port_kits as kits


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def test_mnist_is_the_reference_s(monkeypatch):
    import jax.numpy as jnp

    from byteps_tpu_torch.examples import mnist_push_pull as port

    monkeypatch.syspath_prepend(kits.REPO)
    import examples.mnist_push_pull as ref

    x, y = port.synthetic_mnist()
    rx, ry = ref.synthetic_mnist()
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    model = port.MLP("cpu")
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in model.named_parameters()}
    np.testing.assert_allclose(float(port.loss_fn(model, (x, y)).detach()),
                               float(ref.loss_fn(params, (rx, ry))), rtol=1e-6)
    argv = ["--steps", "5"]
    want = kits.run_example("ref", "mnist_push_pull", argv, monkeypatch)
    got = kits.run_example("port", "mnist_push_pull", argv, monkeypatch)
    assert want[0].startswith("rank 0/1 devices=") and got[0] == "rank 0/1 devices=1"
    kits.assert_lines_close(got[1:], want[1:], rtol=1e-5)
    assert [ln.split()[1] for ln in got[1:]] == ["0", "4"]


def test_cross_barrier_is_the_reference_s(monkeypatch):
    argv = ["--steps", "12", "--width", "32", "--depth", "3", "--batch", "16", "--opt", "adam"]
    want = kits.run_example("ref", "cross_barrier_torch", argv, monkeypatch)
    got = kits.run_example("port", "cross_barrier_torch", argv, monkeypatch)
    kits.assert_lines_close(got[:-1], want[:-1], rtol=1e-6)
    assert len(got) == 4  # steps 0, 10 and 11, then the barrier's line
    for lines in (got, want):
        assert lines[-1].endswith("ms/step, 0 handles outstanding (must be 0)")


def test_elastic_keys_and_outputs_are_the_reference_s(monkeypatch):
    seen = {"port": {"keys": [], "outs": []}, "ref": {"keys": [], "outs": []}}

    def spies(pkg, api):
        declare, push_pull = api.declare_tensor, api.push_pull

        def declare_tensor(name, **kw):
            key = declare(name, **kw)
            seen[pkg]["keys"].append((name, key))
            return key

        def spy_push_pull(x, name, **kw):
            out = push_pull(x, name=name, **kw)
            seen[pkg]["outs"].append((name, np.asarray(out).copy()))
            return out

        monkeypatch.setattr(api, "declare_tensor", declare_tensor)
        monkeypatch.setattr(api, "push_pull", spy_push_pull)

    spies("ref", byteps_tpu)
    want = kits.run_example("ref", "elastic_benchmark", [], monkeypatch)
    spies("port", byteps_tpu_torch)
    got = kits.run_example("port", "elastic_benchmark", [], monkeypatch)
    assert got == want
    assert want[-1] == "gen 1: keys stable, traffic OK"
    assert seen["port"]["keys"] == seen["ref"]["keys"] and len(seen["ref"]["keys"]) == 16
    assert [n for n, _ in seen["port"]["outs"]] == [n for n, _ in seen["ref"]["outs"]]
    for (n, a), (_, b) in zip(seen["port"]["outs"], seen["ref"]["outs"]):
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("name", ["mnist_push_pull", "benchmark_ddp", "long_context_ring"])
def test_without_a_card_an_example_raises(monkeypatch, name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: init() binds it")
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"byteps_tpu_torch.examples.{name}").main()
