"""The port's torch plugin surface against byteps_tpu's torch plugin:
DistributedDataParallel, CrossBarrier, push_pull_inplace,
broadcast_optimizer_state and level-1 Compression.fp16 (bfloat16).

The mixed fleets run one worker of each package in threads against one
fleet of port servers: they share keys only if both packages name and
order their tensors the same way, and they pull the same averages only if
both push the same values.

Tolerances: DDP and the plugin's DistributedOptimizer run torch's own
optimizers on both sides, so their parameters are bitwise equal;
CrossBarrier's per-parameter sgd, adam and rmsprop run in torch in the
port and in numpy in the reference, float32 both, within 1e-6.
"""

import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu.torch as jtorch
import byteps_tpu_torch as pbps
from byteps_tpu.torch import cross_barrier as ref_cb_mod
from byteps_tpu.torch import parallel as ref_parallel
from byteps_tpu_torch import cross_barrier as port_cb_mod
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.parallel import distributed as port_parallel
from test_torch_port_ps import _cluster, _tiny


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_WIRE_LOSSLESS", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    # names are scoped by instance index: both packages count from 0 here
    for cls in (port_parallel.DistributedDataParallel, ref_parallel.DistributedDataParallel,
                port_cb_mod.CrossBarrier, ref_cb_mod.CrossBarrier):
        monkeypatch.setattr(cls, "_instances", 0)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


#: the two workers of a mixed fleet build their models at the same time,
#: and nn.Linear draws from torch's global generator
_INIT_LOCK = threading.Lock()


def _mlp(seed: int = 0) -> torch.nn.Module:
    with _INIT_LOCK:
        torch.manual_seed(seed)
        return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                   torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                   torch.nn.Linear(16, 4))


def _batches(worker: int) -> list:
    rng = np.random.default_rng(100 + worker)
    return [(torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32)))
            for _ in range(3)]


def _recording(monkeypatch, module, attr: str) -> list:
    """Wrap ``module.attr`` (a push_pull_async) to record (name, priority,
    a copy of the pushed values)."""
    calls, fn = [], getattr(module, attr)

    def wrapped(tensor, *args, name=None, priority=0, **kw):
        calls.append((name, priority, np.array(np.asarray(tensor), copy=True)))
        return fn(tensor, *args, name=name, priority=priority, **kw)

    monkeypatch.setattr(module, attr, wrapped)
    return calls


def _mixed_fleet(monkeypatch, port_fn, ref_fn) -> tuple:
    """A port worker and a byteps_tpu worker in threads against one fleet
    of port servers; returns their results."""
    out = [None, None]
    errors = []

    def run(i, init, fn):
        try:
            init()
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported by the test
            errors.append(e)
            raise

    with _cluster(monkeypatch, "port", workers=2):
        threads = [threading.Thread(target=run, args=(0, lambda: pbps.init(device="cpu"),
                                                      port_fn)),
                   threading.Thread(target=run, args=(1, jbps.init, ref_fn))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        pbps.shutdown()
        jbps.shutdown()
    assert not errors, errors
    return out


def _ddp_worker(ddp_cls, worker: int, bucket_bytes: int) -> list:
    model = _mlp()
    ddp = ddp_cls(model, bucket_bytes=bucket_bytes)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    for x, y in _batches(worker):
        opt.zero_grad()
        torch.nn.functional.mse_loss(ddp(x), y).backward()
        ddp.grad_sync()
        opt.step()
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("bucket_bytes", [256, 1 << 20])
def test_ddp_buckets_names_and_parameters_equal_the_reference(monkeypatch, bucket_bytes):
    port_calls = _recording(monkeypatch, port_parallel, "push_pull_async")
    ref_calls = _recording(monkeypatch, ref_parallel, "_push_pull_async")
    port, ref = _mixed_fleet(
        monkeypatch,
        lambda: _ddp_worker(port_parallel.DistributedDataParallel, 0, bucket_bytes),
        lambda: _ddp_worker(ref_parallel.DistributedDataParallel, 1, bucket_bytes))
    assert [(n, p) for n, p, _ in port_calls] == [(n, p) for n, p, _ in ref_calls]
    names = sorted({n for n, _, _ in port_calls})
    want = (["DDP.0.bucket.0", "DDP.0.bucket.1", "DDP.0.bucket.2"] if bucket_bytes == 256
            else ["DDP.0.bucket.0"])
    assert names == want
    assert ([port_registry.get_registry().get(n).declared_key for n in names]
            == list(range(len(names))))
    for a, b in zip(port, ref):
        assert torch.equal(a, b)
    # the average of the two workers' gradients, as one process computes it
    model = _mlp()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    for (x0, y0), (x1, y1) in zip(_batches(0), _batches(1)):
        opt.zero_grad()
        g0 = torch.autograd.grad(torch.nn.functional.mse_loss(model(x0), y0),
                                 list(model.parameters()))
        g1 = torch.autograd.grad(torch.nn.functional.mse_loss(model(x1), y1),
                                 list(model.parameters()))
        for p, a, b in zip(model.parameters(), g0, g1):
            p.grad = (a + b) / 2
        opt.step()
    for a, b in zip(port, model.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


def test_ddp_raises_on_a_stranded_bucket_and_no_sync_skips_communication():
    pbps.init(device="cpu")
    model = torch.nn.ModuleDict({"used": torch.nn.Linear(4, 4), "unused": torch.nn.Linear(4, 4)})

    class Wrapper(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            return self.m["used"](x)

    ddp = pbps.parallel.DistributedDataParallel(Wrapper(), bucket_bytes=1)
    with ddp.no_sync():
        ddp(torch.ones(2, 4)).sum().backward()
        ddp.grad_sync()
    ddp(torch.ones(2, 4)).sum().backward()
    with pytest.raises(RuntimeError, match="unused"):
        ddp.grad_sync()


def _cb_worker(cb_cls, worker: int, opt_name: str, kw: dict) -> list:
    model = _mlp()
    cb = cb_cls(model, opt_name=opt_name, **kw)
    for x, y in _batches(worker):
        torch.nn.functional.mse_loss(model(x), y).backward()
    cb.step()
    assert cb.outstanding() == 0
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-2}),
    ("adam", {"lr": 1e-2, "weight_decay": 1e-2}),
    ("rmsprop", {"lr": 1e-2}),
])
def test_cross_barrier_names_and_parameters_equal_the_reference(monkeypatch, opt_name, kw):
    port_calls = _recording(monkeypatch, port_cb_mod, "push_pull_async")
    ref_calls = _recording(monkeypatch, ref_cb_mod, "_push_pull_async")
    port, ref = _mixed_fleet(
        monkeypatch,
        lambda: _cb_worker(port_cb_mod.CrossBarrier, 0, opt_name, kw),
        lambda: _cb_worker(ref_cb_mod.CrossBarrier, 1, opt_name, kw))
    assert [(n, p) for n, p, _ in port_calls] == [(n, p) for n, p, _ in ref_calls]
    order = [n for n, _ in _mlp().named_parameters()]
    assert ({(n, p) for n, p, _ in port_calls}
            == {(f"CrossBarrier.0.{n}", -i) for i, n in enumerate(order)})
    assert [port_registry.get_registry().get(f"CrossBarrier.0.{n}").declared_key
            for n, _ in _mlp().named_parameters()] == list(range(6))
    for a, b in zip(port, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_cross_barrier_matches_torch_adam_on_one_worker():
    pbps.init(device="cpu")
    model, plain = _mlp(), _mlp()
    cb = pbps.CrossBarrier(model, opt_name="adam", lr=1e-2)
    opt = torch.optim.Adam(plain.parameters(), lr=1e-2)
    for x, y in _batches(0):
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.zero_grad()
        torch.nn.functional.mse_loss(plain(x), y).backward()
        opt.step()
    cb.step()
    for a, b in zip(model.parameters(), plain.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_two_backward_passes_in_a_row_push_the_second_gradient(monkeypatch):
    """The deliberate divergence from byteps_tpu: its hook applies the
    pending update (zeroing p.grad) and then pushes the zeroed gradient;
    the port pushes its snapshot of p.grad, the first gradient plus the
    second as autograd accumulated them."""
    lr = 0.1
    x, y = _batches(0)[0]
    results = {}
    for pkg, api, mod, attr in (("port", pbps, port_cb_mod, "push_pull_async"),
                                ("ref", jbps, ref_cb_mod, "_push_pull_async")):
        calls = _recording(monkeypatch, mod, attr)
        if pkg == "port":
            api.init(device="cpu")
        else:
            api.init()
        model = _mlp()
        p0 = [p.detach().clone() for p in model.parameters()]
        g = torch.autograd.grad(torch.nn.functional.mse_loss(model(x), y),
                                list(model.parameters()))
        cb = mod.CrossBarrier(model, opt_name="sgd", lr=lr)
        losses = [torch.nn.functional.mse_loss(model(x), y) for _ in range(2)]
        losses[0].backward()
        losses[1].backward()
        cb.step()
        api.shutdown()
        results[pkg] = (calls, p0, g, [p.detach().clone() for p in model.parameters()])
    calls, p0, g, final = results["port"]
    n = len(p0)
    index = {f"CrossBarrier.0.{name}": i for i, (name, _) in enumerate(_mlp().named_parameters())}
    assert len(calls) == 2 * n
    for name, _, pushed in calls[n:]:
        grad = g[index[name]].numpy()
        assert np.abs(pushed).max() > 0
        np.testing.assert_allclose(pushed.reshape(grad.shape), 2 * grad, rtol=1e-6, atol=1e-7)
    for a, b, gi in zip(final, p0, g):
        torch.testing.assert_close(a, b - lr * gi - lr * 2 * gi, rtol=0, atol=1e-6)
    # the reference pushed zeros the second time, and applied one gradient
    calls, p0, g, final = results["ref"]
    assert all(not np.any(c[2]) for c in calls[n:])
    for a, b, gi in zip(final, p0, g):
        torch.testing.assert_close(a, b - lr * gi, rtol=0, atol=1e-6)


# --- push_pull_inplace, broadcast_optimizer_state, Compression.fp16 -----------


def _train_tiny(api, worker: int, compression) -> tuple:
    """Three AdamW steps of tiny_test on the worker's own tokens: the
    model, its optimizer and the losses."""
    cfg, sd, _, _ = _tiny()
    rng = np.random.default_rng(7 + worker)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, cfg.max_seq)))
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    opt = api.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                     weight_decay=1e-4),
                                   named_parameters=model.named_parameters(),
                                   compression=compression)
    step = tt.build_train_step(model, opt)
    losses = [float(step(tok, torch.roll(tok, -1, 1))) for _ in range(3)]
    return model, opt, losses


def _plugin_worker(api, worker: int) -> dict:
    """Three AdamW steps, the optimizer state perturbed by the worker's
    index and then broadcast from rank 0, and a push_pull_inplace of a
    worker-specific tensor."""
    model, opt, losses = _train_tiny(api, worker, api.Compression.none)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for st in opt.state.values():
            st["exp_avg"].add_(worker + 1)
    before = {k: v["exp_avg"].clone() for k, v in opt.state_dict()["state"].items()}
    api.broadcast_optimizer_state(opt, root_rank=0)
    after = {k: v["exp_avg"].clone() for k, v in opt.state_dict()["state"].items()}
    t = torch.full((5,), float(worker + 1))
    if api is pbps:
        pbps.push_pull_inplace(t, name="inplace")
    else:
        jtorch.push_pull_inplace(t, name="inplace")
    rank = pbps.rank() if api is pbps else jbps.api.rank()
    return {"rank": rank, "losses": losses, "params": params, "before": before,
            "after": after, "inplace": t}


def test_inplace_and_optimizer_state_broadcast_interoperate_with_the_reference(monkeypatch):
    # byteps_tpu's rank() reads DMLC_WORKER_ID, which two workers in one
    # process share: give it the scheduler's rank, as the port's has
    monkeypatch.setattr(jbps.api, "rank", lambda: jbps.core.state.get_state().ps_client.rank)
    port, ref = _mixed_fleet(monkeypatch, lambda: _plugin_worker(pbps, 0),
                             lambda: _plugin_worker(jtorch, 1))
    assert sorted([port["rank"], ref["rank"]]) == [0, 1]
    assert port["losses"] != ref["losses"]  # each worker trained on its own tokens
    for n, p in port["params"].items():
        assert torch.equal(p, ref["params"][n]), n
    root = port if port["rank"] == 0 else ref
    for w in (port, ref):
        for k, v in w["after"].items():
            assert torch.equal(v, root["before"][k])
        assert torch.equal(w["inplace"], torch.full((5,), 1.5))


def test_bf16_wire_equals_the_reference_plugin(monkeypatch):
    """Compression.fp16 (a bfloat16 cast) over three AdamW steps: the port
    through a fleet of its servers, the reference plugin with one worker
    (its host lane cannot frame a bfloat16 numpy array: ROADMAP.md
    Queue 3)."""
    jbps.init()
    ref, _, ref_losses = _train_tiny(jtorch, 0, jtorch.Compression.fp16)
    jbps.shutdown()
    pbps.init(device="cpu")
    f32, _, _ = _train_tiny(pbps, 0, pbps.Compression.none)
    pbps.shutdown()
    with _cluster(monkeypatch, "port"):
        pbps.init(device="cpu")
        port, _, port_losses = _train_tiny(pbps, 0, pbps.Compression.fp16)
        pbps.shutdown()
    assert port_losses == ref_losses
    for (n, a), b in zip(port.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), n
    # the cast took effect: float32 on the wire trains otherwise
    assert any(not torch.equal(a, b) for a, b in zip(port.parameters(), f32.parameters()))
