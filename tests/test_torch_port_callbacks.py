"""The port's training-loop callbacks (``byteps_tpu_torch/callbacks.py``)
against byteps_tpu's (``tests/test_callbacks.py``):

- the learning-rate schedules and the warmup: every rate over fractional
  and whole epochs bitwise the reference's, the window's edges included,
  with one worker and with a job of four (the warmup starts at lr/size);
  ``apply`` writes it into a torch optimizer's param groups;
- ``momentum_correction`` raises as in the reference;
- ``MetricAverageCallback`` on a fleet of two workers, a port worker and a
  byteps_tpu worker: both get the mean of their metrics (float64 pushes
  under ``Metric.<name>``), equal to the reference's own;
- ``BroadcastGlobalVariablesCallback`` with one worker returns what it
  was given and fires once.

Every listener is bound to port 0."""

import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
import torch_port_kits as kits
from byteps_tpu import callbacks as ref_cb
from byteps_tpu_torch import callbacks as port_cb

EPOCHS = [0, 0.25, 0.5, 1, 1.5, 2, 2.999, 3, 3.5, 4, 5, 7.25, 10, 12]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


@pytest.mark.parametrize("kw", [
    {"multiplier": 0.5, "start_epoch": 2, "end_epoch": 5},
    {"multiplier": lambda e: 0.1 ** (e // 3), "staircase": True},
    {"multiplier": lambda e: 1.0 / (1.0 + e), "staircase": False, "start_epoch": 1},
    {"multiplier": lambda e: 2.0 ** -e, "start_epoch": 3, "end_epoch": 10},
])
def test_the_schedule_s_rates_are_the_reference_s(kw):
    port = port_cb.LearningRateScheduleCallback(0.4, **kw)
    ref = ref_cb.LearningRateScheduleCallback(0.4, **kw)
    assert [port.lr(e) for e in EPOCHS] == [ref.lr(e) for e in EPOCHS]
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    for e in EPOCHS:
        before = opt.param_groups[0]["lr"]
        set_to = port.apply(opt, e)
        assert set_to == ref.lr(e)
        assert opt.param_groups[0]["lr"] == (before if set_to is None else set_to)


@pytest.mark.parametrize("workers", ["1", "4"])
@pytest.mark.parametrize("warmup", [0, 1, 3, 5])
def test_the_warmup_s_rates_are_the_reference_s(workers, warmup, monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", workers)
    port = port_cb.LearningRateWarmupCallback(0.8, warmup_epochs=warmup)
    ref = ref_cb.LearningRateWarmupCallback(0.8, warmup_epochs=warmup)
    assert [port.lr(e) for e in EPOCHS] == [ref.lr(e) for e in EPOCHS]
    if warmup and workers == "4":
        assert port.lr(0) == pytest.approx(0.8 * (0.25 + 0.75 / warmup))


def test_momentum_correction_raises_as_in_the_reference():
    for cb in (port_cb, ref_cb):
        with pytest.raises(NotImplementedError, match="momentum_correction"):
            cb.LearningRateWarmupCallback(0.1, momentum_correction=True)


def test_broadcast_with_one_worker_returns_its_input_once():
    pbps.init(device="cpu")
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    cb = port_cb.BroadcastGlobalVariablesCallback()
    sd = model.state_dict()
    assert cb.on_train_begin(sd, opt) == (sd, opt)
    assert cb._done and cb.on_train_begin(sd, opt) == (sd, opt)
    pbps.shutdown()


def test_metrics_average_over_a_two_worker_fleet(monkeypatch):
    metrics = [{"loss": 0.75, "acc": 0.5, "tiny": 1e-300}, {"loss": 0.25, "acc": 1.0,
                                                            "tiny": 3e-300}]
    out, errors = [None, None], []

    def run(i, init, fn):
        try:
            init()
            out[i] = fn(metrics[i])
        except BaseException as e:  # noqa: BLE001 - reported by the test
            errors.append(e)
            raise

    with kits.fleet(monkeypatch, "port", workers=2, servers=1):
        threads = [threading.Thread(target=run, args=(0, lambda: pbps.init(device="cpu"),
                                                      port_cb.MetricAverageCallback().on_epoch_end)),
                   threading.Thread(target=run, args=(1, jbps.init,
                                                      ref_cb.MetricAverageCallback().on_epoch_end))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        pbps.shutdown()
        jbps.shutdown()
    assert not errors, errors
    port, ref = out
    assert port == ref
    want = {k: (np.float64(metrics[0][k]) + np.float64(metrics[1][k])) / 2 for k in metrics[0]}
    assert port == want
