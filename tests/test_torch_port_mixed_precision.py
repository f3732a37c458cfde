"""The port's mixed precision (``byteps_tpu_torch/mixed_precision.py``,
wrappers around a torch optimizer) against byteps_tpu's optax
transformations (``tests/test_optim.py``'s mixed-precision cases), run op
by op on the same gradient sequence, with an inf and a nan in it:

- ``dynamic_loss_scale(master_weights(SGD with momentum))`` on bf16
  parameters: the scale and its count after every step, and the bf16
  parameters, bitwise.  SGD's rate is a power of two, so ``lr·g`` is exact
  and torch's fused ``p + (-lr)·g`` rounds as optax's two steps do;
- the same around AdamW (torch's and optax's Adam round differently in
  f32): the scale and count bitwise, the masters within 1e-6 (each step
  moves them by ~lr = 1e-2, a few f32 ulps of it apart), the
  bf16 parameters within one bf16 ulp;
- ``dynamic_loss_scale`` around a plain f32 SGD: bitwise;
- a skipped step moves no parameter and leaves the inner optimizer's state
  as it was (Adam's ``step`` count too), and the scale never drops under 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu import mixed_precision as ref_mp
from byteps_tpu_torch import mixed_precision as port_mp

SHAPES = [(6, 5), (5,), (3, 2, 2)]
STEPS = 10
#: the steps whose gradient overflows: an inf at 3, a nan at 6
BAD = {3: np.inf, 6: np.nan}
INIT_SCALE, GROWTH = 16.0, 3


def _params() -> list:
    rng = np.random.default_rng(1)
    return [(rng.integers(-64, 64, s) / 32).astype(jnp.bfloat16) for s in SHAPES]


def _grads(step: int, scale: float) -> list:
    """Scaled gradients in bf16: small dyadic values times the scale (a
    power of two, so scaling and unscaling are exact)."""
    rng = np.random.default_rng(100 + step)
    gs = [(rng.integers(-32, 32, s) / 64 * scale).astype(jnp.bfloat16) for s in SHAPES]
    if step in BAD:
        gs[1][2] = BAD[step]
    return gs


def _ref_run(inner: optax.GradientTransformation) -> tuple:
    tx = ref_mp.dynamic_loss_scale(ref_mp.master_weights(inner), init_scale=INIT_SCALE,
                                   growth_interval=GROWTH)
    params = [jnp.asarray(p) for p in _params()]
    state = tx.init(params)
    trail = []
    with jax.disable_jit():
        for step in range(STEPS):
            grads = [jnp.asarray(g) for g in _grads(step, float(state.scale))]
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            trail.append((float(state.scale), int(state.good_steps),
                          [np.asarray(p.astype(jnp.float32)) for p in params],
                          [np.asarray(m) for m in state.inner.masters]))
    return trail


def _port_run(make_inner) -> tuple:
    params = [torch.nn.Parameter(torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16))
              for p in _params()]
    opt = port_mp.dynamic_loss_scale(port_mp.master_weights(params, make_inner),
                                     init_scale=INIT_SCALE, growth_interval=GROWTH)
    trail = []
    for step in range(STEPS):
        for p, g in zip(params, _grads(step, opt.scale)):
            p.grad = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
        before = [p.detach().clone() for p in params]
        state = {k: v.clone() if torch.is_tensor(v) else v
                 for s in opt.inner.inner.state.values() for k, v in s.items()}
        stepped = opt.step()
        assert stepped == (step not in BAD)
        if not stepped:  # nothing moved, the inner optimizer untouched
            assert all(torch.equal(a, b) for a, b in zip(before, params))
            after = {k: v for s in opt.inner.inner.state.values() for k, v in s.items()}
            assert state.keys() == after.keys()
            assert all(torch.equal(torch.as_tensor(state[k]), torch.as_tensor(after[k]))
                       for k in state)
        opt.zero_grad()
        trail.append((opt.scale, opt.good_steps,
                      [p.detach().float().numpy() for p in params],
                      [m.detach().numpy().copy() for m in opt.inner.masters]))
    return trail


def test_loss_scale_and_master_weights_over_sgd_are_bitwise():
    ref = _ref_run(optax.sgd(2.0 ** -4, momentum=0.9))
    port = _port_run(lambda ms: torch.optim.SGD(ms, lr=2.0 ** -4, momentum=0.9))
    scales = [r[0] for r in ref]
    assert scales == [p[0] for p in port] and [r[1] for r in ref] == [p[1] for p in port]
    # the trail has grown the scale and halved it
    assert max(scales) > INIT_SCALE and min(scales) < max(scales)
    for (_, _, rp, rm), (_, _, pp, pm) in zip(ref, port):
        for a, b in zip(rp + rm, pp + pm):
            np.testing.assert_array_equal(a, b)


def test_loss_scale_and_master_weights_over_adamw():
    ref = _ref_run(optax.adamw(1e-2, weight_decay=1e-4))
    port = _port_run(lambda ms: torch.optim.AdamW(ms, lr=1e-2, weight_decay=1e-4))
    assert [r[:2] for r in ref] == [p[:2] for p in port]
    for (_, _, rp, rm), (_, _, pp, pm) in zip(ref, port):
        for a, b in zip(rm, pm):
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-6)
        for a, b in zip(rp, pp):  # within one bf16 ulp of the reference
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=0)


def test_loss_scale_around_a_plain_f32_optimizer_is_bitwise():
    rng = np.random.default_rng(5)
    w0 = (rng.integers(-64, 64, (7, 3)) / 32).astype(np.float32)
    tx = ref_mp.dynamic_loss_scale(optax.sgd(2.0 ** -3), init_scale=4.0, growth_interval=2)
    state, params = tx.init(jnp.asarray(w0)), jnp.asarray(w0)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = port_mp.dynamic_loss_scale(torch.optim.SGD([p], lr=2.0 ** -3), init_scale=4.0,
                                     growth_interval=2)
    with jax.disable_jit():
        for step in range(7):
            g = (rng.integers(-16, 16, (7, 3)) / 16 * opt.scale).astype(np.float32)
            if step == 4:
                g[0, 0] = -np.inf
            updates, state = tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, updates)
            p.grad = torch.from_numpy(g)
            opt.step()
            assert (float(state.scale), int(state.good_steps)) == (opt.scale, opt.good_steps)
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(params))


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_the_scale_halves_on_overflow_down_to_one(bad):
    p = torch.nn.Parameter(torch.zeros(3))
    opt = port_mp.dynamic_loss_scale(torch.optim.SGD([p], lr=0.1), init_scale=4.0)
    tx = ref_mp.dynamic_loss_scale(optax.sgd(0.1), init_scale=4.0)
    state = tx.init(jnp.zeros(3))
    for _ in range(4):
        p.grad = torch.tensor([1.0, bad, 0.0])
        assert not opt.step()
        _, state = tx.update(jnp.asarray([1.0, bad, 0.0]), state, jnp.zeros(3))
        assert opt.scale == float(state.scale)
    assert opt.scale == 1.0 and opt.skipped == 4 and torch.equal(p.detach(), torch.zeros(3))
