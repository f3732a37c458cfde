"""The port's mixture-of-experts layer (byteps_tpu_torch.parallel.moe)
against byteps_tpu's at one rank (no expert axis), on the same numpy
inputs: the routing, the output, and the gradients of x and of all five
parameters (router, w1, b1, w2, b2) for the loss sum(y * w).

Tolerances: outputs and gradients in f32 within rtol 1e-5 and atol 1e-6
(the same products and sums, in other orders); the routing (each token's
experts, queue slots and drops) exactly equal to the reference's
formulation on the same gates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.parallel import moe as jmoe
from byteps_tpu_torch.parallel import moe as pmoe

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(t, d, f, e, seed, router_bias=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    if router_bias is not None:  # the reference's capacity test: one expert wins
        x, router = np.abs(x), np.zeros((d, e), np.float32)
        router[:, router_bias] = 10.0
    w1 = (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(e, f)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32)
    b2 = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    w = rng.normal(size=(t, d)).astype(np.float32)
    return [x, router, w1, b1, w2, b2], w


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _ref_grad(args, w, cf, k, dtype):
    def loss(*a):
        y = jmoe.moe_mlp(*(v.astype(dtype) for v in a), axis_name=None, axis_size=1,
                         capacity_factor=cf, top_k=k)
        return jnp.sum(y.astype(jnp.float32) * w), y

    return jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)


def _reference(args, w, cf, k, dtype=jnp.float32):
    (_, y), grads = _ref_grad(tuple(jnp.asarray(a) for a in args), jnp.asarray(w), cf, k, dtype)
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g) for g in grads]


def _port(args, w, cf, k, dtype=torch.float32):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = pmoe.moe_mlp(*(t.to(dtype) for t in ts), axis_name=None, axis_size=1,
                     capacity_factor=cf, top_k=k)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return y.float().detach().numpy(), [t.grad.numpy() for t in ts]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _ref_dispatch(gates, k, capacity):
    """The reference's (T, E, C) dispatch mask for these gates, its own
    formulation (byteps_tpu/parallel/moe.py:64-96)."""
    t, e = gates.shape
    masks, remaining = [], gates
    for _ in range(k):
        oh = jax.nn.one_hot(jnp.argmax(remaining, axis=-1), e, dtype=jnp.float32)
        masks.append(oh)
        remaining = remaining * (1.0 - oh.astype(remaining.dtype))
    dispatch = jnp.zeros((t, e, capacity), jnp.float32)
    prev = jnp.zeros((e,), jnp.float32)
    for oh in masks:
        pos = (jnp.cumsum(oh, axis=0) - 1.0) * oh + prev[None, :] * oh
        keep = (pos < capacity) * oh
        pos_oh = jax.nn.one_hot(jnp.sum(pos, axis=-1).astype(jnp.int32), capacity,
                                dtype=jnp.float32)
        dispatch = dispatch + keep[:, :, None] * pos_oh[:, None, :]
        prev = prev + jnp.sum(oh, axis=0)
    return dispatch


def _port_dispatch(gates, k, capacity):
    t, e = gates.shape
    experts, slots, _, keeps = pmoe.route(gates, k, capacity)
    dispatch = np.zeros((t, e, capacity), np.float32)
    for idx, slot, keep in zip(experts, slots, keeps):
        for tok in np.nonzero(keep.numpy())[0]:
            dispatch[tok, int(idx[tok]), int(slot[tok])] += 1.0
    return dispatch


# (label, (t, d, f, e), capacity factor, router bias)
CASES = [
    ("random", (24, 6, 12, 4), 2.0, None),
    ("tight", (24, 6, 12, 4), 0.75, None),  # capacity 4 or 9 of 24: drops
    ("overflow", (16, 4, 8, 4), 0.5, 0),  # reference test: one expert wins every token
]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("label,dims,cf,bias", CASES, ids=[c[0] for c in CASES])
def test_moe_matches_the_reference(label, dims, cf, bias, k):
    args, w = _inputs(*dims, seed=5, router_bias=bias)
    want_y, want_g = _reference(args, w, cf, k)
    got_y, got_g = _port(args, w, cf, k)
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
    for name, g, want in zip(("x", "router", "w1", "b1", "w2", "b2"), got_g, want_g):
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("label,dims,cf,bias", CASES, ids=[c[0] for c in CASES])
def test_routing_is_the_reference(label, dims, cf, bias, k):
    """Which experts each token takes, its queue slot in each, and which
    assignments overflow: equal to the reference's dispatch mask."""
    args, _ = _inputs(*dims, seed=5, router_bias=bias)
    t, _, _, e = dims
    gates = jax.nn.softmax(jnp.asarray(args[0]) @ jnp.asarray(args[1]), axis=-1)
    capacity = pmoe.capacity_of(cf, k, t, e)
    assert capacity == max(1, min(int(cf * k * t / e), t))
    want = np.asarray(_ref_dispatch(gates, k, capacity))
    got = _port_dispatch(torch.tensor(np.asarray(gates)), k, capacity)
    np.testing.assert_array_equal(got, want)
    with pmoe.count_drops() as drops:
        pmoe.moe_mlp(*(torch.from_numpy(a) for a in args), axis_name=None, axis_size=1,
                     capacity_factor=cf, top_k=k)
    assert [int(d) for d in drops] == [int(k * t - want.sum())]
    if label == "overflow":  # every token picks expert 0 first; its queue holds 4
        assert int(drops[0]) > 0 and want[:, 0].sum() == capacity


def test_full_capacity_top2_is_the_gate_mixture():
    """E=2, top-2, no-drop capacity: every token visits both experts, and
    the output is the softmax-gated mixture of the two expert MLPs (the
    reference's test), and the reference's output."""
    args, w = _inputs(10, 6, 12, 2, seed=7)
    x, router, w1, b1, w2, b2 = args
    got_y, got_g = _port(args, w, 2.0, 2)
    want_y, want_g = _reference(args, w, 2.0, 2)
    gates = torch.softmax(torch.from_numpy(x @ router), -1).numpy()
    mix = np.zeros_like(x)
    for e in range(2):
        h = torch.nn.functional.gelu(torch.from_numpy(x @ w1[e] + b1[e]), approximate="tanh")
        mix += gates[:, e:e + 1] * (h.numpy() @ w2[e] + b2[e])
    np.testing.assert_allclose(got_y, mix, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
    for g, want in zip(got_g, want_g):
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)


def test_bf16_positions_are_exact_past_256():
    """320 tokens on 2 experts in bf16: the queue positions stay exact
    past 256 (float32 bookkeeping), so the bf16 output is the f32 one
    within bf16 arithmetic (the reference's tolerance), the routing of the
    bf16 gates is the reference's, and no token is dropped."""
    args, w = _inputs(320, 4, 8, 2, seed=3)
    args[3][:] = 0.0
    args[5][:] = 0.0
    y32, _ = _port(args, w, 2.0, 2)
    y16, _ = _port(args, w, 2.0, 2, dtype=torch.bfloat16)
    np.testing.assert_allclose(y16, y32, rtol=0.15, atol=0.05)
    ref16, _ = _reference(args, w, 2.0, 2, dtype=jnp.bfloat16)
    np.testing.assert_allclose(y16, ref16, rtol=0.15, atol=0.05)
    gates = torch.softmax(torch.from_numpy(args[0]).bfloat16() @
                          torch.from_numpy(args[1]).bfloat16(), -1)
    capacity = pmoe.capacity_of(2.0, 2, 320, 2)
    assert capacity == 320
    got = _port_dispatch(gates, 2, capacity)
    want = np.asarray(_ref_dispatch(jnp.asarray(gates.float().numpy()).astype(jnp.bfloat16), 2,
                                    capacity))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2 * 320 and got.max(axis=0).max() == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_aux_loss_matches_the_reference(seed):
    args, _ = _inputs(24, 6, 12, 4, seed=seed)
    x, router = args[0], args[1]
    want, want_g = jax.value_and_grad(
        lambda a, b: jmoe.moe_aux_loss(a, b, 2, 2), argnums=(0, 1))(jnp.asarray(x),
                                                                   jnp.asarray(router))
    xt, rt = torch.tensor(x, requires_grad=True), torch.tensor(router, requires_grad=True)
    got = pmoe.moe_aux_loss(xt, rt, 2, 2)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_g[1]), rtol=RTOL, atol=ATOL)

