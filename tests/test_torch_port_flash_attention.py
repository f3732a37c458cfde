"""The port's flash attention (byteps_tpu_torch.ops.flash_attention) against
byteps_tpu's on the same inputs.

On the CPU the port's wrappers take their plain versions; byteps_tpu's Pallas
kernels run in interpret mode, with small blocks as tests/test_ops.py runs
them.  Tolerance in f32: rtol 2e-4, atol 2e-5 (the two sum in other orders,
and the Pallas kernels rescale online).
"""

import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops import flash_attention as tfa

# the module, not the function byteps_tpu.ops re-exports under its name
jfa = importlib.import_module("byteps_tpu.ops.flash_attention")

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the cores to
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_launches():
    tfa.reset_launches()
    yield
    tfa.reset_launches()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    dlse = rng.normal(size=shape[:3]).astype(np.float32)
    return q, k, v, do, dlse


def _jax_value_and_grads(q, k, v, do, dlse, causal, block):
    """(O, lse) and d/d(q, k, v) of sum(O·dO) + sum(lse·dlse) in byteps_tpu."""
    kw = dict(causal=causal, block_q=block, block_k=block, interpret=True)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, **kw)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    o, lse = jfa.flash_attention_lse(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, lse, *grads)]


def _port_value_and_grads(q, k, v, do, dlse, causal, fn=None):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    if fn is None:
        o, lse = tfa.flash_attention_lse(*xs, causal=causal)
    else:
        o, lse = fn(*xs, causal, q.shape[-1] ** -0.5)
    loss = (o * torch.tensor(do)).sum() + (lse * torch.tensor(dlse)).sum()
    grads = torch.autograd.grad(loss, xs)
    return [x.detach().numpy() for x in (o, lse, *grads)]


# (S, dh, block, causal): dh 32, and dh 64 (the head dim of the bf16 Hopper
# kernels K1-K3) at one and two of K3's 64-row query tiles, and with block 64
# at one and at one and a half of K2's 128-row query tiles
_PALLAS_CASES = [
    *((128, 32, block, causal) for causal in (False, True) for block in (16, 64)),
    *((s, 64, 32, causal) for s in (64, 128) for causal in (False, True)),
    *((s, 64, 64, causal) for s in (128, 192) for causal in (False, True)),
]


@pytest.mark.parametrize(
    "s, dh, block, causal", _PALLAS_CASES,
    ids=[f"{b}-{c}" if dh == 32 else f"dh{dh}-s{s}-{b}-{c}" for s, dh, b, c in _PALLAS_CASES],
)
def test_matches_byteps_tpu_pallas_interpret(s, dh, block, causal):
    """O, lse, dQ, dK, dV — with a non-zero lse cotangent — against the
    Pallas kernels in interpret mode; the wrappers' backward on CPU tensors
    (flash_bwd_dq and flash_bwd_dkv, their plain versions) takes Δ with
    the cotangent folded in, as _flash_backward does."""
    args = _inputs((1, 2, s, dh), seed=block + causal)
    want = _jax_value_and_grads(*args, causal, block)
    got = _port_value_and_grads(*args, causal)
    for name, g, w in zip(("O", "lse", "dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_dense_reference_autograd(causal):
    """The wrappers' backward (Δ fold of the lse cotangent included) against
    autograd through the one-score-matrix dense reference."""
    args = _inputs((2, 2, 64, 16), seed=7)
    want = _port_value_and_grads(*args, causal, fn=tfa._dense_reference_lse)
    got = _port_value_and_grads(*args, causal)
    for name, g, w in zip(("O", "lse", "dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", [100, 1, 127, 129])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_sequence_matches_byteps_tpu(causal, s, dh):
    """S not a multiple of the block (1, 127, 129 sit at the edges of the
    bf16 dh=64 kernel's 128-row tiles): byteps_tpu takes its dense path; the
    port's plain version, which the card holds the kernels to, must agree
    (the kernels mask the ragged tile on the card)."""
    args = _inputs((1, 2, s, dh), seed=11)
    want = _jax_value_and_grads(*args, causal, 64)
    got = _port_value_and_grads(*args, causal)
    for name, g, w in zip(("O", "lse", "dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_dense_reference_matches_byteps_tpu():
    q, k, v, _, _ = _inputs((1, 3, 48, 8), seed=3)
    for causal in (False, True):
        o, lse = tfa._dense_reference_lse(*map(torch.tensor, (q, k, v)), causal, 0.3)
        jo, jlse = jfa._dense_reference_lse(*map(jnp.asarray, (q, k, v)), causal, 0.3)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=RTOL, atol=ATOL)


def test_flash_attention_is_first_output_of_lse_variant():
    q, k, v, do, _ = _inputs((1, 2, 32, 8), seed=5)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tfa.flash_attention(*xs, causal=True)
    gq = torch.autograd.grad((o * torch.tensor(do)).sum(), xs[0])[0]
    jo = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                             block_q=16, block_k=16, interpret=True)
    jg = jax.grad(lambda x: jnp.sum(jfa.flash_attention(
        x, jnp.asarray(k), jnp.asarray(v), causal=True, block_q=16, block_k=16,
        interpret=True) * do))(jnp.asarray(q))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gq.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


def test_neg_inf_matches_reference():
    """The mask value is -1e30, not -inf, in both packages."""
    assert tfa.NEG_INF == jfa.NEG_INF == -1e30


def test_cpu_path_launches_no_kernel():
    args = _inputs((1, 1, 32, 32), seed=1)
    _port_value_and_grads(*args, True)
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_non_cuda_device_raises_instead_of_falling_back():
    """Only CPU tensors take the plain version; any other device goes to
    the kernel path, which refuses what is not on a CUDA device."""
    q = torch.empty((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, q, q, q, None, None, False, 0.125)
    assert tfa.launches["flash_fwd"] == 0


def test_bf16_head_dim_64_refuses_non_cuda_tensors():
    """bf16 at dh = 64 (the Hopper kernels' inputs) off the CPU and off CUDA
    raises before any launch, in the forward and in both backward kernels."""
    q = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, q, q, False, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, q, q, q, lse, lse, False, 0.125)
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_misaligned_view_is_copied_for_the_kernels():
    """The kernels load 16 bytes a thread: a view that starts off that
    alignment reaches them as an aligned copy with the same values."""
    base = torch.arange(1 + 2 * 64 * 32, dtype=torch.float32)
    x = base[1:].view(1, 2, 64, 32)
    assert x.data_ptr() % 16 != 0
    y = tfa._aligned(x)
    assert y.data_ptr() % 16 == 0 and torch.equal(y, x)
    assert tfa._aligned(y) is y


def test_row_stats_are_aligned_for_the_kernels():
    """lse and Δ that start 4 bytes off a 16-byte boundary reach the kernels
    as aligned copies with the same values (the dK/dV kernel's TMA maps need
    an aligned base)."""
    q = torch.empty((1, 2, 64, 64))
    base = torch.arange(1 + 2 * 2 * 64, dtype=torch.float32)
    lse = base[1:1 + 2 * 64].view(1, 2, 64)
    delta = base[1 + 2 * 64:].view(1, 2, 64)
    assert lse.data_ptr() % 16 == 4 and delta.data_ptr() % 16 == 4
    got_lse, got_delta = tfa._row_stats(q, lse, delta)
    for got, want in ((got_lse, lse), (got_delta, delta)):
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, want)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_exports_exactly_the_three_entry_points():
    """The library's extern "C" functions are the three the wrappers bind,
    so no kernel variant ships behind an exported selector."""
    with open(os.path.join(os.path.dirname(tfa.__file__), "csrc", "flash_attention.cu")) as f:
        text = f.read()
    assert text.count('extern "C" {') == 1
    block = text[text.index('extern "C" {'):]
    names = re.findall(r"^[A-Za-z_][\w\s*]*?(\w+)\(", block, flags=re.M)
    assert sorted(names) == ["bps_flash_bwd_dkv", "bps_flash_bwd_dq", "bps_flash_fwd"]
