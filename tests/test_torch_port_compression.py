"""The port's compression chains (byteps_tpu_torch.compression, the device
adapters of core.device_codec, the lr plumbing of engine, client and
server) against byteps_tpu's on the same numpy inputs.

- Host topk, randomk and dithering payloads equal the reference's numpy
  paths byte for byte (the native library switched off), ties at the k-th
  magnitude included.
- Error-feedback and Nesterov chains over five rounds: payloads and
  residuals bitwise for topk, randomk and dithering; for onebit the sign
  words bitwise, the scale within 1 ULP and the residual within 1e-6 abs
  (the port sums the scale in float64, the reference's numpy path in
  float32).
- The device adapters' plain versions: topk bitwise
  ``byteps_tpu.ops.codecs_device``'s, ties included; dithering decodes
  bit for bit as the host codec, and its rounding is unbiased within the
  bound of tests/test_ops.py:273.
- Mixed fleets, {port, byteps_tpu} worker x {port, byteps_tpu} server:
  pulls bitwise for topk, randomk and dithering; onebit + EF + Nesterov
  bitwise in round 1 and within rtol 1e-6 after it, the servers'
  residuals within 1e-6 abs; the lr frame reaches every server chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.compression import impl as ref_impl
from byteps_tpu.compression import registry as ref_registry
from byteps_tpu.compression.impl import DitheringCompressor as RefDithering
from byteps_tpu.ops import codecs_device as ref_cd
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.compression import registry
from byteps_tpu_torch.compression.error_feedback import VanillaErrorFeedback
from byteps_tpu_torch.compression.momentum import NesterovMomentum
from byteps_tpu_torch.core import device_codec
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.ops import codecs_device as cd
from test_torch_port_ps import _cluster, _tiny


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_WIRE_LOSSLESS", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


@pytest.fixture
def ref_numpy(monkeypatch):
    """byteps_tpu's codecs on their numpy paths."""
    monkeypatch.setattr(ref_impl, "get_lib", lambda: None)


def _kw(ctype, **extra):
    return {"byteps_compressor_type": ctype, **{f"byteps_{k}": str(v) for k, v in extra.items()}}


def _chains(kwargs, n, server=False):
    return (registry.create_compressor(kwargs, n, server=server),
            ref_registry.create_compressor(kwargs, n, server=server))


NS = (1, 31, 1000, 65537)


# --- host codecs ------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", ["7", "0.05"])
@pytest.mark.parametrize("ctype", ["topk", "randomk"])
def test_host_sparse_payloads_equal_the_reference_numpy_path(ref_numpy, ctype, k, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    port, ref = _chains(_kw(ctype, compressor_k=k, seed=11), n)
    payload = port.compress(x)
    assert payload == ref.compress(x)
    assert len(payload) == port.wire_nbytes() == ref.wire_nbytes()
    np.testing.assert_array_equal(port.decompress(payload, n), ref.decompress(payload, n))
    acc, ref_acc = np.ones(n, np.float32), np.ones(n, np.float32)
    port.sum_into(payload, acc)
    ref.sum_into(payload, ref_acc)
    np.testing.assert_array_equal(acc, ref_acc)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("natural,l2,levels", [
    (False, False, 4), (False, True, 3), (True, False, 4), (True, True, 3),
])
def test_host_dithering_payloads_equal_the_reference_numpy_path(ref_numpy, natural, l2,
                                                                  levels, n):
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    x[:: 7] = 0.0
    port, ref = _chains(_kw("dithering", compressor_k=levels, seed=5,
                            dithering_partition=int(natural),
                            dithering_normalize=int(l2)), n)
    payload = port.compress(x)
    assert payload == ref.compress(x)
    assert len(payload) == port.wire_nbytes() == 4 + n
    np.testing.assert_array_equal(port.decompress(payload, n), ref.decompress(payload, n))


def _tied(n: int, seed: int) -> np.ndarray:
    """Magnitudes from a few values, so many tie at the k-th place; +-0.0
    among them."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([-3.0, -2.0, -1.0, -0.0, 0.0, 1.0, 2.0, 3.0], size=n)
         * 0.25).astype(np.float32)
    return x


@pytest.mark.parametrize("n,k", [(1000, 100), (4096, 1500), (65537, 20000)])
def test_topk_ties_select_the_lower_index_on_every_path(ref_numpy, n, k):
    """Host codec, the device adapter's plain version and byteps_tpu's
    numpy codec and lax.top_k packer: one payload."""
    x = _tied(n, seed=k)
    port, ref = _chains(_kw("topk", compressor_k=k), n)
    want = port.compress(x)
    assert ref.compress(x) == want
    idx, vals = ref_cd.topk_compress_device(jnp.asarray(x), k)
    assert ref_cd.topk_payload(idx, vals) == want
    assert cd.topk_payload_device(torch.from_numpy(x), k).numpy().tobytes() == want
    dec = cd.topk_decompress_device(torch.from_numpy(np.frombuffer(want, np.uint8).copy()), n)
    np.testing.assert_array_equal(dec.numpy(), port.decompress(want, n))


# --- chains -----------------------------------------------------------------


def _assert_onebit_close(got: bytes, want: bytes) -> None:
    assert got[4:] == want[4:]  # sign words
    a, b = np.frombuffer(got[:4], np.float32)[0], np.frombuffer(want[:4], np.float32)[0]
    assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 1, (a, b)


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("ctype,extra", [
    ("onebit", {"compressor_onebit_scaling": "True"}),
    ("topk", {"compressor_k": "0.01"}),
    ("randomk", {"compressor_k": "0.01", "seed": 3}),
    ("dithering", {"compressor_k": 4, "seed": 9, "dithering_partition": 1}),
])
def test_error_feedback_chains_equal_the_reference_over_five_rounds(ctype, extra, momentum):
    n = 20000
    kw = _kw(ctype, ef_type="vanilla", **extra)
    if momentum:
        kw.update(_kw(ctype, momentum_type="nesterov", momentum_mu="0.8"))
    port, ref = _chains(kw, n)
    assert isinstance(port, NesterovMomentum) == momentum
    ef, ref_ef = (port.inner, ref.inner) if momentum else (port, ref)
    registry.apply_lr_to_chain(port, 0.5)
    ref_ef.set_lr(0.5)
    assert ef.lr == 0.5
    rng = np.random.default_rng(21)
    for _ in range(5):
        x = rng.standard_normal(n).astype(np.float32)
        got, want = port.compress(x), ref.compress(x)
        if ctype == "onebit":
            _assert_onebit_close(got, want)
            np.testing.assert_allclose(ef.error, ref_ef.error, rtol=0, atol=1e-6)
        else:
            assert got == want
            np.testing.assert_array_equal(ef.error, ref_ef.error)
        if momentum:
            np.testing.assert_array_equal(port.m, ref.m)


def test_a_server_chain_skips_momentum_and_unknown_configs_raise():
    kw = _kw("topk", ef_type="vanilla", momentum_type="nesterov")
    assert isinstance(registry.create_compressor(kw, 100, server=True), VanillaErrorFeedback)
    for bad in (_kw("sparse"), _kw("topk", ef_type="corrected"),
                _kw("topk", momentum_type="heavyball")):
        with pytest.raises(ValueError, match="unknown"):
            pbps.declare_tensor("t", **bad)


# --- device adapters (plain versions on CPU tensors) --------------------------


def test_device_codec_eligibility_equals_the_reference():
    from byteps_tpu.core.device_codec import device_codec_for as ref_for

    for kw in (_kw("onebit"), _kw("topk", compressor_k="0.1"), _kw("randomk"),
               _kw("dithering"), _kw("topk", ef_type="vanilla"),
               _kw("onebit", momentum_type="nesterov")):
        port, ref = device_codec.device_codec_for(kw, 1000), ref_for(kw, 1000)
        assert type(port).__name__ == type(ref).__name__, kw
        if port is not None:
            assert port.wire_nbytes() == ref.wire_nbytes()


@pytest.mark.parametrize("natural", [False, True])
def test_device_dithering_decodes_exactly_as_the_host_codec(natural):
    n, s = 1024, 3
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n).astype(np.float32))
    dc = device_codec.device_codec_for(
        _kw("dithering", compressor_k=s, dithering_partition=int(natural)), n)
    payload = dc.compress(x)
    assert payload.size == dc.wire_nbytes() == 4 + n
    host = RefDithering(n, k=s, partition="natural" if natural else "linear")
    dec = dc.decompress(payload.tobytes(), n, torch.device("cpu"))
    np.testing.assert_array_equal(dec.numpy(), host.decompress(payload.tobytes(), n))
    # a fresh stream every round
    assert dc.compress(x).tobytes() != payload.tobytes()


@pytest.mark.parametrize("l2", [False, True])
def test_device_dithering_is_unbiased_and_on_the_grid(l2):
    """The statistics of tests/test_ops.py:273: the mean of 200 decoded
    draws within 6 standard errors of the input."""
    n, s, trials = 512, 4, 200
    grad = np.random.default_rng(3).normal(size=n).astype(np.float32)
    acc = np.zeros(n, np.float64)
    for t in range(trials):
        g = torch.Generator().manual_seed(t)
        payload = cd.dithering_payload_device(torch.from_numpy(grad), g, s=s, l2=l2)
        lv = payload[4:].view(torch.int8).numpy()
        assert np.all(np.abs(lv.astype(np.int32)) <= s)
        acc += cd.dithering_decompress_device(payload, n, s=s).numpy()
    norm = float(np.sqrt((grad.astype(np.float64) ** 2).sum()) if l2 else np.abs(grad).max())
    se = norm / s / np.sqrt(trials)
    np.testing.assert_allclose(acc / trials, grad, atol=6 * se)


# --- mixed fleets ---------------------------------------------------------------

#: name -> declare kwargs; "tk" goes through each package's device lane
#: (torch tensor, jax array), the others through the host lane (numpy)
FLEET_CODECS = {
    "tk": _kw("topk", compressor_k="0.01"),
    "rk": _kw("randomk", compressor_k="0.02", seed=7),
    "dt": _kw("dithering", compressor_k=4, seed=3, dithering_partition=1,
              dithering_normalize=1),
    "ob": _kw("onebit", compressor_onebit_scaling="True", ef_type="vanilla",
              momentum_type="nesterov"),
}
FLEET_N = 40000  # three partitions of 16384 elements: over both servers
LR = 0.25


def _fleet_rounds() -> list:
    rng = np.random.default_rng(17)
    return [{name: rng.standard_normal(FLEET_N).astype(np.float32) for name in FLEET_CODECS}
            for _ in range(3)]


def _server_ef_state(nodes) -> dict:
    """key -> (lr, residual) of every error-feedback chain on the servers."""
    out = {}
    for node in nodes:
        for key, ks in node._keys.items():
            c = ks.compressor
            if c is not None and hasattr(c, "set_lr"):
                out[key] = (c.lr, None if c.error is None else c.error.copy())
    return out


def _run_fleet(monkeypatch, worker: str, server: str) -> tuple:
    rounds, pulls = _fleet_rounds(), []
    with _cluster(monkeypatch, server) as nodes:
        if worker == "port":
            api = pbps
            api.init(device="cpu")
        else:
            api = jbps
            api.init()
        api.set_compression_lr(LR)
        for name, kw in FLEET_CODECS.items():
            api.declare_tensor(name, **kw)
        for tensors in rounds:
            for name, x in tensors.items():
                src = x.copy()
                if name == "tk":
                    src = torch.from_numpy(src) if worker == "port" else jnp.asarray(src)
                pulls.append((name, np.asarray(api.push_pull(src, name=name)).tobytes()))
        state = _server_ef_state(nodes)
        api.shutdown()
    return pulls, state


def test_mixed_fleets_pull_the_same_and_servers_keep_the_same_residuals(monkeypatch):
    runs = {(w, s): _run_fleet(monkeypatch, w, s)
            for w in ("port", "ref") for s in ("port", "ref")}
    base_pulls, base_state = runs[("port", "port")]
    assert {lr for lr, _ in base_state.values()} == {LR}
    for (w, s), (pulls, state) in runs.items():
        for i, ((name, got), (_, want)) in enumerate(zip(pulls, base_pulls)):
            if name != "ob" or i < len(FLEET_CODECS):
                assert got == want, (w, s, name, i)
            else:
                np.testing.assert_allclose(np.frombuffer(got, np.float32),
                                           np.frombuffer(want, np.float32), rtol=1e-6)
        # the lr frame reached every chain of both packages' servers, and
        # the residuals agree
        assert state.keys() == base_state.keys()
        for key, (lr, err) in state.items():
            assert lr == LR, (w, s, key)
            np.testing.assert_allclose(err, base_state[key][1], rtol=0, atol=1e-6)


def test_the_lr_reaches_chains_made_before_and_after_it(monkeypatch):
    with _cluster(monkeypatch, "port") as nodes:
        pbps.init(device="cpu")
        pbps.declare_tensor("a", **FLEET_CODECS["ob"])
        pbps.push_pull(torch.ones(FLEET_N), name="a")
        pbps.set_compression_lr(0.125)
        pbps.declare_tensor("b", **FLEET_CODECS["ob"])
        pbps.push_pull(torch.ones(FLEET_N), name="b")
        engine = port_state.get_state().engine
        lrs = {c.inner.lr for c in engine._compressors.values()}
        pbps.push_pull(torch.ones(FLEET_N), name="a")  # the servers saw the frame
        server_lrs = {lr for lr, _ in _server_ef_state(nodes).values()}
        pbps.shutdown()
    assert lrs == server_lrs == {0.125}


# --- every chain through DistributedOptimizer ---------------------------------


@pytest.mark.parametrize("chain", ["", "ef", "ef+momentum"])
@pytest.mark.parametrize("ctype", ["onebit", "topk", "randomk", "dithering"])
def test_distributed_optimizer_takes_each_codec_and_chain(monkeypatch, ctype, chain):
    """One AdamW step of tiny_test through a port fleet; bare onebit, topk
    and dithering take the device lane, the other chains the host lane."""
    cfg, sd, tok, tgt = _tiny()
    params = {"compressor": ctype, "k": 0.5 if ctype in ("topk", "randomk") else 4}
    if chain:
        params["ef"] = "vanilla"
    if "momentum" in chain:
        params["momentum"] = "nesterov"
    with _cluster(monkeypatch, "port", BYTEPS_PARTITION_BYTES="2048",
                  BYTEPS_MIN_COMPRESS_BYTES="1024"):
        pbps.init(device="cpu")
        model = tt.Transformer(cfg, device="cpu")
        model.load_state_dict(sd)
        before = [p.detach().clone() for p in model.parameters()]
        opt = pbps.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-2),
                                        named_parameters=model.named_parameters(),
                                        compression_params=params)
        pbps.set_compression_lr(1e-2)
        loss = tt.build_train_step(model, opt)(tok, tgt)
        table = port_state.get_state().engine.partition_table()
        pbps.shutdown()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    sizes: dict = {}
    for r in table:
        sizes[r["name"]] = sizes.get(r["name"], 0) + r["length"] * r["itemsize"]
    on_device = [r["wire_nbytes"] is not None for r in table if sizes[r["name"]] >= 1024]
    assert on_device and set(on_device) == {not chain and ctype != "randomk"}
