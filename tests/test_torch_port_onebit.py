"""The port's onebit codec against byteps_tpu's on the same numpy inputs:
K4's plain version (what the CUDA kernel is held to on the card) against
the Pallas kernel in interpret mode, ``_pack_jnp`` and the host
``OneBitCompressor``; the port's numpy codec and its device decoder
against the reference's; the device adapter of the engine.

Tolerances: the sign words are compared byte for byte.  The scale is
mean |x| in float32; the port sums in float64, the reference's jnp path in
float32, so the two may differ in the last places: rtol 1e-6, as
``tests/test_ops.py::TestOneBitDevice`` allows."""

import ctypes
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.compression.impl import OneBitCompressor as RefOneBit
from byteps_tpu.ops import onebit_device as ref_ob
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.compression.impl import OneBitCompressor
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.device_codec import device_codec_for
from byteps_tpu_torch.ops import onebit_device as ob


@pytest.fixture(autouse=True)
def _reset_runtimes():
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()
    from byteps_tpu.common import config as jconfig
    from byteps_tpu.core.state import shutdown_state

    shutdown_state()
    jconfig.clear_config()


def _draw(n: int, seed: int, specials: bool = False) -> np.ndarray:
    """Normal draws; with ``specials`` also +-0.0, denormals, +-inf and NaNs
    of both signs at random places."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    if specials:
        nan = np.float32(np.nan)
        vals = np.array([np.inf, -np.inf, nan, -nan, 0.0, -0.0, 1e-40, -1e-40],
                        dtype=np.float32)
        idx = rng.permutation(n)[: min(n, 2 * vals.size)]
        x[idx] = np.resize(vals, idx.size)
    return x


def _split(payload: bytes):
    return np.frombuffer(payload[:4], np.float32)[0], payload[4:]


def _port_payload(x: np.ndarray, scaling: bool = True) -> bytes:
    out = ob.onebit_payload_device(torch.from_numpy(x.copy()), scaling=scaling)
    assert out.dtype == torch.uint8 and out.numel() == ob.wire_nbytes(x.size)
    return out.numpy().tobytes()


def test_plain_version_matches_the_pallas_kernel_in_interpret_mode():
    """n = 65536 is kernel-eligible in the reference (n % 32768 == 0), so
    this runs ``_pack_kernel`` itself, interpreted."""
    x = _draw(65536, seed=3)
    scale, words = ref_ob.onebit_compress_device(jnp.asarray(x), scaling=True,
                                                 interpret=True)
    want = ref_ob.onebit_payload(scale, words)
    got = _port_payload(x)
    assert got[4:] == want[4:]
    np.testing.assert_allclose(_split(got)[0], _split(want)[0], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000, 24577])
@pytest.mark.parametrize("specials", [False, True])
def test_plain_version_matches_pack_jnp_and_the_host_codec(n, specials):
    """Ragged n (the reference's jnp path and host codec); -0.0, denormals
    and negative NaNs set their bit as ``signbit`` does, lanes past n are
    clear."""
    x = _draw(n, seed=n, specials=specials)
    scale, words = ref_ob._pack_jnp(jnp.asarray(x), True)
    jnp_payload = ref_ob.onebit_payload(scale, words)
    host_payload = RefOneBit(n, scaling=True).compress(x)
    got = _port_payload(x)
    assert got[4:] == jnp_payload[4:] == host_payload[4:]
    if specials:
        assert not np.isfinite(_split(got)[0])
        assert not np.isfinite(_split(jnp_payload)[0])
    else:
        for want in (jnp_payload, host_payload):
            np.testing.assert_allclose(_split(got)[0], _split(want)[0], rtol=1e-6)


def test_scaling_off_gives_scale_one():
    x = _draw(77, seed=1)
    assert _split(_port_payload(x, scaling=False))[0] == np.float32(1.0)
    assert _port_payload(x, scaling=False) == RefOneBit(77, scaling=False).compress(x)


@pytest.mark.parametrize("n", [1, 33, 4096, 70001])
def test_numpy_codec_is_bytewise_the_references(n):
    """The port's host codec (the servers' decompress-then-sum, and the
    merged round's compression) against the reference's.  Dyadic inputs
    make every sum exact, so the scale is compared bytewise too; random
    normal inputs hold the words bytewise and the scale to rtol 1e-6."""
    rng = np.random.default_rng(n)
    dyadic = (rng.integers(-64, 65, size=n) / 64).astype(np.float32)
    normal = rng.standard_normal(n).astype(np.float32)
    for scaling in (True, False):
        port, ref = OneBitCompressor(n, scaling), RefOneBit(n, scaling)
        assert port.wire_nbytes() == ref.wire_nbytes() == ob.wire_nbytes(n)
        payload = port.compress(dyadic)
        assert payload == ref.compress(dyadic)
        np.testing.assert_array_equal(port.decompress(payload, n),
                                      ref.decompress(payload, n))
        p2, r2 = port.compress(normal), ref.compress(normal)
        assert p2[4:] == r2[4:]
        np.testing.assert_allclose(_split(p2)[0], _split(r2)[0], rtol=1e-6)
        acc = port.decompress(payload, n)
        port.sum_into(p2, acc)
        np.testing.assert_array_equal(acc, ref.decompress(payload, n)
                                      + ref.decompress(p2, n))


@pytest.mark.parametrize("n", [1, 32, 100, 4096])
def test_device_decoder_matches_the_references(n):
    """``onebit_decompress_device`` (bit tests in int32) against the
    reference's jnp decoder, bitwise, including words with the top bit set."""
    x = _draw(n, seed=10 + n)
    x[31::32] = -np.abs(x[31::32])  # bit 31 of every full word
    payload = torch.frombuffer(bytearray(_port_payload(x)), dtype=torch.uint8)
    scale, words = ob.split_payload(payload)
    got = ob.onebit_decompress_device(scale, words, n).numpy()
    want = np.asarray(ref_ob.onebit_decompress_device(
        jnp.float32(scale.item()),
        jnp.asarray(words.numpy().view(np.uint32)), n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(x))


def test_compress_device_returns_the_references_pieces():
    """(scale, words) as the reference returns them, and ``onebit_payload``
    frames them as the host wire format."""
    x = _draw(1000, seed=5)
    scale, words = ob.onebit_compress_device(torch.from_numpy(x))
    assert scale.dtype == torch.float32 and scale.dim() == 0
    assert words.dtype == torch.int32 and words.numel() == 32
    assert ob.onebit_payload(scale, words) == _port_payload(x)
    rs, rw = ref_ob._pack_jnp(jnp.asarray(x), True)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(rw))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel or raises, never to a fallback."""
    with pytest.raises(ValueError, match="unsupported device"):
        ob.onebit_payload_device(torch.ones(64, device="meta"))


def test_device_adapter_round_trip_and_eligibility():
    """The engine's device adapter: the payload it hands to the wire is the
    host codec's, and it decodes a pulled payload on the tensor's device.
    Bare onebit only: a config with error feedback takes no adapter."""
    x = _draw(3000, seed=6)
    dc = device_codec_for({"byteps_compressor_type": "onebit",
                           "byteps_compressor_onebit_scaling": "True"}, x.size)
    payload = dc.compress(torch.from_numpy(x))
    assert payload.nbytes == dc.wire_nbytes() == RefOneBit(x.size).wire_nbytes()
    assert payload.tobytes()[4:] == RefOneBit(x.size, True).compress(x)[4:]
    out = dc.decompress(payload.tobytes(), x.size, torch.device("cpu"))
    np.testing.assert_array_equal(out.numpy(),
                                  OneBitCompressor(x.size).decompress(payload.tobytes(), x.size))
    assert device_codec_for({"byteps_compressor_type": "onebit",
                             "byteps_ef_type": "vanilla"}, 10) is None
    assert device_codec_for({}, 10) is None


@pytest.mark.parametrize("s", [0.5, -0.5, 0.0, -0.0, np.inf, np.nan, -np.nan])
def test_device_decoder_negates_any_scale_like_where(s):
    """The decoder flips the scale's sign bit where a word's bit is set:
    bitwise ``where(bit, -scale, scale)`` for every scale, NaNs and zeros
    included."""
    scale = torch.tensor(s, dtype=torch.float32)
    words = torch.tensor([0x5, -1, -2**31], dtype=torch.int32)
    got = ob.onebit_decompress_device(scale, words, 70)
    bits = ((words[:, None] >> torch.arange(32, dtype=torch.int32)) & 1).reshape(-1)[:70]
    want = torch.where(bits.bool(), -scale, scale)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _view(x: np.ndarray, kind: str):
    """A torch view of ``x``'s values, and a contiguous numpy copy of them:
    ``offset<k>`` starts k elements (4k bytes) into a larger buffer,
    ``strided`` takes every other element, ``column`` the middle column of an
    (n, 3) array."""
    n = x.size
    if kind.startswith("offset"):
        k = int(kind[-1])
        base = np.zeros(n + 3, np.float32)
        base[k:k + n] = x
        return torch.from_numpy(base)[k:k + n], x
    wide = np.zeros((n, 3) if kind == "column" else (n, 2), np.float32)
    wide[:, 1 if kind == "column" else 0] = x
    t = torch.from_numpy(wide)
    view = t[:, 1] if kind == "column" else t.reshape(-1)[::2]
    return view, x


@pytest.mark.parametrize("view", ["offset1", "offset2", "offset3", "strided", "column"])
@pytest.mark.parametrize("n", [5, 1021, 1022, 1023, 1_023_999])
def test_plain_version_on_views_matches_pack_jnp_and_the_host_codec(n, view):
    """The plain version (what K4 is held to on the card) on views the
    wrapper takes: offsets of 4, 8 and 12 bytes, non-contiguous views, and
    n = 1, 2, 3 (mod 4), near a full partition too.  Words bytewise, scale
    within rtol 1e-6 of ``_pack_jnp``'s and the host codec's."""
    x = _draw(n, seed=40 + n)
    t, values = _view(x, view)
    assert t.numel() == n and torch.equal(t, torch.from_numpy(values))
    if view.startswith("offset"):
        assert t.is_contiguous() and t.storage_offset() == int(view[-1])
    else:
        assert not t.is_contiguous()
    out = ob.onebit_payload_device(t, scaling=True)
    assert out.dtype == torch.uint8 and out.numel() == ob.wire_nbytes(n)
    got = out.numpy().tobytes()
    scale, words = ref_ob._pack_jnp(jnp.asarray(values), True)
    jnp_payload = ref_ob.onebit_payload(scale, words)
    host_payload = RefOneBit(n, scaling=True).compress(values)
    assert got[4:] == jnp_payload[4:] == host_payload[4:]
    for want in (jnp_payload, host_payload):
        np.testing.assert_allclose(_split(got)[0], _split(want)[0], rtol=1e-6)


_CU = Path(ob.__file__).parent / "csrc" / "onebit.cu"
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int}


def _source() -> str:
    """onebit.cu without its comments."""
    return re.sub(r"//[^\n]*", "", _CU.read_text())


def test_kernel_source_is_one_kernel_launched_once_a_call():
    """K4 is one ``__global__`` kernel and ``bps_onebit_pack`` launches it
    once: a call is one launch (the scale's sum is the last block's)."""
    src = _source()
    assert len(re.findall(r"__global__", src)) == 1
    assert len(re.findall(r"<<<", src)) == 1
    body = src[src.index("int bps_onebit_pack("):]
    assert body.count("<<<") == 1


def test_wrapper_argtypes_match_the_c_signature():
    """The ctypes argtypes the wrapper sets are the C entry point's
    parameter types, in order: a pointer passed as a 32-bit int would be
    cut."""
    sig = re.search(r"int bps_onebit_pack\(([^)]*)\)", _source()).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    types = [re.match(r"(const void\*|void\*|long long|int)\s*\w+$", p).group(1)
             for p in params]
    assert [_CTYPES[t] for t in types] == ob._PACK_ARGTYPES


def test_wrapper_allocates_only_the_payload_and_sizes_the_grid_by_n():
    """One allocation a call, the payload; the workspace is made once per
    (device, stream).  The grid is a function of n alone (the scale's bits
    depend on it), matched to the kernel's constants."""
    wrapper = inspect.getsource(ob.onebit_payload_device)
    assert len(re.findall(r"torch\.(empty|zeros|ones|full)\w*\(", wrapper)) == 1
    assert "torch.empty(wire_nbytes(n)" in wrapper
    src = _source()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxBlocks"] == ob._MAX_BLOCKS
    assert const["kThreads"] // 32 * const["kChunk"] == ob._BLOCK_ELEMS
    assert [ob._num_blocks(n) for n in (1, 8192, 8193, 1_024_000, 10**9)] == [
        1, 1, 2, 125, ob._MAX_BLOCKS]
