"""The port's native C++ lanes (byteps_tpu_torch.native: its own copy of the
reducer, the codecs, the server's data plane and the client's lanes, built
by g++ from byteps_tpu_torch/native/csrc) against byteps_tpu's.

- The library builds from the port's sources, copies of the reference's;
  its golden frames equal the reference library's and the port's Python
  framing byte for byte.
- Each codec's native entry equals its numpy body and byteps_tpu's codec:
  onebit words bitwise, its scale within 1 ulp (ROADMAP.md Queue 3's
  rule), every other payload and decode bitwise.  The reducer and the key
  -> reducer-lane map equal the reference's.
- Pulls are bitwise across {port Python client, port native client} x
  {port PSServer, port NativePSServer, byteps_tpu PSServer, byteps_tpu
  NativePSServer}, at 1 and 2 workers and, for the native servers, at
  BYTEPS_SERVER_STRIPES 1 and 4: dense float32, bfloat16 and float16, onebit, topk,
  dithering, and onebit + error feedback + Nesterov with the lr frame.
  Onebit inputs are +-2^-k, so every scale is exact whatever the order of
  its sum.
- Without a compiler the native knobs raise; nothing serves or trains on
  the Python lanes instead.  The native knobs no longer raise as unported
  planes; the uds, shm and chaos vans still do.
- Server processes under BYTEPS_SERVER_NATIVE=1 and a worker under
  BYTEPS_NATIVE_CLIENT=1 map no file of byteps_tpu/.
"""

import contextlib
import ctypes
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_wire_golden as twg
from byteps_tpu import native as ref_native
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.compression import impl as ref_impl
from byteps_tpu.server.server import NativePSServer as RefNativeServer
from byteps_tpu.server.server import PSServer as RefServer
import byteps_tpu_torch as pbps
from byteps_tpu_torch import native
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import DataType, RequestType
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.ps_client import ZERO_COPIED, PSClient
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.compression import impl
from byteps_tpu_torch.compression.registry import (
    apply_lr_to_chain,
    create_compressor,
    translate_compression_params,
)
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.server import server as port_server
from byteps_tpu_torch.server.native import NativePSServer
from byteps_tpu_torch.server.server import PSServer as PortServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(REPO, "byteps_tpu", "native")


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_NATIVE_CLIENT", "BYTEPS_SERVER_NATIVE",
              "BYTEPS_SERVER_STRIPES", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


def _ref_lib():
    lib = ref_native.get_lib()
    if lib is None or not hasattr(lib, "bps_wire_golden_checksum"):
        pytest.skip("the reference's native library is not built")
    return lib


# --- the library --------------------------------------------------------------


def test_library_builds_from_the_ports_own_copy_of_the_sources():
    """The loaded library is the port's build of byteps_tpu_torch/native/
    csrc, whose files are the reference's byte for byte."""
    lib = native.get_lib()
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    for f in (*native.SOURCES, *native.HEADERS):
        with open(os.path.join(native.CSRC_DIR, f), "rb") as a, \
                open(os.path.join(REF_NATIVE, f), "rb") as b:
            assert a.read() == b.read(), f
    assert native.get_lib() is lib


_GOLDEN = {"bps_wire_golden": "python_golden_frames",
           "bps_wire_golden_compressed": "python_compressed_golden_frames",
           "bps_wire_golden_checksum": "python_checksum_golden_frames"}


@pytest.mark.parametrize("shim", sorted(_GOLDEN))
def test_golden_frames_equal_the_reference_library_and_the_ports_framing(monkeypatch, shim):
    """The C++ encoder's fixture stream, from the port's library and from
    the reference's, and the same stream framed by the port's transport
    (the fused and resync bodies are the reference's encoders': those
    planes are not ported)."""
    frames = []
    for lib in (native.get_lib(), _ref_lib()):
        buf = (ctypes.c_uint8 * 16384)()
        fn = getattr(lib, shim)
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_uint64], ctypes.c_int64
        n = fn(buf, len(buf))
        assert n > 0
        frames.append(bytes(buf[:n]))
    monkeypatch.setattr(twg, "Message", ptr.Message)
    monkeypatch.setattr(twg, "Op", ptr.Op)
    python = getattr(twg, _GOLDEN[shim])()
    assert frames[0] == frames[1] == python


def test_key_stripe_equals_the_reference():
    keys = [(d << 16) | p for d in range(50) for p in range(5)] + [1 << 40]
    for stripes in (1, 2, 4, 7):
        assert ([native.key_stripe(k, stripes) for k in keys]
                == [ref_native.key_stripe(k, stripes) for k in keys])


_SUM_DTYPES = [(np.float32, DataType.FLOAT32), (np.float64, DataType.FLOAT64),
               (np.int32, DataType.INT32), (np.int64, DataType.INT64),
               (np.int8, DataType.INT8), (np.uint8, DataType.UINT8),
               (np.float16, DataType.FLOAT16), (np.uint16, DataType.BFLOAT16)]


@pytest.mark.parametrize("dtype,dtype_id", _SUM_DTYPES, ids=lambda v: str(v))
def test_cpu_reducer_equals_numpy_and_the_reference(dtype, dtype_id):
    """dst += src elementwise: the reference library's bps_sum bitwise, and
    numpy's add (bfloat16: torch's CPU add) bitwise, but for float16, whose
    C++ conversion rounds a tie away from zero where numpy rounds it to
    even: 1 ulp there (a trait of the reference's reducer, kept)."""
    rng = np.random.default_rng(int(dtype_id))
    n = 1003
    if dtype == np.uint16:  # bfloat16 bits of normal values
        a = torch.randn(n, generator=torch.Generator().manual_seed(1)).bfloat16()
        b = torch.randn(n, generator=torch.Generator().manual_seed(2)).bfloat16()
        dst, src = (t.view(torch.int16).numpy().view(np.uint16).copy() for t in (a, b))
        want = (a + b).view(torch.int16).numpy().view(np.uint16)
    elif np.dtype(dtype).kind == "f":
        dst = rng.standard_normal(n).astype(dtype)
        src = rng.standard_normal(n).astype(dtype)
        want = dst + src
    else:
        info = np.iinfo(dtype)
        dst = rng.integers(info.min // 2, info.max // 2, n).astype(dtype)
        src = rng.integers(info.min // 2, info.max // 2, n).astype(dtype)
        want = dst + src
    ref = dst.copy()
    lib = _ref_lib()
    assert lib.bps_sum(ref.ctypes.data, src.ctypes.data, n, int(dtype_id)) == 0
    native.cpu_reducer.sum_into(dst, src, int(dtype_id))
    assert dst.tobytes() == ref.tobytes()
    if dtype == np.float16:
        ulps = np.abs(dst.view(np.int16).astype(np.int32) - want.view(np.int16).astype(np.int32))
        assert ulps.max() <= 1 and 0 < (ulps > 0).sum() < n // 10
    else:
        assert dst.tobytes() == want.tobytes()


# --- the codecs -----------------------------------------------------------------


def _grad(n: int, seed: int) -> np.ndarray:
    """Normal values with zeros, -0.0 and ties of magnitude (topk's
    ascending-index rule)."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[::7] = 0.0
    x[3::11] = -0.0
    x[5::13] = np.float32(1.5)
    x[6::17] = np.float32(-1.5)
    return x


def _ulps(a: float, b: float) -> int:
    ia, ib = (int(np.array(v, np.float32).view(np.int32)) for v in (a, b))
    return abs(ia - ib)


_CODECS = {
    "onebit": (lambda n: impl.OneBitCompressor(n), lambda n: ref_impl.OneBitCompressor(n)),
    "onebit-scaled": (lambda n: impl.OneBitCompressor(n, scaling=True),
                      lambda n: ref_impl.OneBitCompressor(n, scaling=True)),
    "topk": (lambda n: impl.TopKCompressor(n, max(1, n // 20)),
             lambda n: ref_impl.TopKCompressor(n, max(1, n // 20))),
    "randomk": (lambda n: impl.RandomKCompressor(n, max(1, n // 20), seed=42),
                lambda n: ref_impl.RandomKCompressor(n, max(1, n // 20), seed=42)),
    "dithering-linear-max": (lambda n: impl.DitheringCompressor(n, 4, "linear", "max", 7),
                             lambda n: ref_impl.DitheringCompressor(n, 4, "linear", "max", 7)),
    "dithering-natural-l2": (lambda n: impl.DitheringCompressor(n, 3, "natural", "l2", 9),
                             lambda n: ref_impl.DitheringCompressor(n, 3, "natural", "l2", 9)),
}


@pytest.mark.parametrize("n", [1, 33, 1000, 70001])
@pytest.mark.parametrize("codec", sorted(_CODECS))
def test_native_codec_entries_equal_their_numpy_bodies_and_the_reference(codec, n):
    _ref_lib()  # the reference's codecs take their native entries too
    port, ref = (make(n) for make in _CODECS[codec])
    x = _grad(n, n)
    got, plain, want = port.compress(x), port.compress_plain(x), ref.compress(x)
    if codec.startswith("onebit"):
        assert got[4:] == plain[4:] == want[4:]
        scales = [float(np.frombuffer(p[:4], np.float32)[0]) for p in (got, plain, want)]
        assert _ulps(scales[0], scales[1]) <= 1 and scales[0] == scales[2]
    else:
        assert got == plain == want
    out = port.decompress(got, n)
    assert out.dtype == np.float32 and out.shape == (n,)
    decoders = [port.decompress_plain] if hasattr(port, "decompress_plain") else []
    for dec in decoders + [ref.decompress]:
        assert dec(got, n).tobytes() == out.tobytes()


# --- fleets: {client} x {server} ----------------------------------------------

SERVERS = ["port", "port-native-s1", "port-native-s4", "ref", "ref-native-s1",
           "ref-native-s4"]
CLIENTS = ["python", "native"]
ROUNDS = 2
LR = 0.5

#: key -> (elements, dtype id, compression params or None)
TENSORS = {
    0: (3000, DataType.FLOAT32, None),
    1: (2500, DataType.BFLOAT16, None),
    6: (2222, DataType.FLOAT16, None),
    2: (4099, DataType.FLOAT32, {"compressor": "onebit", "scaling": True}),
    3: (2000, DataType.FLOAT32, {"compressor": "topk", "k": 50}),
    4: (1500, DataType.FLOAT32, {"compressor": "dithering", "k": 4,
                                 "partition": "natural", "normalize": "max", "seed": 7}),
    5: (3333, DataType.FLOAT32, {"compressor": "onebit", "ef": "vanilla",
                                 "momentum": "nesterov", "scaling": True}),
}


def _pushes(worker: int) -> dict:
    """A worker's payloads, by (round, key): raw bytes, or its codec
    chain's (the port's, with the lr set) on +-2^-k for onebit, normal
    values otherwise."""
    out = {}
    chains = {}
    for key, (n, dtype_id, params) in TENSORS.items():
        if params is not None:
            chains[key] = create_compressor(translate_compression_params(params), n)
            apply_lr_to_chain(chains[key], LR)
    for r in range(ROUNDS):
        for key, (n, dtype_id, params) in TENSORS.items():
            rng = np.random.default_rng((worker, r, key))
            if dtype_id == DataType.BFLOAT16:
                t = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).bfloat16()
                out[r, key] = t.view(torch.int16).numpy().tobytes()
            elif dtype_id == DataType.FLOAT16:
                out[r, key] = rng.standard_normal(n).astype(np.float16).tobytes()
            elif params is not None and params["compressor"] == "onebit":
                x = (rng.choice([-1.0, 1.0], n) * 2.0 ** -(2 + worker + r)).astype(np.float32)
                out[r, key] = chains[key].compress(x)
            elif params is not None:
                out[r, key] = chains[key].compress(rng.standard_normal(n).astype(np.float32))
            else:
                out[r, key] = rng.standard_normal(n).astype(np.float32).tobytes()
    return out


def _wait(start) -> object:
    """Run ``start(cb, on_error)`` and wait for one of them."""
    done, box = threading.Event(), []
    start(lambda *a: (box.append(a[0] if a else None), done.set()),
          lambda reason: (box.append(RuntimeError(reason)), done.set()))
    assert done.wait(30), "request timed out"
    if isinstance(box[0], Exception):
        raise box[0]
    return box[0]


def _worker(cfg, pushes: dict, out: dict) -> None:
    client = PSClient(cfg)
    client.connect()
    try:
        for key, (n, dtype_id, params) in TENSORS.items():
            client.init_tensor(key, n, int(dtype_id))
            if params is not None:
                client.register_compressor(key, translate_compression_params(params))
        client.set_compression_lr(LR)
        for r in range(ROUNDS):
            for key, (n, dtype_id, params) in TENSORS.items():
                rtype = (RequestType.DEFAULT_PUSH_PULL if params is None
                         else RequestType.COMPRESSED_PUSH_PULL)
                _wait(lambda cb, err: client.push(key, pushes[r, key], int(dtype_id), r + 1,
                                                  cb, err, request_type=rtype))
                sink = memoryview(bytearray(n * (2 if dtype_id in (DataType.BFLOAT16,
                                                                   DataType.FLOAT16) else 4)))
                got = _wait(lambda cb, err: client.pull(
                    key, r + 1, cb, err, dtype_id=int(dtype_id), request_type=rtype,
                    sink=sink if params is None else None))
                if params is None:
                    assert got is ZERO_COPIED  # the reply landed in the sink
                    got = sink
                out[r, key] = bytes(got)
    finally:
        client.close()


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, workers: int):
    kind, _, stripes = server.partition("-native-s")
    if stripes:
        monkeypatch.setenv("BYTEPS_SERVER_STRIPES", stripes)
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": str(workers),
           "DMLC_NUM_SERVER": "2", "BYTEPS_WIRE_CHECKSUM": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if kind == "port":
        sched = PortScheduler(workers, 2, host="127.0.0.1")
    else:
        sched = RefScheduler(num_workers=workers, num_servers=2, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    if kind == "ref" and stripes:
        _ref_lib()
    make = {("port", False): lambda: PortServer(PortConfig.from_env()),
            ("port", True): lambda: NativePSServer(PortConfig.from_env()),
            ("ref", False): lambda: RefServer(RefConfig.from_env()),
            ("ref", True): lambda: RefNativeServer(RefConfig.from_env())}[kind, bool(stripes)]
    nodes = [make() for _ in range(2)]
    for node in nodes:
        threading.Thread(target=node.start, daemon=True).start()
    try:
        yield nodes
    finally:
        for node in nodes:
            node.stop()
        sched.stop()


def _run(monkeypatch, client: str, server: str, workers: int) -> list:
    """Every worker's pulls, by (round, key)."""
    if client == "native":
        monkeypatch.setenv("BYTEPS_NATIVE_CLIENT", "1")
    outs = [{} for _ in range(workers)]
    with _fleet(monkeypatch, server, workers):
        cfg = PortConfig.from_env()
        assert cfg.native_client == (client == "native")
        threads = [threading.Thread(target=_worker, args=(cfg, _pushes(w), outs[w]))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    monkeypatch.delenv("BYTEPS_NATIVE_CLIENT", raising=False)
    return outs


_BASELINE: dict = {}


def _baseline(monkeypatch, workers: int) -> dict:
    """The reference's Python server with the port's Python client; its
    dense pulls checked against numpy's sums."""
    if workers not in _BASELINE:
        outs = _run(monkeypatch, "python", "ref", workers)
        assert all(o == outs[0] for o in outs) and len(outs[0]) == ROUNDS * len(TENSORS)
        pushes = [_pushes(w) for w in range(workers)]
        for r in range(ROUNDS):
            f32 = sum(np.frombuffer(p[r, 0], np.float32) for p in pushes[1:]) \
                + np.frombuffer(pushes[0][r, 0], np.float32)
            assert outs[0][r, 0] == f32.astype(np.float32).tobytes()
            bf = [torch.from_numpy(np.frombuffer(p[r, 1], np.int16).copy()).view(torch.bfloat16)
                  for p in pushes]
            total = bf[0] + bf[1] if workers == 2 else bf[0]
            assert outs[0][r, 1] == total.view(torch.int16).numpy().tobytes()
        _BASELINE[workers] = outs[0]
    return _BASELINE[workers]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client", CLIENTS)
def test_pulls_are_bitwise_across_clients_and_servers(monkeypatch, client, server, workers):
    want = _baseline(monkeypatch, workers)
    outs = _run(monkeypatch, client, server, workers)
    for w, got in enumerate(outs):
        assert sorted(got) == sorted(want), (w, sorted(set(want) - set(got)))
        bad = [k for k in want if got[k] != want[k]]
        assert not bad, (client, server, workers, w, bad)


# --- failure and configuration --------------------------------------------------


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No C++ compiler on PATH and no library built: the next get_lib()
    must build and cannot."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("PATH", str(tmp_path))
    yield
    native._lib = None


def test_a_cxx_without_openmp_is_passed_over(monkeypatch, tmp_path):
    """$CXX may name a toolchain that finds no libgomp.spec; the
    build takes the system's g++ then."""
    import shutil

    fake = tmp_path / "g++-without-openmp"
    fake.write_text("#!/bin/sh\necho libgomp.spec\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    assert _build._cxx() == shutil.which("g++")


def test_without_a_compiler_the_native_server_raises(monkeypatch, no_compiler):
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native.get_lib()
    monkeypatch.setenv("BYTEPS_SERVER_NATIVE", "1")
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        NativePSServer(PortConfig.from_env())
    # run_server must not fall back to the Python engine
    monkeypatch.setenv("DMLC_ROLE", "server")
    served = []
    monkeypatch.setattr(port_server, "_serve_until_signaled", served.append)
    monkeypatch.setattr(PortServer, "start", lambda self, register=True: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        port_server.run_server()
    assert not served


def test_without_a_compiler_the_native_client_raises(monkeypatch, no_compiler):
    """A worker under BYTEPS_NATIVE_CLIENT=1 fails its init(); it does not
    dial the servers over the Python lanes."""
    monkeypatch.setenv("BYTEPS_NATIVE_CLIENT", "1")
    monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
    with _fleet(monkeypatch, "port", 1):
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            pbps.init(device="cpu")
    assert not port_state.get_state().initialized


def test_the_native_knobs_are_ported_and_the_vans_are_not(monkeypatch):
    for knob in ("BYTEPS_SERVER_NATIVE", "BYTEPS_NATIVE_CLIENT"):
        monkeypatch.setenv(knob, "1")
    port_config.check_unported_env()
    cfg = PortConfig.from_env()
    assert cfg.native_client and cfg.server_native
    for van in ("uds", "shm", "chaos:tcp"):
        monkeypatch.setenv("BYTEPS_VAN", van)
        with pytest.raises(NotImplementedError, match="Queue 1b item P8"):
            port_config.check_unported_env()
        with pytest.raises(NotImplementedError, match="Queue 1b item P8"):
            NativePSServer(PortConfig.from_env())


def _mapped_repo_files(pid: int) -> set:
    with open(f"/proc/{pid}/maps") as f:
        paths = {ln.split()[-1] for ln in f if len(ln.split()) >= 6}
    return {p for p in paths if p.startswith(REPO + os.sep)}


def test_native_server_processes_and_worker_map_nothing_of_byteps_tpu(monkeypatch, tmp_path):
    """`python -m byteps_tpu_torch.server` as the scheduler and a server
    under BYTEPS_SERVER_NATIVE=1, this process a worker under
    BYTEPS_NATIVE_CLIENT=1: a push_pull goes through, the server maps the
    port's library and no file under byteps_tpu/, and logs its stop
    report (pushes, rounds, histograms)."""
    native.get_lib()  # built here, so the server process only loads it
    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "PYTHONPATH": REPO,
           "BYTEPS_SERVER_NATIVE": "1"}
    cmd = [sys.executable, "-m", "byteps_tpu_torch.server"]
    err = tmp_path / "server.err"
    procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "DMLC_ROLE": "scheduler",
                                                  "DMLC_PS_ROOT_PORT": "0"},
                              stdout=subprocess.PIPE, text=True)]
    try:
        port = procs[0].stdout.readline().strip().split("=", 1)[1]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env={**env, "DMLC_ROLE": "server", "DMLC_PS_ROOT_PORT": port},
            stdout=subprocess.DEVNULL, stderr=err.open("w")))
        for k, v in {**env, "DMLC_PS_ROOT_PORT": port, "BYTEPS_FORCE_DISTRIBUTED": "1",
                     "BYTEPS_NATIVE_CLIENT": "1"}.items():
            monkeypatch.setenv(k, v)
        pbps.init(device="cpu")
        x = torch.arange(6000, dtype=torch.float32)
        assert torch.equal(pbps.push_pull(x, name="via.native", average=False), x)
        server_maps = _mapped_repo_files(procs[1].pid)
        worker_maps = _mapped_repo_files(os.getpid())
        pbps.shutdown()
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=30)
    lib = native.get_lib()._name
    assert lib in server_maps and lib in worker_maps
    ref_dir = os.path.join(REPO, "byteps_tpu") + os.sep
    assert not [p for p in server_maps if p.startswith(ref_dir)], server_maps
    log = err.read_text()
    assert "summed 1 pushes into 1 rounds" in log, log[-2000:]
    assert "native_server_sum_seconds count=1 " in log, log[-2000:]
