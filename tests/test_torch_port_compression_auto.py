"""Compression across the control plane, held to byteps_tpu on the same
numpy inputs: an error-feedback chain through a migration (its residual
and its learning rate, F5 in ROADMAP.md Queue 3), and adaptive
compression (``BYTEPS_COMPRESSION_AUTO``): the static verdicts of every
codec and size class, the probe of a data-dependent chain, raw rounds on
a codec-registered key, a round that mixes raw and compressed pushes, and
the device lane's off partitions.  Every comparison is exact."""

import struct

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type

F32 = int(DataType.FLOAT32)
CMD_RAW = get_command_type(RequestType.DEFAULT_PUSH_PULL, F32)
CMD_COMP = get_command_type(RequestType.COMPRESSED_PUSH_PULL, F32)
PKGS = ["port", "ref"]
PAIRS = [(a, b) for a in PKGS for b in PKGS]
EF_ONEBIT = {"byteps_compressor_type": "onebit", "byteps_compressor_onebit_scaling": "True",
             "byteps_ef_type": "vanilla"}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _wire_server(pkg: str, rank: int):
    k = kits.kit(pkg)
    srv = k.PSServer(k.Config(num_worker=1, num_server=1, elastic_reshard=True))
    srv.start(register=False)
    srv.rank = rank
    return srv


def _dial(srv):
    sock = ptr.connect("127.0.0.1", srv.port)
    sock.settimeout(15)
    return sock


def _rpc(sock, msg):
    ptr.send_message(sock, msg)
    return ptr.recv_message(sock)


def _key_owned_by(rank: int, ranks) -> int:
    from byteps_tpu_torch.common.hashing import HashRing

    ring = HashRing(ranks)
    return next(k << 16 for k in range(1 << 12) if ring.owner(k << 16) == rank)


def _register(sock, key: int, kwargs: dict, lr: float) -> None:
    body = "\n".join(f"{k}={v}" for k, v in sorted(kwargs.items())).encode()
    assert _rpc(sock, ptr.Message(ptr.Op.REGISTER_COMPRESSOR, key=key, seq=3,
                                  payload=body)).status == 0
    assert _rpc(sock, ptr.Message(ptr.Op.REGISTER_COMPRESSOR, seq=4, flags=1,
                                  payload=struct.pack("!d", lr))).status == 0


def _round(sock, key: int, version: int, g: np.ndarray) -> bytes:
    """One worker's round: a raw push and a compressed pull."""
    assert _rpc(sock, ptr.Message(ptr.Op.PUSH, key=key, seq=10 + version, flags=1,
                                  cmd=CMD_RAW, version=version,
                                  payload=g.tobytes())).op == ptr.Op.PUSH
    reply = _rpc(sock, ptr.Message(ptr.Op.PULL, key=key, seq=20 + version, cmd=CMD_COMP,
                                   version=version))
    assert reply.op == ptr.Op.PULL
    return bytes(reply.payload)


def _server_chain(lr: float):
    from byteps_tpu_torch.compression.registry import apply_lr_to_chain, create_compressor

    chain = create_compressor(EF_ONEBIT, 64, server=True)
    apply_lr_to_chain(chain, lr)
    return chain


@pytest.mark.parametrize("old,new", PAIRS)
def test_a_migrated_error_feedback_chain_keeps_its_residual_between_port_servers(old, new):
    """The server chain's residual changes the next compressed pull: a
    port server ships it (``ef_error_nbytes``, a tail byteps_tpu's install
    does not read) and a port server installs it, so the pull after the
    move is the one a server that never moved would send.  Any other pair
    restarts the residual at zero, as byteps_tpu does."""
    a, b = _wire_server(old, 0), _wire_server(new, 1)
    key = _key_owned_by(1, [0, 1])
    gs = [np.random.default_rng(30 + i).standard_normal(64).astype(np.float32)
          for i in range(3)]
    stay, fresh = _server_chain(0.5), _server_chain(0.5)
    expect = [stay.compress(g) for g in gs]
    restarted = fresh.compress(gs[2])
    assert restarted != expect[2]  # the residual matters for this pull
    wa = _dial(a)
    wb = _dial(b)
    try:
        assert _rpc(wa, ptr.Message(ptr.Op.INIT, key=key, seq=1, flags=1, version=7,
                                    payload=struct.pack("!QI", 64, F32))).status == 0
        _register(wa, key, EF_ONEBIT, 0.5)
        assert _rpc(wb, ptr.Message(ptr.Op.REGISTER_COMPRESSOR, seq=5, flags=1,
                                    payload=struct.pack("!d", 0.5))).status == 0
        for v in (1, 2):
            assert _round(wa, key, v, gs[v - 1]) == expect[v - 1]
        servers = [["127.0.0.1", a.port], ["127.0.0.1", b.port]]
        for srv in (b, a):
            srv._adopt_book({"map_epoch": 2, "server_ranks": [0, 1], "servers": servers})
        assert kits.wait(lambda: b._keys.get(key) is not None
                         and b._keys[key].store is not None
                         and b._keys[key].migrated_to is None)
        got = _round(wb, key, 3, gs[2])
        assert got == (expect[2] if (old, new) == ("port", "port") else restarted)
    finally:
        ptr.close_socket(wa)
        ptr.close_socket(wb)
        a.stop()
        b.stop()


def _ef_lrs(srv) -> list:
    """The lr of every error-feedback chain a server holds."""
    out = []
    for ks in list(srv._keys.values()):
        codec = ks.compressor
        while codec is not None:
            if hasattr(codec, "error") and hasattr(codec, "lr"):
                out.append(float(codec.lr))
            codec = getattr(codec, "inner", None)
    return out


@pytest.mark.parametrize("joiner", PKGS)
def test_the_lr_reaches_a_server_that_joined_after_it(monkeypatch, joiner):
    """An error-feedback chain shipped by a scale-up to a server that joined
    after ``set_compression_lr`` applies the lr there: the worker sends it
    again when a book grows the server set (ROADMAP.md Queue 3, the eighth
    divergence; byteps_tpu's worker sends it only when it changes)."""
    import threading

    import torch

    import byteps_tpu_torch as pbps

    k = kits.kit("port")
    monkeypatch.setenv("BYTEPS_ELASTIC_RESHARD", "1")
    sched = k.Scheduler(num_workers=1, num_servers=2, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 1, 2, BYTEPS_HEARTBEAT_INTERVAL="0.1",
             BYTEPS_PARTITION_BYTES="1024", BYTEPS_MIN_COMPRESS_BYTES="0")
    fleet = [kits.start_server(k) for _ in range(2)]
    extra = None
    rng = np.random.default_rng(41)
    grads = [rng.standard_normal(4096).astype(np.float32) for _ in range(4)]
    try:
        pbps.init(device="cpu")
        pbps.declare_tensor("ef.w", **EF_ONEBIT)
        pbps.set_compression_lr(0.25)
        for step, g in enumerate(grads):
            if step == 2:
                t = threading.Thread(target=pbps.resume, kwargs={"num_servers": 3},
                                     daemon=True)
                t.start()
                assert kits.wait(lambda: sched.num_servers == 3)
                jk = kits.kit(joiner)
                monkeypatch.setenv("DMLC_NUM_SERVER", "3")
                extra = kits.start_server(jk, jk.Config.from_env())
                t.join(20)
                assert not t.is_alive()
            out = pbps.synchronize(pbps.push_pull_async(torch.from_numpy(g), name="ef.w",
                                                         average=True))
            assert np.isfinite(out.numpy()).all()
        assert kits.wait(lambda: bool(_ef_lrs(extra))), "no chain reached the joiner"
        assert set(_ef_lrs(extra)) == {0.25}
        for srv in fleet:
            assert set(_ef_lrs(srv)) <= {0.25}
    finally:
        pbps.shutdown()
        for s in fleet + ([extra] if extra is not None else []):
            s.stop()
        sched.stop()


# --- adaptive compression: the verdicts -----------------------------------

CODECS = {
    "onebit": {"byteps_compressor_type": "onebit"},
    "onebit_scaled": {"byteps_compressor_type": "onebit",
                      "byteps_compressor_onebit_scaling": "True"},
    "topk_100": {"byteps_compressor_type": "topk", "byteps_compressor_k": "100"},
    "topk_half": {"byteps_compressor_type": "topk", "byteps_compressor_k": "0.5"},
    "randomk_100": {"byteps_compressor_type": "randomk", "byteps_compressor_k": "100"},
    "dithering": {"byteps_compressor_type": "dithering"},
    "onebit_ef_nesterov": {**EF_ONEBIT, "byteps_momentum_type": "nesterov"},
    "topk_12000": {"byteps_compressor_type": "topk", "byteps_compressor_k": "12000"},
}
SIZES = [8, 100, 222, 24576, 1024000]


def _engine(pkg: str, **cfg):
    k = kits.kit(pkg)
    return k.PipelineEngine(k.Config(num_worker=1, compression_auto=True, **cfg), object())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("codec", list(CODECS))
def test_static_verdicts_equal_the_references(codec, size):
    """Every shipped codec's wire is size-deterministic: its exact wire
    bytes decide the key at registration, in both packages alike; a device
    codec's wire bytes equal its host twin's."""
    from byteps_tpu.compression.registry import create_compressor as ref_create
    from byteps_tpu_torch.compression.registry import create_compressor as port_create
    from byteps_tpu_torch.core.device_codec import device_codec_for

    kw = CODECS[codec]
    pc, rc = port_create(kw, size), ref_create(kw, size)
    assert (pc.wire_static, pc.wire_nbytes()) == (rc.wire_static, rc.wire_nbytes())
    assert pc.wire_static is True
    dc = device_codec_for(kw, size)
    if dc is not None:
        assert dc.wire_static and dc.wire_nbytes() == pc.wire_nbytes()
    off = {}
    for pkg, c in (("port", pc), ("ref", rc)):
        eng = _engine(pkg)
        eng._codec_names[5] = kw["byteps_compressor_type"]
        eng._auto_static_verdict(5, c)
        off[pkg] = (5 in eng._compression_auto_off, eng._auto_stats.get(5, "absent"))
    assert off["port"] == off["ref"]
    assert off["port"][0] == (pc.wire_nbytes() / (4 * size) >= 0.9)


@pytest.mark.parametrize("sizes,expect_off", [
    ([3900, 3950, 3990], True),             # near the raw size: raw after 3 rounds
    ([400, 4000, 4000, 4000, 4000], False),  # mean 0.7: keeps it, and stops probing
    ([4000, 4000], False),                   # two rounds: no verdict yet
])
def test_the_probe_judges_a_data_dependent_chain_as_the_reference(sizes, expect_off):
    out = {}
    for pkg in ("port", "ref"):
        eng = _engine(pkg)
        eng._codec_names[9] = "custom"
        for comp in sizes:
            eng._note_compression(9, 4000, comp)
        out[pkg] = (9 in eng._compression_auto_off, eng._auto_stats.get(9, "absent"))
    assert out["port"] == out["ref"]
    assert out["port"][0] is expect_off


def _tap_pushes(srv, seen: list):
    """Record (key, compressed?) of each push a port server takes."""
    orig = srv._push_args

    def tap(ks, msg):
        compressed, arr = orig(ks, msg)
        seen.append((msg.key, bool(compressed)))
        return compressed, arr

    srv._push_args = tap


def _topk(pkg: str, n: int, k: int):
    if pkg == "port":
        from byteps_tpu_torch.compression.impl import TopKCompressor
    else:
        from byteps_tpu.compression.impl import TopKCompressor
    return TopKCompressor(n, k)


def _worker_round(sock, key, version, payload, compressed: bool, seq: int):
    assert _rpc(sock, ptr.Message(ptr.Op.PUSH, key=key, seq=seq, flags=1,
                                  cmd=CMD_COMP if compressed else CMD_RAW, version=version,
                                  payload=payload)).op == ptr.Op.PUSH


def _pull(sock, key, version, compressed: bool, seq: int) -> bytes:
    reply = _rpc(sock, ptr.Message(ptr.Op.PULL, key=key, seq=seq, version=version,
                                   cmd=CMD_COMP if compressed else CMD_RAW))
    assert reply.op == ptr.Op.PULL
    return bytes(reply.payload)


@pytest.mark.parametrize("server", PKGS)
def test_raw_rounds_on_a_codec_registered_key(server):
    """A key whose verdict is off pushes and pulls raw while its codec
    stays registered: the server answers the raw sum, and a compressed
    pull of the same round its codec's encoding of that sum."""
    srv = _wire_server(server, 0)
    w = _dial(srv)
    g = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    try:
        assert _rpc(w, ptr.Message(ptr.Op.INIT, key=4, seq=1, flags=1, version=7,
                                   payload=struct.pack("!QI", 512, F32))).status == 0
        _register(w, 4, CODECS["topk_100"], 1.0)
        _worker_round(w, 4, 1, g.tobytes(), False, 10)
        assert _pull(w, 4, 1, False, 11) == g.tobytes()
        assert _pull(w, 4, 1, True, 12) == _topk("ref", 512, 100).compress(g)
    finally:
        ptr.close_socket(w)
        srv.stop()


def _mixed_round(server: str) -> list:
    """Two workers on one key in one round: one pushes topk's payload (a
    worker still compressing), the other the raw values (a worker that
    adopted a fleet codec_off first); each pulls in its own format."""
    k = kits.kit(server)
    srv = k.PSServer(k.Config(num_worker=2, num_server=1))
    srv.start(register=False)
    srv.rank = 0
    rng = np.random.default_rng(21)
    a, b = (rng.standard_normal(512).astype(np.float32) for _ in range(2))
    socks = [_dial(srv), _dial(srv)]
    try:
        for i, s in enumerate(socks):
            ptr.send_message(s, ptr.Message(ptr.Op.INIT, key=4, seq=1, flags=i + 1, version=7,
                                            payload=struct.pack("!QI", 512, F32)))
        for s in socks:
            assert ptr.recv_message(s).status == 0
        _register(socks[0], 4, CODECS["topk_100"], 1.0)
        comp = _topk("port", 512, 100).compress(a)
        assert comp == _topk("ref", 512, 100).compress(a)
        for s, (payload, c) in zip(socks, ((comp, True), (b.tobytes(), False))):
            assert _rpc(s, ptr.Message(ptr.Op.PUSH, key=4, seq=10, flags=socks.index(s) + 1,
                                       cmd=CMD_COMP if c else CMD_RAW, version=1,
                                       payload=payload)).op == ptr.Op.PUSH
        return [_pull(socks[0], 4, 1, True, 20), _pull(socks[1], 4, 1, False, 21),
                comp, b.tobytes()]
    finally:
        for s in socks:
            ptr.close_socket(s)
        srv.stop()


def test_a_round_that_mixes_raw_and_compressed_pushes_sums_as_the_reference():
    port, ref = _mixed_round("port"), _mixed_round("ref")
    assert port == ref
    comp_pull, raw_pull, comp, raw_b = port
    dec = _topk("ref", 512, 100).decompress(comp, 512)
    total = dec + np.frombuffer(raw_b, np.float32)
    assert raw_pull == total.tobytes()
    assert comp_pull == _topk("ref", 512, 100).compress(total)


@pytest.mark.parametrize("pkg", PKGS)
def test_an_off_partition_pushes_raw_on_the_ports_device_lane(monkeypatch, pkg):
    """A tensor whose partitions all have device codecs takes the device
    lane in both packages.  byteps_tpu's device lane does not read the off
    set: its off partition keeps pushing topk's payload.  The port's pushes
    it raw while the tensor's other partition stays compressed on the
    device lane (ROADMAP.md Queue 3, the ninth divergence)."""
    import torch

    k = kits.kit("port")
    sched = k.Scheduler(num_workers=1, num_servers=1, host="127.0.0.1")
    sched.start()
    kits.env(monkeypatch, sched, 1, 1, BYTEPS_COMPRESSION_AUTO="1",
             BYTEPS_PARTITION_BYTES="4096", BYTEPS_MIN_COMPRESS_BYTES="0")
    srv = kits.start_server(k)
    seen: list = []
    _tap_pushes(srv, seen)
    w = kits.kit(pkg)
    g = np.random.default_rng(8).standard_normal(1124).astype(np.float32)
    try:
        kits.init(w)
        w.api.declare_tensor("dl.w", **CODECS["topk_100"])
        if pkg == "port":
            src = torch.from_numpy(g.copy())
        else:
            import jax.numpy as jnp

            src = jnp.asarray(g)
        for _ in range(2):
            out = np.asarray(w.api.push_pull(src, name="dl.w", average=False))
        eng = w.state.get_state().engine
        on_device = all(p in eng._device_codecs for p in eng._compressors)
        assert on_device and len(eng._compressors) == 2
        (off_key,) = eng._compression_auto_off
        on_key = next(p for p in eng._compressors if p != off_key)
        pushed = {(key, c) for key, c in seen}
        assert (on_key, True) in pushed and (on_key, False) not in pushed
        assert (off_key, pkg == "ref") in pushed and (off_key, pkg == "port") not in pushed
        assert np.isfinite(out).all() and out.shape == (1124,)
        if pkg == "port":
            np.testing.assert_array_equal(out[1024:], g[1024:])  # raw: exact
    finally:
        w.api.shutdown()
        srv.stop()
        sched.stop()
