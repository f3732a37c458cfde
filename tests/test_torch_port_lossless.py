"""Lossless wire frames of the port (``compression/lossless.py``, the
``LOSSLESS_FLAG`` frames of ``comm/transport.py`` and the lossless arm of
adaptive compression in ``core/engine.py``) against byteps_tpu's.

- The port's plain LZ and container are bitwise
  ``byteps_tpu.compression.lossless``, and its C++ (wire.h) bitwise its
  plain version, on seeded inputs: random bytes, zeros, float32 with zero
  rows, JSON and the fixtures of ``tests/test_lossless.py``.
- Every fail-closed case raises LosslessError with the reference's reason.
- A flagged frame's bytes equal the reference's encoding, CRC32C included.
- MIGRATE_STATE and RESYNC_STATE travel lossless between port and
  reference servers with ``BYTEPS_WIRE_LOSSLESS=1`` on each end.
- The probe and the fleet's codec_lossless arm adopt the keys the
  reference's engine adopts, and a worker's probed pushes go out flagged
  to port, reference and C++ servers, their pulls bitwise.
"""

import json
import struct

import numpy as np
import pytest
import torch

import torch_port_kits as kits
from byteps_tpu.comm import transport as rtr
from byteps_tpu.compression import lossless as rl
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.compression import lossless as pl

F32 = 0


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("BYTEPS_WIRE_LOSSLESS", raising=False)
    yield from kits.reset_runtime(monkeypatch)


def _inputs() -> dict:
    rng = np.random.default_rng(17)
    rows = np.zeros((96, 64), np.float32)
    hot = rng.choice(96, 23, replace=False)
    rows[hot] = rng.standard_normal((23, 64)).astype(np.float32)
    state = {"keys": {str(k << 16): {"store_version": 7, "seen": 6, "recv_count": 0,
                                     "init": True} for k in range(40)}}
    return {
        "random": rng.integers(0, 256, 6000, dtype=np.uint8).tobytes(),
        "zeros": bytes(5000),
        "f32_zero_rows": rows.tobytes(),
        "json": json.dumps(state).encode(),
        "repetitive": b"abcdef" * 700,
        "runs": b"\x00" * 100 + b"\xff" * 100 + bytes(range(256)) * 3,
        "f32_grad": rng.standard_normal(1024).astype(np.float32).tobytes(),
        "short": b"x" * (pl.MIN_BYTES - 1),
        "at_min": b"y" * pl.MIN_BYTES,
        "empty": b"",
        "one": b"\x00",
        "long_runs": bytes(70000) + b"\x01" * 300 + bytes(range(200)) * 2,
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_the_codec_is_bitwise_the_reference(name):
    data = INPUTS[name]
    assert pl.lz_compress(data) == rl.lz_compress(data)
    blob = rl.compress_frame(data)
    assert pl.compress_frame_plain(data) == blob
    assert pl.compress_frame(data) == blob  # the port's C++
    assert len(blob) <= len(data) + pl.HEADER_SIZE
    assert pl.decompress_frame(blob) == pl.decompress_frame_plain(blob) == data
    assert rl.decompress_frame(pl.compress_frame(data)) == data
    if blob[5] == pl.METHOD_LZ:
        assert pl.lz_decompress(blob[pl.HEADER_SIZE:], len(data)) == data
    assert pl.byte_entropy(data) == rl.byte_entropy(data)
    assert pl.byte_entropy(data, limit=0) == rl.byte_entropy(data, limit=0)


def _reference_fixtures() -> list:
    import test_lossless

    return test_lossless._cases()


@pytest.mark.parametrize("name,data", _reference_fixtures(),
                         ids=[n for n, _ in _reference_fixtures()])
def test_the_reference_fixtures_compress_bitwise(name, data):
    """``tests/test_lossless.py``'s own fixtures: the same containers from
    the port's C++ and plain version as from the reference, each
    decoding back."""
    blob = rl.compress_frame(data)
    assert pl.compress_frame(data) == pl.compress_frame_plain(data) == blob
    assert pl.decompress_frame(blob) == data


def test_the_constants_and_the_cutoff_are_the_reference(monkeypatch):
    for name in ("MAGIC", "VERSION", "METHOD_STORE", "METHOD_LZ", "HEADER_SIZE", "MIN_BYTES"):
        assert getattr(pl, name) == getattr(rl, name)
    assert ptr.LOSSLESS_FLAG == rtr.LOSSLESS_FLAG and ptr._LOSSLESS_OPS == rtr._LOSSLESS_OPS
    for v in ("", "3.5", "junk"):
        monkeypatch.setenv("BYTEPS_LOSSLESS_ENTROPY", v)
        assert pl.lossless_entropy_cutoff() == rl.lossless_entropy_cutoff()


_BLOB = rl.compress_frame(b"compressible " * 100)
_MUTATIONS = {
    "truncated": _BLOB[: len(_BLOB) // 2],
    "magic": b"XXXX" + _BLOB[4:],
    "version": _BLOB[:4] + b"\x07" + _BLOB[5:],
    "method": _BLOB[:5] + b"\x09" + _BLOB[6:],
    "rawlen": _BLOB[: pl.HEADER_SIZE - 4] + struct.pack("!I", 999999) + _BLOB[pl.HEADER_SIZE:],
    "nobody": _BLOB[: pl.HEADER_SIZE],
    "short_header": b"nope",
    "stored_len": rl.compress_frame(bytes(range(10)))[:-1],
}


@pytest.mark.parametrize("case", sorted(_MUTATIONS))
def test_every_fail_closed_case_raises_the_reference_reason(case):
    """The plain decoder gives the reference's plain reason; the C++ one
    the reference's C++ reason (both fail closed where the reference
    does, on the header checks with the same words)."""
    blob = bytes(_MUTATIONS[case])
    with pytest.raises(rl.LosslessError) as ref:
        rl.decompress_frame(blob, op=25)
    with pytest.raises(pl.LosslessError) as plain:
        pl.decompress_frame_plain(blob, op=25)
    with pytest.raises(pl.LosslessError) as native:
        pl.decompress_frame(blob, op=25)
    assert native.value.reason == ref.value.reason
    assert native.value.op == plain.value.op == 25
    ref_plain = rl._native
    try:
        rl._native = False  # the reference's pure-Python decoder
        with pytest.raises(rl.LosslessError) as refp:
            rl.decompress_frame(blob, op=25)
    finally:
        rl._native = ref_plain
    assert plain.value.reason == refp.value.reason
    assert str(plain.value) == str(refp.value)


def test_the_lz_block_rejects_bad_offsets_and_lengths():
    data = b"abcabcabc" * 50
    block = pl.lz_compress(data)
    for args in ((block, len(data) + 1), (block[:-3], len(data)),
                 (b"\x10a\x00\x00", 5), (b"\xf0", 20)):
        with pytest.raises(pl.LosslessError) as p:
            pl.lz_decompress(*args)
        with pytest.raises(rl.LosslessError) as r:
            rl.lz_decompress(*args)
        assert p.value.reason == r.value.reason


@pytest.mark.parametrize("trace", [None, (0x1122334455667788, 0x99AABBCCDDEEFF00)])
@pytest.mark.parametrize("checksum", [False, True])
def test_a_flagged_frame_is_the_reference_encoding(trace, checksum):
    payload = INPUTS["f32_zero_rows"]
    frames = [tr.Message(tr.Op.PUSH, key=42, payload=payload, seq=7, cmd=6, version=3,
                         flags=1, trace=trace, checksum=checksum, lossless=True).encode()
              for tr in (ptr, rtr)]
    assert frames[0] == frames[1]
    assert frames[0][2] & ptr.LOSSLESS_FLAG
    small = ptr.Message(ptr.Op.PUSH, payload=b"z" * 10, lossless=True)
    assert not small.encode()[2] & ptr.LOSSLESS_FLAG  # too short to win: sent raw


def test_the_knob_stamps_resync_and_migrate_only(monkeypatch):
    monkeypatch.setenv("BYTEPS_WIRE_LOSSLESS", "1")
    body = INPUTS["json"]
    for op in ("RESYNC_STATE", "MIGRATE_STATE", "PUSH", "PULL"):
        frames = [tr.Message(tr.Op[op], key=5, seq=1, payload=body).encode() for tr in (ptr, rtr)]
        assert frames[0] == frames[1]
        assert bool(frames[0][2] & ptr.LOSSLESS_FLAG) == (op in ("RESYNC_STATE", "MIGRATE_STATE"))
    msg = ptr.Message(ptr.Op.MIGRATE_STATE, payload=body)
    assert msg.encode_header() == msg.encode_header()  # the transform runs once


def _count_decodes(monkeypatch) -> dict:
    """Count each package's lossless decodes by op name."""
    seen = {"port": [], "ref": []}
    for pkg, mod in (("port", pl), ("ref", rl)):
        orig = mod.decompress_frame

        def counted(blob, op=None, _orig=orig, _pkg=pkg):
            seen[_pkg].append(getattr(op, "name", str(op)))
            return _orig(blob, op=op)

        monkeypatch.setattr(mod, "decompress_frame", counted)
    return seen


@pytest.mark.parametrize("old,new", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_migrate_state_travels_lossless_between_packages(monkeypatch, old, new):
    """A key's store and ledger ship to the new owner as a lossless
    container, and land bitwise."""
    import test_torch_port_reshard as rs

    monkeypatch.setenv("BYTEPS_WIRE_LOSSLESS", "1")
    seen = _count_decodes(monkeypatch)
    a, b = rs.wire_server(old, rank=0), rs.wire_server(new, rank=1)
    key = rs.key_owned_by(1, [0, 1])
    g = np.zeros(4096, np.float32)
    g[::64] = np.arange(64, dtype=np.float32)
    w = rs.dial(a)
    try:
        rs.init_key(w, key, g.size)
        assert rs.push(w, key, 1, g).op == ptr.Op.PUSH
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        b._adopt_book(rs.book(2, [0, 1], servers))
        a._adopt_book(rs.book(2, [0, 1], servers))
        assert kits.wait(lambda: rs.landed(b, key)), "the migration never landed"
        np.testing.assert_array_equal(b._keys[key].store, g)
        assert "MIGRATE_STATE" in seen[new]
    finally:
        ptr.close_socket(w)
        a.stop()
        b.stop()


@pytest.mark.parametrize("server", ["port", "ref", "port-native"])
def test_resync_state_travels_lossless(monkeypatch, server):
    """A RESYNC_QUERY for every key: the server's answer (40 keys of
    repetitive JSON) comes back flagged and decodes to the reference's
    body."""
    monkeypatch.setenv("BYTEPS_WIRE_LOSSLESS", "1")
    with kits.fleet(monkeypatch, server, servers=1) as nodes:
        k = kits.kit("port")
        client = k.PSClient(k.Config.from_env())
        client.connect()
        try:
            keys = [(40 + i) << 16 for i in range(40)]
            for key in keys:
                client.init_tensor(key, 16, F32)
            sock = ptr.connect(nodes[0].host, nodes[0].port)
            ptr.send_message(sock, ptr.Message(ptr.Op.RESYNC_QUERY, seq=3,
                                               payload=ptr.encode_resync_query(1, [])))
            hdr = ptr.recv_header_ex(sock)
            assert hdr[0] == ptr.Op.RESYNC_STATE and hdr[-1], "the reply is not lossless"
            body = ptr._recv_exact(sock, hdr[7])
            state = ptr.decode_resync_state(pl.decompress_frame(body))
            assert sorted(state) == keys
            ptr.close_socket(sock)
        finally:
            client.close()


def _engine(pkg: str):
    k = kits.kit(pkg)
    return k.PipelineEngine(k.Config(num_worker=1), object())


@pytest.mark.parametrize("switch", ["0", "1"])
def test_the_probe_adopts_the_keys_the_reference_adopts(monkeypatch, switch):
    """One probe a key: a compressible raw payload turns the arm on, an
    incompressible one does not, and nothing turns on with the knob off;
    the votes carry the codec label."""
    monkeypatch.setenv("BYTEPS_WIRE_LOSSLESS", switch)
    payloads = {11: INPUTS["f32_zero_rows"], 12: INPUTS["random"] * 3, 13: INPUTS["zeros"],
                14: INPUTS["short"], 15: INPUTS["f32_grad"] * 4}
    got = {}
    for pkg in ("port", "ref"):
        eng = _engine(pkg)
        eng._codec_names = {11: "topk", 12: "topk", 13: "onebit", 14: "topk", 15: "topk"}
        before = dict(kits.kit(pkg).counters().snapshot_labeled().get(
            "compression_auto_lossless", {}))
        for key, data in payloads.items():
            eng._lossless_probe(key, memoryview(data))
        after = kits.kit(pkg).counters().snapshot_labeled().get("compression_auto_lossless", {})
        votes = {lbl: n - before.get(lbl, 0) for lbl, n in after.items()
                 if n - before.get(lbl, 0)}
        got[pkg] = (set(eng._lossless_keys), set(eng._lossless_probed), votes)
    assert got["port"][:2] == got["ref"][:2]
    assert sorted(got["port"][2].values()) == sorted(got["ref"][2].values())
    assert got["port"][0] == ({11, 13} if switch == "1" else set())
    assert got["port"][1] == set(payloads)


def _zero_rows_grad(seed: int, rows: int = 512, width: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.zeros((rows, width), np.float32)
    hot = rng.choice(rows, rows // 4, replace=False)
    g[hot] = rng.integers(-8, 8, (hot.size, width)).astype(np.float32)
    return g.reshape(-1)


@pytest.mark.parametrize("server", ["port", "ref", "port-native"])
def test_a_probed_key_pushes_lossless_and_pulls_bitwise(monkeypatch, server):
    """Adaptive compression turns a declared topk of k = 0.5 off at
    registration (its wire is as large as the raw bytes); the first raw
    push is probed (zero rows: low entropy) and the later pushes go out as
    lossless containers, which the server decodes; every pull is the sum,
    bitwise.  The reference's worker adopts the same partitions."""
    import byteps_tpu as jbps

    seen = _count_decodes(monkeypatch)
    xs = [_zero_rows_grad(s) for s in range(3)]
    adopted = {}
    for pkg in ("port", "ref"):
        with kits.fleet(monkeypatch, server, BYTEPS_COMPRESSION_AUTO="1",
                        BYTEPS_WIRE_LOSSLESS="1", BYTEPS_PARTITION_BYTES="65536"):
            k = kits.kit(pkg)
            kits.init(k)
            k.api.declare_tensor("emb.grad", byteps_compressor_type="topk",
                                     byteps_compressor_k="0.5")
            for x in xs:
                out = k.api.push_pull(kits.tensor(k, x), name="emb.grad", average=False)
                np.testing.assert_array_equal(np.asarray(out), x)
            eng = k.state.get_state().engine
            adopted[pkg] = (set(eng._lossless_keys), set(eng._compression_auto_off))
            k.api.shutdown()
        if not server.endswith("native"):
            assert seen[server.split("-")[0]].count("PUSH") >= 2 * len(adopted[pkg][0])
        seen["port"].clear()
        seen["ref"].clear()
    assert adopted["port"] == adopted["ref"]
    assert len(adopted["port"][0]) == 4  # every partition of the 256 KiB tensor


def test_the_device_lane_probes_the_raw_bytes_it_copies_back(monkeypatch):
    """The ninth divergence: on the port's device lane (a torch tensor) a
    declared topk in the off set pushes raw and its raw bytes are probed,
    where byteps_tpu's device lane keeps compressing and never probes; the
    port adopts the partitions its host lane adopts."""
    from byteps_tpu_torch.core import state as port_state

    x = _zero_rows_grad(4)
    adopted = []
    for as_tensor in (False, True):
        with kits.fleet(monkeypatch, "port", BYTEPS_COMPRESSION_AUTO="1",
                        BYTEPS_WIRE_LOSSLESS="1", BYTEPS_PARTITION_BYTES="65536"):
            k = kits.kit("port")
            kits.init(k)
            k.api.declare_tensor("emb.dev", byteps_compressor_type="topk",
                                     byteps_compressor_k="0.5")
            src = torch.from_numpy(x.copy()) if as_tensor else x.copy()
            for _ in range(2):
                out = k.api.push_pull(src, name="emb.dev", average=False)
                np.testing.assert_array_equal(np.asarray(out), x)
            adopted.append(set(port_state.get_state().engine._lossless_keys))
            k.api.shutdown()
    assert adopted[0] == adopted[1] and len(adopted[0]) == 4


def _corrupt_container_frame(op, **kw) -> bytes:
    """A frame whose lossless container passes its CRC32C but does not
    decode (the version byte flipped before the CRC was stamped)."""
    blob = bytearray(pl.compress_frame(INPUTS["repetitive"]))
    blob[4] ^= 0xFF
    msg = ptr.Message(op, payload=bytes(blob), checksum=True, lossless=False, **kw)
    frame = bytearray(msg.encode())
    frame[2] |= ptr.LOSSLESS_FLAG
    return bytes(frame)


def test_a_container_that_does_not_decode_fails_closed_on_the_server(monkeypatch):
    """The port's server counts ``wire_lossless_fail{side="server"}`` and
    drops the connection, as it does for a CRC32C mismatch: the worker's
    pending requests go to its retry path at once."""
    from byteps_tpu_torch.core.telemetry import counters

    with kits.fleet(monkeypatch, "port", servers=1) as nodes:
        before = counters().snapshot_labeled().get("wire_lossless_fail", {})
        sock = ptr.connect(nodes[0].host, nodes[0].port)
        sock.settimeout(10)
        sock.sendall(_corrupt_container_frame(ptr.Op.PUSH, key=1, seq=1))
        assert sock.recv(1) == b""  # closed, unanswered
        sock.close()
        after = counters().snapshot_labeled()["wire_lossless_fail"]
        lbl = '{op="PUSH",side="server"}'
        assert after[lbl] == before.get(lbl, 0) + 1


def test_a_reply_that_does_not_decode_fails_its_attempt(monkeypatch):
    """The client counts ``wire_lossless_fail{side="client"}`` and fails the
    attempt (with no retry left, the request) with the reason."""
    import threading

    from byteps_tpu_torch.comm.ps_client import PSClient
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core.telemetry import counters

    srv, port = ptr.listen("127.0.0.1", 0)

    def serve():
        conn, _ = srv.accept()
        try:
            msg = ptr.recv_message(conn)
            conn.sendall(_corrupt_container_frame(ptr.Op.PULL, key=msg.key, seq=msg.seq))
            ptr.recv_message(conn)  # until the client closes
        except (ConnectionError, OSError):
            pass
        conn.close()
        srv.close()

    threading.Thread(target=serve, daemon=True).start()
    client = PSClient(Config(num_server=1, rpc_retries=0, resync_deadline_s=0))
    client.num_servers = 1
    client._servers.append(client._new_conn("127.0.0.1", port, "0"))
    before = counters().snapshot_labeled().get("wire_lossless_fail", {})
    done, errors = threading.Event(), []
    client.pull(5, 1, lambda p: done.set(),
                on_error=lambda reason: (errors.append(reason), done.set()))
    assert done.wait(10)
    assert errors and "failed its lossless decode" in errors[0]
    lbl = '{op="PULL",server="0",side="client"}'
    assert counters().snapshot_labeled()["wire_lossless_fail"][lbl] == before.get(lbl, 0) + 1
    client._stop.set()
    for sc in client._servers:
        ptr.close_socket(sc.sock)
