"""Row-sparse push_pull of the port (``api.push_pull_rowsparse``, the
engine's ``submit_rowsparse``, the servers' scatter-sum and gather)
against byteps_tpu's, on the same seeded inputs.

- ``validate_rowsparse``: the same errors with the same messages.
- One worker: the scatter-add and gather of the reference's shortcut.
- Two workers (a port worker and a reference worker at once) against
  port, reference and C++ servers: duplicate indices accumulate, rows no
  worker pushed are reset each round, ``average`` divides; each round's
  rows equal the numpy reckoning bit for bit, and the port's push and
  pull frames equal the reference's byte for byte.
- A server-side optimizer refuses row-sparse; fusion never packs it; a
  replayed push is summed once; a migrated key redirects its row-sparse
  requests; a row-sparse key goes on through a live resize under
  ``BYTEPS_ELASTIC_RESHARD=1``; a local group of more than one process
  raises.
"""

import threading
import types

import numpy as np
import pytest
import torch

import torch_port_kits as kits
from byteps_tpu.common.partition import validate_rowsparse as ref_validate
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.common.partition import validate_rowsparse as port_validate
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type

TOTAL, WIDTH = 40, 16
CMD_RS = get_command_type(RequestType.ROW_SPARSE_PUSH_PULL, int(DataType.FLOAT32))


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


_BAD = {
    "ok": (np.array([0, 3, 3]), np.ones((3, 4)), 4),
    "high": (np.array([0, 4]), np.ones((2, 4)), 4),
    "negative": (np.array([-1]), np.ones((1, 4)), 4),
    "2d_indices": (np.array([[0]]), np.ones((1, 4)), 4),
    "1d_values": (np.array([0]), np.ones(4), 4),
    "count": (np.array([0]), np.ones((2, 4)), 4),
    "empty": (np.zeros(0, np.int64), np.zeros((0, 4)), 4),
}


@pytest.mark.parametrize("case", sorted(_BAD))
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_validation_equals_the_reference(case, as_torch):
    idx, vals, total = _BAD[case]
    try:
        want = ref_validate(idx, vals, total)
    except ValueError as e:
        want = e
    args = (torch.from_numpy(idx), torch.from_numpy(vals)) if as_torch else (idx, vals)
    if isinstance(want, ValueError):
        with pytest.raises(ValueError) as got:
            port_validate(*args, total)
        assert str(got.value) == str(want)
        return
    got_idx, got_vals = port_validate(*args, total)
    assert np.array_equal(np.asarray(got_idx), want[0])
    assert np.asarray(got_vals).dtype == np.float32
    assert np.array_equal(np.asarray(got_vals), want[1])


def _round(rng, n: int) -> tuple:
    """A round's (indices, rows): duplicates included, small integers so
    the sums are exact."""
    idx = rng.integers(0, TOTAL, n)
    idx[-1] = idx[0]
    return idx, rng.integers(-8, 8, (n, WIDTH)).astype(np.float32)


def test_one_worker_scatter_adds_and_gathers_as_the_reference():
    import byteps_tpu as jbps
    import byteps_tpu_torch as pbps

    rng = np.random.default_rng(1)
    pbps.init(device="cpu")
    jbps.init()
    for _ in range(2):
        idx, vals = _round(rng, 9)
        want = jbps.push_pull_rowsparse(idx, vals, "one.emb", TOTAL)
        np.testing.assert_array_equal(pbps.push_pull_rowsparse(idx, vals, "one.emb", TOTAL),
                                      want)
        out = pbps.push_pull_rowsparse(torch.from_numpy(idx), torch.from_numpy(vals),
                                       "one.emb", TOTAL)
        assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), want)
        with pytest.raises(ValueError, match="out of range"):
            pbps.push_pull_rowsparse(idx + TOTAL, vals, "one.emb", TOTAL)


def _expected(rounds_a, rounds_b, average: bool) -> list:
    out = []
    for (ia, va), (ib, vb) in zip(rounds_a, rounds_b):
        dense = np.zeros((TOTAL, WIDTH), np.float32)
        np.add.at(dense, ia, va)
        np.add.at(dense, ib, vb)
        if average:
            dense = dense / np.float32(2)
        out.append((dense[ia], dense[ib]))
    return out


def _tap_pushes(monkeypatch) -> dict:
    """Each package's row-sparse push payloads and pull requests."""
    frames = {"port": [], "ref": []}
    for pkg in frames:
        cls = kits.kit(pkg).PSClient
        orig_push, orig_pull = cls.push, cls.pull

        def push(self, key, payload, *a, _o=orig_push, _pkg=pkg, **kw):
            if int(kw.get("request_type", 0)) == int(RequestType.ROW_SPARSE_PUSH_PULL):
                frames[_pkg].append(("push", bytes(memoryview(payload).cast("B"))))
            return _o(self, key, payload, *a, **kw)

        def pull(self, key, version, cb, *a, _o=orig_pull, _pkg=pkg, **kw):
            if int(kw.get("request_type", 0)) == int(RequestType.ROW_SPARSE_PUSH_PULL):
                frames[_pkg].append(("pull", bytes(kw.get("payload", b""))))
            return _o(self, key, version, cb, *a, **kw)

        monkeypatch.setattr(cls, "push", push)
        monkeypatch.setattr(cls, "pull", pull)
    return frames


@pytest.mark.parametrize("average", [False, True], ids=["sum", "average"])
@pytest.mark.parametrize("server", ["port", "port-native", "ref", "ref-native"])
def test_two_workers_sum_rows_bitwise_against_every_server(monkeypatch, server, average):
    """Three rounds: the port worker pushes torch tensors, the reference
    worker numpy; both get their own rows of the round's sum."""
    if server == "ref-native":
        from conftest import have_native_parity_server

        if not have_native_parity_server():
            pytest.skip("the reference's native server library is not built")
    import byteps_tpu as jbps
    import byteps_tpu_torch as pbps

    rng = np.random.default_rng(2)
    rounds = [[_round(rng, 7 + r) for r in range(3)], [_round(rng, 5 + r) for r in range(3)]]
    want = _expected(*rounds, average)
    frames = _tap_pushes(monkeypatch)
    got: list = [[], []]

    def port_worker():
        pbps.init(device="cpu")
        for idx, vals in rounds[0]:
            out = pbps.push_pull_rowsparse(torch.from_numpy(idx), torch.from_numpy(vals),
                                           "emb.grad", TOTAL, average=average)
            got[0].append(out.numpy().copy())
        pbps.shutdown()

    def ref_worker():
        jbps.init()
        for idx, vals in rounds[1]:
            got[1].append(np.asarray(jbps.push_pull_rowsparse(idx, vals, "emb.grad", TOTAL,
                                                              average=average)))
        jbps.shutdown()

    with kits.fleet(monkeypatch, server, workers=2, servers=2):
        kits.in_threads(port_worker, ref_worker, timeout=60)
    for r, (wa, wb) in enumerate(want):
        assert np.array_equal(got[0][r], wa), r
        assert np.array_equal(got[1][r], wb), r
    # each package's frames encode its own inputs the same way
    for pkg, rs in (("port", rounds[0]), ("ref", rounds[1])):
        assert frames[pkg] == [f for idx, vals in rs
                               for f in (("push", _rs_body(idx, vals)), ("pull", _rs_body(idx)))]


def test_the_frames_equal_the_reference_frames(monkeypatch):
    """One worker of each package, alone against a port fleet, pushes the
    same rows: the push payloads and pull requests are byte-equal."""
    rng = np.random.default_rng(3)
    rounds = [_round(rng, 6) for _ in range(2)]
    frames = _tap_pushes(monkeypatch)
    for pkg in ("port", "ref"):
        with kits.fleet(monkeypatch, "port", servers=1):
            k = kits.kit(pkg)
            kits.init(k)
            for idx, vals in rounds:
                src = (torch.from_numpy(idx), torch.from_numpy(vals)) if pkg == "port" else (
                    idx, vals)
                k.api.push_pull_rowsparse(*src, "frame.emb", TOTAL, average=False)
            k.api.shutdown()
    assert len(frames["port"]) == 4 and frames["port"] == frames["ref"]


def test_a_server_side_optimizer_refuses_row_sparse(monkeypatch):
    got = {}
    for pkg in ("port", "ref"):
        with kits.fleet(monkeypatch, "port" if pkg == "port" else "ref", servers=1):
            k = kits.kit(pkg)
            kits.init(k)
            k.api.declare_tensor("sopt.rs", byteps_server_opt="sgd")
            with pytest.raises(ValueError, match="row-sparse") as e:
                k.api.push_pull_rowsparse_async(np.array([0, 1]), np.zeros((2, 8), np.float32),
                                                name="sopt.rs", total_rows=4)
            got[pkg] = str(e.value)
            k.api.shutdown()
    assert got["port"] == got["ref"]


def test_fusion_never_packs_a_row_sparse_frame(monkeypatch):
    import byteps_tpu_torch as pbps
    from byteps_tpu_torch.core.telemetry import counters

    rng = np.random.default_rng(4)
    with kits.fleet(monkeypatch, "port", servers=1, BYTEPS_FUSION_THRESHOLD="1048576"):
        pbps.init(device="cpu")
        before = counters().get("fused_keys")
        for _ in range(3):
            idx, vals = _round(rng, 4)
            dense = np.zeros((TOTAL, WIDTH), np.float32)
            np.add.at(dense, idx, vals)
            out = pbps.push_pull_rowsparse(idx, vals, "fuse.emb", TOTAL, average=False)
            np.testing.assert_array_equal(out, dense[idx])
        assert counters().get("fused_keys") == before
        small = torch.arange(8, dtype=torch.float32)
        assert torch.equal(pbps.push_pull(small, name="fuse.small", average=False), small)
        assert counters().get("fused_keys") == before + 1  # a dense small one does fuse
        pbps.shutdown()


def _rs_body(idx, vals=None) -> bytes:
    head = np.array([len(idx), WIDTH], ">u4").tobytes() + np.asarray(idx).astype(">u4").tobytes()
    return head + (vals.tobytes() if vals is not None else b"")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_replayed_push_is_summed_once_and_rows_reset(pkg):
    """A resent push (same worker, same round) is acked and not summed
    again; the next round starts with every row at zero; a RESYNC_QUERY
    reports the key's rounds and the worker's last push."""
    import test_torch_port_reshard as rs

    srv = rs.wire_server(pkg, reshard=False)
    w = rs.dial(srv)
    try:
        rs.init_key(w, 1 << 16, TOTAL * WIDTH)
        idx, vals = np.array([2, 9, 2]), np.full((3, WIDTH), 1.5, np.float32)
        for seq in (1, 2):  # the second is a replay
            ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=1 << 16, seq=seq, flags=1,
                                            cmd=CMD_RS, version=1, payload=_rs_body(idx, vals)))
            assert ptr.recv_message(w).op == ptr.Op.PUSH
        ptr.send_message(w, ptr.Message(ptr.Op.PULL, key=1 << 16, seq=3, cmd=CMD_RS,
                                        version=1, payload=_rs_body([2, 9, 5])))
        rows = np.frombuffer(ptr.recv_message(w).payload, np.float32).reshape(3, WIDTH)
        np.testing.assert_array_equal(rows[:, 0], [3.0, 1.5, 0.0])
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=1 << 16, seq=4, flags=1, cmd=CMD_RS,
                                        version=2, payload=_rs_body([5], vals[:1])))
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        ptr.send_message(w, ptr.Message(ptr.Op.PULL, key=1 << 16, seq=5, cmd=CMD_RS,
                                        version=2, payload=_rs_body([2, 9, 5])))
        rows = np.frombuffer(ptr.recv_message(w).payload, np.float32).reshape(3, WIDTH)
        np.testing.assert_array_equal(rows[:, 0], [0.0, 0.0, 1.5])
        assert srv._keys[1 << 16].push_seen == {1: 2}
        # the recovery plane reads a row-sparse key as any other
        ptr.send_message(w, ptr.Message(ptr.Op.RESYNC_QUERY, seq=6, payload=(
            ptr.encode_resync_query(1, [1 << 16]))))
        state = ptr.decode_resync_state(ptr.recv_message(w).payload)
        assert state == {1 << 16: {"store_version": 2, "seen": 2, "recv_count": 0,
                                   "init": True}}
    finally:
        ptr.close_socket(w)
        srv.stop()


@pytest.mark.parametrize("old,new", [("port", "ref"), ("ref", "port")])
def test_a_migrated_key_redirects_row_sparse_requests(old, new):
    """A row-sparse key is one partition of the dense store: it migrates
    whole; the old owner answers its row-sparse push WRONG_OWNER with the
    map epoch, the new one sums it onto the migrated rounds."""
    import test_torch_port_reshard as rs

    a, b = rs.wire_server(old, rank=0), rs.wire_server(new, rank=1)
    key = rs.key_owned_by(1, [0, 1])
    vals = np.full((2, WIDTH), 2.0, np.float32)
    w = rs.dial(a)
    wb = None
    try:
        rs.init_key(w, key, TOTAL * WIDTH)
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=1, flags=1, cmd=CMD_RS,
                                        version=1, payload=_rs_body([1, 4], vals)))
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        b._adopt_book(rs.book(2, [0, 1], servers))
        a._adopt_book(rs.book(2, [0, 1], servers))
        assert kits.wait(lambda: rs.landed(b, key))
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=2, flags=1, cmd=CMD_RS,
                                        version=2, payload=_rs_body([4], vals[:1])))
        reply = ptr.recv_message(w)
        assert reply.op == ptr.Op.WRONG_OWNER and reply.version == 2
        wb = rs.dial(b)
        ptr.send_message(wb, ptr.Message(ptr.Op.PUSH, key=key, seq=3, flags=1, cmd=CMD_RS,
                                         version=2, payload=_rs_body([4], vals[:1])))
        assert ptr.recv_message(wb).op == ptr.Op.PUSH
        ptr.send_message(wb, ptr.Message(ptr.Op.PULL, key=key, seq=4, cmd=CMD_RS, version=2,
                                         payload=_rs_body([1, 4])))
        rows = np.frombuffer(ptr.recv_message(wb).payload, np.float32).reshape(2, WIDTH)
        np.testing.assert_array_equal(rows[:, 0], [0.0, 2.0])
    finally:
        for s in (w, wb):
            ptr.close_socket(s)
        a.stop()
        b.stop()


def test_a_row_sparse_key_goes_on_through_a_live_resize(monkeypatch):
    """One worker and two port servers under resharding; after round 2 the
    job scales to three servers (the new one joins) and the rounds go on,
    every round's rows exact."""
    import byteps_tpu_torch as pbps

    k = kits.kit("port")
    rng = np.random.default_rng(5)
    with kits.fleet(monkeypatch, "port", servers=2, BYTEPS_ELASTIC_RESHARD="1",
                    BYTEPS_HEARTBEAT_INTERVAL="0.1") as nodes:
        pbps.init(device="cpu")
        extra = None
        try:
            for r in range(5):
                if r == 2:
                    t = threading.Thread(target=pbps.resume, kwargs={"num_servers": 3},
                                         daemon=True)
                    t.start()
                    monkeypatch.setenv("DMLC_NUM_SERVER", "3")
                    extra = kits.start_server(k, k.Config.from_env())
                    t.join(20)
                    assert not t.is_alive()
                idx, vals = _round(rng, 6)
                dense = np.zeros((TOTAL, WIDTH), np.float32)
                np.add.at(dense, idx, vals)
                out = pbps.push_pull_rowsparse(torch.from_numpy(idx), torch.from_numpy(vals),
                                               "resize.emb", TOTAL, average=False)
                np.testing.assert_array_equal(out.numpy(), dense[idx])
            from byteps_tpu_torch.core.state import get_state

            assert get_state().ps_client.server_generation == 0  # no re-init barrier
            pbps.shutdown()
        finally:
            if extra is not None:
                nodes.append(extra)


def test_a_local_group_raises(monkeypatch):
    import byteps_tpu_torch as pbps
    from byteps_tpu_torch import api

    pbps.init(device="cpu")
    monkeypatch.setattr(api, "get_global_mesh", lambda: types.SimpleNamespace(size=2))
    with pytest.raises(NotImplementedError, match="local size 2"):
        pbps.push_pull_rowsparse(np.array([0]), np.ones((1, 2), np.float32), "group.emb", 4)
