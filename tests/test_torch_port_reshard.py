"""Online resharding of the port against byteps_tpu's (the cases of
``tests/test_reshard.py``): the ownership ring and its C++ twin, the
MIGRATE_STATE and WRONG_OWNER frames, the migration wire between servers
of either package in both directions, the server-side Adam state across a
migration, the workers' chase of a redirect and the C++ server's
ownership check.  The fleets (the port's scheduler driving a scale-up and
a drain, mixed hashing, the engine through a resize) are in
``test_torch_port_reshard_fleets.py``.  Inputs come from numpy seeds;
every comparison is exact."""

import struct
import threading
import time

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.comm import transport as rtr
from byteps_tpu.common import hashing as rhash
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.common import hashing as phash
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type

F32 = int(DataType.FLOAT32)
CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, F32)
PKGS = ["port", "ref"]
PAIRS = [(a, b) for a in PKGS for b in PKGS]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def key_owned_by(rank: int, ranks, vnodes: int = 64, start: int = 0) -> int:
    """The smallest partition key (a declared key << 16) the ring homes on
    ``rank``."""
    ring = phash.HashRing(ranks, vnodes=vnodes)
    for k in range(start, start + (1 << 12)):
        if ring.owner(k << 16) == rank:
            return k << 16
    raise AssertionError(f"no key owned by rank {rank}")


def wire_server(pkg: str, reshard: bool = True, rank: int = 0, workers: int = 1):
    """A server of ``pkg`` serving with no scheduler, as rank ``rank``."""
    k = kits.kit(pkg)
    srv = k.PSServer(k.Config(num_worker=workers, num_server=1, elastic_reshard=reshard))
    srv.start(register=False)
    srv.rank = rank
    return srv


def book(epoch: int, ranks, servers, drain: bool = False) -> dict:
    b = {"map_epoch": epoch, "server_ranks": list(ranks),
         "servers": [list(s) for s in servers]}
    if drain:
        b["drain"] = True
    return b


def dial(srv):
    sock = ptr.connect("127.0.0.1", srv.port)
    sock.settimeout(15)
    return sock


def init_key(sock, key: int, n: int, token: int = 77, payload: bytes = b"") -> None:
    ptr.send_message(sock, ptr.Message(ptr.Op.INIT, key=key, seq=100, flags=1, version=token,
                                       payload=payload or struct.pack("!QI", n, F32)))
    reply = ptr.recv_message(sock)
    assert reply.op == ptr.Op.INIT and reply.status == 0


def push(sock, key: int, version: int, arr: np.ndarray, seq: int = 1):
    ptr.send_message(sock, ptr.Message(ptr.Op.PUSH, key=key, seq=seq, flags=1, cmd=CMD_F32,
                                       version=version, payload=arr.tobytes()))
    return ptr.recv_message(sock)


def pull(sock, key: int, version: int, seq: int = 2) -> np.ndarray:
    ptr.send_message(sock, ptr.Message(ptr.Op.PULL, key=key, seq=seq, cmd=CMD_F32,
                                       version=version))
    reply = ptr.recv_message(sock)
    assert reply.op == ptr.Op.PULL, reply.op
    return np.frombuffer(reply.payload, np.float32)


def landed(srv, key: int) -> bool:
    ks = srv._keys.get(key)
    return ks is not None and ks.store is not None and ks.migrated_to is None


# --- the ring ---------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [64, 8])
@pytest.mark.parametrize("ranks", [(0, 1), (0, 1, 2), (0, 2)])
def test_ring_ownership_equals_the_reference(ranks, vnodes):
    keys = np.random.default_rng(5).integers(0, 1 << 40, 10_000).tolist()
    pr, rr = phash.HashRing(ranks, vnodes), rhash.HashRing(ranks, vnodes)
    assert pr.points() == rr.points()
    assert [pr.owner(k) for k in keys] == [rr.owner(k) for k in keys]
    over = {keys[0]: ranks[-1], keys[1]: 7}  # a rank off the map is dropped
    pm = phash.OwnershipMap(ranks, epoch=3, vnodes=vnodes, overrides=over)
    rm = rhash.OwnershipMap(ranks, epoch=3, vnodes=vnodes, overrides=over)
    assert pm.epoch == 3 and pm.ranks == rm.ranks and pm.overrides == rm.overrides
    assert [pm.owner(k) for k in keys[:2000]] == [rm.owner(k) for k in keys[:2000]]
    if ranks == (0, 1, 2):
        n = len(ranks)
        assert ([phash.assign_server(k, n, fn="ring", ring_vnodes=vnodes) for k in keys[:2000]]
                == [rhash.assign_server(k, n, fn="ring", ring_vnodes=vnodes)
                    for k in keys[:2000]])


def test_ring_key_hash_equals_the_reference_and_the_cxx_twin():
    from byteps_tpu_torch import native

    keys = [0, 1, 65536, 1 << 40, (1 << 64) - 1] + np.random.default_rng(6).integers(
        0, 1 << 62, 500).tolist()
    for k in keys:
        h = phash.ring_key_hash(k)
        assert h == rhash.ring_key_hash(k) == native.ring_key_hash(k)


def test_adding_a_rank_moves_only_its_arcs():
    keys = [k << 16 for k in range(4000)]
    two, three = phash.HashRing([0, 1]), phash.HashRing([0, 1, 2])
    moved = [k for k in keys if two.owner(k) != three.owner(k)]
    assert moved and all(three.owner(k) == 2 for k in moved)
    assert 0.2 < len(moved) / len(keys) < 0.5


# --- the frames -------------------------------------------------------------


def test_migrate_state_frames_equal_the_reference():
    rng = np.random.default_rng(8)
    store = rng.standard_normal(16).astype(np.float32).tobytes()
    accum = rng.standard_normal(16).astype(np.float32).tobytes()
    meta = {"key": 5 << 16, "epoch": 4, "dtype": "float32", "store_version": 3,
            "push_seen": {"1": 3}, "init_done": {"1": 77}, "store_nbytes": len(store),
            "accum_nbytes": len(accum), "opt_slot_nbytes": [8]}
    body = ptr.encode_migrate_state(meta, store, accum) + b"12345678"
    assert body == rtr.encode_migrate_state(meta, store, accum) + b"12345678"
    assert ptr.decode_migrate_state(body) == rtr.decode_migrate_state(body)
    assert ptr.decode_migrate_state(body) == (meta, store, accum)
    assert ptr.decode_migrate_extra(body, meta) == rtr.decode_migrate_extra(body, meta)
    assert ptr.decode_migrate_extra(body, meta) == b"12345678"
    assert ptr.encode_wrong_owner(9, 2) == rtr.encode_wrong_owner(9, 2)
    assert ptr.decode_wrong_owner(ptr.encode_wrong_owner(9, 2)) == (9, 2)
    for bad in (b"", b"not json", b"[1]"):
        assert ptr.decode_wrong_owner(bad) == rtr.decode_wrong_owner(bad) == (0, -1)


@pytest.mark.parametrize("cut", [2, 10, -1])
def test_a_truncated_migrate_frame_raises(cut):
    store = np.arange(8, dtype=np.float32).tobytes()
    body = ptr.encode_migrate_state({"key": 1, "store_nbytes": len(store),
                                     "accum_nbytes": 0}, store)
    for mod in (ptr, rtr):
        with pytest.raises(ValueError, match="migrate frame"):
            mod.decode_migrate_state(body[:cut])


# --- the migration wire ------------------------------------------------------


@pytest.mark.parametrize("old,new", PAIRS)
def test_migration_moves_state_redirects_and_dedupes(old, new):
    """The old owner's store, ledger and init tokens land bitwise at the
    new owner; a stale push is redirected with the map epoch; a replay of a
    round the old owner summed is deduped there; the rounds go on."""
    a, b = wire_server(old, rank=0), wire_server(new, rank=1)
    key = key_owned_by(1, [0, 1])
    g1, g2, g3 = kits.vals(11, 16, 3)
    w = dial(a)
    wb = None
    try:
        init_key(w, key, 16)
        for ver, g in ((1, g1), (2, g2)):
            assert push(w, key, ver, g).op == ptr.Op.PUSH
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        b._adopt_book(book(2, [0, 1], servers))
        a._adopt_book(book(2, [0, 1], servers))
        assert kits.wait(lambda: landed(b, key)), "the migration never landed"
        st = b._keys[key]
        assert st.store_version == 2 and st.push_seen.get(1) == 2
        assert st.init_done.get(1) == 77
        np.testing.assert_array_equal(st.store, g2)
        # the old owner frees its copy only once it has read the new
        # owner's ack, which may come after the landing
        assert kits.wait(lambda: a._keys[key].store is None), "the old copy was never freed"
        assert a._keys[key].migrated_to == 1 and a._keys[key].store is None
        reply = push(w, key, 3, g1, seq=9)
        assert reply.op == ptr.Op.WRONG_OWNER and reply.version == 2
        assert ptr.decode_wrong_owner(reply.payload) == (2, 1)
        wb = dial(b)
        assert push(wb, key, 2, g2, seq=10).op == ptr.Op.PUSH  # summed at a: deduped
        np.testing.assert_array_equal(pull(wb, key, 2, seq=11), g2)
        assert push(wb, key, 3, g3, seq=12).op == ptr.Op.PUSH
        np.testing.assert_array_equal(pull(wb, key, 3, seq=13), g3)
    finally:
        for s in (w, wb):
            ptr.close_socket(s)
        a.stop()
        b.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_fused_frame_is_redirected_once_as_a_whole(pkg):
    a = wire_server(pkg, rank=0)
    key = key_owned_by(1, [0, 1])
    w = dial(a)
    try:
        a._adopt_book(book(2, [0, 1], [("127.0.0.1", a.port), ("127.0.0.1", 1)]))
        mine = key_owned_by(0, [0, 1])
        init_key(w, mine, 8)
        g = np.ones(8, np.float32)
        frame = ptr.encode_fused_push([(mine, CMD_F32, 1, g.tobytes()),
                                       (key, CMD_F32, 1, g.tobytes())])
        ptr.send_message(w, ptr.Message(ptr.Op.FUSED, key=mine, seq=44, flags=1, cmd=2,
                                        payload=frame))
        reply = ptr.recv_message(w)
        assert reply.op == ptr.Op.WRONG_OWNER and reply.seq == 44
        assert ptr.decode_wrong_owner(reply.payload) == (2, 1)
        # the member summed before the redirect is in the ledger: its
        # per-key resend is acked without a second sum
        assert push(w, mine, 1, g, seq=45).op == ptr.Op.PUSH
        np.testing.assert_array_equal(pull(w, mine, 1, seq=46), g)
    finally:
        ptr.close_socket(w)
        a.stop()


@pytest.mark.parametrize("sender,receiver", PAIRS)
def test_a_request_parks_until_the_migration_lands(sender, receiver):
    """The new owner holds a push for a key whose state is on its way, and
    takes it when the shipment (encoded by either package) lands."""
    b = wire_server(receiver, rank=1)
    key = key_owned_by(1, [0, 1])
    g = np.full(8, 2.0, np.float32)
    b._adopt_book(book(2, [0, 1], [("127.0.0.1", 1), ("127.0.0.1", b.port)]))
    w, peer = dial(b), dial(b)
    try:
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=1, flags=1, cmd=CMD_F32,
                                        version=2, payload=g.tobytes()))
        w.settimeout(0.3)
        with pytest.raises(TimeoutError):
            ptr.recv_message(w)  # parked: neither acked nor dropped
        w.settimeout(15)
        store = np.arange(8, dtype=np.float32)
        meta = {"key": key, "epoch": 2, "dtype": "float32", "store_version": 1,
                "recv_count": 0, "push_seen": {"1": 1}, "init_done": {},
                "compressor_kwargs": {}, "store_nbytes": store.nbytes, "accum_nbytes": 0}
        enc = (ptr if sender == "port" else rtr).encode_migrate_state
        ptr.send_message(peer, ptr.Message(ptr.Op.MIGRATE_STATE, key=key, version=2,
                                           payload=enc(meta, store.tobytes())))
        assert ptr.recv_message(peer).status == 0
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        np.testing.assert_array_equal(pull(w, key, 2), g)
    finally:
        ptr.close_socket(w)
        ptr.close_socket(peer)
        b.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_an_evicted_previous_owner_is_not_waited_for(pkg):
    """Rank 0 left the map with no drain: nothing will ship, so a push of a
    key this server never held drops the connection at once (the worker's
    re-init path owns the key)."""
    b = wire_server(pkg, rank=1)
    key = key_owned_by(0, [0, 1])
    b._adopt_book(book(2, [0, 1], [("127.0.0.1", 1), ("127.0.0.1", b.port)]))
    b._adopt_book(book(3, [1], [("127.0.0.1", b.port)]))
    w = dial(b)
    w.settimeout(5)
    try:
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=1, flags=1, cmd=CMD_F32,
                                        version=1, payload=np.ones(4, np.float32).tobytes()))
        with pytest.raises(ConnectionError):
            ptr.recv_message(w)  # dropped, not parked until the timeout
    finally:
        ptr.close_socket(w)
        b.stop()


def test_a_draining_previous_owner_is_waited_for():
    """The port's books name the ranks that leave by a drain (alive, and
    shipping): their keys' new owners park requests, where byteps_tpu's
    drop them into the worker's retry path (ROADMAP.md Queue 3)."""
    b = wire_server("port", rank=1)
    key = key_owned_by(0, [0, 1])
    b._adopt_book(book(2, [0, 1], [("127.0.0.1", 1), ("127.0.0.1", b.port)]))
    b._adopt_book(dict(book(3, [1], [("127.0.0.1", b.port)]), draining=[0]))
    w = dial(b)
    try:
        ptr.send_message(w, ptr.Message(ptr.Op.PULL, key=key, seq=1, cmd=CMD_F32, version=0))
        w.settimeout(0.3)
        with pytest.raises(TimeoutError):
            ptr.recv_message(w)
        assert key in b._awaiting
    finally:
        ptr.close_socket(w)
        b.stop()


def test_a_key_drained_back_parks_at_its_old_owner():
    """A key shipped away and homed here again by a newer map (its new
    owner drains) parks its requests until it lands, where byteps_tpu's
    server redirects them to the draining server, which redirects them
    back (ROADMAP.md Queue 3); the parked push then sums once."""
    a, b = wire_server("port", rank=0), wire_server("port", rank=1)
    key = key_owned_by(1, [0, 1])
    g1, g2 = kits.vals(14, 8, 2)
    w = dial(a)
    try:
        init_key(w, key, 8)
        assert push(w, key, 1, g1).op == ptr.Op.PUSH
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        b._adopt_book(book(2, [0, 1], servers))
        a._adopt_book(book(2, [0, 1], servers))
        assert kits.wait(lambda: landed(b, key))
        a._adopt_book(dict(book(3, [0], servers[:1]), draining=[1]))
        ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=2, flags=1, cmd=CMD_F32,
                                        version=2, payload=g2.tobytes()))
        w.settimeout(0.3)
        with pytest.raises(TimeoutError):
            ptr.recv_message(w)  # parked, not redirected to the drained rank
        w.settimeout(15)
        b._adopt_book(book(3, [0], servers[:1], drain=True))
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        assert kits.wait(lambda: b._stop.is_set())
        np.testing.assert_array_equal(pull(w, key, 2, seq=3), g2)
        assert a._keys[key].push_seen[1] == 2 and a._keys[key].migrated_to is None
    finally:
        ptr.close_socket(w)
        a.stop()
        b.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_live_key_refuses_a_shipment_as_complete(pkg):
    srv = wire_server(pkg, rank=0)
    key = key_owned_by(0, [0])
    live = np.full(8, 2.0, np.float32)
    w = dial(srv)
    try:
        srv._adopt_book(book(3, [0], [("127.0.0.1", srv.port)]))
        init_key(w, key, 8)
        assert push(w, key, 1, live).op == ptr.Op.PUSH
        stale = np.full(8, 9.0, np.float32)
        ptr.send_message(w, ptr.Message(ptr.Op.MIGRATE_STATE, key=key, version=2,
                                        payload=ptr.encode_migrate_state(
                                            {"key": key, "epoch": 2, "dtype": "float32",
                                             "store_version": 40, "store_nbytes": stale.nbytes,
                                             "accum_nbytes": 0}, stale.tobytes())))
        reply = ptr.recv_message(w)
        assert reply.op == ptr.Op.MIGRATE_STATE and reply.status == 3
        assert srv._keys[key].store_version == 1
        np.testing.assert_array_equal(srv._keys[key].store, live)
    finally:
        ptr.close_socket(w)
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_shipment_is_refused_with_resharding_off(pkg):
    srv = wire_server(pkg, reshard=False)
    w = dial(srv)
    try:
        ptr.send_message(w, ptr.Message(ptr.Op.MIGRATE_STATE, key=5, version=1,
                                        payload=ptr.encode_migrate_state(
                                            {"key": 5, "store_nbytes": 0,
                                             "accum_nbytes": 0})))
        reply = ptr.recv_message(w)
        assert reply.op == ptr.Op.MIGRATE_STATE and reply.status == 1
    finally:
        ptr.close_socket(w)
        srv.stop()


# --- the server-side optimizer's state ---------------------------------------


@pytest.mark.parametrize("old,new", PAIRS)
def test_adam_state_migrates_and_the_trajectory_stays_bitwise(old, new):
    """Seed round and two Adam rounds at the old owner, then the
    migration, then two rounds at the new owner: the parameters equal the
    rule applied locally, bit for bit, and a replay of a round the old
    owner applied does not fire the rule again."""
    from byteps_tpu_torch.server import update_rules as prules

    a, b = wire_server(old, rank=0), wire_server(new, rank=1)
    key = key_owned_by(1, [0, 1])
    n, hp = 32, {"lr": 0.002}
    rng = np.random.default_rng(21)
    x0 = rng.standard_normal(n).astype(np.float32)
    grads = [x0] + [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    ref = prules.make_rule("adam", hp, n, np.float32)
    expect = [x0.copy()]
    for t, g in enumerate(grads[1:], start=1):
        p = expect[-1].copy()
        ref.apply(p, g, 1, t)
        expect.append(p)
    payload = (struct.pack("!QI", n, F32) + struct.pack("!Bi", ptr.PROFILE_SERVER_OPT, -1)
               + ptr.encode_server_opt_block("adam", prules.canonical_hp(hp)))
    w = dial(a)
    wb = None
    try:
        init_key(w, key, n, payload=payload)
        for ver in (1, 2, 3):
            assert push(w, key, ver, grads[ver - 1]).op == ptr.Op.PUSH
        np.testing.assert_array_equal(pull(w, key, 3), expect[2])
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        b._adopt_book(book(2, [0, 1], servers))
        a._adopt_book(book(2, [0, 1], servers))
        assert kits.wait(lambda: landed(b, key))
        st = b._keys[key]
        assert kits.wait(lambda: a._keys[key].opt_rule is None), "the old rule was never freed"
        assert st.opt_step == 3 and a._keys[key].opt_rule is None
        wb = dial(b)
        for ver in (4, 5):
            assert push(wb, key, ver, grads[ver - 1], seq=ver).op == ptr.Op.PUSH
            np.testing.assert_array_equal(pull(wb, key, ver, seq=ver + 10), expect[ver - 1])
        step = b._keys[key].opt_step
        assert push(wb, key, 3, grads[2], seq=30).op == ptr.Op.PUSH  # replayed
        assert b._keys[key].opt_step == step
        np.testing.assert_array_equal(b._keys[key].store, expect[4])
    finally:
        for s in (w, wb):
            ptr.close_socket(s)
        a.stop()
        b.stop()


# --- the workers' chase -----------------------------------------------------


def _stale_client(a):
    """A port worker that knows one server (rank 0) under map epoch 1."""
    from byteps_tpu_torch.comm.ps_client import PSClient
    from byteps_tpu_torch.common.config import Config

    pc = PSClient(Config(num_worker=1, num_server=2, elastic_reshard=True, rpc_retries=4,
                         rpc_deadline_s=2.0))
    pc.rank, pc.num_servers = 0, 1
    pc._servers = [pc._new_conn("127.0.0.1", a.port, "0")]
    pc._server_addrs = [("127.0.0.1", a.port)]
    pc._install_routing(pc._servers, [0], phash.OwnershipMap([0], epoch=1))
    return pc


def _deliver_book(pc, b, delay: float = 0.3) -> None:
    """The epoch-2 book reaching the stale worker late."""
    def run():
        time.sleep(delay)
        pc._servers = [pc._servers[0], pc._new_conn("127.0.0.1", b.port, "1")]
        pc._server_addrs.append(("127.0.0.1", b.port))
        pc._install_routing(pc._servers, [0, 1], phash.OwnershipMap([0, 1], epoch=2))

    threading.Thread(target=run, daemon=True).start()


@pytest.mark.parametrize("pkg", PKGS)
def test_an_async_push_chases_the_redirect(pkg):
    from byteps_tpu_torch.core.telemetry import counters

    a, b = wire_server(pkg, rank=0), wire_server(pkg, rank=1)
    key = key_owned_by(1, [0, 1])
    g1, g2 = kits.vals(12, 8, 2)
    w = dial(a)
    pc = None
    try:
        init_key(w, key, 8)
        assert push(w, key, 1, g1).op == ptr.Op.PUSH
        servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        a._adopt_book(book(2, [0, 1], servers))
        b._adopt_book(book(2, [0, 1], servers))
        assert kits.wait(lambda: landed(b, key))
        before = counters().get("wrong_owner_redirect")
        pc = _stale_client(a)
        done, errors = threading.Event(), []
        pc.push(key, g2.tobytes(), F32, 2, cb=done.set,
                on_error=lambda why: (errors.append(why), done.set()))
        _deliver_book(pc, b)
        assert done.wait(15) and not errors, errors
        assert counters().get("wrong_owner_redirect") > before
        assert b._keys[key].store_version == 2
        np.testing.assert_array_equal(b._keys[key].store, g2)
        assert pc.server_generation == 0 and pc.map_epoch == 2
    finally:
        if pc is not None:
            pc.close()
        ptr.close_socket(w)
        a.stop()
        b.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_blocking_init_chases_the_redirect(pkg):
    a, b = wire_server(pkg, rank=0), wire_server(pkg, rank=1)
    key = key_owned_by(1, [0, 1])
    servers = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
    a._adopt_book(book(2, [0, 1], servers))
    b._adopt_book(book(2, [0, 1], servers))
    pc = _stale_client(a)
    try:
        _deliver_book(pc, b)
        pc.init_tensor(key, 8, F32)
        assert landed(b, key)
        assert key not in a._keys or a._keys[key].store is None
    finally:
        pc.close()
        a.stop()
        b.stop()


def test_a_fused_push_does_not_chase():
    """A fused frame answered WRONG_OWNER fails its request (the engine
    sends the members again unfused, each routed on its own)."""
    a, b = wire_server("port", rank=0), wire_server("port", rank=1)
    key = key_owned_by(1, [0, 1])
    a._adopt_book(book(2, [0, 1], [("127.0.0.1", a.port), ("127.0.0.1", b.port)]))
    pc = _stale_client(a)
    try:
        done, errors = threading.Event(), []
        pc.push_fused([(key, CMD_F32, 1, np.ones(4, np.float32).tobytes())],
                      cb=lambda r: done.set(),
                      on_error=lambda why: (errors.append(why), done.set()))
        assert done.wait(10) and errors and "fused frame does not chase" in errors[0]
    finally:
        pc.close()
        a.stop()
        b.stop()


# --- the C++ server ---------------------------------------------------------


def _native_server(rank: int = 0):
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.server.native import NativePSServer

    srv = NativePSServer(Config(num_worker=1, num_server=1, elastic_reshard=True))
    srv.start(register=False)
    srv.rank = rank
    return srv


def test_the_native_server_redirects_under_a_map():
    srv = _native_server()
    mine, theirs = key_owned_by(0, [0, 1]), key_owned_by(1, [0, 1])
    other = key_owned_by(1, [0, 1], start=2048)
    g = np.arange(8, dtype=np.float32)
    w = dial(srv)
    try:
        init_key(w, theirs, 8)  # held before the map: served after it
        srv._adopt_book(book(5, [0, 1], [("127.0.0.1", srv.port), ("127.0.0.1", 1)]))
        assert push(w, theirs, 1, g).op == ptr.Op.PUSH
        init_key(w, mine, 8)
        assert push(w, mine, 1, g, seq=2).op == ptr.Op.PUSH
        reply = push(w, other, 1, g, seq=3)
        assert reply.op == ptr.Op.WRONG_OWNER and reply.version == 5
        assert ptr.decode_wrong_owner(reply.payload) == (5, 1)
        ptr.send_message(w, ptr.Message(ptr.Op.PULL, key=other, seq=4, cmd=CMD_F32,
                                        version=1))
        assert ptr.recv_message(w).op == ptr.Op.WRONG_OWNER
        frame = ptr.encode_fused_push([(other, CMD_F32, 1, g.tobytes())])
        ptr.send_message(w, ptr.Message(ptr.Op.FUSED, key=other, seq=31, flags=1, cmd=1,
                                        payload=frame))
        reply = ptr.recv_message(w)
        assert reply.op == ptr.Op.WRONG_OWNER and reply.seq == 31
        assert srv.native_counters()["native_wrong_owner"] >= 3
    finally:
        ptr.close_socket(w)
        srv.stop()


def test_the_native_server_refuses_a_drain_and_stays_up():
    srv = _native_server(rank=1)
    key = key_owned_by(1, [0, 1])
    g = np.arange(8, dtype=np.float32)
    w = dial(srv)
    try:
        srv._adopt_book(book(2, [0, 1], [("127.0.0.1", 1), ("127.0.0.1", srv.port)]))
        init_key(w, key, 8)
        assert push(w, key, 1, g).op == ptr.Op.PUSH
        srv._adopt_book(book(3, [0], [("127.0.0.1", 1)], drain=True))
        assert srv.drain_refused and not srv._stop.is_set()
        np.testing.assert_array_equal(pull(w, key, 1), g)  # still authoritative
    finally:
        ptr.close_socket(w)
        srv.stop()
