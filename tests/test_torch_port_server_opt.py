"""The port's server-side optimizer against byteps_tpu's.

- The INIT profile extension (the async and server-optimizer bits, the
  staleness bound and the rule block) equals byteps_tpu's bytes.
- The port's own copy of ``update_rules`` steps bitwise as byteps_tpu's.
- On raw sockets, two workers' trajectories through the port's server are
  bitwise a worker applying the same rule (an independent numpy version of
  the worker engine's order: divide, then update) for sgd, momentum and
  adam, fused and unfused; Adam's fixed-seed trajectory equals the digest
  byteps_tpu's tests froze.
- An unknown rule fails at declare, and a server refuses it cleanly (status
  1, counted, the stream still framed); a re-init without the profile
  returns the key to summing; the port's C++ engine refuses the profile and
  counts it, and a worker against it raises.
- Through the engine: declare kwargs, the process-wide knobs (and a
  per-tensor opt-out), mixed fleets of the two packages, and
  DistributedOptimizer(server_side=True) bitwise byteps_tpu's
  ``server_step``."""

import contextlib
import hashlib
import struct
import threading

import jax
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.comm import transport as rtr
from byteps_tpu.comm.rendezvous import Scheduler as RefScheduler
from byteps_tpu.server import update_rules as ref_rules
from byteps_tpu.server.server import PSServer as RefServer
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import DataType, RequestType, get_command_type
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.telemetry import counters
from byteps_tpu_torch.server import update_rules
from byteps_tpu_torch.server.native import NativePSServer
from byteps_tpu_torch.server.server import PSServer as PortServer
from test_server_opt import ADAM_FROZEN_DIGEST

CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, int(DataType.FLOAT32))
F32 = int(DataType.FLOAT32)
KEY_A, KEY_B, N = 7, 9, 64


@pytest.fixture(autouse=True)
def _reset_port_runtime(monkeypatch):
    for k in ("BYTEPS_WIRE_CHECKSUM", "BYTEPS_SERVER_OPT", "BYTEPS_SERVER_OPT_HP",
              "BYTEPS_FUSION_THRESHOLD", "BYTEPS_SERVER_NATIVE", "BYTEPS_VAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


# --- the INIT profile and the rules ---------------------------------------------


def _ref_init_payload(n, dtype_id, async_profile, staleness, rule, hp) -> bytes:
    """byteps_tpu's INIT body (comm/ps_client.py init_tensor)."""
    payload = struct.pack("!QI", n, dtype_id)
    profile = (1 if async_profile else 0) | (2 if rule else 0)
    if profile:
        payload += struct.pack("!Bi", profile, int(staleness))
    if rule:
        payload += rtr.encode_server_opt_block(rule, ref_rules.canonical_hp(hp or {}))
    return payload


@pytest.mark.parametrize("async_profile,staleness,rule,hp", [
    (False, -1, None, None),
    (True, -1, None, None),
    (True, 3, None, None),
    (False, -1, "sgd", {"lr": 0.5}),
    (False, -1, "adam", {"lr": 1e-4, "b2": 0.99, "average": True}),
    (True, 0, "momentum", {"momentum": 0.8}),
])
def test_init_profile_equals_the_reference(async_profile, staleness, rule, hp):
    profile = (ptr.PROFILE_ASYNC if async_profile else 0) | (
        ptr.PROFILE_SERVER_OPT if rule else 0)
    block = ptr.encode_server_opt_block(rule, update_rules.canonical_hp(hp)) if rule else b""
    got = ptr.encode_init(1000, F32, profile, staleness, block)
    assert got == _ref_init_payload(1000, F32, async_profile, staleness, rule, hp)
    assert ptr.decode_init_profile(got) == ((profile, staleness) if profile else (0, -1))
    if rule:
        name, raw = ptr.decode_server_opt_block(got, ptr.RULE_BLOCK_OFFSET)
        assert (name, update_rules.parse_hp(raw)) == (rule, hp)
        with pytest.raises(ValueError, match="truncated"):
            ptr.decode_server_opt_block(got[:-1], ptr.RULE_BLOCK_OFFSET)


@pytest.mark.parametrize("rule,hp", [("sgd", {"lr": 0.05}), ("momentum", {"momentum": 0.7}),
                                     ("adam", {"lr": 0.002}), ("adam", {"average": False})])
def test_update_rules_step_bitwise_as_the_reference(rule, hp):
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(333).astype(np.float32)
    mine, theirs = x0.copy(), x0.copy()
    a = update_rules.make_rule(rule, hp, x0.size, np.float32)
    b = ref_rules.make_rule(rule, hp, x0.size, np.float32)
    for t in range(1, 6):
        g = rng.standard_normal(333).astype(np.float32)
        a.apply(mine, g, 3, t)
        b.apply(theirs, g, 3, t)
        assert mine.tobytes() == theirs.tobytes()
    assert update_rules.same_config(a, rule, hp) and not update_rules.same_config(a, "sgd", {})
    assert a.state_nbytes() == 4 * x0.size * {"sgd": 0, "momentum": 1, "adam": 2}[rule]


def test_a_rule_needs_a_floating_store():
    with pytest.raises(ValueError, match="floating"):
        update_rules.make_rule("sgd", {}, 4, np.int32)
    with pytest.raises(ValueError, match="unknown server update rule"):
        update_rules.make_rule("adagrad", {}, 4, np.float32)


# --- on raw sockets ---------------------------------------------------------------


class _WorkerSideRef:
    """A worker applying the rule to the pulled sum, in the worker engine's
    order (divide, then the update), written apart from update_rules."""

    def __init__(self, rule, hp, x0):
        self.rule = rule
        self.lr = np.float32(hp.get("lr", 0.001 if rule == "adam" else 0.01))
        self.params = x0.copy()
        self.m = np.zeros_like(x0)
        self.v = np.zeros_like(x0)
        self.mu = np.float32(hp.get("momentum", 0.9))
        self.b1, self.b2 = np.float32(hp.get("b1", 0.9)), np.float32(hp.get("b2", 0.999))
        self.eps = np.float32(hp.get("eps", 1e-8))
        self.t = 0

    def step(self, grad_sum, num_workers):
        grad = grad_sum / num_workers
        self.t += 1
        if self.rule == "sgd":
            self.params -= self.lr * grad
        elif self.rule == "momentum":
            np.multiply(self.m, self.mu, out=self.m)
            self.m += grad
            self.params -= self.lr * self.m
        else:
            one = np.float32(1)
            np.multiply(self.m, self.b1, out=self.m)
            self.m += (one - self.b1) * grad
            np.multiply(self.v, self.b2, out=self.v)
            self.v += (one - self.b2) * (grad * grad)
            m_hat = self.m / (one - self.b1 ** np.float32(self.t))
            v_hat = self.v / (one - self.b2 ** np.float32(self.t))
            self.params -= self.lr * (m_hat / (np.sqrt(v_hat) + self.eps))
        return self.params


def _opt_init_payload(n, rule, hp=None, async_profile=False, staleness=-1):
    return _ref_init_payload(n, F32, async_profile, staleness, rule, hp)


def _send(sock, op, key, seq, flag=0, version=0, arr=None, payload=b"", cmd=CMD_F32):
    ptr.send_message(sock, ptr.Message(op, key=key, seq=seq, flags=flag, cmd=cmd,
                                       version=version,
                                       payload=arr.tobytes() if arr is not None else payload))


def _pull(sock, key, version, seq):
    _send(sock, ptr.Op.PULL, key, seq, version=version)
    r = ptr.recv_message(sock)
    assert r.op == ptr.Op.PULL
    return np.frombuffer(r.payload, dtype=np.float32)


@contextlib.contextmanager
def _wire(num_workers: int):
    srv = PortServer(PortConfig(num_worker=num_workers, num_server=1))
    srv.start(register=False)
    socks = [ptr.connect(srv.host, srv.port) for _ in range(num_workers)]
    for s in socks:
        s.settimeout(15)
    try:
        yield srv, socks
    finally:
        for s in socks:
            ptr.close_socket(s)
        srv.stop()


def _init_keys(socks, keys, payload, token=77):
    for key in keys:
        for i, sock in enumerate(socks):
            _send(sock, ptr.Op.INIT, key, 100 + i, flag=i + 1, version=token, payload=payload)
        for sock in socks:
            r = ptr.recv_message(sock)
            assert r.op == ptr.Op.INIT and r.status == 0


def _trajectory(rule, hp, fused, rounds=5, seed=42) -> str:
    """Two workers: the seed round, then ``rounds`` gradient rounds; every
    pull held bitwise to the worker-side version.  Returns the digest of
    the pulls."""
    rng = np.random.default_rng(seed)
    x0 = {k: rng.standard_normal(N).astype(np.float32) for k in (KEY_A, KEY_B)}
    refs = {k: _WorkerSideRef(rule, hp, x0[k]) for k in (KEY_A, KEY_B)}
    digest = hashlib.sha256()
    with _wire(2) as (srv, (w1, w2)):
        _init_keys([w1, w2], (KEY_A, KEY_B), _opt_init_payload(N, rule, hp))
        for k in (KEY_A, KEY_B):
            _send(w1, ptr.Op.PUSH, k, 1, flag=1, version=1, arr=x0[k])
            _send(w2, ptr.Op.PUSH, k, 1, flag=2, version=1, arr=x0[k])
            assert ptr.recv_message(w1).op == ptr.recv_message(w2).op == ptr.Op.PUSH
            assert _pull(w1, k, 1, seq=2).tobytes() == x0[k].tobytes()
        for r in range(2, 2 + rounds):
            grads = {(k, w): rng.standard_normal(N).astype(np.float32)
                     for k in (KEY_A, KEY_B) for w in (1, 2)}
            got = {}
            if fused:
                for sock, w in ((w1, 1), (w2, 2)):
                    frame = ptr.encode_fused_push([(k, CMD_F32, r, grads[k, w].tobytes())
                                                   for k in (KEY_A, KEY_B)])
                    _send(sock, ptr.Op.FUSED, KEY_A, 10 * r + w, flag=w, payload=frame, cmd=2)
                for sock in (w1, w2):
                    msg = ptr.recv_message(sock)
                    assert msg.op == ptr.Op.FUSED
                    for k, _, payload in ptr.decode_fused_reply(msg.payload):
                        got[k] = np.frombuffer(payload, np.float32)
            else:
                for k in (KEY_A, KEY_B):
                    _send(w1, ptr.Op.PUSH, k, 10 * r, flag=1, version=r, arr=grads[k, 1])
                    _send(w2, ptr.Op.PUSH, k, 10 * r, flag=2, version=r, arr=grads[k, 2])
                    assert ptr.recv_message(w1).op == ptr.recv_message(w2).op == ptr.Op.PUSH
                got = {k: _pull(w1, k, r, seq=10 * r + 5) for k in (KEY_A, KEY_B)}
            for k in (KEY_A, KEY_B):
                gs = grads[k, 1].copy()
                gs += grads[k, 2]  # COPY_FIRST then SUM_RECV
                assert got[k].tobytes() == refs[k].step(gs, 2).tobytes(), (rule, fused, r, k)
                digest.update(got[k].tobytes())
        assert srv._keys[KEY_A].opt_step == 1 + rounds
    return digest.hexdigest()


@pytest.mark.parametrize("rule,hp", [("sgd", {"lr": 0.05}),
                                     ("momentum", {"lr": 0.05, "momentum": 0.9}),
                                     ("adam", {"lr": 0.002})])
def test_worker_vs_server_trajectory_is_bitwise_fused_and_unfused(rule, hp):
    assert _trajectory(rule, hp, fused=False) == _trajectory(rule, hp, fused=True)


def test_adam_trajectory_equals_the_frozen_digest():
    assert _trajectory("adam", {}, fused=False, rounds=6, seed=1234) == ADAM_FROZEN_DIGEST


def test_a_replayed_gradient_push_never_applies_twice():
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal(N).astype(np.float32)
    ref = _WorkerSideRef("momentum", {"lr": 0.1}, x0)
    with _wire(2) as (srv, (w1, w2)):
        _init_keys([w1, w2], (KEY_A,), _opt_init_payload(N, "momentum", {"lr": 0.1}))
        for version, (a, b) in enumerate([(x0, x0), tuple(
                rng.standard_normal(N).astype(np.float32) for _ in range(2))], start=1):
            _send(w1, ptr.Op.PUSH, KEY_A, version, flag=1, version=version, arr=a)
            _send(w2, ptr.Op.PUSH, KEY_A, version, flag=2, version=version, arr=b)
            assert ptr.recv_message(w1).op == ptr.recv_message(w2).op == ptr.Op.PUSH
        gs = a.copy()
        gs += b
        want = ref.step(gs, 2).copy()
        assert _pull(w1, KEY_A, 2, seq=3).tobytes() == want.tobytes()
        step = srv._keys[KEY_A].opt_step
        _send(w1, ptr.Op.PUSH, KEY_A, 4, flag=1, version=2, arr=a)  # a retransmit
        assert ptr.recv_message(w1).op == ptr.Op.PUSH
        assert srv._keys[KEY_A].opt_step == step
        assert _pull(w1, KEY_A, 2, seq=5).tobytes() == want.tobytes()


def test_async_rule_fires_per_push_after_each_workers_seed():
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal(N).astype(np.float32)
    ref = _WorkerSideRef("sgd", {"lr": 0.05}, x0)
    with _wire(1) as (srv, (w,)):
        _init_keys([w], (KEY_A,), _opt_init_payload(N, "sgd", {"lr": 0.05},
                                                    async_profile=True))
        _send(w, ptr.Op.PUSH, KEY_A, 1, flag=1, version=1, arr=x0)
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        assert _pull(w, KEY_A, 1, seq=2).tobytes() == x0.tobytes()
        for r in range(2, 5):
            g = rng.standard_normal(N).astype(np.float32)
            _send(w, ptr.Op.PUSH, KEY_A, 10 * r, flag=1, version=r, arr=g)
            assert ptr.recv_message(w).op == ptr.Op.PUSH
            assert _pull(w, KEY_A, r, seq=10 * r + 1).tobytes() == ref.step(g, 1).tobytes()


# --- declarations ---------------------------------------------------------------


def test_an_unknown_rule_fails_at_declare():
    with pytest.raises(ValueError, match="adagrad"):
        pbps.declare_tensor("sopt.typo", byteps_server_opt="adagrad")
    pbps.declare_tensor("sopt.off", byteps_server_opt="off")
    pbps.declare_tensor("sopt.adam", byteps_server_opt="adam", byteps_server_opt_hp={"lr": 1})


@pytest.mark.parametrize("block", ["unknown rule", "torn block", "int32 store"])
def test_the_server_refuses_a_rule_it_cannot_run(block):
    payload = {"unknown rule": _opt_init_payload(N, "adagrad"),
               "torn block": _opt_init_payload(N, "sgd")[:-3],
               "int32 store": struct.pack("!QI", N, int(DataType.INT32))
               + _opt_init_payload(N, "sgd")[12:]}[block]
    with _wire(1) as (srv, (w,)):
        before = counters().get("server_opt_reject")
        _send(w, ptr.Op.INIT, KEY_A, 1, flag=1, version=77, payload=payload)
        r = ptr.recv_message(w)
        assert r.op == ptr.Op.INIT and r.status != 0
        assert counters().get("server_opt_reject") == before + 1
        _send(w, ptr.Op.PING, 0, 2)
        assert ptr.recv_message(w).op == ptr.Op.PING  # still framed


def test_a_reinit_without_the_profile_returns_the_key_to_summing():
    with _wire(1) as (srv, (w,)):
        _init_keys([w], (KEY_A,), _opt_init_payload(N, "sgd", {"lr": 0.5}))
        assert srv._keys[KEY_A].opt_rule is not None
        _init_keys([w], (KEY_A,), struct.pack("!QI", N, F32), token=78)
        ks = srv._keys[KEY_A]
        assert ks.opt_rule is None and ks.opt_step == 0
        g = np.full(N, 2.0, np.float32)
        _send(w, ptr.Op.PUSH, KEY_A, 10, flag=1, version=1, arr=g)
        assert ptr.recv_message(w).op == ptr.Op.PUSH
        assert _pull(w, KEY_A, 1, seq=11).tobytes() == g.tobytes()


def test_the_native_engine_refuses_the_profile_and_counts_it():
    srv = NativePSServer(PortConfig(num_worker=1, num_server=1))
    try:
        s = ptr.connect("127.0.0.1", srv.port)
        _send(s, ptr.Op.INIT, KEY_A, 1, flag=1, version=7, payload=_opt_init_payload(8, "sgd"))
        r = ptr.recv_message(s)
        assert r.op == ptr.Op.INIT and r.status != 0
        _send(s, ptr.Op.PING, 0, 2)
        assert ptr.recv_message(s).op == ptr.Op.PING
        assert srv.native_counters().get("native_server_opt_reject", 0) >= 1
        ptr.close_socket(s)
    finally:
        srv.stop()


# --- through the engine -----------------------------------------------------------


@contextlib.contextmanager
def _fleet(monkeypatch, server: str, **env):
    base = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
            "BYTEPS_FORCE_DISTRIBUTED": "1"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    sched = (PortScheduler(1, 1, host="127.0.0.1") if server != "ref"
             else RefScheduler(num_workers=1, num_servers=1, host="127.0.0.1"))
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    node = {"port": lambda: PortServer(PortConfig.from_env()),
            "port-native": lambda: NativePSServer(PortConfig.from_env()),
            "ref": lambda: RefServer(RefConfig.from_env())}[server]()
    threading.Thread(target=node.start, daemon=True).start()
    try:
        yield node
    finally:
        node.stop()
        sched.stop()


def _pull_trajectory(api, as_input, rounds=4) -> list:
    """Declare a momentum tensor, seed it, push gradients: the pulls."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(300).astype(np.float32)
    api.declare_tensor("sopt.w", byteps_server_opt="momentum",
                       byteps_server_opt_hp={"lr": 0.01})
    out = [np.asarray(api.push_pull(as_input(x0), name="sopt.w")).tobytes()]
    for _ in range(rounds):
        g = rng.standard_normal(300).astype(np.float32)
        out.append(np.asarray(api.push_pull(as_input(g), name="sopt.w")).tobytes())
    return out


def _want_trajectory(rounds=4) -> list:
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(300).astype(np.float32)
    ref = _WorkerSideRef("momentum", {"lr": 0.01}, x0)
    out = [x0.tobytes()]
    for _ in range(rounds):
        out.append(ref.step(rng.standard_normal(300).astype(np.float32), 1).tobytes())
    return out


@pytest.mark.parametrize("worker,server", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_declared_rules_pull_parameters_across_packages(monkeypatch, worker, server):
    with _fleet(monkeypatch, server):
        counters().reset()
        if worker == "port":
            pbps.init(device="cpu")
            got = _pull_trajectory(pbps, torch.from_numpy)
            pbps.shutdown()
        else:
            jbps.init()
            got = _pull_trajectory(jbps, lambda a: a)
            jbps.shutdown()
    assert got == _want_trajectory()
    assert counters().get("server_opt_updates") == (4 if server == "port" else 0)


def test_the_process_wide_knobs_and_a_per_tensor_opt_out(monkeypatch):
    with _fleet(monkeypatch, "port", BYTEPS_SERVER_OPT="sgd", BYTEPS_SERVER_OPT_HP='{"lr": 0.25}'):
        pbps.init(device="cpu")
        x0 = torch.ones(32)
        assert torch.equal(pbps.push_pull(x0, name="sopt.env"), x0)
        g = torch.full((32,), 2.0)
        want = _WorkerSideRef("sgd", {"lr": 0.25}, x0.numpy()).step(g.numpy(), 1)
        assert pbps.push_pull(g, name="sopt.env").numpy().tobytes() == want.tobytes()
        pbps.declare_tensor("sopt.plain", byteps_server_opt="off")
        assert torch.equal(pbps.push_pull(g, name="sopt.plain"), g)
        pbps.shutdown()


def test_a_worker_against_native_servers_raises_with_their_refusal(monkeypatch):
    with _fleet(monkeypatch, "port-native"):
        pbps.init(device="cpu")
        pbps.declare_tensor("sopt.n", byteps_server_opt="adam")
        with pytest.raises(RuntimeError, match="server-side optimizer .*Python-engine"):
            pbps.push_pull(torch.ones(8), name="sopt.n")
        pbps.shutdown()


def test_distributed_optimizer_server_side_equals_the_references_server_step(monkeypatch):
    """The same parameters and gradients through the port's
    DistributedOptimizer(None, server_side=True) and byteps_tpu's
    server_step: bitwise the same parameters every step, and no optimizer
    state on the port's worker."""
    from byteps_tpu.optim import DistributedOptimizer as RefDistributedOptimizer

    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal(64).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.size).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    hp = {"lr": 0.1}

    with _fleet(monkeypatch, "port"):
        pbps.init(device="cpu")
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        opt = pbps.DistributedOptimizer(None, named_parameters=list(params.items()),
                                        server_side=True, server_rule="adam", server_hp=hp)
        port_steps = []
        for g in grads:
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            port_steps.append({k: p.detach().numpy().copy() for k, p in params.items()})
        assert opt.state == {} and opt.state_dict() == {}
        pbps.shutdown()
    port_registry.reset_registry()
    port_config.clear_config()

    with _fleet(monkeypatch, "ref"):
        jbps.init()
        ref_opt = RefDistributedOptimizer(server_side=True, server_rule="adam", server_hp=hp)
        tree = {k: jax.numpy.asarray(v) for k, v in init.items()}
        ref_steps = []
        for g in grads:
            tree = ref_opt.server_step(tree, {k: jax.numpy.asarray(v) for k, v in g.items()})
            ref_steps.append({k: np.asarray(v) for k, v in tree.items()})
        jbps.shutdown()
    for mine, theirs in zip(port_steps, ref_steps):
        for k in init:
            assert mine[k].tobytes() == theirs[k].tobytes()


def test_synchronize_then_step_applies_each_gradient_once(monkeypatch):
    """Backward pushes each gradient from its hook; ``synchronize()`` then
    ``step()`` pulls the servers' parameters once, as ``step()`` alone
    does: after three steps the two parameters are bitwise equal, and the
    servers applied one update a step to each."""
    rng = np.random.default_rng(5)
    init = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(3)]
    with _fleet(monkeypatch, "port") as server:
        pbps.init(device="cpu")
        params = {k: torch.nn.Parameter(torch.from_numpy(init.copy())) for k in ("a", "b")}
        opts = {k: pbps.DistributedOptimizer(None, named_parameters=[(f"w.{k}", p)],
                                             server_side=True, server_rule="adam",
                                             server_hp={"lr": 0.1})
                for k, p in params.items()}
        for g in grads:
            for k, p in params.items():
                opts[k].zero_grad()
                (p * torch.from_numpy(g)).sum().backward()
                if k == "b":
                    opts[k].synchronize()
                opts[k].step()
        updates = server.stats.snapshot().get("server_opt_updates", 0)
        pbps.shutdown()
    assert params["a"].detach().numpy().tobytes() == params["b"].detach().numpy().tobytes()
    assert updates == 2 * len(grads)


def test_server_side_arguments_are_checked():
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(TypeError, match="needs an optimizer"):
        pbps.DistributedOptimizer(None, named_parameters=[("p", p)])
    with pytest.raises(ValueError, match="named_parameters"):
        pbps.DistributedOptimizer(None, server_side=True)
    with pytest.raises(ValueError, match="no compression"):
        pbps.DistributedOptimizer(None, named_parameters=[("p", p)], server_side=True,
                                  compression_params={"compressor": "onebit"})
