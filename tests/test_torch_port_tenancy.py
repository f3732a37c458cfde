"""Multi-tenant job namespaces of the port against byteps_tpu's (the cases
of ``tests/test_multitenant.py``), in one process:

- the job knobs read as the reference reads them; ``BYTEPS_JOB_SLO_S``
  above 0 raises, naming ROADMAP.md item 10 (the flight recorder's
  trigger rules);
- the stage queue's weighted fair queuing across jobs pops in
  byteps_tpu's order on the same sequences of tasks: one job as the
  classic queue, starvation freedom, no priority inversion, per-job
  credits, a job that comes back from idle, and a random mix;
- the server's engine queue serves in byteps_tpu's order, and the
  admission quota bucket defers by the same amounts under one clock;
- the scheduler's books carry byteps_tpu's ``jobs`` map, the quota split
  over the servers and re-split when one is gone, and tenant workers do
  not resize the fleet;
- on raw sockets against each package's server: two jobs declare the
  same key, and each job's init barrier, rounds, async staleness gate
  and server-side update rule complete against its own workers, with
  byteps_tpu's pulls bitwise;
- the quota through a server: deferred, never dropped, INITs not
  metered, the job series counted, the gauge removed with the quota, a
  re-enqueue from a migration park not charged again, and the stop
  report's job line;
- the C++ engine answers a job key with a status-1 echo and counts it,
  and the port's worker raises byteps_tpu's message.

Inputs come from numpy seeds; every comparison is exact.  The fleets
(scheduler, servers and workers of both packages) are in
``test_torch_port_tenancy_fleets.py``."""

import struct
import threading
import time
import types

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.common.config import Config as RefConfig
from byteps_tpu.common.tenancy import job_key as ref_job_key
from byteps_tpu.common.types import QueueType as RefQueueType
from byteps_tpu.common.types import TensorTableEntry as RefEntry
from byteps_tpu.core import scheduler as rsched
from byteps_tpu.server import server as rserver
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.registry import job_key
from byteps_tpu_torch.common.types import DataType, QueueType, RequestType, get_command_type
from byteps_tpu_torch.common.types import TensorTableEntry as PortEntry
from byteps_tpu_torch.comm import transport as ptr
from byteps_tpu_torch.core import scheduler as psched
from byteps_tpu_torch.core.telemetry import counters, metrics
from byteps_tpu_torch.server import server as pserver

F32 = int(DataType.FLOAT32)
CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, F32)
PKGS = ["port", "ref"]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_JOB_ID", "BYTEPS_JOB_PRIORITY", "BYTEPS_JOB_QUOTA_MBPS",
              "BYTEPS_JOB_CREDIT_BYTES", "BYTEPS_JOB_SLO_S", "BYTEPS_ENABLE_ASYNC"):
        monkeypatch.delenv(k, raising=False)
    yield from kits.reset_runtime(monkeypatch)


# --- the knobs -----------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"BYTEPS_JOB_ID": "7", "BYTEPS_JOB_PRIORITY": "4", "BYTEPS_JOB_QUOTA_MBPS": "2.5",
     "BYTEPS_JOB_CREDIT_BYTES": "4096"},
    {"BYTEPS_JOB_ID": "70000", "BYTEPS_JOB_PRIORITY": "0", "BYTEPS_JOB_QUOTA_MBPS": "-3",
     "BYTEPS_JOB_CREDIT_BYTES": "-1"},
])
def test_the_job_knobs_read_as_the_reference_reads_them(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, r = PortConfig.from_env(), RefConfig.from_env()
    assert ((p.job_id, p.job_priority, p.job_quota_mbps, p.job_credit_bytes)
            == (r.job_id, r.job_priority, r.job_quota_mbps, r.job_credit_bytes))
    assert "tenancy" not in port_config.UNPORTED


@pytest.mark.parametrize("value, raises", [("0", False), ("", False), ("0.0", False),
                                           ("0.25", True), ("3", True)])
def test_a_job_slo_raises_naming_item_10(monkeypatch, value, raises):
    """The knob that raised naming ROADMAP.md item 10 until the flight
    recorder's ``slo_breach`` rule was ported (``raises``: the values that
    select the rule) is now read as the reference reads it: by a worker's
    config and by a server's recorder, the rule armed exactly for those
    values (tests/test_torch_port_flight_rules.py fires it)."""
    from byteps_tpu_torch.core import flightrec

    monkeypatch.setenv("BYTEPS_JOB_SLO_S", value)
    port_config.check_unported_env()
    assert PortConfig.from_env().job_slo_s == RefConfig.from_env().job_slo_s
    flightrec.set_process_recorder(None)
    srv = pserver.PSServer(PortConfig(num_worker=1, num_server=1))
    try:
        assert (flightrec.get_process_recorder().slo_s > 0) == raises
        assert flightrec.get_process_recorder().slo_s == float(value or 0)
    finally:
        srv.stop()
        flightrec.set_process_recorder(None)


def test_a_task_takes_its_job_from_its_key():
    assert job_key(3, 5 << 16) == ref_job_key(3, 5 << 16)
    assert PortEntry(tensor_name="t", key=job_key(3, 5 << 16)).job == 3
    assert PortEntry(tensor_name="t", key=5 << 16).job == 0
    assert PortEntry(tensor_name="t", key=5 << 16, job=9).job == 9


# --- the stage queue's weighted fair queuing -------------------------------------


def _drive_stage_queue(pkg: str, ops, weights: dict, job_credits=None, credit: int = 0):
    """Run ``ops`` (("add", job, key, priority, length) | ("pop",) |
    ("finish",), which returns the oldest popped task still out) through
    ``pkg``'s ScheduledQueue; the pops' (job, key) or None."""
    mod, entry, qt = ((psched, PortEntry, QueueType) if pkg == "port"
                      else (rsched, RefEntry, RefQueueType))
    for job, w in weights.items():
        mod.set_job_weight(job, w)
    q = mod.ScheduledQueue(qt.PUSH, credit_bytes=credit, job_credits=job_credits)
    out, out_tasks = [], []
    for op in ops:
        if op[0] == "add":
            _, job, key, prio, length = op
            q.add_task(entry(tensor_name=f"j{job}.k{key}", key=key, priority=prio,
                             length=length, queue_list=[qt.PUSH], job=job))
        elif op[0] == "pop":
            t = q.get_task(0.0)
            out.append(None if t is None else (t.job, t.key))
            if t is not None:
                out_tasks.append(t)
        elif out_tasks:
            q.report_finish(out_tasks.pop(0))
    assert q.pending() == sum(o[0] == "add" for o in ops) - sum(x is not None for x in out)
    return out


def _random_ops(seed: int, jobs, n: int = 240) -> list:
    """Adds (a random job, a new key, a priority, a length), pops and
    finishes, from a numpy seed."""
    rng = np.random.default_rng(seed)
    ops, key = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            key += 1
            ops.append(("add", int(rng.choice(jobs)), key, int(rng.integers(-3, 4)),
                        int(rng.integers(0, 200))))
        else:
            ops.append(("pop",) if r < 0.85 else ("finish",))
    return ops


STAGE_CASES = {
    # (priority desc, key asc) with one job: the classic order
    "one job": ([("add", 0, 3, 0, 25), ("add", 0, 1, 5, 25), ("add", 0, 2, 5, 25),
                 ("add", 0, 9, 1, 25)] + [("pop",)] * 4, {}, None),
    # a weight-10 job cannot starve a weight-1 job
    "starvation": ([("add", 11, 100 + i, 0, 25) for i in range(30)]
                   + [("add", 22, 200 + i, 0, 25) for i in range(3)] + [("pop",)] * 33,
                   {11: 10, 22: 1}, None),
    # a bulk job's huge task priorities do not outrank another job
    "priority inversion": ([("add", 24, 300 + i, 10 ** 6, 25) for i in range(10)]
                           + [("add", 13, 1, 0, 25)] + [("pop",)] * 11,
                           {13: 100, 24: 1}, None),
    # a job's spent budget holds its tasks while others flow; a finish
    # returns it
    "job credits": ([("add", 26, 1, 0, 30), ("add", 26, 2, 0, 30), ("add", 15, 3, 0, 30),
                     ("pop",), ("pop",), ("pop",), ("finish",), ("pop",)],
                    {15: 1, 26: 1}, {26: 150}),
    # a job that ran alone, went idle and came back joins at the live floor
    "idle rejoin": ([("add", 17, i, 0, 100) for i in range(6)] + [("pop",)] * 6
                    + [("add", 28, 50 + i, 0, 10) for i in range(4)]
                    + [("add", 17, 60 + i, 0, 100) for i in range(4)] + [("pop",)] * 8,
                    {17: 1, 28: 2}, None),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_the_stage_queue_pops_in_the_reference_order(case):
    ops, weights, credits = STAGE_CASES[case]
    port = _drive_stage_queue("port", ops, weights, credits)
    assert port == _drive_stage_queue("ref", ops, weights, credits)
    if case == "one job":
        assert [k for _, k in port] == [1, 2, 9, 3]
    elif case == "starvation":
        assert [j for j, _ in port].index(22) < 25 and [j for j, _ in port].count(22) == 3
    elif case == "priority inversion":
        assert 13 in [j for j, _ in port[:2]]
    elif case == "job credits":
        assert port == [(26, 1), (15, 3), None, (26, 2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_stage_queue_pops_a_random_mix_in_the_reference_order(seed):
    weights = {41: 1, 42: 3, 43: 7}
    ops = _random_ops(seed, list(weights))
    credits = {42: 600}
    got = _drive_stage_queue("port", ops, weights, credits, credit=2000)
    assert got == _drive_stage_queue("ref", ops, weights, credits, credit=2000)
    assert sum(x is not None for x in got) > 20


# --- the server's engine queue and quota bucket -----------------------------------


def _drive_engine_queue(pkg: str, ops, weights: dict):
    """``ops``: ("put", item, job, cost) | ("get",) through ``pkg``'s engine
    queue (the reference's without its anti-starvation order, as the port's
    server has none); the gets."""
    wf = lambda j: weights.get(j, 1.0)  # noqa: E731
    q = (pserver._EngineQueue(weight_fn=wf) if pkg == "port"
         else rserver._EngineQueue(enable_schedule=False, weight_fn=wf))
    out = []
    for op in ops:
        if op[0] == "put":
            if pkg == "port":
                q.put(op[1], job=op[2], cost=op[3])
            else:
                q.put(0, op[1], job=op[2], cost=op[3])
        else:
            out.append(q.get(0.0))
    return out


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_the_engine_queue_serves_in_the_reference_order(seed):
    weights = {1: 10.0, 2: 1.0, 3: 4.0}
    if seed is None:
        # one lane is the plain FIFO; a latency job's request is served
        # among the first two, ahead of a bulk job's backlog
        ops = [("put", f"item{i}", 0, 0) for i in range(3)] + [("get",)] * 3
        assert _drive_engine_queue("port", ops, weights) == ["item0", "item1", "item2"]
        ops = ([("put", f"bulk{i}", 2, 1000) for i in range(5)] + [("put", "latency", 1, 10)]
               + [("get",)] * 6)
    else:
        rng = np.random.default_rng(seed)
        ops = []
        for i in range(300):
            if rng.random() < 0.55:
                ops.append(("put", f"r{i}", int(rng.integers(0, 4)), int(rng.integers(0, 5000))))
            else:
                ops.append(("get",))
    port = _drive_engine_queue("port", ops, weights)
    assert port == _drive_engine_queue("ref", ops, weights)
    if seed is None:
        assert "latency" in port[:2]


def _clock(start: float = 1000.0):
    box = [start]
    fake = types.SimpleNamespace(**{n: getattr(time, n) for n in dir(time)
                                    if not n.startswith("_")})
    fake.monotonic = lambda: box[0]
    return box, fake


@pytest.mark.parametrize("mbps", [0.5, 1.0, 8.0])
def test_the_quota_bucket_defers_as_the_reference_does(monkeypatch, mbps):
    box, fake = _clock()
    monkeypatch.setattr(pserver, "time", fake)
    monkeypatch.setattr(rserver, "time", fake)
    port, ref = pserver._QuotaBucket(mbps), rserver._QuotaBucket(mbps)
    rng = np.random.default_rng(int(mbps * 10))
    delays = []
    for _ in range(200):
        box[0] += float(rng.exponential(0.02))
        n = int(rng.integers(0, 400_000))
        d = port.reserve(n)
        assert d == ref.reserve(n)
        delays.append(d)
    assert sum(d > 0 for d in delays) > 10 and min(delays) == 0.0
    # the reference test's case: a burst is free, an overload defers
    b = pserver._QuotaBucket(1.0)
    assert b.reserve(200_000) == 0.0
    b.reserve(500_000)
    assert b.reserve(100_000) > 0.2


# --- the scheduler's jobs map ---------------------------------------------------


def _worker(uid: str, job: int, prio: int = 1, quota: float = 0.0, nw: int = 3) -> dict:
    return {"role": "worker", "host": "", "port": 0, "uid": uid, "num_workers": nw,
            "num_servers": 2, "job": job, "job_priority": prio, "job_quota_mbps": quota}


def _jobs_books(pkg: str) -> dict:
    """A scheduler of ``pkg`` for three workers and two servers: job 1's
    two workers (priorities 4 and 2, declaring 2 workers), job 2's one
    (a 12 MB/s quota, declaring 1); then server 1 goes.  The books each
    node received, and the scheduler's worker count."""
    k = kits.kit(pkg)
    sched = k.Scheduler(3, 2, host="127.0.0.1", dead_node_timeout=0.5)
    sched.start()
    try:
        servers = [kits.RawNode(k, sched.port, {"role": "server", "host": "127.0.0.1",
                                                 "port": 1 + i, "uid": f"s{i}"})
                   for i in range(2)]
        w = [kits.RawNode(k, sched.port, _worker("w0", 1, 4, nw=2))]
        assert kits.wait(lambda: sched.num_workers == 3 and len(sched._nodes["worker"]) == 1)
        w.append(kits.RawNode(k, sched.port, _worker("w1", 1, 2, nw=2)))
        assert kits.wait(lambda: len(sched._nodes["worker"]) == 2)
        w.append(kits.RawNode(k, sched.port, _worker("w2", 2, 1, 12.0, nw=1)))
        assert kits.wait(lambda: all(n.books for n in servers + w), 5)
        nw_after_bringup = sched.num_workers
        servers[1].close()
        assert kits.wait(lambda: len(servers[0].books) >= 2 and len(w[2].books) >= 2, 5)
        got = {"s0": servers[0].books, "w2": w[2].books[:2], "num_workers": nw_after_bringup}
        for n in servers + w:
            n.close()
    finally:
        sched.stop()
    return got


def test_the_books_carry_the_reference_jobs_map_and_split_the_quota():
    port = _jobs_books("port")
    assert port == _jobs_books("ref")
    assert port["num_workers"] == 3  # tenant workers do not resize the fleet
    first = port["s0"][0][1]["jobs"]
    assert first == {"1": {"workers": [0, 1], "priority": 4, "quota_mbps": 0.0},
                     "2": {"workers": [2], "priority": 1, "quota_mbps": 6.0,
                           "quota_mbps_total": 12.0}}
    # one server left: the book re-splits the quota over the live one
    assert port["s0"][-1][1]["jobs"]["2"]["quota_mbps"] == 12.0


# --- per-job rounds on raw sockets ----------------------------------------------


def _kpkg(pkg: str):
    return (types.SimpleNamespace(tr=ptr, srv=pserver, Config=PortConfig) if pkg == "port"
            else types.SimpleNamespace(tr=__import__("byteps_tpu.comm.transport",
                                                     fromlist=["x"]),
                                       srv=rserver, Config=RefConfig))


class _Wire:
    """A server of ``pkg`` for ``workers`` workers with no scheduler, the
    book's jobs map adopted, and a raw connection per worker flag."""

    def __init__(self, pkg: str, workers: int, jobs: dict, flags) -> None:
        self.k = _kpkg(pkg)
        self.srv = self.k.srv.PSServer(self.k.Config(num_worker=workers, num_server=1))
        self.srv.start(register=False)
        self.srv._adopt_jobs({"jobs": jobs})
        self.socks = {}
        for f in flags:
            s = self.k.tr.connect(self.srv.host, self.srv.port)
            s.settimeout(15)
            self.socks[f] = s
        self.seq = 0

    def _seq(self) -> int:
        self.seq += 1
        return self.seq

    def send(self, flag: int, op: str, key: int, **kw) -> int:
        seq = self._seq()
        self.k.tr.send_message(self.socks[flag], self.k.tr.Message(
            self.k.tr.Op[op], key=key, seq=seq, flags=flag, **kw))
        return seq

    def recv(self, flag: int):
        return self.k.tr.recv_message(self.socks[flag])

    def init(self, flags, key: int, n: int, extra: bytes = b"") -> list:
        payload = struct.pack("!QI", n, F32) + extra
        for f in flags:
            self.send(f, "INIT", key, version=100 + f, payload=payload)
        return [self.recv(f).status for f in flags]

    def push(self, flag: int, key: int, version: int, arr) -> int:
        self.send(flag, "PUSH", key, version=version, cmd=CMD_F32, payload=arr.tobytes())
        return self.recv(flag).status

    def pull_async(self, flag: int, key: int, version: int) -> dict:
        box = {}

        def run():
            self.send(flag, "PULL", key, version=version, cmd=CMD_F32)
            msg = self.recv(flag)
            box["out"] = np.frombuffer(msg.payload, np.float32).copy()
            box["version"] = msg.version

        box["thread"] = threading.Thread(target=run, daemon=True)
        box["thread"].start()
        return box

    def close(self) -> None:
        for s in self.socks.values():
            self.k.tr.close_socket(s)
        self.srv.stop()


JOBS_2_1 = {"1": {"workers": [0, 1], "priority": 1, "quota_mbps": 0},
            "2": {"workers": [2], "priority": 1, "quota_mbps": 0}}


def _two_jobs_one_key(pkg: str) -> dict:
    """One server, a fleet of three workers: job 1 (flags 1, 2) and job 2
    (flag 3) declare the same key.  Job 2's barrier and rounds need its
    one worker; job 1's pull waits for both of job 1's pushes, never for
    the fleet's three."""
    xs = kits.vals(3, n=16, k=6)
    w = _Wire(pkg, 3, JOBS_2_1, [1, 2, 3])
    k1, k2 = job_key(1, 9 << 16), job_key(2, 9 << 16)
    got = {}
    try:
        assert w.init([3], k2, 16) == [0]  # alone: no other job's INIT needed
        assert w.init([1, 2], k1, 16) == [0, 0]
        for v in (1, 2):
            assert w.push(3, k2, v, xs[v - 1]) == 0
            p = w.pull_async(3, k2, v)
            p["thread"].join(5)
            got[f"job2.round{v}"] = p["out"]
            assert w.push(1, k1, v, xs[2 + v]) == 0
            p = w.pull_async(1, k1, v)
            p["thread"].join(0.3)
            assert p["thread"].is_alive(), "job 1's round published with one push"
            assert w.push(2, k1, v, xs[4 + v - 1]) == 0
            p["thread"].join(5)
            got[f"job1.round{v}"] = p["out"]
        stores = {j: w.srv._key_state(key).store.copy() for j, key in ((1, k1), (2, k2))}
    finally:
        w.close()
    np.testing.assert_array_equal(got["job2.round2"], xs[1])
    np.testing.assert_array_equal(got["job1.round1"], xs[3] + xs[4])
    np.testing.assert_array_equal(got["job1.round2"], xs[4] + xs[5])
    return {**got, "stores": stores}


def test_two_jobs_of_the_same_key_round_against_their_own_workers():
    port, ref = _two_jobs_one_key("port"), _two_jobs_one_key("ref")
    for name in ("job2.round1", "job2.round2", "job1.round1", "job1.round2"):
        assert port[name].tobytes() == ref[name].tobytes()
    for j in (1, 2):
        assert port["stores"][j].tobytes() == ref["stores"][j].tobytes()


def _async_gate(pkg: str) -> dict:
    """Job 2 (one worker) runs the key async with bound 0 beside job 1's
    two workers: its pull is gated by its own worker's pushes only; job 1's
    async pull at bound 0 waits for both of its workers."""
    xs = kits.vals(4, n=8, k=4)
    w = _Wire(pkg, 3, JOBS_2_1, [1, 2, 3])
    k1, k2 = job_key(1, 4 << 16), job_key(2, 4 << 16)
    ext = struct.pack("!Bi", 1, 0)
    out = {}
    try:
        assert w.init([3], k2, 8, ext) == [0]
        assert w.init([1, 2], k1, 8, ext) == [0, 0]
        assert w.push(3, k2, 1, xs[0]) == 0
        p = w.pull_async(3, k2, 1)
        p["thread"].join(5)
        assert not p["thread"].is_alive(), "job 2's pull waited for another job's workers"
        out["job2"] = p["out"]
        assert w.push(1, k1, 1, xs[1]) == 0
        p = w.pull_async(1, k1, 1)
        p["thread"].join(0.3)
        assert p["thread"].is_alive(), "job 1's pull passed the bound with one push"
        assert w.push(2, k1, 1, xs[2]) == 0
        p["thread"].join(5)
        out["job1"] = p["out"]
    finally:
        w.close()
    np.testing.assert_array_equal(out["job1"], xs[1] + xs[2])
    return out


def test_an_async_tenants_staleness_gate_reads_its_own_workers():
    port, ref = _async_gate("port"), _async_gate("ref")
    assert {k: v.tobytes() for k, v in port.items()} == {k: v.tobytes() for k, v in ref.items()}


def _rule_per_job(pkg: str) -> dict:
    """A server-side SGD rule on the same key of both jobs: job 1's rounds
    average over its two workers, job 2's over its one."""
    tr = _kpkg(pkg).tr
    block = tr.encode_server_opt_block("sgd", '{"lr":0.5}')
    ext = struct.pack("!Bi", 2, -1) + block
    xs = kits.vals(5, n=8, k=6)
    w = _Wire(pkg, 3, JOBS_2_1, [1, 2, 3])
    k1, k2 = job_key(1, 6 << 16), job_key(2, 6 << 16)
    out = {}
    try:
        assert w.init([3], k2, 8, ext) == [0]
        assert w.init([1, 2], k1, 8, ext) == [0, 0]
        for v in (1, 2, 3):  # the seed round, then two updates
            assert w.push(3, k2, v, xs[v - 1]) == 0
            p = w.pull_async(3, k2, v)
            p["thread"].join(5)
            out[f"job2.{v}"] = p["out"]
            assert w.push(1, k1, v, xs[v]) == 0
            assert w.push(2, k1, v, xs[v + 2]) == 0
            p = w.pull_async(1, k1, v)
            p["thread"].join(5)
            out[f"job1.{v}"] = p["out"]
    finally:
        w.close()
    np.testing.assert_array_equal(out["job2.2"], xs[0] - np.float32(0.5) * xs[1])
    return out


def test_a_server_side_rule_averages_over_the_jobs_workers():
    port, ref = _rule_per_job("port"), _rule_per_job("ref")
    assert {k: v.tobytes() for k, v in port.items()} == {k: v.tobytes() for k, v in ref.items()}


# --- the admission quota through a server ----------------------------------------


def _job_counts(name: str, job: str) -> int:
    return sum(v for key, v in counters().labeled_raw().get(name, {}).items()
               if dict(key).get("job") == job)


def test_a_quota_defers_a_tenants_pushes_and_never_its_init():
    """The reference's case on the port's server (0.5 MB/s, two 256 KB
    pushes: the second is deferred, both served), and what the port adds
    to it: INIT bytes are counted but never wait, every request is
    counted once (a re-enqueue from a migration park is not charged
    again), the gauge goes with the quota, and the stop report carries
    the job's line."""
    srv = pserver.PSServer(PortConfig(num_worker=1, num_server=1))
    srv.start(register=False)
    try:
        srv._adopt_jobs({"jobs": {"5": {"workers": [0], "priority": 1, "quota_mbps": 0.5}}})
        assert srv._qos_active
        key = job_key(5, 7 << 16)
        w = ptr.connect(srv.host, srv.port)
        w.settimeout(15)
        payload = struct.pack("!QI", 65536, F32)
        ptr.send_message(w, ptr.Message(ptr.Op.INIT, key=key, seq=1, flags=1, version=3,
                                        payload=payload))
        assert ptr.recv_message(w).status == 0
        body = np.ones(65536, dtype=np.float32).tobytes()
        t0 = time.monotonic()
        for v in (1, 2):
            ptr.send_message(w, ptr.Message(ptr.Op.PUSH, key=key, seq=10 + v, flags=1,
                                            version=v, cmd=CMD_F32, payload=body))
            msg = ptr.recv_message(w)
            assert msg.op == ptr.Op.PUSH and msg.status == 0
        took = time.monotonic() - t0
        assert _job_counts("job_quota_deferred", "5") >= 1 and took > 0.1
        assert _job_counts("server_job_requests", "5") == 3
        assert _job_counts("server_job_bytes", "5") == 12 + 2 * len(body)
        # a parked request taken again is neither counted nor metered twice
        (conn,) = srv._conns  # the server's end of ``w``
        srv._enqueue(ptr.Message(ptr.Op.PULL, key=key, seq=20, version=2, cmd=CMD_F32), conn,
                     threading.Lock(), metered=True)
        msg = ptr.recv_message(w)
        assert msg.op == ptr.Op.PULL and msg.version == 2
        assert np.array_equal(np.frombuffer(msg.payload, np.float32), np.ones(65536))
        assert _job_counts("server_job_requests", "5") == 3
        lines = pserver.stop_report(srv)
        assert lines[-1].startswith("rank None job 5 ") and "server_job_quota_mbps=0.5" in lines[-1]
        assert "job_quota_deferred=" in lines[-1]
        gauges = metrics().snapshot()["gauges"]
        assert gauges['server_job_quota_mbps{job="5"}'] == 0.5, gauges
        srv._adopt_jobs({"jobs": {"5": {"workers": [0], "priority": 1, "quota_mbps": 0}}})
        assert not srv._qos_active and not srv._job_quota
        gauges = metrics().snapshot()["gauges"]
        assert 'server_job_quota_mbps{job="5"}' not in gauges, gauges
        ptr.close_socket(w)
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_the_reference_quota_case_on_either_server(pkg):
    """tests/test_multitenant.py ``test_server_quota_defers_then_serves``
    on each package's server, with the same frames."""
    k = _kpkg(pkg)
    srv = k.srv.PSServer(k.Config(num_worker=1, num_server=1))
    srv.start(register=False)
    try:
        srv._adopt_jobs({"jobs": {"6": {"workers": [0], "priority": 1, "quota_mbps": 0.5}}})
        key = job_key(6, 7 << 16)
        w = k.tr.connect(srv.host, srv.port)
        w.settimeout(15)
        k.tr.send_message(w, k.tr.Message(k.tr.Op.INIT, key=key, seq=1, flags=1, version=3,
                                          payload=struct.pack("!QI", 65536, F32)))
        assert k.tr.recv_message(w).status == 0
        body = np.arange(65536, dtype=np.float32).tobytes()
        t0 = time.monotonic()
        for v in (1, 2):
            k.tr.send_message(w, k.tr.Message(k.tr.Op.PUSH, key=key, seq=10 + v, flags=1,
                                              version=v, cmd=CMD_F32, payload=body))
            assert k.tr.recv_message(w).status == 0
        assert time.monotonic() - t0 > 0.1
        k.tr.send_message(w, k.tr.Message(k.tr.Op.PULL, key=key, seq=30, version=2,
                                          cmd=CMD_F32))
        msg = k.tr.recv_message(w)
        assert msg.payload == body and msg.version == 2
        k.tr.close_socket(w)
    finally:
        srv.stop()


def test_job_0_and_a_book_without_qos_keep_the_single_job_server():
    """No job declared QoS: the engine queues put everything in job 0's
    lane, replies go inline (no writer thread), and job 0's requests
    count no job series."""
    writers = lambda: sum(t.name == "ps-reply-writer" for t in threading.enumerate())  # noqa: E731
    before, n_writers = {n: dict(v) for n, v in counters().labeled_raw().items()}, writers()
    w = _Wire("port", 1, {"0": {"workers": [0], "priority": 1, "quota_mbps": 0}}, [1])
    try:
        assert not w.srv._qos_active
        assert w.init([1], 3 << 16, 4) == [0]
        assert w.push(1, 3 << 16, 1, np.ones(4, np.float32)) == 0
        assert all(set(q._lanes) <= {0} for q in w.srv._queues)
        assert not w.srv._writers
        assert writers() <= n_writers  # an earlier test's writers may have ended
    finally:
        w.close()
    after = counters().labeled_raw()
    for name in pserver.JOB_COUNTERS:
        assert after.get(name, {}) == before.get(name, {})


def test_qos_routes_replies_through_one_writer_per_connection():
    jobs = {"1": {"workers": [0, 1], "priority": 4, "quota_mbps": 0},
            "2": {"workers": [2], "priority": 1, "quota_mbps": 0}}
    xs = kits.vals(8, n=16, k=2)
    w = _Wire("port", 3, jobs, [1, 2, 3])
    try:
        assert w.srv._qos_active
        k1 = job_key(1, 2 << 16)
        assert w.init([1, 2], k1, 16) == [0, 0]
        assert w.push(1, k1, 1, xs[0]) == 0 and w.push(2, k1, 1, xs[1]) == 0
        p = w.pull_async(1, k1, 1)
        p["thread"].join(5)
        np.testing.assert_array_equal(p["out"], xs[0] + xs[1])
        assert len([x for x in w.srv._writers.values() if not x.dead]) == 2
        assert {j for q in w.srv._queues for j in q._lanes} == {1}
    finally:
        w.close()


# --- the native lane ------------------------------------------------------------


def test_the_native_engine_echoes_status_1_for_a_job_key_and_counts_it():
    from byteps_tpu_torch.server.native import NativePSServer

    srv = NativePSServer(PortConfig(num_worker=1, num_server=1))
    try:
        s = ptr.connect("127.0.0.1", srv.port)
        s.settimeout(15)
        jkey = job_key(3, 5 << 16)
        ptr.send_message(s, ptr.Message(ptr.Op.INIT, key=jkey, seq=1, flags=1, version=7,
                                        payload=struct.pack("!QI", 8, F32)))
        r = ptr.recv_message(s)
        assert r.op == ptr.Op.INIT and r.status != 0 and r.key == jkey
        ptr.send_message(s, ptr.Message(ptr.Op.PUSH, key=jkey, seq=2, flags=1, version=1,
                                        cmd=CMD_F32, payload=b"\0" * 32))
        r = ptr.recv_message(s)
        assert r.op == ptr.Op.PUSH and r.status != 0 and r.key == jkey
        ptr.send_message(s, ptr.Message(ptr.Op.PING, seq=3))
        r = ptr.recv_message(s)
        assert r.op == ptr.Op.PING and r.status == 0  # the stream stayed framed
        assert srv.native_counters().get("native_job_reject", 0) >= 2
        ptr.close_socket(s)
        # the book's jobs map is adopted for observability
        srv._adopt_jobs({"jobs": {"3": {"workers": [0], "priority": 2, "quota_mbps": 4.0}}})
        assert pserver.job_series(srv)["3"]["server_job_quota_mbps"] == 4.0
    finally:
        srv.stop()
        metrics().gauge_remove("server_job_quota_mbps", labels={"job": "3"})


def _refused_init_error(pkg: str, key: int, **kw) -> str:
    if pkg == "port":
        from byteps_tpu_torch.comm.ps_client import PSClient
        mk = ptr.Message
        op = ptr.Op.INIT
    else:
        from byteps_tpu.comm import transport as rtr
        from byteps_tpu.comm.ps_client import PSClient
        mk = rtr.Message
        op = rtr.Op.INIT
    client = object.__new__(PSClient)
    client.rank = 0
    client.membership_epoch = 0
    client._init_seq_lock = threading.Lock()
    client._init_seqs = {}
    client._init_salt = 1
    client._blocking_request_retrying = (
        lambda key, make, errmsg, use_deadline=True: mk(op, key=key, status=1))
    with pytest.raises(RuntimeError) as e:
        client.init_tensor(key, 8, 0, **kw)
    return str(e.value)


@pytest.mark.parametrize("key, kw", [(job_key(3, 1 << 16), {}), (1 << 16, {})])
def test_a_refused_init_raises_the_reference_message(key, kw):
    port = _refused_init_error("port", key, **kw)
    if key >> 48:
        assert port == _refused_init_error("ref", key, **kw)
        assert "job 3 keys need Python-engine servers" in port
    else:
        assert "refused" in port and "Python-engine" not in port


def test_a_fusion_pack_never_mixes_jobs():
    """The FUSE stage packs by (server, job): a pack competes, spends
    credit and is metered as one job, as byteps_tpu's does."""
    from byteps_tpu_torch.core.engine import _Fuser

    added = []
    stop = threading.Event()
    engine = types.SimpleNamespace(
        client=types.SimpleNamespace(server_for=lambda key: 0),
        cfg=types.SimpleNamespace(fusion_bytes=1 << 20, fusion_cycle_ms=1000.0),
        _stop=stop, queues={QueueType.PUSH: types.SimpleNamespace(add_task=added.append)})
    fuser = _Fuser(engine)
    try:
        for i, job in enumerate((1, 2, 1, 0)):
            fuser.add(PortEntry(tensor_name=f"t{i}", key=job_key(job, (7 + i) << 16), length=4),
                      b"\0" * 16)
        fuser.drain_idle()
    finally:
        stop.set()
    assert sorted((t.job, len(t.context.members)) for t in added) == [(0, 1), (1, 2), (2, 1)]
    assert all({m.job for m, _ in t.context.members} == {t.job} for t in added)


@pytest.mark.parametrize("jobs, port_n, ref_n", [
    ({"0": {"workers": [0], "priority": 1, "quota_mbps": 0}}, 2, 1),
    ({"0": {"workers": [0], "priority": 1, "quota_mbps": 0},
      "3": {"workers": [1], "priority": 1, "quota_mbps": 0}}, 1, 1),
])
def test_a_single_tenant_book_keeps_the_fleets_worker_count(jobs, port_n, ref_n):
    """The fourteenth divergence: with job 0 alone in the map (a single-
    tenant fleet) the port's rounds complete against the book's worker
    count, as before jobs were ported (under elastic membership the map
    lists only the live ranks); byteps_tpu's take the map's.  With a
    tenant in the map both packages size job 0 by its own workers."""
    key = 4 << 16
    sizes = []
    for pkg in PKGS:
        k = _kpkg(pkg)
        srv = k.srv.PSServer(k.Config(num_worker=2, num_server=1))
        try:
            srv._adopt_jobs({"jobs": jobs})
            sizes.append(srv._workers_for_ks(srv._key_state(key)))
        finally:
            srv.stop()
    assert sizes == [port_n, ref_n]
    if port_n == 2:
        # a job-0 round on the port's server still waits for two pushes
        w = _Wire("port", 2, jobs, [1])
        try:
            assert not w.srv._qos_active and not w.srv._job_workers
            w.send(1, "INIT", key, version=101, payload=struct.pack("!QI", 4, F32))
            ks = w.srv._key_state(key)
            assert kits.wait(lambda: len(ks.init_waiters) == 1)
            time.sleep(0.2)
            assert len(ks.init_waiters) == 1  # the barrier waits for the second
        finally:
            w.close()
