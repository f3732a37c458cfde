"""Multi-tenant fleets of the port against byteps_tpu's
(``tests/test_multitenant.py``, ``tools/chaos_soak.py --multi-tenant``),
each a scheduler, servers and workers in one process:

- job 0 alone sends and receives the frames it did before job namespaces
  were ported (digests frozen from that tree), with no job lane, reply
  writer or job-labelled series;
- two jobs that declare the same key (job 1 of two workers, job 2 of one)
  on one fleet of three workers: each round's pulls are the exact sum of
  the job's own pushes and the books give each job its own population,
  on the port's and on byteps_tpu's servers, and with one job's workers of
  byteps_tpu beside the port's tenant;
- a tenant through the port's engine (``BYTEPS_JOB_ID``, a priority and a
  quota) beside two PSClient workers of another job: its averages, its
  job-labelled series on both sides, the servers' byte count against the
  worker's and its flight records' job;
- an async tenant with a quota under the chaos van: the store is the exact
  sum of the applied pushes, on either package's servers.

Every listener is bound to port 0."""

import dataclasses
import hashlib
import json
import os
import threading

import numpy as np
import pytest

import torch_port_kits as kits

#: job 0's frames before job namespaces were ported (``job0_frames`` on
#: that tree, commit 3a2fc1a): sha256 of the sorted normalized frames, and
#: their counts
JOB0_FRAMES = {"requests": "b52a6335232be04b8d342405ce4d007f52b0f8d2dd3eb1cfbb726d7231dbc057",
               "replies": "e4c61f04effcc9e968a99094f83a2b68611840e013458d68095157423fe3cb36",
               "counts": [31, 29]}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_JOB_ID", "BYTEPS_JOB_PRIORITY", "BYTEPS_JOB_QUOTA_MBPS",
              "BYTEPS_JOB_CREDIT_BYTES", "BYTEPS_JOB_SLO_S"):
        monkeypatch.delenv(k, raising=False)
    yield from kits.reset_runtime(monkeypatch)


# --- job 0 as it was -------------------------------------------------------------


def job0_frames() -> dict:
    """A job-0 worker of the port through the port's scheduler and one
    server: a onebit tensor of four partitions and a raw one, two rounds
    each.  The frames the worker sends (REGISTER, BARRIER and the data
    plane) and the server's replies, each normalized (seq 0, an
    INIT's random token salt dropped, the node uid blanked), sorted
    (the stage threads race) and hashed.  Runs on any tree of the port,
    so that a digest can be frozen from one and checked on another.

    The job is the process's first: its tensors are keys 0 and 1 << 16.
    A registry that an earlier test in the same process left declared
    would number them after its own and change every keyed frame (an
    xdist worker that ran ``test_torch_port_hybrid.py`` first did), so
    the registry starts empty."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import ps_client, transport
    from byteps_tpu_torch.comm.rendezvous import Scheduler
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.registry import reset_registry
    from byteps_tpu_torch.server import server as server_mod

    reset_registry()

    sent = {"requests": [], "replies": []}

    def norm(msg) -> bytes:
        payload = bytes(msg.payload)
        if msg.op == transport.Op.REGISTER:
            info = json.loads(payload.decode())
            info["uid"] = ""
            payload = json.dumps(info).encode()
        version = msg.version & 0xFFFF if msg.op == transport.Op.INIT else msg.version
        return transport.Message(msg.op, key=msg.key, payload=payload, cmd=msg.cmd,
                                 version=version, status=msg.status, flags=msg.flags,
                                 trace=msg.trace, checksum=msg.checksum).encode()

    def tap(which, orig, skip):
        def send(sock, msg, lock=None):
            if msg.op not in skip:
                sent[which].append(norm(msg))
            return orig(sock, msg, lock)
        return send

    saved = dict(os.environ)
    orig_client, orig_server = ps_client.send_message, server_mod.send_message
    sched = Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    srv = None
    try:
        os.environ.update({"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
                           "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
                           "BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_PARTITION_BYTES": "131072",
                           "BYTEPS_HEARTBEAT_INTERVAL": "0"})
        Op = transport.Op
        ps_client.send_message = tap("requests", orig_client, (Op.PING,))
        # the server's own REGISTER carries its random port and uid
        server_mod.send_message = tap("replies", orig_server, (Op.PING, Op.REGISTER, Op.BARRIER))
        srv = server_mod.PSServer(Config.from_env())
        threading.Thread(target=srv.start, daemon=True).start()
        bps.init(device="cpu")
        bps.declare_tensor("j0.onebit", byteps_compressor_type="onebit",
                           byteps_compressor_onebit_scaling="True")
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
        y = torch.from_numpy(rng.integers(-8, 8, 5000).astype(np.float32))
        for _ in range(2):
            bps.push_pull(x, name="j0.onebit", average=False)
            bps.push_pull(y, name="j0.raw", average=True)
        bps.shutdown()
    finally:
        ps_client.send_message, server_mod.send_message = orig_client, orig_server
        os.environ.clear()
        os.environ.update(saved)
        if srv is not None:
            srv.stop()
        sched.stop()
    return {"requests": hashlib.sha256(b"".join(sorted(sent["requests"]))).hexdigest(),
            "replies": hashlib.sha256(b"".join(sorted(sent["replies"]))).hexdigest(),
            "counts": [len(sent["requests"]), len(sent["replies"])]}


def test_job_0_sends_and_receives_the_frames_it_did_before(monkeypatch):
    from byteps_tpu_torch.core.telemetry import counters, metrics

    writers = lambda: sum(t.name == "ps-reply-writer" for t in threading.enumerate())  # noqa: E731
    n_writers = writers()
    assert job0_frames() == JOB0_FRAMES
    assert writers() <= n_writers
    for per in counters().labeled_raw().values():
        assert not any(dict(key).get("job") == "0" for key in per)
    assert not any('job="0"' in name for name in metrics().snapshot()["histograms"])


# --- two jobs of one key on one fleet --------------------------------------------


def _client(k, job: int, uid: str, **extra):
    cfg = dataclasses.replace(k.Config.from_env(), job_id=job, **extra)
    return k.PSClient(cfg, node_uid=uid)


@pytest.mark.parametrize("server, job1", [("port", "port"), ("ref", "port"), ("port", "ref")])
def test_two_jobs_of_one_key_round_over_their_own_workers(monkeypatch, server, job1):
    """Job 1 (two workers, priority 4, of ``job1``'s package) and job 2
    (one port worker) declare the same key on a fleet of three workers and
    two servers of ``server``'s package: every pull is the exact sum of
    its job's pushes, and each job's book and averaging population is its
    own."""
    from byteps_tpu_torch.common.registry import job_key

    xs = kits.vals(21, n=64, k=9)
    with kits.fleet(monkeypatch, server, workers=3, servers=2):
        a, b = (_client(kits.kit(job1), 1, f"w{i}", job_priority=4) for i in range(2))
        c = _client(kits.kit("port"), 2, "w2")
        kits.in_threads(a.connect, b.connect, c.connect)
        try:
            assert [x.num_workers for x in (a, b, c)] == [2, 2, 1]
            # ranks within the job (the thirteenth divergence)
            assert c.job_rank() == 0 and sorted({a.rank, b.rank, c.rank}) == [0, 1, 2]
            if job1 == "port":
                assert sorted([a.job_rank(), b.job_rank()]) == [0, 1]
            k1, k2 = job_key(1, 5 << 16), job_key(2, 5 << 16)
            kits.in_threads(lambda: kits.init_key([a, b], k1), lambda: kits.init_key([c], k2))
            for v in (1, 2, 3):
                got = kits.in_threads(
                    lambda v=v: kits.round_([a, b], k1, v, xs[3 * v - 3: 3 * v - 1]),
                    lambda v=v: kits.roundtrip(c, k2, xs[3 * v - 1], v))
                for out in got[0]:
                    np.testing.assert_array_equal(out, xs[3 * v - 3] + xs[3 * v - 2])
                np.testing.assert_array_equal(got[1], xs[3 * v - 1])
        finally:
            for x in (a, b, c):
                x.close()


# --- a tenant through the port's engine ------------------------------------------


def test_a_tenant_through_the_engine_beside_another_job(monkeypatch):
    """Job 2 runs the port's engine (``BYTEPS_JOB_ID=2``, priority 3, a
    quota) on a fleet of three workers; job 1's two PSClient workers push
    the same names' keys.  Job 2 averages over itself, its wire bytes and
    round trips carry its label, its rank is 0 within its job, the servers'
    ``server_job_bytes{job="2"}`` is its pushes' bytes and 12 bytes an INIT, it mints
    ``job_step_seconds{job="2"}`` and its flight records carry job 2."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.registry import get_registry, job_key
    from byteps_tpu_torch.core import flightrec, state
    from byteps_tpu_torch.core.telemetry import counters, metrics

    def job_count(name, job):
        return sum(v for key, v in counters().labeled_raw().get(name, {}).items()
                   if dict(key).get("job") == job)

    before = {n: job_count(n, "2") for n in ("wire_tx_bytes", "server_job_bytes")}
    xs = kits.vals(22, n=3000, k=6)
    with kits.fleet(monkeypatch, "port", workers=3, servers=2) as nodes:
        a, b = (_client(kits.kit("port"), 1, f"w{i}") for i in range(2))
        monkeypatch.setenv("BYTEPS_JOB_ID", "2")
        monkeypatch.setenv("BYTEPS_JOB_PRIORITY", "3")
        monkeypatch.setenv("BYTEPS_JOB_QUOTA_MBPS", "40")
        # the worker's own recorder (in one process the servers made the
        # first, with their context)
        flightrec.set_process_recorder(None)
        kits.in_threads(a.connect, b.connect, lambda: bps.init(device="cpu"))
        try:
            client = state.get_state().ps_client
            assert client.num_workers == 1 and bps.size() == 1
            # its rank within job 2, whatever its fleet rank (the
            # thirteenth divergence: byteps_tpu's rank() reads
            # DMLC_WORKER_ID), so a broadcast from root 0 has its root
            assert bps.rank() == 0 and client.rank in (0, 1, 2)
            p = torch.arange(8, dtype=torch.float32)
            assert torch.equal(bps.broadcast_parameters({"p": p.clone()})["p"], p)
            assert kits.wait(lambda: all(n._job_qos.get(2, {}).get("quota_mbps") == 20.0
                                         for n in nodes))
            assert all(n._qos_active and n._job_weight(2) == 3.0 for n in nodes)
            ctx = get_registry().declare("t.shared")
            k1 = job_key(1, ctx.declared_key << 16)
            kits.init_key([a, b], k1, n=3000)
            for v in (1, 2):
                x = torch.from_numpy(xs[v])
                got = kits.in_threads(
                    lambda x=x: bps.push_pull(x, name="t.shared", average=True),
                    lambda v=v: kits.round_([a, b], k1, v, xs[2 + 2 * v: 4 + 2 * v]))
                np.testing.assert_array_equal(got[0].numpy(), xs[v])
                for out in got[1]:
                    np.testing.assert_array_equal(out, xs[2 + 2 * v] + xs[3 + 2 * v])
            steps = [r for r in state.get_state().flightrec.ledger_tail() if r["k"] == "step"]
            assert steps and all(r["job"] == 2 for r in steps)
            bps.shutdown()
        finally:
            a.close()
            b.close()
            flightrec.set_process_recorder(None)
    tx = job_count("wire_tx_bytes", "2") - before["wire_tx_bytes"]
    assert tx == 8 * 4 + 2 * 3000 * 4  # the broadcast, then two rounds
    assert job_count("server_job_bytes", "2") - before["server_job_bytes"] == tx + 2 * 12
    hists = metrics().snapshot()["histograms"]
    assert any(n.startswith("job_step_seconds") and 'job="2"' in n for n in hists), list(hists)
    assert any(n.startswith("rpc_round_trip_seconds") and 'job="2"' in n for n in hists)


# --- an async tenant under the chaos van, with a quota ---------------------------


CHAOS_ENV = {"BYTEPS_CHAOS_SEED": "11", "BYTEPS_CHAOS_DROP": "0.05",
             "BYTEPS_CHAOS_DELAY": "0.05", "BYTEPS_CHAOS_DELAY_MS": "10",
             "BYTEPS_CHAOS_DISCONNECT": "0", "BYTEPS_CHAOS_TRUNCATE": "0",
             "BYTEPS_CHAOS_CORRUPT": "0", "BYTEPS_RPC_DEADLINE_S": "0.3",
             "BYTEPS_INIT_DEADLINE_S": "0.5", "BYTEPS_RPC_RETRIES": "8",
             "BYTEPS_RPC_BACKOFF_S": "0.05", "BYTEPS_CONNECT_RETRY_S": "0.2"}


#: the async tensor: 17,600 bytes a push, against the 12,500 bytes of idle
#: credit (0.25 s) of its server's share of the quota (0.05 MB/s of 0.1)
ASYNC_DIM = 4400


@pytest.mark.parametrize("server", ["port", "ref"])
def test_an_async_tenant_under_chaos_with_a_quota_is_the_exact_sum(monkeypatch, server):
    """``TestMultiTenantDemo::test_async_tenant_exact_under_chaos_retries``
    with the port's worker as job 2 under a quota: a sync tensor of job 1
    stays bitwise each step, the async tensor's pull is the exact running
    sum of every applied push, and its store advanced once a push, through
    dropped and delayed frames and the quota's deferrals.

    The deferral does not depend on the host's speed: each step's async
    push (ASYNC_DIM floats, one partition) costs its server 0.352 s of
    the quota's 50,000 bytes a second, past the meter's 0.25 s of idle
    credit, so the pull that follows it within 0.1 s waits for the meter
    however long the steps take; it takes twelve steps whose pulls all
    trail their pushes by more for none to wait."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.registry import get_registry
    from byteps_tpu_torch.common.types import job_of_key

    steps, dim = 12, 1024
    rng = np.random.default_rng(11)
    w = rng.standard_normal(dim).astype(np.float32)
    running = np.zeros(ASYNC_DIM, dtype=np.float32)
    with kits.fleet(monkeypatch, server, workers=1, servers=2, BYTEPS_VAN="chaos:tcp") as nodes:
        for k, v in {**CHAOS_ENV, "BYTEPS_JOB_ID": "2", "BYTEPS_JOB_QUOTA_MBPS": "0.1"}.items():
            monkeypatch.setenv(k, v)
        kits.kit("port").chaos.reset_fault_budget(None)
        bps.init(device="cpu")
        get_registry().declare("mt.sync", byteps_job="1")
        get_registry().declare("mt.async", byteps_async="1", byteps_staleness="-1")
        for _ in range(steps):
            grad = 2.0 * w
            agg = bps.push_pull(torch.from_numpy(grad), name="mt.sync", average=True).numpy()
            np.testing.assert_array_equal(agg, grad)
            w = w - np.float32(0.05) * agg
            delta = rng.standard_normal(ASYNC_DIM).astype(np.float32)
            pulled = bps.push_pull(torch.from_numpy(delta), name="mt.async",
                                   average=False).numpy()
            running = running + delta
            np.testing.assert_array_equal(pulled, running)
        snap = bps.get_robustness_counters()
        bps.shutdown()
        # one applied push a step: a lost push or a replay summed twice
        # would leave another version
        tenant = [ks for n in nodes for key, ks in n._keys.items()
                  if ks.store is not None and job_of_key(key) == 2]
        assert tenant and all(ks.async_mode and ks.store_version == steps for ks in tenant)
    assert sum(v for k, v in snap.items() if k.startswith("chaos_")) > 0, snap
    labeled = kits.kit(server).counters().snapshot_labeled().get("job_quota_deferred", {})
    assert sum(v for key, v in labeled.items() if 'job="2"' in str(key) or
               (isinstance(key, tuple) and dict(key).get("job") == "2")) > 0, labeled
