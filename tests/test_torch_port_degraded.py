"""The port's degraded surface against byteps_tpu's.

- ``DegradedError``: with the in-place heal off, a step whose push dies
  past its retries fails degraded, and the next submit runs the init
  barrier again; with ``BYTEPS_DEGRADED_STEP_RETRIES`` the api heals it
  in place (``PipelineEngine.heal_degraded``: a resync, the journaled
  round replayed, the round pulled) when the client's own heal failed,
  or else submits it again.  The reference's worker gives the same pulls
  and counts on the same inputs.
- Under a local group (two gloo ranks on the CPU, one PS worker) the
  root's degraded push_pull reaches every local rank, none waits in the
  broadcast, and a degraded-step heal gives every rank the fault-free
  average.  The reference has no counterpart: the average is held to
  numpy's.

Exact throughout.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
import torch_port_ranks as ranks
from byteps_tpu.comm import chaos as rchaos
from byteps_tpu.comm.ps_client import PSClient as RefClient
from byteps_tpu.common.types import DegradedError as RefDegradedError
from byteps_tpu.core.telemetry import counters as ref_counters
from byteps_tpu_torch.comm import chaos as pchaos
from byteps_tpu_torch.comm.ps_client import PSClient
from byteps_tpu_torch.comm.rendezvous import Scheduler as PortScheduler
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common.config import Config as PortConfig
from byteps_tpu_torch.common.types import DegradedError
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.telemetry import counters
from byteps_tpu_torch.server.server import PSServer as PortServer


def _reset_chaos() -> None:
    for mod in (pchaos, rchaos):
        mod.reset_conn_indices()
        mod.reset_fault_budget()


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for k in ("BYTEPS_VAN", "BYTEPS_WIRE_CHECKSUM", "BYTEPS_NATIVE_CLIENT",
              "BYTEPS_DEGRADED_STEP_RETRIES"):
        monkeypatch.delenv(k, raising=False)
    _reset_chaos()
    counters().reset()
    ref_counters().reset()
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()
    _reset_chaos()


@contextlib.contextmanager
def _fleet(monkeypatch):
    """A port scheduler and one Python server under the chaos van with no
    faults of its own."""
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_NUM_WORKER": "1",
           "DMLC_NUM_SERVER": "1", "BYTEPS_FORCE_DISTRIBUTED": "1",
           "BYTEPS_VAN": "chaos:tcp", "BYTEPS_WIRE_CHECKSUM": "1", "BYTEPS_CHAOS_DROP": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sched = PortScheduler(1, 1, host="127.0.0.1")
    sched.start()
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(sched.port))
    srv = PortServer(PortConfig.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        yield srv
    finally:
        srv.stop()
        sched.stop()


def _degraded_run(monkeypatch, worker: str, mode: str) -> tuple:
    """One worker on a port fleet whose first push and its retry die.
    ``mode``: "raise" (heal off, no step retries), "resubmit" (heal off,
    step retries: the init barrier again) or "heal" (step retries, the
    client's heal failing once: the api heals in place).  Returns the
    pulls (None where DegradedError surfaced) and the worker's counters."""
    env = {"BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "11",
           "BYTEPS_CHAOS_FAULT_BUDGET": "2", "BYTEPS_RPC_DEADLINE_S": "0.2",
           "BYTEPS_RPC_RETRIES": "1", "BYTEPS_RPC_BACKOFF_S": "0.02",
           "BYTEPS_RESYNC_DEADLINE_S": "0" if mode != "heal" else "5",
           "BYTEPS_DEGRADED_STEP_RETRIES": "0" if mode == "raise" else "2"}
    x = np.arange(200, dtype=np.float32)
    outs = []
    with _fleet(monkeypatch):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        api, err = (pbps, DegradedError) if worker == "port" else (jbps, RefDegradedError)
        client_cls = PSClient if worker == "port" else RefClient
        if mode == "heal":
            real, calls = client_cls._heal_in_place, []

            def fails_once(self, key, sid):
                calls.append(key)
                return len(calls) > 1 and real(self, key, sid)

            monkeypatch.setattr(client_cls, "_heal_in_place", fails_once)
        api.init(**({"device": "cpu"} if worker == "port" else {}))
        for i in range(2):
            src = torch.from_numpy(x + i) if worker == "port" else x + i
            try:
                outs.append(np.asarray(api.push_pull(src, name="deg.one", average=False))
                            .tobytes())
            except err:
                outs.append(None)
        if worker == "port":
            reinit = sorted(port_state.get_state().engine._reinit_names)
        else:
            from byteps_tpu.core.state import get_state

            reinit = sorted(get_state().engine._reinit_names)
        api.shutdown()
    snap = (counters() if worker == "port" else ref_counters()).snapshot()
    return outs, {k: snap.get(k, 0) for k in (
        "rpc_giveup", "degraded_jobs", "resync_attempt", "resync_replayed_rounds",
        "chaos_drop")}, reinit


@pytest.mark.parametrize("mode", ["raise", "resubmit", "heal"])
def test_degraded_steps_surface_resubmit_and_heal_as_the_reference(monkeypatch, mode):
    port = _degraded_run(monkeypatch, "port", mode)
    counters().reset()
    ref_counters().reset()
    _reset_chaos()
    ref = _degraded_run(monkeypatch, "ref", mode)
    x = np.arange(200, dtype=np.float32)
    want = [None if mode == "raise" else x.tobytes(), (x + 1).tobytes()]
    assert port[0] == ref[0] == want
    assert port[1] == ref[1] and port[2] == ref[2] == []
    assert port[1]["rpc_giveup"] == port[1]["degraded_jobs"] == 1
    assert port[1]["resync_replayed_rounds"] == (1 if mode == "heal" else 0)


def test_a_degraded_host_level_push_pull_reaches_every_local_rank(tmp_path, monkeypatch):
    """Two local ranks on the CPU (gloo) under one PS worker, its root's
    pushes lost: both ranks raise DegradedError, then train on; with
    degraded-step retries the root heals in place and both ranks get the
    fault-free average bit for bit."""
    monkeypatch.setenv("BYTEPS_VAN", "chaos:tcp")
    sched = PortScheduler(1, 1, host="127.0.0.1")
    sched.start()
    srv = PortServer(PortConfig(num_worker=1, num_server=1, ps_root_uri="127.0.0.1",
                                ps_root_port=sched.port))
    threading.Thread(target=srv.start, daemon=True).start()
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
           "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1", "BYTEPS_FORCE_DISTRIBUTED": "1",
           "BYTEPS_CHAOS_DROP": "1.0", "BYTEPS_CHAOS_OPS": "push",
           "BYTEPS_CHAOS_FAULT_BUDGET": "0", "BYTEPS_RPC_DEADLINE_S": "0.2",
           "BYTEPS_RPC_RETRIES": "1", "BYTEPS_RPC_BACKOFF_S": "0.02",
           "BYTEPS_RESYNC_DEADLINE_S": "0", "BYTEPS_VAN": ""}
    try:
        procs = ranks.spawn_group("degraded", 2, str(tmp_path), env=env)
        res = ranks.collect(procs, "degraded", 2, str(tmp_path), timeout=90)
    finally:
        srv.stop()
        sched.stop()
    xs = ranks.member_inputs(60, 2, (ranks.DEGRADED_N,))
    two = np.float32(2)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["clean"], (xs[0] + xs[1]) / two)
        assert out["raised"] is not None and "push_pull failed" in out["raised"], out["raised"]
        np.testing.assert_array_equal(out["after"], ((xs[0] + 1) + (xs[1] + 1)) / two)
        np.testing.assert_array_equal(out["healed"], ((xs[0] + 2) + (xs[1] + 2)) / two)
    root = res[0]["counters"]
    assert root.get("resync_replayed_rounds") == 1 and root.get("degraded_jobs") == 1, root
    assert res[0]["reinit"] == [] and res[1]["reinit"] is None
