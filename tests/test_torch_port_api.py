"""The port's runtime and API (byteps_tpu_torch) against byteps_tpu's on the
same calls: init and its refusals, push_pull on one worker, handles, tensor
keys, suspend/resume, DistributedOptimizer hooks, parameter conversion, and
that importing the port loads neither JAX nor byteps_tpu."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as bps
from byteps_tpu.common import types as jtypes
from byteps_tpu.core.handle_manager import HandleManager as JaxHandleManager
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common import types as ptypes
from byteps_tpu_torch.core import state as port_state
from byteps_tpu_torch.core.handle_manager import HandleManager
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the cores to
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    yield
    port_state.shutdown_state()
    port_registry.reset_registry()
    port_config.clear_config()


def test_init_on_cpu_binds_the_cpu():
    bps.init(device="cpu")
    assert bps.device() == torch.device("cpu")
    assert (bps.rank(), bps.size(), bps.local_rank(), bps.local_size()) == (0, 1, 0, 1)


def test_init_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bps.init()
    assert not port_state.get_state().initialized


def test_init_binds_local_rank_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("BYTEPS_LOCAL_RANK", "3")
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "4")
    bps.init()
    assert bps.device() == torch.device("cuda", 3)


@pytest.mark.parametrize("local_rank", ["0", "1"])
def test_distributed_worker_without_the_local_rendezvous_raises(monkeypatch, local_rank):
    """A distributed process at local size > 1 needs its host's group: only
    the group's root joins the PS, and the others reach the PS through it.
    Without the launcher's rendezvous init() raises, naming the launcher,
    before it dials anything."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    monkeypatch.setenv("BYTEPS_LOCAL_RANK", local_rank)
    monkeypatch.delenv("BYTEPS_LOCAL_INIT_METHOD", raising=False)
    with pytest.raises(RuntimeError, match="python -m byteps_tpu_torch.launcher.launch"):
        bps.init(device="cpu")
    assert not port_state.get_state().initialized


def test_init_brings_up_the_group_from_the_rendezvous_at_local_size_one(monkeypatch, tmp_path):
    """Under the launcher at BYTEPS_LOCAL_SIZE=1, init() brings up the
    host's one-rank group from BYTEPS_LOCAL_INIT_METHOD and makes it the
    global mesh; push_pull goes through its three levels and gives the
    input's values; shutdown() tears the group down."""
    import torch.distributed as dist

    from byteps_tpu_torch.comm.mesh import get_global_mesh

    monkeypatch.setenv("BYTEPS_LOCAL_INIT_METHOD", "file://" + str(tmp_path / "store"))
    bps.init(device="cpu")
    mesh = get_global_mesh()
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo") and dist.is_initialized()
    assert port_state.get_state().mesh is mesh
    assert (bps.rank(), bps.size(), bps.local_rank(), bps.local_size()) == (0, 1, 0, 1)
    x = torch.linspace(-1.0, 2.0, 7)
    assert torch.equal(bps.push_pull(x, name="one.rank"), x)
    assert torch.equal(bps.push_pull(x, name="one.rank.sum", average=False), x)
    bps.shutdown()
    assert get_global_mesh() is None and not dist.is_initialized()


@pytest.mark.parametrize("env", [
    {"BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_WIRE_LOSSLESS": "1"},
    {"BYTEPS_FORCE_DISTRIBUTED": "1", "BYTEPS_VAN": "shm"},
    {"DMLC_ROLE": "server"},
])
def test_distributed_topology_raises(monkeypatch, env):
    """init() of a server or scheduler role raises, pointing at the process
    entry that runs it.  A distributed worker with lossless frames or the
    shm van (planes that raised before they were ported) inits against a
    fleet of the port on that van and pushes through it."""
    import tempfile
    import threading

    from byteps_tpu_torch.comm.rendezvous import Scheduler
    from byteps_tpu_torch.server.server import PSServer

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env.get("DMLC_ROLE") == "server":
        with pytest.raises(ValueError, match="python -m byteps_tpu_torch.server"):
            bps.init(device="cpu")
        assert not port_state.get_state().initialized
        return
    monkeypatch.setenv("BYTEPS_SOCKET_PATH", tempfile.mkdtemp(dir="/tmp"))
    sched = Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
                 "DMLC_NUM_SERVER": "1"}.items():
        monkeypatch.setenv(k, v)
    srv = PSServer(port_config.Config.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        bps.init(device="cpu")
        x = torch.linspace(-1.0, 2.0, 4096)
        assert torch.equal(bps.push_pull(x, name="topology.grad"), x)
        bps.shutdown()
    finally:
        srv.stop()
        sched.stop()
    assert srv.host.startswith("shm+unix://") == (env.get("BYTEPS_VAN") == "shm")


def test_distributed_init_against_a_fake_cluster(monkeypatch):
    """BYTEPS_FORCE_DISTRIBUTED=1 with a scheduler and a server of the port
    in-process: init() registers, the rank and size come from the address
    book, push_pull goes through the server, shutdown() stops the engine."""
    import threading

    from byteps_tpu_torch.comm.rendezvous import Scheduler
    from byteps_tpu_torch.server.server import PSServer

    sched = Scheduler(1, 1, host="127.0.0.1")
    sched.start()
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(sched.port),
                 "DMLC_NUM_SERVER": "1", "BYTEPS_FORCE_DISTRIBUTED": "1"}.items():
        monkeypatch.setenv(k, v)
    srv = PSServer(port_config.Config.from_env())
    threading.Thread(target=srv.start, daemon=True).start()
    try:
        bps.init(device="cpu")
        st = port_state.get_state()
        assert st.engine is not None and st.ps_client is not None
        assert (bps.rank(), bps.size()) == (0, 1)
        x = torch.arange(10.0)
        y = bps.push_pull(x, name="fake.cluster")
        assert y is not x and torch.equal(y, x)
        assert srv._keys  # the server holds the tensor's key
        bps.shutdown()
        assert port_state.get_state().engine is None
    finally:
        srv.stop()
        sched.stop()


def test_api_before_init_raises():
    with pytest.raises(RuntimeError, match="init"):
        bps.push_pull(torch.ones(2), name="x")


def test_push_pull_is_identity_on_one_worker():
    bps.init(device="cpu")
    t = torch.arange(6.0).reshape(2, 3)
    assert bps.push_pull(t, name="grad.a") is t
    h = bps.push_pull_async(t, name="grad.a", priority=-1)
    assert bps.poll(h)
    assert bps.synchronize(h) is t
    # the reference's numpy path returns the same values
    jbps.init()
    np.testing.assert_array_equal(jbps.push_pull(t.numpy(), name="grad.a"), t.numpy())


def test_unknown_and_consumed_handles_raise_like_the_reference():
    bps.init(device="cpu")
    h = bps.push_pull_async(torch.ones(1), name="g")
    bps.synchronize(h)
    for fn in (bps.poll, bps.synchronize):
        with pytest.raises(ValueError, match="unknown handle"):
            fn(h)


@pytest.mark.parametrize("kind, error", [
    ("Degraded", ptypes.DegradedError),
    ("Aborted", RuntimeError),
    ("OK", None),
])
def test_handle_status_errors_match_the_reference(kind, error):
    for manager, types in ((HandleManager(), ptypes), (JaxHandleManager(), jtypes)):
        h = manager.allocate()
        assert not manager.poll(h)
        status = getattr(types.Status, kind)(*(() if kind == "OK" else ("lost",)))
        manager.mark_done(h, "result", status)
        manager.mark_done(h + 1, "late")  # unknown handle: dropped
        if error is None:
            assert manager.wait_and_clear(h) == "result"
        else:
            expected = types.DegradedError if kind == "Degraded" else error
            with pytest.raises(expected, match="lost"):
                manager.wait_and_clear(h)


def test_declared_keys_equal_the_reference(monkeypatch):
    names = ["Gradient.embed", "Gradient.layers.0.wq", "Parameter.head", "x"]
    got = [bps.declare_tensor(n) for n in names]
    want = [jbps.declare_tensor(n) for n in names]
    assert got == want == [0, 1, 2, 3]
    assert bps.declare_tensor("x") == 3  # re-declaring keeps the key
    monkeypatch.setenv("BYTEPS_JOB_ID", "5")
    port_config.clear_config()
    from byteps_tpu.common import config as jconfig

    jconfig.clear_config()
    pj = bps.get_registry().declare("job.tensor")
    jj = jbps.get_registry().declare("job.tensor")
    assert (pj.job, pj.base_key, pj.key_for_part(7)) == (jj.job, jj.base_key, jj.key_for_part(7))
    assert pj.base_key == (5 << 48) | (4 << 16)


def test_suspend_resume_keeps_keys():
    bps.init(device="cpu")
    names = ["a", "b", "c"]
    keys = [bps.declare_tensor(n, byteps_compressor="onebit") for n in names]
    bps.suspend()
    assert not port_state.get_state().initialized
    bps.resume(num_workers=1)
    assert bps.device() == torch.device("cpu")
    reg = bps.get_registry()
    assert [reg.get(n).declared_key for n in names] == keys
    assert reg.get("b").kwargs == {"byteps_compressor": "onebit"}
    assert bps.declare_tensor("d") == 3


def test_datatype_ids_equal_the_reference():
    import ml_dtypes

    pairs = [
        (torch.float32, np.float32), (torch.float64, np.float64),
        (torch.float16, np.float16), (torch.uint8, np.uint8), (torch.int32, np.int32),
        (torch.int8, np.int8), (torch.int64, np.int64), (torch.bfloat16, ml_dtypes.bfloat16),
    ]
    for t, n in pairs:
        assert int(ptypes.to_datatype(t)) == int(jtypes.to_datatype(n))
    with pytest.raises(TypeError):
        ptypes.to_datatype(torch.complex64)


def test_broadcast_parameters_and_object_on_one_worker():
    bps.init(device="cpu")
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = model.state_dict()
    assert bps.broadcast_parameters(sd, root_rank=0) is sd
    bps.broadcast_parameters(model.named_parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(TypeError):
        bps.broadcast_parameters(model)
    obj = {"step": 3}
    assert bps.broadcast_object(obj) is obj


def test_distributed_optimizer_hooks_push_device_gradients(monkeypatch):
    """Each gradient is pushed from its hook during backward, named
    Gradient.<name>, with priority −(declaration index), as the tensor
    itself (no host copy); step() waits, then steps the inner optimizer."""
    from byteps_tpu_torch import optim

    bps.init(device="cpu")
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
    pushed = []
    real = optim.push_pull_async

    def spy(tensor, name, average, priority):
        pushed.append((name, priority, tensor))
        return real(tensor, name, average=average, priority=priority)

    monkeypatch.setattr(optim, "push_pull_async", spy)
    opt = bps.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                   named_parameters=model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert [bps.get_registry().get(f"Gradient.{n}").declared_key for n in names] == [0, 1, 2, 3]
    w0 = model[0].weight.detach().clone()
    model(torch.ones(2, 3)).sum().backward()
    params = dict(model.named_parameters())
    assert sorted(p for _, p, _ in pushed) == [-3, -2, -1, 0]
    for name, priority, tensor in pushed:
        n = name.removeprefix("Gradient.")
        assert tensor is params[n].grad and priority == -names.index(n)
    opt.step()
    assert torch.allclose(model[0].weight, w0 - 0.1 * model[0].weight.grad)


def test_distributed_optimizer_accumulates_backward_passes(monkeypatch):
    from byteps_tpu_torch import optim

    bps.init(device="cpu")
    model = torch.nn.Linear(2, 1, bias=False)
    pushed = []
    real = optim.push_pull_async
    monkeypatch.setattr(optim, "push_pull_async",
                        lambda t, name, average, priority: pushed.append(name)
                        or real(t, name, average=average, priority=priority))
    opt = bps.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1.0),
                                   named_parameters=model.named_parameters(),
                                   backward_passes_per_step=2)
    w0 = model.weight.detach().clone()
    model(torch.ones(1, 2)).sum().backward()
    assert pushed == [] and opt.step() is None
    assert torch.equal(model.weight, w0)
    model(torch.ones(1, 2)).sum().backward()
    assert pushed == ["Gradient.weight"]
    opt.step()
    assert torch.allclose(model.weight, w0 - 2.0)  # two accumulated passes


def test_distributed_optimizer_does_not_keep_the_model_alive():
    """A dropped model and its optimizer are freed: the gradient hooks do
    not hold the optimizer, which holds the parameters."""
    import gc
    import weakref

    bps.init(device="cpu")

    def train_once():
        model = torch.nn.Linear(4, 4)
        opt = bps.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                       named_parameters=model.named_parameters())
        model(torch.ones(2, 4)).sum().backward()
        opt.step()
        return weakref.ref(model.weight), weakref.ref(opt)

    param, opt = train_once()
    gc.collect()
    assert param() is None and opt() is None


def test_distributed_optimizer_rejects_duplicate_names():
    bps.init(device="cpu")
    p = torch.nn.Parameter(torch.ones(1))
    q = torch.nn.Parameter(torch.ones(1))
    with pytest.raises(ValueError, match="duplicate"):
        bps.DistributedOptimizer(torch.optim.SGD([p, q], lr=1.0),
                                 named_parameters=[("w", p), ("w", q)])


@pytest.mark.parametrize("pp_size", [1, 2])
def test_params_round_trip_exactly(pp_size):
    cfg = tt.tiny_test(attn_bias=True, n_kv_heads=2)
    np_params = tt.init_params(cfg, seed=3, pp_size=pp_size)
    sd = params_from_jax(np_params, cfg)
    assert list(sd)[:5] == ["embed", "pos", "ln_f_s", "ln_f_b", "head"]
    assert "layers.3.wq_b" in sd
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    back = params_to_jax(model.state_dict(), cfg, pp_size=pp_size)
    assert list(back) == list(np_params)
    for name in np_params:
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], np_params[name], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in np_params.items() if k != "head"}, cfg)


def test_import_loads_neither_jax_nor_byteps_tpu():
    """A fresh interpreter that imports every module of the port, loads
    its native library and runs a host codec: no module of JAX or
    byteps_tpu is imported, and no file under byteps_tpu/ is opened or
    loaded (this process has JAX loaded by conftest)."""
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys
        opened = []
        sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                         if ev in ("open", "ctypes.dlopen") and args and args[0] else None)
        import numpy as np
        import byteps_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(byteps_tpu_torch.__path__,
                                                      "byteps_tpu_torch.")]
        assert "byteps_tpu_torch.server.server" in mods, mods
        assert "byteps_tpu_torch.server.native" in mods, mods
        for name in mods:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m in ("jax", "optax", "flax", "byteps_tpu")
               or m.startswith(("jax.", "optax.", "flax.", "byteps_tpu."))]
        assert not bad, bad
        from byteps_tpu_torch.compression.impl import OneBitCompressor
        from byteps_tpu_torch.native import get_lib
        get_lib()
        OneBitCompressor(100).compress(np.ones(100, np.float32))
        ref = os.path.join(os.getcwd(), "byteps_tpu") + os.sep
        with open("/proc/self/maps") as f:
            opened += [ln.split()[-1] for ln in f if len(ln.split()) >= 6]
        bad = [p for p in opened if os.path.abspath(p).startswith(ref)]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("entry", ["byteps_tpu_torch.server.__main__",
                                   "byteps_tpu_torch.launcher.launch",
                                   "byteps_tpu_torch.server.native"])
def test_a_server_or_launcher_process_starts_without_torch(entry):
    """The package's names load on first use: the server and scheduler
    entry, the C++ server's wrapper and the launcher import no torch, so
    each fleet's processes start without its import; the public names
    still resolve, and an unknown one raises AttributeError."""
    code = textwrap.dedent(f"""
        import sys
        import {entry}
        assert "torch" not in sys.modules, "{entry} imported torch"
        import byteps_tpu_torch as bps
        assert "torch" not in sys.modules
        assert callable(bps.push_pull) and bps.parallel.DistributedDataParallel
        assert "torch" in sys.modules
        try:
            bps.no_such_name
        except AttributeError:
            pass
        else:
            raise AssertionError("an unknown name resolved")
        assert sorted(set(bps.__all__) - set(dir(bps))) == []
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_source_imports_jax_or_byteps_tpu():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|flax|byteps_tpu)(\.|\s|$)", re.M)
    roots = [os.path.join(REPO, "byteps_tpu_torch"), os.path.join(REPO, "chip_smoke.py")]
    files = [roots[1]] + [
        os.path.join(d, f) for d, _, fs in os.walk(roots[0]) for f in fs if f.endswith(".py")
    ]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_server_processes_import_neither_jax_nor_byteps_tpu(monkeypatch, tmp_path):
    """``python -m byteps_tpu_torch.server`` as the scheduler and as a
    server, with this process as the worker: every module the two
    processes import (``-X importtime`` lists them) is neither JAX nor
    byteps_tpu, and a push_pull goes through them."""
    import signal

    env = {**os.environ, "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
           "DMLC_PS_ROOT_URI": "127.0.0.1", "PYTHONPATH": REPO}
    cmd = [sys.executable, "-X", "importtime", "-m", "byteps_tpu_torch.server"]
    logs = [tmp_path / "scheduler.err", tmp_path / "server.err"]
    procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "DMLC_ROLE": "scheduler",
                                                  "DMLC_PS_ROOT_PORT": "0"},
                              stdout=subprocess.PIPE, stderr=logs[0].open("w"), text=True)]
    try:
        line = procs[0].stdout.readline().strip()
        assert line.startswith("BYTEPS_SCHEDULER_PORT="), line
        port = line.split("=", 1)[1]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env={**env, "DMLC_ROLE": "server", "DMLC_PS_ROOT_PORT": port},
            stdout=subprocess.DEVNULL, stderr=logs[1].open("w")))
        for k, v in {**env, "DMLC_PS_ROOT_PORT": port, "BYTEPS_FORCE_DISTRIBUTED": "1"}.items():
            monkeypatch.setenv(k, v)
        bps.init(device="cpu")
        x = torch.arange(6, dtype=torch.int32)
        assert torch.equal(bps.push_pull(x, name="via.processes"), x)
        bps.shutdown()
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=30)
    for p, log in zip(procs, logs):
        err = log.read_text()
        imported = [ln.rsplit("|", 1)[1].strip() for ln in err.splitlines()
                    if ln.startswith("import time:") and "|" in ln]
        assert "byteps_tpu_torch.server.server" in imported
        bad = [m for m in imported if m.split(".")[0] in ("jax", "optax", "flax", "byteps_tpu")]
        assert not bad, bad
        assert p.returncode in (0, -signal.SIGTERM), err[-2000:]
