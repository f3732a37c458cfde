"""The port's examples that push through servers, against the JAX
package's, each worker in this process through an in-process fleet of its
own package (``kits.fleet``: a scheduler and two servers), the reference's
worker on conftest's CPU mesh and the port's with ``--device cpu``; and the
cluster health tool of each package against a scheduler of each:

- ``compressed_training`` with onebit and vanilla error feedback: the
  printed losses line by line within rtol 1e-4 (and one unit of the
  print's last digit; the host codec is the reference's byte for byte,
  the gradient's float32 products are torch's, not numpy's);
- ``async_training`` against an async fleet (``BYTEPS_ENABLE_ASYNC=1``):
  the printed losses within rtol 1e-5, the last below the first; without
  async it exits with the reference's message;
- ``check_cluster``: stdout and exit code equal to the reference tool's,
  the ages aside, for every node live (0), a node past ``--dead-after``
  (1) and no scheduler (2)."""

import re
import socket
import subprocess
import sys
import time

import pytest

import torch_port_kits as kits


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _run_through_fleet(pkg: str, name: str, argv: list, monkeypatch, **env) -> list:
    with kits.fleet(monkeypatch, pkg, **env):
        return kits.run_example(pkg, name, argv, monkeypatch)


def test_compressed_training_is_the_reference_s(monkeypatch):
    argv = ["--compressor", "onebit", "--ef", "vanilla", "--steps", "21"]
    want = _run_through_fleet("ref", "compressed_training", argv, monkeypatch)
    got = _run_through_fleet("port", "compressed_training", argv, monkeypatch)
    assert [ln.split()[1] for ln in want] == ["0", "10", "20"]
    kits.assert_lines_close(got, want, rtol=1e-4)
    losses = [float(ln.split()[-1]) for ln in got]
    assert losses[-1] < losses[0]


def test_async_training_is_the_reference_s(monkeypatch):
    argv = ["--rounds", "6"]
    want = _run_through_fleet("ref", "async_training", argv, monkeypatch,
                              BYTEPS_ENABLE_ASYNC="1")
    got = _run_through_fleet("port", "async_training", argv, monkeypatch,
                             BYTEPS_ENABLE_ASYNC="1")
    assert [ln.split()[1] for ln in want] == ["0", "5"]
    kits.assert_lines_close(got, want, rtol=1e-5)
    assert float(got[-1].split()[-1]) < float(got[0].split()[-1])


def test_async_training_without_async_exits_with_the_reference_s_message(monkeypatch):
    msgs = []
    for pkg in ("ref", "port"):
        with pytest.raises(SystemExit) as e:
            kits.run_example(pkg, "async_training", [], monkeypatch)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "set BYTEPS_ENABLE_ASYNC=1 on workers and servers"


def _tool(pkg: str, port: int, dead_after: str) -> tuple:
    cmd = ([sys.executable, "tools/check_cluster.py"] if pkg == "ref" else
           [sys.executable, "-m", "byteps_tpu_torch.tools.check_cluster"])
    r = subprocess.run(cmd + ["--port", str(port), "--dead-after", dead_after], cwd=kits.REPO,
                       capture_output=True, text=True, timeout=60,
                       env={"PYTHONPATH": kits.REPO, "PATH": "/usr/bin:/bin"})
    # the ages aside: the two tools ask at two moments
    return re.sub(r"last heartbeat +[\d.]+s ago", "last heartbeat <age>s ago", r.stdout), \
        r.returncode


def _silent_for_an_hour(sched, uid: str) -> None:
    """Make node ``uid``'s last heartbeat an hour old: the age the test
    sets, which the beating nodes (every 50 ms, from threads that a loaded
    host can delay) cannot reach."""
    with sched._lock:
        rank = next(n.rank for nodes in sched._nodes.values() for n in nodes if n.uid == uid)
        sched._last_seen[("worker", rank)] = time.monotonic() - 3600


@pytest.mark.parametrize("sched_pkg", ["port", "ref"])
def test_check_cluster_is_the_reference_tool(sched_pkg):
    k = kits.kit(sched_pkg)
    sched = k.Scheduler(2, 1, host="127.0.0.1", dead_node_timeout=0)
    sched.start()
    try:
        nodes = [kits.RawNode(k, sched.port, {"role": "server", "host": "127.0.0.1",
                                               "port": 1, "uid": "s0"}),
                 kits.RawNode(k, sched.port, {"role": "worker", "host": "", "port": 0,
                                               "uid": "w0", "num_workers": 2,
                                               "num_servers": 1}),
                 kits.RawNode(k, sched.port, {"role": "worker", "host": "", "port": 0,
                                               "uid": "w1", "num_workers": 2,
                                               "num_servers": 1}, beat=False)]
        assert kits.wait(lambda: all(n.books for n in nodes))
        live = {pkg: _tool(pkg, sched.port, "30") for pkg in ("ref", "port")}
        assert live["port"] == live["ref"]
        assert live["port"][1] == 0 and live["port"][0].count("OK") == 3
        _silent_for_an_hour(sched, "w1")  # w1 sends nothing after its REGISTER
        dead = {pkg: _tool(pkg, sched.port, "30") for pkg in ("ref", "port")}
        assert dead["port"] == dead["ref"]
        assert dead["port"][1] == 1 and "worker[1]: last heartbeat <age>s ago  DEAD?" in \
            dead["port"][0]
        for n in nodes:
            n.close()
    finally:
        sched.stop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    gone = {pkg: _tool(pkg, free, "30") for pkg in ("ref", "port")}
    assert gone["port"] == gone["ref"] and gone["port"][1] == 2
