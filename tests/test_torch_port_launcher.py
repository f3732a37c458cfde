"""The port's launchers (byteps_tpu_torch.launcher.launch and
dist_launcher) against byteps_tpu's: the copied NUMA planner, check_env,
build_role_env and ssh_command give the reference's answers on the same
inputs; GPU discovery reads the environment; the launcher runs one
process per local GPU, each with its local rank and the local group's
rendezvous, and a failing process makes it stop the others and exit
non-zero."""

import os
import subprocess
import sys
import time

import pytest

import byteps_tpu.launcher.dist_launcher as ref_dist
import byteps_tpu.launcher.launch as ref_launch
import byteps_tpu_torch.launcher.dist_launcher as port_dist
import byteps_tpu_torch.launcher.launch as port_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the layouts and knobs of tests/test_models.py's TestNumaAutoQuota
TWO_NODES = [[0, 1, 2, 3], [4, 5, 6, 7]]
PLANS = [
    (2, {"BYTEPS_MULTITHREADED_CPU": "0"}, TWO_NODES),
    (2, {"BYTEPS_MULTITHREADED_CPU": "0", "BYTEPS_NUMA_DEFAULT_QUOTA": "2",
         "BYTEPS_NUMA_ROOT_QUOTA": "3", "BYTEPS_CPU_BLACKLIST": "0"}, TWO_NODES),
    (1, {"BYTEPS_MULTITHREADED_CPU": "1"}, TWO_NODES),
    (2, {}, []),
    (1, {"BYTEPS_MULTITHREADED_CPU": "0"}, TWO_NODES),
    (2, {"BYTEPS_MULTITHREADED_CPU": "0", "BYTEPS_NUMA_DEFAULT_QUOTA": "6"}, TWO_NODES),
    (4, {"BYTEPS_MULTITHREADED_CPU": "1"}, TWO_NODES),
    (8, {"BYTEPS_MULTITHREADED_CPU": "0"}, [[0, 1, 2, 3, 4, 5]]),
]


@pytest.mark.parametrize("local_size,env,nodes", PLANS)
def test_allocate_cpu_matches_reference(local_size, env, nodes):
    assert port_launch.allocate_cpu(local_size, env=env, nodes=nodes) == \
        ref_launch.allocate_cpu(local_size, env=env, nodes=nodes)


@pytest.mark.parametrize("env", [
    {"BYTEPS_MULTITHREADED_CPU": "0", "BYTEPS_LOCAL_SIZE": "2", "BYTEPS_LOCAL_RANK": "1"},
    {"BYTEPS_MULTITHREADED_CPU": "0", "BYTEPS_LOCAL_SIZE": "2", "BYTEPS_LOCAL_RANK": "0"},
    {"BYTEPS_VISIBLE_CPU_CORES": "5,6"},
    {"BYTEPS_NUMA_ON": "0", "BYTEPS_LOCAL_SIZE": "2"},
])
def test_numa_prefix_matches_reference(monkeypatch, env):
    for mod in (port_launch, ref_launch):
        monkeypatch.setattr(mod.shutil, "which", lambda _: "/usr/bin/numactl")
        monkeypatch.setattr(mod, "get_numa_nodes",
                            lambda cpu_mt=True, numa_path="": [[0, 1], [2, 3]])
    assert port_launch.numa_prefix(env) == ref_launch.numa_prefix(env)
    assert port_launch.build_worker_command(["python", "x.py"], {**env, "BYTEPS_ENABLE_GDB": "1"}) \
        == ref_launch.build_worker_command(["python", "x.py"], {**env, "BYTEPS_ENABLE_GDB": "1"})


def test_check_env_matches_reference():
    for env in ({"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "2"}, {}):
        for fn in (port_launch.check_env, ref_launch.check_env):
            with pytest.raises(SystemExit, match="missing"):
                fn(env)
    port_launch.check_env({"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "1"})


def test_role_env_and_ssh_command_match_reference():
    for role, rank in (("worker", 2), ("server", 0), ("scheduler", 0)):
        args = (role, rank, 4, 2, "10.0.0.1", 9000, {"FOO": "1"})
        assert port_dist.build_role_env(*args) == ref_dist.build_role_env(*args)
    env = {"A": "x y", "DMLC_ROLE": "worker"}
    cmd = ["python", "train.py", "--name", "it's"]
    assert port_dist.ssh_command("h1", env, cmd) == ref_dist.ssh_command("h1", env, cmd)


def test_read_hostfile_matches_reference(tmp_path):
    path = tmp_path / "hosts"
    path.write_text("# workers\nhost-a\n\n  host-b  \n")
    assert port_dist.read_hostfile(str(path)) == ref_dist.read_hostfile(str(path)) == \
        ["host-a", "host-b"]


@pytest.mark.parametrize("env,want", [
    ({"BYTEPS_LOCAL_SIZE": "3", "CUDA_VISIBLE_DEVICES": "0"}, 3),  # explicit wins
    ({"CUDA_VISIBLE_DEVICES": "0,1,3"}, 3),
    ({"CUDA_VISIBLE_DEVICES": "2", "NVIDIA_VISIBLE_DEVICES": "0,1"}, 1),
    ({"NVIDIA_VISIBLE_DEVICES": "GPU-a,GPU-b"}, 2),
])
def test_gpu_discovery_reads_the_environment(env, want):
    assert port_launch.discover_local_size(env) == want


def test_gpu_discovery_without_a_gpu_raises(monkeypatch):
    import torch

    for env in ({"CUDA_VISIBLE_DEVICES": ""}, {"NVIDIA_VISIBLE_DEVICES": "none"}):
        with pytest.raises(SystemExit, match="no GPU"):
            port_launch.discover_local_size(env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="no GPU"):
        port_launch.discover_local_size({"NVIDIA_VISIBLE_DEVICES": "all"})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert port_launch.discover_local_size({"NVIDIA_VISIBLE_DEVICES": "all"}) == 8
    assert port_launch.discover_local_size({}) == 8


def _launch(cmd, env, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch", "--", *cmd],
        env={**os.environ, "PYTHONPATH": REPO, "BYTEPS_NUMA_ON": "0", **env},
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )


def test_launcher_runs_one_process_per_local_rank():
    """At BYTEPS_LOCAL_SIZE=2 each child sees its own local rank, the local
    size and one rendezvous shared by the host's processes.  Each child
    writes its line in one write call: the children share the launcher's
    stdout, and with PYTHONUNBUFFERED=1 a print of several arguments is
    several writes, which two children can interleave."""
    code = ("import os; e = os.environ; os.write(1, ' '.join(['CHILD', "
            "e['BYTEPS_LOCAL_RANK'], e['BYTEPS_LOCAL_SIZE'], "
            "e['BYTEPS_LOCAL_INIT_METHOD'], e['DMLC_ROLE']]).encode() + b'\\n')")
    out = _launch([sys.executable, "-c", code], {"DMLC_ROLE": "worker", "BYTEPS_LOCAL_SIZE": "2"})
    assert out.returncode == 0, out.stderr
    lines = sorted(ln.split() for ln in out.stdout.splitlines() if ln.startswith("CHILD"))
    assert [ln[1:3] for ln in lines] == [["0", "2"], ["1", "2"]]
    assert lines[0][3] == lines[1][3] and lines[0][3].startswith("file://")
    assert not os.path.exists(os.path.dirname(lines[0][3][len("file://"):]))  # removed after
    assert {ln[4] for ln in lines} == {"worker"}


def test_a_failing_child_stops_the_others(tmp_path):
    """Local rank 1 exits 3 at once; local rank 0 would sleep a minute: the
    launcher terminates it and exits 3."""
    code = ("import os, sys, time; r = os.environ['BYTEPS_LOCAL_RANK']; "
            "sys.exit(3) if r == '1' else time.sleep(60)")
    t0 = time.monotonic()
    out = _launch([sys.executable, "-c", code], {"DMLC_ROLE": "worker", "BYTEPS_LOCAL_SIZE": "2"},
                  timeout=50)
    assert out.returncode == 3, out.stderr
    assert time.monotonic() - t0 < 30
    assert "a local worker exited with 3" in out.stderr
