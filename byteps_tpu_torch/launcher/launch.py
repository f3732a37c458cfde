"""bpslaunch for the port: the per-host process launcher.

The reference BytePS launcher (launch.py:161-199) starts one worker process
per local GPU; ``byteps_tpu``'s starts one process per TPU host.  This one
is the GPU launcher again:

- Role from ``DMLC_ROLE`` (worker | server | scheduler | joint), topology
  from the ``DMLC_*`` environment (``dist_launcher`` sets it per host).
- Worker role: one process per local GPU.  The count is
  ``BYTEPS_LOCAL_SIZE`` when set, else the devices that
  ``CUDA_VISIBLE_DEVICES`` or ``NVIDIA_VISIBLE_DEVICES`` lists, else
  ``torch.cuda.device_count()``.  Each process gets:

  - ``BYTEPS_LOCAL_RANK``: its index on the host; ``init()`` binds
    ``cuda:<BYTEPS_LOCAL_RANK>``;
  - ``BYTEPS_LOCAL_SIZE``: the number of processes on the host;
  - ``BYTEPS_LOCAL_INIT_METHOD``: the local group's rendezvous, a
    ``torch.distributed`` init method: ``file://<path>`` (the default: a
    file in a directory the launcher makes and removes) or
    ``tcp://<address>:<port>``.  Set it before launching to choose one.

  The launcher waits for every local process.  When one fails, it
  terminates the others and exits with that process's code.
- Server / scheduler roles: ``python -m byteps_tpu_torch.server``; the
  joint role runs a server beside the workers.
- NUMA: each worker is bound with ``numactl --physcpubind`` to its share
  of the cores (``allocate_cpu``, launch.py:49-141), or to
  ``BYTEPS_VISIBLE_CPU_CORES``; ``BYTEPS_NUMA_ON=0`` turns it off.
- ``BYTEPS_ENABLE_GDB=1`` wraps each worker in gdb; ``BYTEPS_TRACE_ON=1``
  creates ``BYTEPS_TRACE_DIR/<local rank>``.

Usage:  python -m byteps_tpu_torch.launcher.launch [--] CMD [ARGS...]
"""

from __future__ import annotations

import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from byteps_tpu_torch.common.config import LOCAL_INIT_METHOD

REQUIRED_ENV = ["DMLC_ROLE"]
WORKER_REQUIRED_ENV = ["DMLC_NUM_WORKER", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT"]
NUMA_PATH = "/sys/devices/system/node"


def get_numa_nodes(
    cpu_mt: bool = True, numa_path: str = NUMA_PATH
) -> List[List[int]]:
    """Per-NUMA-node cpu id lists, e.g. [[0..15], [16..31]].

    With ``cpu_mt`` (BYTEPS_MULTITHREADED_CPU, default on) only the first
    half of each node — the physical cores — is planned; hyperthread
    siblings are re-added per allocation (launch.py:50-72)."""
    nodes: List[List[int]] = []
    if not os.path.isdir(numa_path):
        return nodes
    for entry in sorted(os.listdir(numa_path)):
        if not re.fullmatch(r"node\d+", entry):
            continue
        cpu_ids = sorted(
            int(m.group(1))
            for item in os.listdir(os.path.join(numa_path, entry))
            if (m := re.fullmatch(r"cpu(\d+)", item))
        )
        if not cpu_ids:
            continue
        if cpu_mt:
            cpu_ids = cpu_ids[: len(cpu_ids) // 2]
        nodes.append(cpu_ids)
    return nodes


def allocate_cpu(
    local_size: int,
    env: Optional[Dict[str, str]] = None,
    nodes: Optional[List[List[int]]] = None,
) -> Optional[List[List[int]]]:
    """Automatic per-process core quotas (allocate_cpu, launch.py:49-141).

    The LAST local process is the root (it runs the aggregation/PS-facing
    threads) and gets every core the others left — the reference gives the
    root more cpu for the same reason.  Knobs honored:
    ``BYTEPS_NUMA_DEFAULT_QUOTA``, ``BYTEPS_NUMA_ROOT_QUOTA``,
    ``BYTEPS_CPU_BLACKLIST``, ``BYTEPS_MULTITHREADED_CPU``.

    Returns one core list per local rank (hyperthread siblings included
    when cpu_mt), or None when no NUMA information exists.
    """
    env = env if env is not None else dict(os.environ)
    cpu_mt = env.get("BYTEPS_MULTITHREADED_CPU", "1").lower() in ("1", "true")
    if nodes is None:
        nodes = get_numa_nodes(cpu_mt)
    if not nodes or local_size < 1:
        return None
    nodes = [list(n) for n in nodes]
    cpu_num = sum(len(n) for n in nodes)

    default_quota = int(env.get("BYTEPS_NUMA_DEFAULT_QUOTA", cpu_num // local_size))
    while default_quota >= 1 and default_quota * local_size > cpu_num:
        default_quota -= 1
    root_quota = cpu_num - default_quota * (local_size - 1)
    if int(env.get("BYTEPS_NUMA_ROOT_QUOTA", "0")):
        root_quota = int(env["BYTEPS_NUMA_ROOT_QUOTA"])  # explicit wins, unclamped
    elif local_size > 1:
        # sharing the host: keep the root NUMA-local like the reference;
        # a SINGLE process per host gets every core
        node_size = len(nodes[0])
        while root_quota > node_size >= 1:
            root_quota -= 1

    blacklist = {
        int(c) for c in env.get("BYTEPS_CPU_BLACKLIST", "-1").split(",") if c
    }
    # hyperthread sibling offset: cpu i pairs with i + physical-core count
    sibling_off = cpu_num

    out: List[List[int]] = []
    for quota in [default_quota] * (local_size - 1) + [root_quota]:
        taken: List[int] = []
        q = max(1, quota)
        while q > 0:
            # prefer one NUMA node that satisfies the remaining quota
            # whole; otherwise drain the largest node and keep filling
            # from the next (multi-socket quotas span nodes)
            node = next((n for n in nodes if len(n) >= q), None)
            if node is None:
                node = max(nodes, key=len, default=None)
                if not node:
                    break
            grab = min(q, len(node))
            taken.extend(node[:grab])
            node[:] = node[grab:]
            q -= grab
        alloc = [c for c in taken if c not in blacklist]
        if cpu_mt:
            alloc.extend(
                c + sibling_off for c in taken if c + sibling_off not in blacklist
            )
        out.append(alloc)
    return out


def discover_local_size(env: Optional[Dict[str, str]] = None) -> int:
    """The number of worker processes on this host: ``BYTEPS_LOCAL_SIZE``
    when set; else the devices ``CUDA_VISIBLE_DEVICES`` (then
    ``NVIDIA_VISIBLE_DEVICES``) lists, where ``all`` means every GPU torch sees;
    else ``torch.cuda.device_count()``.  Raises when that finds no GPU."""
    env = env if env is not None else dict(os.environ)
    if env.get("BYTEPS_LOCAL_SIZE"):
        return int(env["BYTEPS_LOCAL_SIZE"])
    count = None
    for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES"):
        value = env.get(var)
        if value is None:
            continue
        value = value.strip()
        if value == "all":
            break
        count = 0 if value in ("none", "void") else len(
            [d for d in value.split(",") if d.strip()])
        break
    if count is None:
        import torch

        count = torch.cuda.device_count()
    if count < 1:
        raise SystemExit(
            "bpslaunch: no GPU is visible to this host's workers; set "
            "BYTEPS_LOCAL_SIZE to run that many worker processes"
        )
    return count


def check_env(env: Dict[str, str]) -> None:
    """Validate required topology env (check_env, launch.py:144-158)."""
    missing = [k for k in REQUIRED_ENV if not env.get(k)]
    if env.get("DMLC_ROLE") == "worker" and int(env.get("DMLC_NUM_WORKER", "1")) > 1:
        missing += [k for k in WORKER_REQUIRED_ENV if not env.get(k)]
    if missing:
        raise SystemExit(f"bpslaunch: missing required env: {', '.join(missing)}")


def numa_prefix(env: Dict[str, str]) -> List[str]:
    """numactl binding for the worker's host threads (allocate_cpu,
    launch.py:49-141): explicit ``BYTEPS_VISIBLE_CPU_CORES`` wins; with
    ``BYTEPS_NUMA_ON`` (default 1) and NUMA info present, the automatic
    quota plan binds this local rank's share."""
    if not shutil.which("numactl"):
        return []
    cores = env.get("BYTEPS_VISIBLE_CPU_CORES", "")
    if not cores and env.get("BYTEPS_NUMA_ON", "1") == "1":
        local_size = int(env.get("BYTEPS_LOCAL_SIZE", "1"))
        local_rank = int(env.get("BYTEPS_LOCAL_RANK", "0"))
        plan = allocate_cpu(local_size, env)
        if plan and local_rank < len(plan) and plan[local_rank]:
            cores = ",".join(str(c) for c in plan[local_rank])
    if not cores:
        return []
    return ["numactl", f"--physcpubind={cores}"]


def build_worker_command(cmd: List[str], env: Dict[str, str]) -> List[str]:
    full = numa_prefix(env) + cmd
    if env.get("BYTEPS_ENABLE_GDB", "0") == "1":
        full = ["gdb", "-ex", "run", "-ex", "bt", "--batch", "--args"] + full
    return full


def run_workers(cmd: List[str], env: Dict[str, str], local_size: int) -> int:
    """One process of ``cmd`` per local rank, each with its
    ``BYTEPS_LOCAL_RANK``, ``BYTEPS_LOCAL_SIZE`` and the local group's
    rendezvous.  Returns 0 when all exit 0; when one fails, terminates the
    others and returns its code.  The processes are stopped however this
    function is left."""
    tmp = None
    if not env.get(LOCAL_INIT_METHOD):
        tmp = tempfile.mkdtemp(prefix="bpslaunch-")
        env = {**env, LOCAL_INIT_METHOD: "file://" + os.path.join(tmp, "local_group")}
    procs: List[subprocess.Popen] = []
    try:
        for rank in range(local_size):
            penv = {**env, "BYTEPS_LOCAL_RANK": str(rank),
                    "BYTEPS_LOCAL_SIZE": str(local_size)}
            if penv.get("BYTEPS_TRACE_ON", "0") == "1":
                os.makedirs(os.path.join(penv.get("BYTEPS_TRACE_DIR", "."), str(rank)),
                            exist_ok=True)
            procs.append(subprocess.Popen(build_worker_command(cmd, penv), env=penv))
        while True:
            rcs = [p.poll() for p in procs]
            failed = next((rc for rc in rcs if rc not in (None, 0)), None)
            if failed is not None:
                print(f"bpslaunch: a local worker exited with {failed}; stopping the "
                      "others", file=sys.stderr, flush=True)
                return failed
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(0.05)
    finally:
        stop_processes(procs)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def stop_processes(procs: List[subprocess.Popen], timeout: float = 10.0) -> None:
    """Terminate every process still running, wait up to ``timeout``
    seconds for each, then kill what is left."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _server_command() -> List[str]:
    return [sys.executable, "-m", "byteps_tpu_torch.server"]


def main(argv: Optional[List[str]] = None) -> int:
    # a SIGTERM unwinds through run_workers' finally, which stops the workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]

    env = dict(os.environ)
    env.setdefault("DMLC_ROLE", "worker")
    check_env(env)
    role = env["DMLC_ROLE"]

    if role in ("server", "scheduler"):
        # become the server/scheduler process (launch.py:269-277)
        return subprocess.call(_server_command(), env=env)

    # worker / joint both run the user command, once per local GPU
    if not argv:
        raise SystemExit(f"bpslaunch: no command given for {role} role")
    local_size = discover_local_size(env)

    if role == "joint":
        # colocated server + workers on one host (mixed mode deployments)
        server = subprocess.Popen(_server_command(), env=dict(env, DMLC_ROLE="server"))
        try:
            return run_workers(argv, dict(env, DMLC_ROLE="worker"), local_size)
        finally:
            stop_processes([server])

    return run_workers(argv, env, local_size)


if __name__ == "__main__":
    raise SystemExit(main())
