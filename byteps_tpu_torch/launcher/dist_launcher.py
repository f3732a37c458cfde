"""Multi-host SSH fan-out launcher for the port.

Re-design of launcher/dist_launcher.py (SURVEY §2.6), as in
``byteps_tpu.launcher.dist_launcher``: reads host files for workers and
servers, SSHes the port's launcher (``python -m
byteps_tpu_torch.launcher.launch``) onto every host with the proper
``DMLC_*`` role env, and streams logs to ``sshlog/<host>.log``.  The
scheduler runs on the first server host (or ``--scheduler-host``).  A
worker host's launcher starts one process per local GPU; ``DMLC_NUM_WORKER``
counts hosts, as in BytePS.

Usage:
    python -m byteps_tpu_torch.launcher.dist_launcher \
        --worker-hostfile workers.txt --server-hostfile servers.txt \
        [--scheduler-port 9000] [--env KEY=VAL ...] -- CMD [ARGS...]
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import threading
from typing import Dict, List, Optional


def read_hostfile(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def build_role_env(
    role: str,
    rank: int,
    num_workers: int,
    num_servers: int,
    root_uri: str,
    root_port: int,
    extra: Dict[str, str],
) -> Dict[str, str]:
    """Per-role env exports (dist_launcher.py:55-90)."""
    env = {
        "DMLC_ROLE": role,
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": str(num_servers),
        "DMLC_PS_ROOT_URI": root_uri,
        "DMLC_PS_ROOT_PORT": str(root_port),
    }
    if role == "worker":
        env["DMLC_WORKER_ID"] = str(rank)
        env["BYTEPS_GLOBAL_RANK"] = str(rank)
    env.update(extra)
    return env


def ssh_command(host: str, env: Dict[str, str], cmd: List[str]) -> List[str]:
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    remote = f"{exports} {' '.join(shlex.quote(c) for c in cmd)}"
    return [
        "ssh", "-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes",
        host, remote,
    ]


def _run_logged(argv: List[str], log_path: str) -> int:
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as log:
        return subprocess.call(argv, stdout=log, stderr=subprocess.STDOUT)


def main(args: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worker-hostfile", required=True)
    p.add_argument("--server-hostfile", default="")
    p.add_argument("--scheduler-host", default="")
    p.add_argument("--scheduler-port", type=int, default=9000)
    p.add_argument("--env", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--log-dir", default="sshlog")
    p.add_argument(
        "--remote-python", default="python3",
        help="python executable on remote hosts (the local sys.executable "
        "path rarely exists remotely)",
    )
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    ns = p.parse_args(args)

    workers = read_hostfile(ns.worker_hostfile)
    servers = read_hostfile(ns.server_hostfile) if ns.server_hostfile else []
    cmd = ns.cmd[1:] if ns.cmd[:1] == ["--"] else ns.cmd
    if not cmd:
        raise SystemExit("dist_launcher: no worker command given")
    extra = dict(kv.split("=", 1) for kv in ns.env)
    sched_host = ns.scheduler_host or (servers[0] if servers else workers[0])

    launch = [ns.remote_python, "-m", "byteps_tpu_torch.launcher.launch", "--"]
    worker_threads: List[threading.Thread] = []
    rcs: Dict[str, int] = {}

    def popen_logged(argv: List[str], tag: str) -> subprocess.Popen:
        os.makedirs(ns.log_dir, exist_ok=True)
        log = open(f"{ns.log_dir}/{tag}.log", "w")
        return subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT)

    # scheduler/server run indefinitely → keep Popen handles so we can tear
    # them down once the workers finish (the reference leaves them running;
    # we do the tidy thing and reap them)
    services: List[subprocess.Popen] = []
    services.append(
        popen_logged(
            ssh_command(
                sched_host,
                build_role_env("scheduler", 0, len(workers), len(servers), sched_host, ns.scheduler_port, extra),
                launch,
            ),
            "scheduler",
        )
    )
    for i, host in enumerate(servers):
        services.append(
            popen_logged(
                ssh_command(
                    host,
                    build_role_env("server", i, len(workers), len(servers), sched_host, ns.scheduler_port, extra),
                    launch,
                ),
                f"server-{i}",
            )
        )

    def run_worker(i: int, host: str) -> None:
        env = build_role_env("worker", i, len(workers), len(servers), sched_host, ns.scheduler_port, extra)
        rcs[f"worker-{i}"] = _run_logged(
            ssh_command(host, env, launch + cmd), f"{ns.log_dir}/worker-{i}.log"
        )

    for i, host in enumerate(workers):
        t = threading.Thread(target=run_worker, args=(i, host), daemon=True)
        t.start()
        worker_threads.append(t)

    # wait for WORKERS only (services never exit on their own)
    for t in worker_threads:
        t.join()
    for p in services:
        p.terminate()
    failed = {k: v for k, v in rcs.items() if v != 0}
    if failed:
        print(f"dist_launcher: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
