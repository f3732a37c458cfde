"""Cluster health CLI: query the scheduler's heartbeat table
(``tools/check_cluster.py`` of the JAX package, on the port's transport).

    python -m byteps_tpu_torch.tools.check_cluster [--uri 127.0.0.1] [--port 9000] \\
        [--dead-after 30]

Prints each node's heartbeat age (seconds since its last message) and
exits 1 if any age exceeds ``--dead-after``, 2 if the scheduler cannot be
reached, 0 otherwise: a hook for a watchdog or an orchestrator (the
failure-detection policy layer, SURVEY §5.3).  It imports no torch.
"""

from __future__ import annotations

import argparse
import os

from byteps_tpu_torch.comm.transport import (
    Message,
    Op,
    connect,
    decode_liveness,
    recv_message,
    send_message,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--uri", default=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"))
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("DMLC_PS_ROOT_PORT", "9000")))
    ap.add_argument("--dead-after", type=float, default=30.0)
    args = ap.parse_args()

    try:
        sock = connect(args.uri, args.port, timeout=5)
    except OSError as e:
        print(f"scheduler unreachable at {args.uri}:{args.port}: {e}")
        return 2
    try:
        send_message(sock, Message(Op.QUERY, seq=1))
        live = decode_liveness(recv_message(sock).payload)
    finally:
        sock.close()

    rc = 0
    for role in ("worker", "server"):
        nodes = live.get(role, {})
        if not nodes:
            print(f"{role}s: none registered")
            continue
        for rank in sorted(nodes):
            age = nodes[rank]
            state = "OK" if age <= args.dead_after else "DEAD?"
            if state != "OK":
                rc = 1
            print(f"{role}[{rank}]: last heartbeat {age:6.1f}s ago  {state}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
