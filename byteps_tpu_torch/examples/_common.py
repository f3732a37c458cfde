"""What the examples share: the ``--device`` flag, the host's group as a
mesh, and the rank tag of a printed line."""

from __future__ import annotations

import argparse
import sys


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="the device init() binds: cuda:<local rank> by default (init() "
                         "raises without a card); cpu runs the example without one")


def host_mesh():
    """The host's group: the launcher's local group, else this process
    alone (a mesh of one rank runs no collective)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import Mesh, get_global_mesh

    mesh = get_global_mesh()
    if mesh is not None:
        return mesh
    dev = bps.device()
    return Mesh(0, 1, dev, "nccl" if dev.type == "cuda" else "gloo")


def say(line: str) -> None:
    """Print ``line``; in a local group of more than one process, tagged
    with this process's local rank (each rank prints its own lines).  The
    line and its newline go in one write: the group's processes share one
    output, unbuffered under the launcher."""
    import byteps_tpu_torch as bps

    n = bps.local_size()
    sys.stdout.write(f"[local {bps.local_rank()}/{n}] {line}\n" if n > 1 else f"{line}\n")
    sys.stdout.flush()
