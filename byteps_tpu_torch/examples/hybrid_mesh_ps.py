"""The two-level topology in one training loop: collectives inside the
host and the PS push_pull between hosts (``examples/hybrid_mesh_ps.py`` of
the JAX package; BytePS's docs/architecture.md:26-44: the intra-machine
reduce, then the inter-machine push/pull).  A Megatron block on a dp x tp
mesh of the host's processes: ``w1`` column-parallel, ``w2`` row-parallel,
their product summed over tp, under ``HybridDataParallel``.

One host of four processes, each its own PS worker hop (one worker: the
hop is an identity average):

    DMLC_ROLE=worker DMLC_NUM_WORKER=1 BYTEPS_LOCAL_SIZE=4 \\
        BYTEPS_MESH_TRANSPORT=staged ... python -m byteps_tpu_torch.launcher.launch -- \\
        python -m byteps_tpu_torch.examples.hybrid_mesh_ps --steps 20 --dp 2 --tp 2

(``staged`` lets four processes share one card; on four cards leave it
unset.)  Every host runs it unchanged; the PS hop averages across hosts.
"""

from __future__ import annotations

import argparse

import numpy as np

from byteps_tpu_torch.examples._common import add_device_flag, say


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    add_device_flag(ap)
    args = ap.parse_args()

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import collectives
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.parallel import HybridDataParallel
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device=args.device)
    n_proc = args.dp * args.tp
    group = get_global_mesh()
    if group is None or group.size != n_proc:
        raise SystemExit(
            f"need {n_proc} processes for dp={args.dp}×tp={args.tp}; have "
            f"{group.size if group else 1} (run under python -m "
            f"byteps_tpu_torch.launcher.launch with BYTEPS_LOCAL_SIZE={n_proc})")
    mesh = make_training_mesh(n_proc, {"dp": args.dp, "tp": args.tp})
    dev = bps.device()

    # Megatron block: column-parallel w1, row-parallel w2
    rng = np.random.default_rng(bps.rank())
    r0 = np.random.default_rng(0)
    w1 = r0.normal(0, 0.1, (args.dim, args.hidden)).astype(np.float32)
    w2 = r0.normal(0, 0.1, (args.hidden, args.dim)).astype(np.float32)
    t, h = mesh.axis_index("tp"), args.hidden // args.tp
    model = torch.nn.Module()
    model.w1 = torch.nn.Parameter(torch.from_numpy(w1[:, t * h:(t + 1) * h].copy()).to(dev))
    model.w2 = torch.nn.Parameter(torch.from_numpy(w2[t * h:(t + 1) * h].copy()).to(dev))
    specs = {"w1": (None, "tp"), "w2": ("tp", None)}

    def loss_fn(m, batch):
        x, y = batch
        o = collectives.psum(torch.tanh(x @ m.w1) @ m.w2, "tp", mesh)
        return torch.mean((o - y) ** 2)

    hdp = HybridDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1), mesh=mesh,
                             param_specs=specs)
    x = rng.normal(size=(args.batch, args.dim)).astype(np.float32)
    y = 0.1 * rng.normal(size=(args.batch, args.dim)).astype(np.float32)
    b, d = args.batch // args.dp, mesh.axis_index("dp")
    batch = tuple(torch.from_numpy(a[d * b:(d + 1) * b]).to(dev) for a in (x, y))
    for step in range(args.steps):
        loss = hdp.step(batch, loss_fn)
        if step % 5 == 0 or step == args.steps - 1:
            say(f"[rank {bps.rank()}] step {step:3d} loss {loss:.6f}")
    bps.shutdown()
    say(f"[rank {bps.rank()}] done — the group's all-reduce + PS push_pull in every step")


if __name__ == "__main__":
    main()
