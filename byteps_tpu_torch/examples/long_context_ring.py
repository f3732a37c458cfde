"""Long-context attention over the sp axis (``examples/long_context_ring.py``
of the JAX package): the sequence is cut into contiguous blocks, one a
process of the host's group, and ring attention rotates the K/V blocks
around the ring with online-softmax accumulation (the peak score memory a
process is O(S_local x S_local)), or Ulysses trades the sequence split for
a head split by all-to-all.  Each process checks its block against dense
attention on the whole sequence.

    DMLC_ROLE=worker DMLC_NUM_WORKER=1 DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000 \\
        BYTEPS_LOCAL_SIZE=4 BYTEPS_MESH_TRANSPORT=staged \\
        python -m byteps_tpu_torch.launcher.launch -- \\
        python -m byteps_tpu_torch.examples.long_context_ring --seq 4096
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from byteps_tpu_torch.examples._common import add_device_flag, say


def qkv(batch: int, heads: int, seq: int, dh: int):
    """The whole sequence's q, k and v, (B, H, S, dh) float32 numpy arrays
    from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    shape = (batch, heads, seq, dh)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def attend(args, mesh):
    """This process's block of the causal attention over the sp ring:
    (the output block (B, H, S_local, dh), ms of the timed call, q, k and
    v whole on the device)."""
    import byteps_tpu_torch as bps

    sp = mesh.axis_size("sp") if mesh is not None else 1
    me = mesh.axis_index("sp") if mesh is not None else 0
    s_local = args.seq // sp
    q, k, v = (torch.from_numpy(a).to(bps.device())
               for a in qkv(args.batch, args.heads, args.seq, args.dh))
    blocks = [a[:, :, me * s_local:(me + 1) * s_local].contiguous() for a in (q, k, v)]
    if args.impl == "ulysses":
        from byteps_tpu_torch.parallel.ulysses import ulysses_attention

        def fn():
            return ulysses_attention(*blocks, "sp", sp, causal=True, mesh=mesh)
    else:
        from byteps_tpu_torch.parallel.ring_attention import ring_attention

        def fn():
            return ring_attention(*blocks, "sp", sp, causal=True, mesh=mesh)
    with torch.no_grad():
        fn()
        if q.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if q.is_cuda:
            torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, (q, k, v)


def dense_error(out, q, k, v, me: int) -> float:
    """The largest difference of the block ``out`` from dense causal
    attention on the whole sequence, at the rows of block ``me``."""
    s_local, seq, dh = out.shape[2], q.shape[2], q.shape[3]
    rows = torch.arange(me * s_local, (me + 1) * s_local, device=q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows], k) / np.sqrt(dh)
    mask = rows[:, None] >= torch.arange(seq, device=q.device)[None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    ref = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return float((out - ref).abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--impl", choices=["ring", "ulysses"], default="ring",
                    help="sequence-parallel strategy (ulysses needs heads divisible "
                    "by the group's size)")
    add_device_flag(ap)
    args = ap.parse_args()

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import get_global_mesh
    from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh

    bps.init(device=args.device)
    group = get_global_mesh()
    sp = group.size if group is not None else 1
    if args.seq % sp:
        raise SystemExit(f"--seq must divide the {sp}-process ring")
    mesh = make_training_mesh(sp, {"sp": sp}) if group is not None else None
    say(f"{args.impl} over {sp} devices, {args.seq} total tokens, {args.seq // sp}/device")

    out, ms, (q, k, v) = attend(args, mesh)
    say(f"{args.impl} attention: {ms:.1f} ms/step, output "
        f"{(args.batch, args.heads, args.seq, args.dh)}")

    # spot-check against dense attention on the whole sequence
    err = dense_error(out, q, k, v, mesh.axis_index("sp") if mesh is not None else 0)
    say(f"max abs err vs dense: {err:.2e}")
    if not err < 1e-3:
        raise SystemExit(f"max abs err vs dense {err:.2e} is not below 1e-3")
    bps.shutdown()


if __name__ == "__main__":
    main()
