#!/usr/bin/env python3
"""The port's model parallelism over NCCL on four GPUs of one host.

    python3 tools/torch_port_model_parallel.py

Run from the repository root on a host with four GPUs.  It runs
chip_smoke.py's phases (h) and (i) (``train_model_parallel``) with one rank
a GPU: the launcher's four processes bind cuda:<local rank> and bring the
host's group up over NCCL, where chip_smoke.py puts the four ranks on one
card over the staged transport.  The same runs and checks: (h1)
BERT-large at 4 layers on {pp:2, tp:2}, (h2) GPT-2 medium at 2 layers on
{sp:2, tp:2} (the ring of flash hops), (h3) the same on Ulysses, (h4)
BERT-large at 2 layers on {dp:2, tp:2} and (h5) on {dp:2, pp:2} through
HybridDataParallel and two Python servers, and one f32 step of (h1) and
(h2) at 2 layers; then phase (i)'s mesh parts: (i2) GPT-2 medium with 8
experts at 2 layers on {sp:2, tp:2} (no-drop, the defaults, one f32
step), (i3) on {dp:2, sp:2} through
HybridDataParallel, (i5) its f32 KV-cached decode on {sp:2, tp:2} and
{pp:2, tp:2}, (i6) ``dryrun_multichip(4)``.  Each is held to one process
of the same model, weights and tokens on GPU 0, every rank's K1-K3
launches counted; the one-process parts (i1) and (i4) are chip_smoke.py's
alone.  Prints the card's name and power limit first, the runs' lines,
and exits non-zero if a check failed.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    if torch.cuda.device_count() < cs.MP_RANKS:
        print(f"torch_port_model_parallel: needs {cs.MP_RANKS} GPUs", file=sys.stderr)
        return 1
    cs.MP_TRANSPORT, cs.MP_HOST_DEVICE = "", ""  # NCCL, a GPU a rank
    card = cs.main_path_setup()
    cs.phase_build()
    cs.train_model_parallel(card, one_process_i=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
