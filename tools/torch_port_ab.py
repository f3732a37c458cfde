#!/usr/bin/env python3
"""The port's main path on two trees of this repository, in turns, on one GPU.

    python3 tools/torch_port_ab.py PARENT_DIR CHANGE_DIR

Each directory holds a checkout of the repository (for example a `git
archive` unpacked under build/).  The two trees run in the order parent,
change, change, parent, each in a process of its own with the tree as its
working directory: this repository's `chip_smoke.main_path_setup` (the
settings chip_smoke.py measures under, and the card's name), then the tree's
own chip_smoke.py build phase and main path (BERT-large, seq 512, bf16,
remat, flash attention, batch 32; device time a step by kernel family from
torch.profiler, samples/s, peak memory, kernel launches).  The lines the main
path prints are printed under a header naming the tree and the card.  Two
versions are compared only within one call: another call may land on another
card, or share its host with other work.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
TIMEOUT_S = 240  # build and main path of one tree took 30-51 s on an H100

# the setup from this repository's chip_smoke.py, loaded under another name;
# the build and the main path from the tree's own chip_smoke.py (the cwd)
CODE = """import importlib.util, sys
spec = importlib.util.spec_from_file_location("smoke_setup", sys.argv[1])
setup = importlib.util.module_from_spec(spec)
spec.loader.exec_module(setup)
card = setup.main_path_setup()
import chip_smoke
chip_smoke.phase_build()
chip_smoke.train_main_path(card)
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    rc = 0
    for tree in (sys.argv[1], sys.argv[2], sys.argv[2], sys.argv[1]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CODE, SMOKE], cwd=tree,
                             capture_output=True, text=True, timeout=TIMEOUT_S)
        lines = out.stdout.splitlines()
        print(f"== {tree}: rc {out.returncode}, {time.perf_counter() - t0:.0f} s, "
              f"{lines[0] if lines else 'no output'}", flush=True)
        print("\n".join(line for line in lines
                        if line.startswith(("main path", "profile: step"))), flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
