#!/usr/bin/env python3
"""The port's distributed step with the servers' OpenMP settings varied, in
turns, on one GPU.

    python3 tools/torch_port_server_omp.py

Runs chip_smoke.py's distributed path (BERT-large, seq 512, bf16, remat,
flash attention, batch 32, one worker, a scheduler and two server
processes, bare onebit; one warm-up, 3 timed and one profiled step) seven
times in this order: the native lanes (BYTEPS_SERVER_NATIVE=1 and
BYTEPS_NATIVE_CLIENT=1), the Python lanes, the native lanes with the
servers at OMP_WAIT_POLICY=PASSIVE, the native lanes with the servers at
OMP_NUM_THREADS=1, the Python lanes with the servers at OMP_NUM_THREADS=1
(their host codecs are the same C++), then the native and the Python
lanes again.  Each run prints chip_smoke.py's lines (step, split, stage
dwell, round trips, the servers' reports); the last lines give ms a step
for each.  The OpenMP variables reach only the server processes: this
process loaded its OpenMP runtime before.  Compare runs only within one
call.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

TIMED_STEPS = 3
RUNS = (
    ("native lanes", True, True, {}),
    ("Python lanes", False, False, {}),
    ("native lanes, servers OMP_WAIT_POLICY=PASSIVE", True, True,
     {"OMP_WAIT_POLICY": "PASSIVE"}),
    ("native lanes, servers OMP_NUM_THREADS=1", True, True, {"OMP_NUM_THREADS": "1"}),
    ("Python lanes, servers OMP_NUM_THREADS=1", False, False, {"OMP_NUM_THREADS": "1"}),
    ("native lanes again", True, True, {}),
    ("Python lanes again", False, False, {}),
)


def main() -> None:
    card = cs.main_path_setup()
    cs.phase_build()
    steps = []
    for label, server_native, client_native, env in RUNS:
        saved = dict(os.environ)
        os.environ.update(env)  # inherited by the server processes only
        try:
            r = cs._run_distributed(card, label, TIMED_STEPS, server_native=server_native,
                                    client_native=client_native)
        finally:
            os.environ.clear()
            os.environ.update(saved)
        steps.append((label, r["step_ms"]))
    for label, ms in steps:
        print(f"server OpenMP: {label}: {ms:.1f} ms a step, on {card}", flush=True)


if __name__ == "__main__":
    main()
