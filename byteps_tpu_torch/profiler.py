"""The profiling surface (``byteps_tpu.profiler``), in two layers:

- the host's communication stages and spans: the tracer the engine feeds
  (``BYTEPS_TRACE_*``, ``core/tracing.py``), for chrome://tracing or
  Perfetto, merged across processes by ``tools/trace_merge.py``;
- the device's kernels and the host's torch operators:
  ``torch.profiler`` (CPU activity, and CUDA when the card is there),
  through :func:`trace` and :func:`annotate`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

#: kernels launched under the device's activity before a window starts
WARM_KERNELS = 64


def _free_name(log_dir: str, stem: str) -> str:
    path = os.path.join(log_dir, f"{stem}.json")
    n = 2
    while os.path.exists(path):
        path = os.path.join(log_dir, f"{stem}.{n}.json")
        n += 1
    return path


def _warm_device() -> None:
    """Small kernels on the current stream, then a wait for them, while the
    device's activity is on and before the window starts."""
    import torch

    x = torch.zeros(1024, device="cuda")
    for _ in range(WARM_KERNELS):
        x.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, host_tracing: bool = True) -> Iterator[object]:
    """Profile the block with ``torch.profiler`` (CPU and, when available,
    CUDA activity) and write its Chrome trace into ``log_dir``
    (``torch_trace.json``, then ``torch_trace.<n>.json``); with
    ``host_tracing``, flush the window the host tracer recorded meanwhile
    into the same directory (``<log_dir>/<local_rank>/comm.json``, or
    ``comm.<n>.json``).  Any number of windows a process: each exit writes
    its own.  Yields the ``torch.profiler.profile`` object.

    On the card the device's activity is switched on before the window
    opens, under a few small kernels that the window leaves out, and the
    window closes once the device is idle: a kernel still queued at the
    close would miss the device trace."""
    import torch

    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.prepare_trace()
    if cuda:
        _warm_device()
    prof.start_trace()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(_free_name(log_dir, "torch_trace"))
        if host_tracing:
            from byteps_tpu_torch.core.state import get_state

            st = get_state()
            if st.initialized and st.tracer is not None and st.tracer.enabled:
                st.tracer.trace_dir = log_dir
                st.tracer.flush()


def annotate(name: str):
    """A named region on the profiler's timeline
    (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
