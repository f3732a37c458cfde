"""The C++ data plane behind the port's control shell
(``byteps_tpu.server.server.NativePSServer``, reduced to tcp).

The engine of ``native/csrc/ps_server.cc`` owns the worker-facing socket:
framing, the CRC32C, KV rounds, the codecs and the sums, on its own
threads with no interpreter lock (``BYTEPS_SERVER_STRIPES`` reducer lanes,
read from the environment).  This wrapper does what the Python server's
control plane does: it registers with the scheduler, passes the bring-up
barrier and follows the scheduler's control messages, with
``PSServer``'s own methods borrowed unbound.  SHUTDOWN stops the engine;
a resize book is refused and stops it (elastic membership is not ported).
The engine's counters and histograms reach ``core/telemetry.py`` through
the registry's provider seam.  Selected by ``BYTEPS_SERVER_NATIVE=1``.
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional

from byteps_tpu_torch.common.config import Config, check_unported_env
from byteps_tpu_torch.comm.transport import close_socket
from byteps_tpu_torch.core.telemetry import metrics
from byteps_tpu_torch.server.server import PSServer, summarize_histograms

#: the engine's histograms a stop report summarizes (merged over keys)
NATIVE_HISTOGRAMS = ("native_server_sum_seconds", "native_server_publish_seconds")


class NativePSServer:
    def __init__(self, cfg: Config, host: str = "127.0.0.1") -> None:
        import uuid

        from byteps_tpu_torch.native import get_lib, native_server_histograms

        check_unported_env()
        self._lib = get_lib()
        self.cfg = cfg
        self.host = host
        self.port = self._lib.bps_native_server_start(0, cfg.num_worker, 0)
        if self.port < 0:
            raise RuntimeError("bps_native_server_start failed")
        self._id = self.port
        self.rank: Optional[int] = None
        self.num_workers = cfg.num_worker
        self.node_uid = uuid.uuid4().hex
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        self._threads: List[threading.Thread] = []
        self._sched_conn: Optional[socket.socket] = None
        sid = self._id
        self._hist_provider = lambda: native_server_histograms(sid)
        metrics().register_hist_provider(self._hist_provider)
        #: (pushes, rounds, histograms) frozen when the engine stops
        self._final: Optional[tuple] = None

    # the control plane of the Python server: these touch only the state
    # both classes carry (cfg, host, port, uid, rank, num_workers, the
    # scheduler connection, the stop event and the thread list)
    _register_with_scheduler = PSServer._register_with_scheduler
    _control_loop = PSServer._control_loop
    _fail_stop = PSServer._fail_stop
    _spawn = PSServer._spawn

    def start(self, register: bool = True) -> None:
        if register:
            try:
                self._register_with_scheduler()
            except (ConnectionError, OSError):
                if not self._stop.is_set():
                    raise
                return
            # the scheduler's book wins over the launch-time environment
            self._lib.bps_native_server_set_num_workers(self._id, self.num_workers)

    def native_counters(self) -> Dict[str, int]:
        """The engine's ``native_*`` counters (empty once stopped)."""
        from byteps_tpu_torch.native import native_server_counters

        return native_server_counters(self._id)

    def _read_stats(self) -> tuple:
        """(pushes summed, rounds published, histogram summaries) from the
        engine.  It counts neither: every push observes its key's sum
        histogram (a replayed one too, counted apart as
        ``native_push_dedup``), so a key's rounds are its pushes over the
        worker count.  The publish histogram is not a count of rounds: the
        engine times a publish on the epoch clock in double seconds (a
        step of ~240 ns) and skips one that reads 0 (ROADMAP.md Queue 3)."""
        from byteps_tpu_torch.native import native_server_histograms

        recs = native_server_histograms(self._id)
        per_key = [int(r["count"]) for r in recs if r.get("name") == NATIVE_HISTOGRAMS[0]]
        hists = summarize_histograms(
            {n: [r for r in recs if r.get("name") == n] for n in NATIVE_HISTOGRAMS})
        pushes = sum(per_key) - self.native_counters().get("native_push_dedup", 0)
        rounds = sum(c // max(1, self.num_workers) for c in per_key)
        return pushes, rounds, hists

    def pushes_and_rounds(self) -> tuple:
        return (self._final or self._read_stats())[:2]

    def histograms(self) -> Dict[str, dict]:
        return (self._final or self._read_stats())[2]

    def stop(self) -> None:
        """Stop the engine (once): its histograms are folded into the
        registry and its totals frozen for the stop report first."""
        self._stop.set()
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._final = self._read_stats()
            metrics().absorb_hist_provider(self._hist_provider)
            self._lib.bps_native_server_stop(self._id)
        close_socket(self._sched_conn)
