"""ctypes bindings of the port's native C++ lanes: the CPU reducer and the
host codecs (``csrc/reducer.cc``, ``csrc/compressor.cc``), the PS server's
data plane (``csrc/ps_server.cc``) and the worker's client lanes
(``csrc/ps_client.cc``), over the wire of ``csrc/wire.h``.

The library is built from ``csrc/`` by ``g++`` at the first
:func:`get_lib` call (``ops/_build.py``: one compiler process per source,
under a file lock, into ``build/lib<name>-<digest>.so``), never at import.
:func:`get_lib` raises, with the compiler's output, when the library
cannot be built or loaded: a caller that asked for the native lanes never
runs on the Python ones instead (ROADMAP.md Queue 3, a deliberate
divergence from the reference, whose loader returns None and falls back).

Selected by ``BYTEPS_SERVER_NATIVE=1`` (``server.native.NativePSServer``)
and ``BYTEPS_NATIVE_CLIENT=1`` (``comm.ps_client._NativeServerConn``); the
host codecs (``compression/impl.py``) call the codec entries on numpy
inputs.  ``BYTEPS_SERVER_STRIPES`` (reducer lanes of a server) and
``BYTEPS_WIRE_CHECKSUM`` reach the C++ side from the environment.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("reducer.cc", "compressor.cc", "ps_server.cc", "ps_client.cc")
HEADERS = ("wire.h", "hist.h")

#: completion-callback signature of the client lanes (ps_client.cc
#: bpsc_cb_t): (ctx, op, status, flags, seq, key, cmd, version, payload,
#: length, zero_copied).  It fires as the doorbell of a batch (op = -2,
#: the rest zero), drained with ``bpsc_drain``, and once per record at
#: ``bpsc_close``.
BPSC_CALLBACK = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_int32,
)

#: ps_client.cc's DrainRec (change both together)
DRAIN_REC_DTYPE = np.dtype([
    ("key", "<u8"), ("len", "<u8"), ("off", "<u8"),
    ("op", "<i4"), ("status", "<i4"), ("flags", "<u4"), ("seq", "<u4"),
    ("cmd", "<u4"), ("version", "<u4"), ("zc", "<i4"), ("_pad", "<i4"),
])
assert DRAIN_REC_DTYPE.itemsize == 56

#: ``bps_native_server_counters`` in ps_server.cc's ``NativeCounter``
#: order (change both together)
NATIVE_COUNTER_NAMES = (
    "native_wire_rpc",
    "native_fused_frames",
    "native_fused_keys",
    "native_push_dedup",
    "native_init_replay_ack",
    "native_resync_query",
    "native_zombie_reject",
    "native_span_drop",
    "native_wrong_owner",
    "native_job_reject",
    "native_async_reject",
    "native_checksum_fail",
    "native_checksum_conn_drop",
    "native_server_opt_reject",
    "native_lossless_fail",
)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        # reducer.cc, compressor.cc
        "bps_sum": ([c.c_void_p, c.c_void_p, c.c_int64, c.c_int32], c.c_int32),
        "bps_onebit_compress": ([c.c_void_p, c.c_int64, c.c_void_p, c.c_int32], c.c_int64),
        "bps_onebit_decompress": ([c.c_void_p, c.c_int64, c.c_void_p], c.c_int32),
        "bps_topk_compress": ([c.c_void_p, c.c_int64, c.c_int64, c.c_void_p], c.c_int64),
        "bps_topk_decompress": ([c.c_void_p, c.c_int64, c.c_void_p, c.c_int64], c.c_int32),
        "bps_topk_sum_into": ([c.c_void_p, c.c_int64, c.c_void_p, c.c_int64], c.c_int32),
        "bps_randomk_compress": ([c.c_void_p, c.c_int64, c.c_int64, c.c_uint64,
                                  c.c_uint64, c.c_void_p], c.c_int64),
        "bps_dithering_compress": ([c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
                                    c.c_uint64, c.c_uint64, c.c_void_p], c.c_int64),
        "bps_dithering_decompress": ([c.c_void_p, c.c_int64, c.c_int32, c.c_int32,
                                      c.c_void_p], c.c_int32),
        # ps_server.cc
        "bps_native_server_start": ([c.c_int32, c.c_int32, c.c_int32], c.c_int32),
        "bps_native_server_set_num_workers": ([c.c_int32, c.c_int32], None),
        "bps_native_server_stop": ([c.c_int32], None),
        "bps_native_server_counters": ([c.c_int32, c.POINTER(c.c_uint64), c.c_int32],
                                       c.c_int32),
        "bps_native_server_metrics_json": ([c.c_int32, c.c_void_p, c.c_uint64], c.c_int64),
        "bps_wire_key_stripe": ([c.c_uint64, c.c_int32], c.c_int32),
        "bps_wire_golden": ([c.c_void_p, c.c_uint64], c.c_int64),
        "bps_wire_golden_compressed": ([c.c_void_p, c.c_uint64], c.c_int64),
        "bps_wire_golden_checksum": ([c.c_void_p, c.c_uint64], c.c_int64),
        # ps_client.cc
        "bpsc_create": ([c.c_char_p, c.c_int32, c.c_int32, c.c_int32], c.c_int64),
        "bpsc_set_cb": ([c.c_int64, BPSC_CALLBACK, c.c_void_p], None),
        "bpsc_alloc_seq": ([c.c_int64, c.c_void_p, c.c_uint64], c.c_int64),
        "bpsc_send": ([c.c_int64, c.c_int32, c.c_uint32, c.c_uint64, c.c_uint32,
                       c.c_uint32, c.c_uint32, c.c_void_p, c.c_uint64], c.c_int32),
        "bpsc_drain": ([c.c_int64, c.c_void_p, c.c_int64, c.c_void_p, c.c_uint64],
                       c.c_int64),
        "bpsc_metrics_json": ([c.c_int64, c.c_void_p, c.c_uint64], c.c_int64),
        "bpsc_close": ([c.c_int64], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def get_lib() -> ctypes.CDLL:
    """The port's native library, built from ``csrc/`` on first call.
    Raises RuntimeError (with the compiler's or the loader's message) when
    it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from byteps_tpu_torch.ops._build import build_cxx

            path = build_cxx("byteps_native", CSRC_DIR, SOURCES, HEADERS, BUILD_DIR)
            try:
                _lib = _bind(ctypes.CDLL(path))
            except OSError as e:
                raise RuntimeError(f"the port's native library {path} failed to "
                                   f"load: {e}") from e
        return _lib


def native_server_counters(server_id: int) -> dict:
    """One native server's counters as ``{name: int}`` (empty once it
    stopped)."""
    out = (ctypes.c_uint64 * len(NATIVE_COUNTER_NAMES))()
    n = get_lib().bps_native_server_counters(server_id, out, len(NATIVE_COUNTER_NAMES))
    return {NATIVE_COUNTER_NAMES[i]: int(out[i]) for i in range(max(0, n))}


def _metrics_json(call, ident) -> list:
    """A native metrics-JSON export as histogram-provider records (see
    ``core/telemetry.py``): grown and retried while the buffer is too
    small; empty when the source is gone or the body is malformed."""
    cap = 1 << 16
    for _ in range(8):
        buf = (ctypes.c_uint8 * cap)()
        n = call(ident, buf, cap)
        if n in (-1, 0):
            return []
        if n < 0:
            cap = max(-int(n), cap * 2)
            continue
        try:
            doc = json.loads(bytes(buf[:n]).decode())
        except (ValueError, UnicodeDecodeError):
            return []
        return list(doc.get("histograms") or [])
    return []


def native_server_histograms(server_id: int) -> list:
    """One native server's histograms: ``native_server_sum_seconds`` and
    ``native_request_bytes`` per key, ``native_stripe_sum_seconds`` per
    reducer lane, ``native_server_publish_seconds``."""
    return _metrics_json(get_lib().bps_native_server_metrics_json, server_id)


def native_client_histograms(handle: int) -> list:
    """One client handle's ``native_rpc_round_trip_seconds`` (send to the
    reply's last byte, on the lanes)."""
    return _metrics_json(get_lib().bpsc_metrics_json, handle)


def key_stripe(key: int, n_stripes: int) -> int:
    """The reducer lane a key is pinned to (wire.h ``key_stripe``)."""
    return int(get_lib().bps_wire_key_stripe(key, n_stripes))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class cpu_reducer:
    """The CPU reducer (cpu_reducer.h)."""

    @staticmethod
    def sum_into(dst: np.ndarray, src: np.ndarray, dtype_id: Optional[int] = None) -> None:
        """dst[:len(src)] += src elementwise in the wire dtype ``dtype_id``
        (by default ``src``'s; bfloat16 elements are stored as uint16, so
        they need the id).  A float16 sum rounds a tie away from zero."""
        from byteps_tpu_torch.common.types import to_datatype

        if dtype_id is None:
            dtype_id = int(to_datatype(src.dtype))
        if not (dst.flags.c_contiguous and src.flags.c_contiguous) or dst.size < src.size:
            raise ValueError("cpu_reducer: dst and src must be contiguous, dst at least "
                             "as long as src")
        if get_lib().bps_sum(_ptr(dst), _ptr(src), src.size, dtype_id) != 0:
            raise ValueError(f"cpu_reducer: wire dtype {dtype_id} is not summed natively")
