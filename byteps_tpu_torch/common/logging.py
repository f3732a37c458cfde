"""Leveled logging (BPS_LOG / BPS_CHECK, logging.h), as
``byteps_tpu.common.logging`` has it.

The level comes from ``BYTEPS_LOG_LEVEL`` (TRACE | DEBUG | INFO | WARNING |
ERROR | FATAL; WARNING when unset or unknown), read at import and again at
every ``init()``.  :func:`check` logs at FATAL and raises.  The handler
writes to whatever ``sys.stderr`` is when a record is emitted, so a host
application or a test that swaps stderr later still gets the lines.  A thin
layer over the standard library's ``logging``: a host application may
reroute the ``byteps_tpu_torch`` logger.
"""

from __future__ import annotations

import logging as _pylog
import os
import sys

TRACE = 5
_pylog.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "TRACE": TRACE,
    "DEBUG": _pylog.DEBUG,
    "INFO": _pylog.INFO,
    "WARNING": _pylog.WARNING,
    "ERROR": _pylog.ERROR,
    "FATAL": _pylog.CRITICAL,
}


class _StderrProxy:
    """``sys.stderr`` looked up at each write, not at import."""

    def write(self, s):
        return sys.stderr.write(s)

    def flush(self):
        return sys.stderr.flush()


logger = _pylog.getLogger("byteps_tpu_torch")
if not logger.handlers:
    _h = _pylog.StreamHandler(_StderrProxy())
    _h.setFormatter(
        _pylog.Formatter("[%(asctime)s] BYTEPS %(levelname)s %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)


def apply_env_level() -> None:
    """Set the level from ``BYTEPS_LOG_LEVEL`` as the environment holds it
    now: ``init()`` calls it, so that a process that sets the variable
    after the import still gets its level."""
    logger.setLevel(_LEVELS.get(os.environ.get("BYTEPS_LOG_LEVEL", "WARNING").upper(),
                                _pylog.WARNING))


apply_env_level()


def trace(msg, *a):
    logger.log(TRACE, msg, *a)


def debug(msg, *a):
    logger.debug(msg, *a)


def info(msg, *a):
    logger.info(msg, *a)


def warning(msg, *a):
    logger.warning(msg, *a)


def error(msg, *a):
    logger.error(msg, *a)


def check(cond: bool, msg: str = "") -> None:
    """BPS_CHECK: a failed condition is fatal (logging.h)."""
    if not cond:
        logger.critical("check failed: %s", msg)
        raise AssertionError(f"BPS_CHECK failed: {msg}")
