"""The port's leveled logging (byteps_tpu_torch.common.logging) against
byteps_tpu's: ``BYTEPS_LOG_LEVEL`` and its TRACE level, read again at every
init; FATAL raises; stderr is bound when a line is written; and
``BYTEPS_DEBUG_SAMPLE_TENSOR``'s per-stage lines, on the host lane and on
the device-codec lane, next to the reference's."""

import io
import logging
import re
import sys

import numpy as np
import pytest

import torch_port_kits as kits
from byteps_tpu.common import logging as ref_log
from byteps_tpu_torch.common import logging as port_log

LOGS = {"port": port_log, "ref": ref_log}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("BYTEPS_LOG_LEVEL", raising=False)
    yield from kits.reset_runtime(monkeypatch)
    monkeypatch.delenv("BYTEPS_LOG_LEVEL", raising=False)
    for mod in LOGS.values():
        mod.apply_env_level()


def _lines(mod, capsys) -> list:
    """What each level writes at the current level, as the level names."""
    for fn in ("trace", "debug", "info", "warning", "error"):
        getattr(mod, fn)("%s line %d", fn, 7)
    err = capsys.readouterr().err
    return re.findall(r"BYTEPS (\w+) (\w+) line 7", err)


@pytest.mark.parametrize("level", [None, "TRACE", "debug", "INFO", "WARNING", "ERROR", "FATAL",
                                   "bogus"])
def test_the_levels_are_the_references(monkeypatch, capsys, level):
    if level is not None:
        monkeypatch.setenv("BYTEPS_LOG_LEVEL", level)
    out = {}
    for pkg, mod in LOGS.items():
        mod.apply_env_level()
        out[pkg] = (mod.logger.level, _lines(mod, capsys))
    assert out["port"] == out["ref"]
    assert port_log.TRACE == ref_log.TRACE == 5
    assert logging.getLevelName(5) == "TRACE"
    if level in (None, "WARNING", "bogus"):
        assert [n for n, _ in out["port"][1]] == ["WARNING", "ERROR"]
    if level == "TRACE":
        assert [n for n, _ in out["port"][1]][0] == "TRACE"


def test_fatal_raises(capsys):
    for mod in LOGS.values():
        mod.check(True, "fine")
        with pytest.raises(AssertionError, match="BPS_CHECK failed: bad thing"):
            mod.check(False, "bad thing")
    assert capsys.readouterr().err.count("CRITICAL check failed: bad thing") == 2


def test_stderr_is_bound_when_a_line_is_written(monkeypatch):
    for mod in LOGS.values():
        mod.apply_env_level()
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stderr", buf)
        mod.warning("late %s", "binding")
        monkeypatch.undo()
        assert buf.getvalue().endswith("WARNING late binding\n")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_init_reads_the_level_again(monkeypatch, pkg):
    """A process that sets BYTEPS_LOG_LEVEL after the import gets it at
    init()."""
    k = kits.kit(pkg)
    LOGS[pkg].apply_env_level()
    assert LOGS[pkg].logger.level == logging.WARNING
    monkeypatch.setenv("BYTEPS_LOG_LEVEL", "DEBUG")
    kits.init(k)
    assert LOGS[pkg].logger.level == logging.DEBUG
    k.api.shutdown()


_SAMPLE = re.compile(r"sample (\S+) key=(\d+) stage=(\w+) v=(\d+) norm=(\S+) first=(\S+)")


def _samples(pkg: str, monkeypatch, capsys, env=None, **declare) -> list:
    """Two push_pulls of a 2-partition tensor and one of another through a
    fleet of the same package, with BYTEPS_DEBUG_SAMPLE_TENSOR naming the
    first: its sample lines."""
    k = kits.kit(pkg)
    x = np.random.default_rng(3).standard_normal(2000).astype(np.float32)
    with kits.fleet(monkeypatch, pkg, servers=2, BYTEPS_LOG_LEVEL="INFO",
                    BYTEPS_DEBUG_SAMPLE_TENSOR="grad.w", BYTEPS_PARTITION_BYTES="4096",
                    **(env or {})):
        kits.init(k)
        if declare:
            k.api.declare_tensor("grad.w", **declare)
        capsys.readouterr()
        for step in range(2):
            k.api.push_pull(kits.tensor(k, x * (step + 1)), name="grad.w", average=False)
        k.api.push_pull(kits.tensor(k, x), name="other", average=False)
        k.api.shutdown()
    return sorted(_SAMPLE.findall(capsys.readouterr().err))


def test_the_debug_sample_lines_are_the_references(monkeypatch, capsys):
    """Every stage of every partition of the named tensor, pushed values on
    the way out and the sums on the way back: the same lines, norms and
    first values as the reference's (the other tensor logs none)."""
    port = _samples("port", monkeypatch, capsys)
    ref = _samples("ref", monkeypatch, capsys)
    assert port == ref
    assert {s[2] for s in port} == {"COPYD2H", "PUSH", "PULL", "COPYH2D"}
    assert len(port) == 2 * 2 * 4 and all(s[0] == "grad.w" for s in port)


def test_a_device_codec_partition_samples_its_decoded_values(monkeypatch, capsys):
    """Onebit on the port's device lane (a CPU tensor takes K4's plain
    version): the DECOMPRESS and COPYH2D lines read the decoded partition on
    the device; the push side holds no host copy and a compressed PULL holds
    codec bytes, so neither has a line, as in the reference."""
    lines = _samples("port", monkeypatch, capsys, env={"BYTEPS_MIN_COMPRESS_BYTES": "1024"},
                     byteps_compressor_type="onebit")
    stages = [s[2] for s in lines]
    assert sorted(stages) == ["COPYH2D"] * 4 + ["DECOMPRESS"] * 4
    for s in lines:
        assert np.isfinite(float(s[4])) and float(s[4]) > 0
