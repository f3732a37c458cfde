"""The port's examples on a host's group of four processes
(``hybrid_mesh_ps``, ``bert_4d_parallel``), each rank a gloo process of
``tests/torch_port_ranks.py``'s ``example`` case, against the JAX
package's examples run in this process on conftest's CPU mesh with the
same arguments:

- ``hybrid_mesh_ps`` (dp 2 x tp 2, the Megatron block under
  ``HybridDataParallel``, one worker): every rank's printed losses within
  rtol 1e-5 of the reference's (and one unit of the print's last digit),
  the four ranks' lines equal;
- ``bert_4d_parallel`` on {pp: 2, sp: 2} at 2 layers and tiny widths, 2
  steps, dense and with ``--moe`` (4 experts over sp): the mesh line
  equal, every rank's printed losses within rtol 1e-4."""

import json

import pytest

import torch_port_kits as kits
import torch_port_ranks as ranks

RUNS = {
    "hybrid": ("hybrid_mesh_ps", ["--steps", "6", "--dp", "2", "--tp", "2"]),
    "4d": ("bert_4d_parallel", ["--dp", "1", "--pp", "2", "--sp", "2", "--tp", "1",
                                "--layers", "2", "--steps", "2"]),
    "4d_moe": ("bert_4d_parallel", ["--dp", "1", "--pp", "2", "--sp", "2", "--tp", "1",
                                    "--layers", "2", "--steps", "2", "--moe"]),
}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every run's group of four, started at the module's first test so
    that they run beside the reference's examples."""
    out = {}
    for label, (name, argv) in RUNS.items():
        d = str(tmp_path_factory.mktemp(f"example_{label}"))
        out[label] = (d, ranks.spawn_group("example", 4, d, env={
            "EXAMPLE": name, "EXAMPLE_ARGV": json.dumps(argv)}))
    return out


def _ranks(spawned, label: str) -> list:
    """Each rank's printed lines, their ``[local r/4]`` tags checked and
    taken off."""
    d, procs = spawned[label]
    lines = []
    for r, res in enumerate(ranks.collect(procs, "example", 4, d, timeout=150)):
        tag = f"[local {r}/4] "
        assert all(ln.startswith(tag) for ln in res["lines"]), res["lines"]
        lines.append([ln[len(tag):] for ln in res["lines"]])
    return lines


def test_hybrid_mesh_ps_is_the_reference_s(spawned, monkeypatch):
    name, argv = RUNS["hybrid"]
    want = kits.run_example("ref", name, argv, monkeypatch)
    got = _ranks(spawned, "hybrid")
    assert all(lines == got[0] for lines in got)  # equal losses along dp and tp
    steps = [ln for ln in want if " step " in ln]
    assert [ln.split()[3] for ln in steps] == ["0", "5"]
    kits.assert_lines_close(got[0][:-1], steps, rtol=1e-5)
    assert got[0][-1] == "[rank 0] done — the group's all-reduce + PS push_pull in every step"


@pytest.mark.parametrize("label", ["4d", "4d_moe"])
def test_bert_4d_parallel_is_the_reference_s(spawned, monkeypatch, label):
    name, argv = RUNS[label]
    want = kits.run_example("ref", name, argv, monkeypatch)
    got = _ranks(spawned, label)
    assert want[0] == "mesh {'dp': 1, 'pp': 2, 'sp': 2, 'tp': 1}  layers=2 moe=" + \
        str(label == "4d_moe")
    for lines in got:
        assert lines[0] == want[0]
        assert lines[-1].endswith(" samples/s")
        kits.assert_lines_close(lines[1:-1], want[1:-1], rtol=1e-4)
