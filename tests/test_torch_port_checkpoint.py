"""The port's checkpoint module (``byteps_tpu_torch/checkpoint.py``)
against byteps_tpu's (``tests/test_checkpoint.py``):

- shards written by either package read back bitwise by the other, the
  files themselves byte for byte equal, over payloads that compress, that
  do not, and the empty one;
- a short, truncated, bit-flipped or trailer-flipped shard fails closed in
  both packages, with the same error class;
- save / restore of a model's and an optimizer's state dict, into a
  template's dtypes, and the refusal to overwrite without ``force``;
- ``restore_and_broadcast`` on a fleet of two workers, a port worker as the
  root and a byteps_tpu worker beside it: the worker that did not read
  gets the root's values bitwise, under the same names.

Every listener is bound to port 0."""

import threading

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu_torch as pbps
import torch_port_kits as kits
from byteps_tpu import checkpoint as ref_ckpt
from byteps_tpu.compression.lossless import LosslessError as RefLosslessError
from byteps_tpu_torch import checkpoint as port_ckpt
from byteps_tpu_torch.compression.lossless import LosslessError as PortLosslessError

PKGS = {"port": port_ckpt, "ref": ref_ckpt}
ERRORS = {"port": PortLosslessError, "ref": RefLosslessError}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    yield from kits.reset_runtime(monkeypatch)


def _payloads() -> dict:
    rng = np.random.default_rng(4)
    return {"empty": b"", "tiny": b"ab",
            "repetitive": (b"gradient-shard:" * 5000),
            "random": rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes(),
            "floats": rng.standard_normal(50_000).astype(np.float32).tobytes(),
            "sparse": np.where(rng.random(80_000) < 0.05, 1.0, 0.0).astype(np.float32).tobytes()}


@pytest.mark.parametrize("name", sorted(_payloads()))
@pytest.mark.parametrize("writer, reader", [("port", "ref"), ("ref", "port")])
def test_a_shard_of_one_package_reads_bitwise_in_the_other(tmp_path, name, writer, reader):
    data = _payloads()[name]
    path, twin = str(tmp_path / "a.shard"), str(tmp_path / "b.shard")
    n = PKGS[writer].write_shard(path, data)
    assert PKGS[reader].read_shard(path) == data
    # the files themselves are the same bytes, and the count is theirs
    assert PKGS[reader].write_shard(twin, data) == n
    with open(path, "rb") as a, open(twin, "rb") as b:
        assert a.read() == b.read()
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def _damage(kind: str, blob: bytes) -> bytes:
    if kind == "short":
        return blob[:3]
    if kind == "truncated":
        return blob[: len(blob) // 2]
    if kind == "bitflip":
        i = len(blob) // 3
        return blob[:i] + bytes([blob[i] ^ 0x10]) + blob[i + 1:]
    return blob[:-1] + bytes([blob[-1] ^ 0x01])  # the trailer


@pytest.mark.parametrize("kind", ["short", "truncated", "bitflip", "trailer"])
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_damaged_shard_fails_closed(tmp_path, kind, pkg):
    path = str(tmp_path / "s.shard")
    port_ckpt.write_shard(path, _payloads()["floats"])
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(_damage(kind, blob))
    with pytest.raises(ERRORS[pkg]) as err:
        PKGS[pkg].read_shard(path)
    assert isinstance(err.value, ValueError)
    # both packages name the same failure
    with pytest.raises(ERRORS["ref" if pkg == "port" else "port"], match=str(err.value)[:20]):
        PKGS["ref" if pkg == "port" else "port"].read_shard(path)


def test_save_and_restore_a_model_and_its_optimizer(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.randn(3, 6)).sum().backward()
    opt.step()
    path = str(tmp_path / "ckpt.pt")
    port_ckpt.save(path, {"model": model.state_dict(), "opt": opt.state_dict()})
    with pytest.raises(FileExistsError):
        port_ckpt.save(path, {}, force=False)
    got = port_ckpt.restore(path)
    for k, v in model.state_dict().items():
        assert torch.equal(got["model"][k], v)
    fresh = torch.optim.AdamW(model.parameters(), lr=1e-2)
    fresh.load_state_dict(got["opt"])
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    # a template sets each tensor's dtype; a template of another shape raises
    template = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    restored = port_ckpt.restore(str(tmp_path / "ckpt.pt"), {"model": template,
                                                             "opt": got["opt"]})
    assert all(t.dtype == torch.bfloat16 for t in restored["model"].values())
    with pytest.raises(ValueError):
        port_ckpt.restore(path, {"model": {k: torch.zeros(1) for k in template},
                                 "opt": got["opt"]})


def test_restore_and_broadcast_on_a_two_worker_fleet(tmp_path, monkeypatch):
    """The port worker (the root, whichever rank the scheduler gave it)
    reads its checkpoint; the byteps_tpu worker starts from zeros and gets
    the root's values through the broadcast: the two trees equal bitwise,
    and equal to what was saved."""
    rng = np.random.default_rng(8)
    saved = {"dense": {"kernel": rng.standard_normal((5, 3)).astype(np.float32),
                       "bias": rng.standard_normal(3).astype(np.float32)},
             "step": np.arange(4, dtype=np.int32)}
    path = str(tmp_path / "root.pt")
    port_ckpt.save(path, {"dense": {k: torch.from_numpy(v) for k, v in saved["dense"].items()},
                          "step": torch.from_numpy(saved["step"])})
    template = {"dense": {k: torch.zeros(v.shape) for k, v in saved["dense"].items()},
                "step": torch.zeros(4, dtype=torch.int32)}
    out, errors = [None, None], []

    def run(i, init, fn):
        try:
            init()
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported by the test
            errors.append(e)
            raise

    with kits.fleet(monkeypatch, "port", workers=2, servers=1):
        threads = [
            threading.Thread(target=run, args=(0, lambda: pbps.init(device="cpu"),
                                               lambda: port_ckpt.restore_and_broadcast(
                                                   path, template, root_rank=pbps.rank()))),
            threading.Thread(target=run, args=(1, jbps.init,
                                               lambda: ref_ckpt.restore_and_broadcast(
                                                   str(tmp_path / "nowhere"),
                                                   {"dense": {k: np.zeros_like(v) for k, v in
                                                              saved["dense"].items()},
                                                    "step": np.zeros(4, np.int32)},
                                                   root_rank=1 - jbps.rank())))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        pbps.shutdown()
        jbps.shutdown()
    assert not errors, errors
    port, ref = out
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(port["dense"][k].numpy(), saved["dense"][k])
        np.testing.assert_array_equal(np.asarray(ref["dense"][k]), saved["dense"][k])
    np.testing.assert_array_equal(np.asarray(ref["step"]), saved["step"])
    assert port["step"].dtype == torch.int32
