"""tiny_test trained by the port over tensor parallelism, {tp:2}, on a
gloo group of two CPU processes, against byteps_tpu's shard_map train
step on the same mesh of forced CPU devices: each step's loss, each rank's gradient shard of every
parameter, and the parameters after the step gathered by
``params_to_jax`` (``torch_port_mp_ref`` states the tolerances); and the
converter: ``shard_params_from_jax`` is the reference's ``shard_params``
placement.
"""

import numpy as np
import pytest
import torch

import torch_port_mp_ref as mpref
from byteps_tpu.models import transformer as jt
from byteps_tpu.parallel.mesh_utils import make_training_mesh
from byteps_tpu_torch.comm import mesh as pmesh
from byteps_tpu_torch.models import transformer as tt
from byteps_tpu_torch.models.convert import shard_params_from_jax
from byteps_tpu_torch.parallel.mesh_utils import make_training_mesh as port_mesh

TWO = ["tp2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mpref.run(TWO, [], str(tmp_path_factory.mktemp("mp_tp")))


@pytest.mark.parametrize("label", TWO)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])


@pytest.mark.parametrize("sizes", [{"tp": 2}, {"pp": 2, "tp": 2}, {"dp": 2, "pp": 2, "tp": 2},
                                   {"dp": 2, "sp": 2, "tp": 2}])
def test_shards_are_the_reference_placement(monkeypatch, sizes):
    """Every rank's state dict is the block the reference's shard_params
    puts on the device at the rank's coordinates, in the module's names
    and shapes."""
    monkeypatch.setattr(pmesh.Mesh, "make_axis_groups", lambda self: None)
    n = int(np.prod(list(sizes.values())))
    cfg_kw = dict(attn_bias=True, n_kv_heads=2)
    jcfg, pcfg = jt.tiny_test(**cfg_kw), tt.tiny_test(**cfg_kw)
    params = jt.init_params(jcfg, seed=5, pp_size=sizes.get("pp", 1))
    jmesh = make_training_mesh(n_devices=n, axis_sizes=sizes)
    placed = jt.shard_params(params, jcfg, jmesh)
    for r in range(n):
        mesh = port_mesh(n, axis_sizes=sizes, base=pmesh.Mesh(r, n, torch.device("cpu"), "gloo"))
        sd = shard_params_from_jax(params, pcfg, mesh)
        model = tt.Transformer(pcfg, device="meta", mesh=mesh)
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in model.state_dict().items()}
        device = jmesh.devices.flat[r]
        for name, arr in placed.items():
            block = np.asarray(next(s.data for s in arr.addressable_shards if s.device == device))
            if tt.is_layer_param(name):
                first = mesh.axis_index("pp") * block.shape[1]
                for j in range(block.shape[1]):
                    np.testing.assert_array_equal(sd[f"layers.{first + j}.{name}"].numpy(),
                                                  block[0, j], err_msg=f"rank {r} {name}")
            else:
                np.testing.assert_array_equal(sd[name].numpy(), block, err_msg=name)


def test_one_rank_round_trips_the_layout():
    """Without a mesh the converter is the one-device layout, both ways."""
    from byteps_tpu_torch.models.convert import params_from_jax, params_to_jax

    cfg = tt.tiny_test()
    params = tt.init_params(cfg, seed=2, pp_size=2)
    back = params_to_jax(params_from_jax(params, cfg), cfg, pp_size=2)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
