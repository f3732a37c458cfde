"""tiny_test with expert layers trained by the port over meshes, on gloo
groups of CPU processes, against byteps_tpu's shard_map train step on the
same meshes of forced CPU devices: {sp:2} (8 experts, 4 a rank, routed by
the all-to-all over sp; causal) and {pp:2} (top-1, two microbatches: the
aux term summed over the microbatches and the stages) on two processes
(four: tests/test_torch_port_model_parallel_moe_tp.py).  Each step's loss (with the aux term, summed over the mesh), each
rank's gradient shard of every parameter (the experts' over sp), and the
parameters after the step gathered by ``params_to_jax``
(``torch_port_mp_ref`` states the tolerances).
"""

import pytest

import torch_port_mp_ref as mpref

LABELS = ["moe_sp2", "moe_pp2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_moe"))
    return mpref.run(LABELS, [], out)


@pytest.mark.parametrize("label", LABELS)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])
