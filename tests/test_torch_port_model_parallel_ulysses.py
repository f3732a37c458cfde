"""tiny_test trained by the port over Ulysses sequence parallelism, {sp:2}
(causal), on a gloo group of two CPU processes,
against byteps_tpu's shard_map train step on the same mesh of forced CPU
devices: each step's loss, each rank's gradient shard of every
parameter, and the parameters after the step gathered by
``params_to_jax`` (``torch_port_mp_ref`` states the tolerances).
"""

import pytest

import torch_port_mp_ref as mpref

LABELS = ["sp2_ulysses"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_ulysses"))
    return mpref.run(LABELS, [], out)


@pytest.mark.parametrize("label", LABELS)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])
