"""tiny_test trained by the port over pipeline and tensor parallelism,
{pp:2, tp:2} (causal, attention biases, two microbatches: the stages'
count), on a gloo group of four CPU processes,
against byteps_tpu's shard_map train step on the same mesh of forced CPU
devices: each step's loss, each rank's gradient shard of every
parameter, and the parameters after the step gathered by
``params_to_jax`` (``torch_port_mp_ref`` states the tolerances).
"""

import pytest

import torch_port_mp_ref as mpref

LABELS = ["pp2_tp2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_tp_pp"))
    return mpref.run([], LABELS, out)


@pytest.mark.parametrize("label", LABELS)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])
