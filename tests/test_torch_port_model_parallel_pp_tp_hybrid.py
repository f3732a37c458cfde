"""tiny_test trained by the port's HybridDataParallel over pipeline
stages and tensor-parallel shards, on a gloo group of four CPU processes
(one host, so its PS hop is the identity): {pp:2, tp:2}, causal, with
attention biases, two microbatches.  Against
byteps_tpu's hybrid's level 1 on the same mesh of forced CPU devices:
each step's loss, each rank's gradient shard of every parameter (the
pulls of the stacked keys narrowed to the rank's stage and block) and
the parameters after the step gathered by ``params_to_jax``
(``torch_port_mp_ref`` states the tolerances).
"""

import pytest

import torch_port_mp_ref as mpref

LABELS = ["pp2_tp2_hybrid"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_pp_tp_hybrid"))
    return mpref.run([], LABELS, out)


@pytest.mark.parametrize("label", LABELS)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])
