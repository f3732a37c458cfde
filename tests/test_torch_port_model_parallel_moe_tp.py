"""tiny_test with expert layers trained by the port over meshes, on gloo
groups of CPU processes, against byteps_tpu's shard_map train step on the
same meshes of forced CPU devices, on four processes: {sp:2, tp:2} (GQA,
flash; the tokens replicated over tp route alike on both tp ranks, whose
expert gradients are not summed again) and {dp:2, sp:2} through
HybridDataParallel (the experts gathered over sp for the PS hop and cut
again).  Each step's loss (with the aux term, summed over the mesh), each
rank's gradient shard of every parameter (the experts' over sp), and the
parameters after the step gathered by ``params_to_jax``
(``torch_port_mp_ref`` states the tolerances).
"""

import pytest

import torch_port_mp_ref as mpref

LABELS = ["moe_sp2_tp2", "moe_dp2_sp2_hybrid"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mp_moe_tp"))
    return mpref.run([], LABELS, out)


@pytest.mark.parametrize("label", LABELS)
def test_steps_match_the_reference(runs, label):
    mpref.check(label, *runs[label])
