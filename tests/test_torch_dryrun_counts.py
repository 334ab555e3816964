"""The dry run's traced counts against the reference's compiled HLO:
forward (prefill) and decode steps.

For one arch of each family at ``reduced(...)``, batch 2 x 128 (decode: a
128-long cache), the port's step traced on ``meta`` by ``StepTrace`` and
the reference's step compiled on one CPU device and read by
``repro.roofline.hlo_graph.analyze`` (``_dryrun_ref.py`` builds both legs):
the dot FLOPs and the dot bytes are equal, exactly. An eager trace counts
the dots the reference's compiled program runs, each as often as it
runs. The training step's counts: ``test_torch_dryrun_train_counts.py``.
"""

import pytest

from _dryrun_ref import FAMILIES, port_counts, reference_counts


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_decode_counts_equal_the_reference(arch, kind):
    ref_flops, ref_bytes = reference_counts(arch, kind)
    flops, nbytes = port_counts(arch, kind)
    assert ref_flops > 0 and ref_bytes > 0
    assert flops == ref_flops
    assert nbytes == ref_bytes
