"""The dry run's traced counts against the reference's compiled HLO: the
training step (``Model.loss`` with remat, its gradient, the AdamW update).

Built as in ``test_torch_dryrun_counts.py`` (``_dryrun_ref.py``). The
attention families' dot FLOPs and dot bytes equal the reference's,
exactly: the remat recomputation, the backward's products and AdamW's
(none) alike. falcon-mamba's too: on ``meta`` its scan takes the
reference's chunked form (``models/ssm.py::_selective_scan_blocked``),
whose state read-out has the compiled program's vjp.

zamba2's counts differ, pinned here with their cause (exact numbers at
this size: the reference 6,521,749,504 FLOPs and 215,400,448 bytes, the
port 9,175,040 and 5,253,120 fewer), in the Mamba-2 SSD's chunk loop
(``ssd_chunked_ref``, the reference's ``_ssd_chunked``):
- in the carry update's three-operand einsum ``bsh,bsn,bshp->bhpn``, JAX
  forms the outer product of ``decay · dt`` and B as a ``dot_general``
  with no contraction (XLA turns it into a multiply), whose vjp is two
  dots contracting N and H: 2 x 2·B·chunk·H·N FLOPs a chunk of a layer,
  1,310,720 in all. torch's einsum forms that product by broadcasting,
  and its vjp has no dot;
- JAX's ``lax.scan`` transpose runs the whole body's backward for every
  chunk; torch's autograd skips what no output needs: the first chunk's
  state cotangent (the initial state is a constant) and the last chunk's
  carry update (its state is discarded), 3 products of 2·B·H·P·N·chunk
  FLOPs a layer, 7,864,320 in all.
"""

import pytest

from _dryrun_ref import FAMILIES, port_counts, reference_counts

#: zamba2's training counts, port / reference (see the module docstring)
ZAMBA2_FLOPS_RATIO = 6_512_574_464 / 6_521_749_504     # 0.998593...
ZAMBA2_BYTES_RATIO = 210_147_328 / 215_400_448         # 0.975612...


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "zamba2-7b"])
def test_training_counts_equal_the_reference(arch):
    ref_flops, ref_bytes = reference_counts(arch, "train")
    flops, nbytes = port_counts(arch, "train")
    assert ref_flops > 0 and ref_bytes > 0
    assert flops == ref_flops
    assert nbytes == ref_bytes


def test_zamba2_training_counts_pinned():
    ref_flops, ref_bytes = reference_counts("zamba2-7b", "train")
    flops, nbytes = port_counts("zamba2-7b", "train")
    assert flops / ref_flops == pytest.approx(ZAMBA2_FLOPS_RATIO, abs=1e-9)
    assert nbytes / ref_bytes == pytest.approx(ZAMBA2_BYTES_RATIO, abs=1e-9)
