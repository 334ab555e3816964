"""Seeded-violation fixtures for the launch checker.

Excluded from the default scan; selected with ``--fixture <name>`` to prove
that each violation class trips (``python -m repro_torch.analysis`` must
exit non-zero on every one):

- ``race``  — a launch whose two blocks write one output tile
  (``racy_kernel.racy_sum``, a CUDA kernel that really races);
- ``oob``   — blocks tiling past the array edge with no declared mask;
- ``alias`` — an input sharing a buffer with an output, undeclared.

The JAX package's lint fixture (``tracer-leak``) belongs to its ``jaxlint``
pass, which is specific to JAX and has no counterpart here.
"""

GEOMETRY_FIXTURES = ("race", "oob", "alias")
