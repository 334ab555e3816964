"""Analysis of the port: the launch geometry checker (``launch_check``),
which proves for every registered CUDA launch that its blocks write
disjoint outputs, stay in bounds or mask their edges, and share buffers
only through declared in-place outputs; and the runtime invariants of
``REPRO_SANITIZE=1`` (``sanitize``).

Entry point: ``python -m repro_torch.analysis [--fixture race|oob|alias]``.
The JAX package's ``jaxlint`` pass has no counterpart here: it is
specific to JAX and XLA.
"""

from repro_torch.analysis.launch_check import (  # noqa: F401
    BlockDecl, KernelGeometry, Violation, check_all, load_registry, register,
)
