"""Flash attention: causal / windowed / soft-capped GQA prefill attention.

The kernel's wrapper is ``flash_attention.flash_attention`` (the module keeps
the launch count); the package exports the dispatcher and the plain version.
"""

from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_op", "attention_ref"]
