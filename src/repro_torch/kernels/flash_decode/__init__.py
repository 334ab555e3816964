"""Flash decode: one query token against a KV cache, masked by ``pos`` and
a sliding window, soft-capped, GQA.

The kernel's wrapper is ``flash_decode.flash_decode`` (the module keeps the
launch count); the package exports the dispatcher and the plain version.
"""

from repro_torch.kernels.flash_decode.ops import decode_attention_op
from repro_torch.kernels.flash_decode.ref import decode_attention_ref

__all__ = ["decode_attention_op", "decode_attention_ref"]
