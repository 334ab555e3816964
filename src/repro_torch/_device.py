"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller names another device: a run
that was meant for the card must not quietly become a CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); anything else is
    passed to ``torch.device`` as given (tests pass ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
