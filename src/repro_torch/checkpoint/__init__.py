"""The port's checkpoints, in the reference's ``.npz`` + ``meta.json``
layout (``checkpoint.py``)."""

from repro_torch.checkpoint.checkpoint import restore, save  # noqa: F401
