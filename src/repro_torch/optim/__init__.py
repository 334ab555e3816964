"""The port's optimizer: AdamW with a cosine schedule and global-norm
clipping (``adamw.py``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
