"""The port's synthetic training data and the dry run's input stand-ins
(``pipeline.py``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticCorpus,
    make_batch_specs,
)
