"""The port's synthetic training data (``pipeline.py``)."""

from repro_torch.data.pipeline import SyntheticCorpus  # noqa: F401
