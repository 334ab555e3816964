"""The deadline-constrained serving engine of the waste pipeline."""

from repro_torch.serving.engine import ServingEngine, StageProfile

__all__ = ["ServingEngine", "StageProfile"]
