"""The paper's own application model (§III): the waste-classification
pipeline stages, expressed as one compact vision-token classifier.

Stage 1 (detector), stage 2 (binary) and stage 3 (4-class) share this
backbone at different input resolutions in the serving example; the conv
feature extractor is stubbed by patch embeddings exactly like the VLM
frontends.  This is the model the deadline-constrained scheduler actually
serves in examples/waste_pipeline.py.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="waste-pipeline",
    arch_type="vlm",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=1024,           # class/token space of the pipeline heads
    frontend="vision",
    n_media_tokens=169,        # 13x13 feature grid (YoloV2-style)
    source="paper SS III/V (YoloV2-based 3-stage pipeline, re-expressed)",
)
