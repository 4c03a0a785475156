"""InternVL2-26B — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821]  Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The vision tower is stubbed per the assignment:
``input_specs()`` provides precomputed patch embeddings (256 image tokens
after pixel-shuffle) which replace the first ``num_frontend_tokens`` token
embeddings of the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    num_frontend_tokens=256,
)
