"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B]  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA ranks follow the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=96,  # qk head dim = nope(64) + rope(32)
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)
