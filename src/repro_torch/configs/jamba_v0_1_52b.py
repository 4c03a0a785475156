"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Jamba block: period of 8 layers with a single attention layer (index 4 of
the period in the reference implementation), MoE replacing the dense FFN on
every second layer (e=16, top-2).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_period=8,
    attn_offset=4,
)
