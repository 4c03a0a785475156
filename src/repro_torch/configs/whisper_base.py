"""Whisper-base — encoder-decoder, conv frontend (STUB).  [arXiv:2212.04356]

6L (enc) + 6L (dec), d_model=512 8H d_ff=2048 vocab=51865.  The conv1d mel
frontend is stubbed: ``input_specs()`` provides 1500 precomputed frame
embeddings for the encoder.  Attention is full MHA (kv=8 == heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    encoder_layers=6,
    encoder_seq_len=1500,
)
