"""Whisper-large-v3 — audio enc-dec backbone; conv frontend is a stub.
[arXiv:2212.04356]

``input_specs()`` supplies precomputed mel/conv frame embeddings
(batch, frames, d_model); the encoder (bidirectional) + decoder
(causal self-attn + cross-attn) transformer backbone is real.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    enc_dec=True, n_enc_layers=32,
    rope="none", mlp_act="gelu", norm="layernorm", qkv_bias=True,
    source="arXiv:2212.04356",
))
