"""Qwen2-VL-72B — VLM decoder backbone, M-RoPE; ViT frontend is a stub.
[arXiv:2409.12191]

``input_specs()`` supplies precomputed patch embeddings (batch, patches,
d_model) merged ahead of the text tokens; M-RoPE = 3-section rotary
(temporal / height / width position ids).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    rope="mrope", qkv_bias=True, mlp_act="swiglu", norm="rmsnorm",
    source="arXiv:2409.12191",
))
