"""OLMoE-1B-7B — MoE, 64 experts top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, moe_d_ff=1024,
    rope="rope", mlp_act="swiglu", norm="rmsnorm",
    source="arXiv:2409.02060",
))
