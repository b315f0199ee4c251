"""Llama-3.1-405B — dense, GQA(kv=8), 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256,
    rope="rope", rope_theta=500_000.0, mlp_act="swiglu", norm="rmsnorm",
    source="arXiv:2407.21783",
))
