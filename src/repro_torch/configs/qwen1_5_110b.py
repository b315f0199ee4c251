"""Qwen1.5-110B — dense, GQA(kv=8), QKV bias. [hf:Qwen/Qwen1.5-0.5B scaled card]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064,
    rope="rope", qkv_bias=True, mlp_act="swiglu", norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-0.5B",
))
