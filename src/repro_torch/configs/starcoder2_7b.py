"""StarCoder2-7B — dense, GQA(kv=4), RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    rope="rope", mlp_act="gelu", norm="layernorm", qkv_bias=True,
    source="arXiv:2402.19173",
))
