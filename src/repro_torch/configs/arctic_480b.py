"""Snowflake Arctic-480B — MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    rope="rope", mlp_act="swiglu", norm="rmsnorm",
    source="hf:Snowflake/snowflake-arctic-base",
))
