"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention block. [arXiv:2411.15242]

54 Mamba2 layers; a single *weight-shared* full transformer block is invoked
every ``shared_attn_period`` layers (Zamba2 concatenation details simplified
to additive residual reuse). Long-context serving applies a sliding window to
the shared attention block.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_period=6, sliding_window=4096,
    rope="rope", mlp_act="swiglu", norm="rmsnorm",
    source="arXiv:2411.15242",
))
