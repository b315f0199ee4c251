"""H2O-Danube-3-4B — dense llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    sliding_window=4096,
    rope="rope", mlp_act="swiglu", norm="rmsnorm",
    source="arXiv:2401.16818",
))
