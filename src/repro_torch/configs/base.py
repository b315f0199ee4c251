"""Architecture configuration system (port of `repro/configs/base.py`).

The same plain frozen dataclasses as the JAX package, copied rather than
imported, for all six families:

  dense | moe | hybrid (mamba2 + shared attention) | audio (enc-dec) |
  vlm (M-RoPE decoder) | ssm (mamba2)

The port's model code (`repro_torch.models.model`) runs all six.
``reduced()`` returns the CPU-test variant of the same family (2 layers,
d_model <= 256, <= 4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # derived if 0
    # --- attention flavour ---
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA width (danube, hybrid long-ctx)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (defaults to d_ff)
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25    # expert capacity; large => no dropping
    # FSDP axis for expert weights: "d_model" shards the contracting dim
    # (naive; induces per-layer activation all-reduces over the data axis),
    # "d_ff" shards the expert hidden dim (ZeRO-style weight all-gather).
    moe_fsdp_dim: str = "d_ff"
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (zamba2-style): shared attention block every `period` layers
    shared_attn_period: int = 0
    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- misc ---
    mlp_act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                 # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.enc_dec and self.n_enc_layers == 0:
            object.__setattr__(self, "n_enc_layers", self.n_layers)

    # ------------------------------------------------------------------ sizes
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic serving path exists (SSM / hybrid-SWA / native SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    # --------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count of our implementation (no frontend stubs)."""
        # lazy: the model modules import this one
        from repro_torch.models.model import param_count
        return param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        from repro_torch.models.model import param_count
        total = param_count(self)
        if self.n_experts:
            expert = param_count(self, experts_only=True)
            total = total - expert + expert * self.top_k // self.n_experts
        return total

    def model_flops_per_token(self) -> float:
        """MODEL_FLOPS/token ~= 6 * N_active (standard 6ND accounting)."""
        return 6.0 * self.active_param_count()

    # --------------------------------------------------------------- variants
    def reduced(self) -> "ArchConfig":
        """CPU smoke variant: same family/topology, tiny dimensions."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = 0
        if self.n_heads:
            # preserve GQA ratio where possible
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            n_kv = max(1, n_heads // ratio)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=2 if self.enc_dec else 0,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d_model // n_heads) if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.n_experts else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else 64,
            ssm_chunk=32,
            shared_attn_period=min(self.shared_attn_period, 2)
            if self.shared_attn_period else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "InputShape":
        return InputShape(self.name + "-smoke", min(self.seq_len, 64),
                          min(self.global_batch, 2), self.kind)


# --------------------------------------------------------------------- registry
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401
        starcoder2_7b, olmoe_1b_7b, zamba2_2_7b, whisper_large_v3,
        qwen2_vl_72b, qwen1_5_110b, arctic_480b, llama3_405b,
        mamba2_780m, h2o_danube_3_4b)
    _LOADED = True
