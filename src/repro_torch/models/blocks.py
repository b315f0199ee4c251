"""Per-layer blocks (port of `repro/models/blocks.py`): the dense and SSM
families.

The MoE and encoder-decoder blocks wait for their families (ROADMAP.md,
A21, A25). A dense block's parameters are one layer's dict: ``ln1``,
``attn``, ``ln2``, ``mlp``; an SSM block's ``ln1`` and ``ssm``.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_schema,
                                       norm_schema)


def dense_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": attn_mod.attention_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def ssm_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "ssm": ssm_mod.ssm_schema(cfg)}


def apply_dense_block(cfg, p, x, positions, *, causal=True, impl="auto",
                      window="cfg"):
    h = attn_mod.apply_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                 positions, causal=causal, impl=impl,
                                 window=window)
    x = x + h
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))


def apply_ssm_block(cfg, p, x):
    return x + ssm_mod.apply_ssm(cfg, p["ssm"], apply_norm(cfg, p["ln1"], x))


def apply_dense_block_prefill(cfg, p, x, positions, cache, *, impl="auto"):
    """`apply_dense_block` that also fills this layer's decode cache in
    place."""
    h, c = attn_mod.apply_attention_prefill(
        cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions, cache,
        impl=impl)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, c


def apply_ssm_block_prefill(cfg, p, x, *, cache_dtype=None):
    y, c = ssm_mod.apply_ssm_prefill(cfg, p["ssm"],
                                     apply_norm(cfg, p["ln1"], x),
                                     cache_dtype=cache_dtype)
    return x + y, c


def apply_dense_block_decode(cfg, p, x, cache, pos, *, window="cfg"):
    xn = apply_norm(cfg, p["ln1"], x)
    h, cache = attn_mod.apply_attention_decode(cfg, p["attn"], xn, cache, pos,
                                               window=window)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, cache


def apply_ssm_block_decode(cfg, p, x, cache):
    """The cache (one layer's {"conv", "state"}) is updated in place."""
    y, cache = ssm_mod.apply_ssm_decode(cfg, p["ssm"],
                                        apply_norm(cfg, p["ln1"], x), cache)
    return x + y, cache
