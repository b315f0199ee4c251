"""Per-layer blocks (port of `repro/models/blocks.py`): the dense family.

The MoE, SSM and encoder-decoder blocks wait for their families (ROADMAP.md,
A20, A21, A25). A block's parameters are one layer's dict: ``ln1``,
``attn``, ``ln2``, ``mlp``.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_schema,
                                       norm_schema)


def dense_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": attn_mod.attention_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def apply_dense_block(cfg, p, x, positions, *, causal=True, impl="auto",
                      window="cfg"):
    h = attn_mod.apply_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                 positions, causal=causal, impl=impl,
                                 window=window)
    x = x + h
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))


def apply_dense_block_prefill(cfg, p, x, positions, cache, *, impl="auto"):
    """`apply_dense_block` that also fills this layer's decode cache in
    place."""
    h, c = attn_mod.apply_attention_prefill(
        cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions, cache,
        impl=impl)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, c


def apply_dense_block_decode(cfg, p, x, cache, pos, *, window="cfg"):
    xn = apply_norm(cfg, p["ln1"], x)
    h, cache = attn_mod.apply_attention_decode(cfg, p["attn"], xn, cache, pos,
                                               window=window)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, cache
