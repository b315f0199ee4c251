"""Per-layer blocks (port of `repro/models/blocks.py`) for the six
families.

A dense block's parameters are one layer's dict: ``ln1``, ``attn``,
``ln2``, ``mlp``; an MoE block's ``ln1``, ``attn``, ``ln2``, ``moe`` (and
``mlp`` with a dense residual, as in Arctic); an SSM block's ``ln1`` and
``ssm``; an encoder-decoder's decoder block ``ln1``, ``self``, ``ln2``,
``cross``, ``ln3``, ``mlp`` (the VLM family and the audio encoder use the
dense block). An MoE block returns its load-balance loss beside its output
in `forward` only; prefill and decode drop it, as JAX does.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_schema,
                                       norm_schema)
from repro_torch.sharding import shard


def dense_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": attn_mod.attention_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def moe_block_schema(cfg):
    s = {"ln1": norm_schema(cfg), "attn": attn_mod.attention_schema(cfg),
         "ln2": norm_schema(cfg), "moe": moe_mod.moe_schema(cfg)}
    if cfg.dense_residual:
        s["mlp"] = mlp_schema(cfg)
    return s


def ssm_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "ssm": ssm_mod.ssm_schema(cfg)}


def decoder_block_schema(cfg):
    """Enc-dec decoder block: self-attn + cross-attn + mlp."""
    return {"ln1": norm_schema(cfg), "self": attn_mod.attention_schema(cfg),
            "ln2": norm_schema(cfg), "cross": attn_mod.attention_schema(cfg),
            "ln3": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def apply_dense_block(cfg, p, x, positions, *, causal=True, impl="auto",
                      window="cfg"):
    h = attn_mod.apply_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                 positions, causal=causal, impl=impl,
                                 window=window)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return shard(x, "batch", "seq", "embed")


def _moe_ffn(cfg, p, x):
    """The MoE half of a block after attention: (x + y, aux)."""
    xn = apply_norm(cfg, p["ln2"], x)
    y, aux = moe_mod.apply_moe_auto(cfg, p["moe"], xn)
    if cfg.dense_residual:
        y = y + apply_mlp(cfg, p["mlp"], xn)
    return x + y, aux


def apply_moe_block(cfg, p, x, positions, *, impl="auto"):
    """Returns (x, aux): the block's output and its load-balance loss."""
    h = attn_mod.apply_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                 positions, causal=True, impl=impl)
    x, aux = _moe_ffn(cfg, p, x + h)
    return shard(x, "batch", "seq", "embed"), aux


def apply_ssm_block(cfg, p, x):
    y = ssm_mod.apply_ssm(cfg, p["ssm"], apply_norm(cfg, p["ln1"], x))
    return shard(x + y, "batch", "seq", "embed")


def apply_decoder_block(cfg, p, x, enc_out, positions, *, impl="auto"):
    h = attn_mod.apply_attention(cfg, p["self"], apply_norm(cfg, p["ln1"], x),
                                 positions, causal=True, impl=impl)
    x = x + h
    x = x + attn_mod.apply_cross_attention(
        cfg, p["cross"], apply_norm(cfg, p["ln2"], x),
        dict(zip(("k", "v"), attn_mod.kv_of(p["cross"], enc_out))), impl=impl)
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], x))
    return shard(x, "batch", "seq", "embed")


def apply_dense_block_prefill(cfg, p, x, positions, cache, *, impl="auto"):
    """`apply_dense_block` that also fills this layer's decode cache in
    place."""
    h, c = attn_mod.apply_attention_prefill(
        cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions, cache,
        impl=impl)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return shard(x, "batch", "seq", "embed"), c


def apply_moe_block_prefill(cfg, p, x, positions, cache, *, impl="auto"):
    """`apply_moe_block` that also fills this layer's decode cache in
    place."""
    h, c = attn_mod.apply_attention_prefill(
        cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions, cache,
        impl=impl)
    x, _ = _moe_ffn(cfg, p, x + h)
    return shard(x, "batch", "seq", "embed"), c


def apply_ssm_block_prefill(cfg, p, x, *, cache_dtype=None):
    y, c = ssm_mod.apply_ssm_prefill(cfg, p["ssm"],
                                     apply_norm(cfg, p["ln1"], x),
                                     cache_dtype=cache_dtype)
    return shard(x + y, "batch", "seq", "embed"), c


def apply_decoder_block_prefill(cfg, p, x, cross, positions, cache, *,
                                impl="auto"):
    """`apply_decoder_block` that fills this layer's self-attention cache in
    place; its cross-attention reads ``cross``, the layer's {"k", "v"} of
    the cross cache (`models.model.fill_cross_caches`), where JAX forms
    them again from the encoder output."""
    h, c = attn_mod.apply_attention_prefill(
        cfg, p["self"], apply_norm(cfg, p["ln1"], x), positions, cache,
        causal=True, window=None, impl=impl)
    x = x + h
    x = x + attn_mod.apply_cross_attention(
        cfg, p["cross"], apply_norm(cfg, p["ln2"], x), cross, impl=impl)
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], x))
    return shard(x, "batch", "seq", "embed"), c


def apply_dense_block_decode(cfg, p, x, cache, pos, *, window="cfg"):
    xn = apply_norm(cfg, p["ln1"], x)
    h, cache = attn_mod.apply_attention_decode(cfg, p["attn"], xn, cache, pos,
                                               window=window)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, cache


def apply_moe_block_decode(cfg, p, x, cache, pos):
    xn = apply_norm(cfg, p["ln1"], x)
    h, cache = attn_mod.apply_attention_decode(cfg, p["attn"], xn, cache, pos)
    x, _ = _moe_ffn(cfg, p, x + h)
    return x, cache


def apply_ssm_block_decode(cfg, p, x, cache):
    """The cache (one layer's {"conv", "state"}) is updated in place."""
    y, cache = ssm_mod.apply_ssm_decode(cfg, p["ssm"],
                                        apply_norm(cfg, p["ln1"], x), cache)
    return x + y, cache


def apply_decoder_block_decode(cfg, p, x, self_cache, cross_cache, pos,
                               cross_pos):
    """The self cache is updated in place; the cross cache is read only,
    at ``cross_pos`` = T - 1 on every row (all of its T slots)."""
    xn = apply_norm(cfg, p["ln1"], x)
    h, self_cache = attn_mod.apply_attention_decode(
        cfg, p["self"], xn, self_cache, pos, window=None)
    x = x + h
    xn = apply_norm(cfg, p["ln2"], x)
    h, _ = attn_mod.apply_attention_decode(
        cfg, p["cross"], xn, cross_cache, cross_pos, cross=True, window=None)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], x))
    return x, self_cache
