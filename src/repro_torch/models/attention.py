"""Attention: GQA / MHA / sliding-window; full sequence, prefill and decode
(port of `repro/models/attention.py`).

Parameters are plain dicts of tensors with the JAX leaf names (`wq`, `wk`,
`wv`, `wo`, and `bq`/`bk`/`bv` with a qkv bias). `attend` picks an
implementation (``impl``):

  auto, pallas — on a CUDA tensor the hand-written `flash_attention`
                 kernel (`kernels.ops`); on a CPU tensor `_attend_naive`.
                 "pallas" keeps the JAX name so a reader finds the
                 counterpart; the kernel takes no q_offset and raises on
                 one.
  naive        — one einsum over the full (S, T) score matrix.

The JAX package's XLA "flash" (`_attend_chunked`, `_online_block` and its
banded sliding-window variant) waits (ROADMAP.md, A26).

Decode writes the new token's K/V into the cache in place (JAX donates the
cache buffer and scatters; the port updates the tensor it is given) and
attends through `kernels.ops.decode_attention`, with a window too: a
sliding-window config keeps a ring cache of T = min(max_len, window) slots
written at pos % T, whose valid slots (JAX's ring mask, age < min(pos + 1,
T)) are exactly the slots <= min(pos, T - 1) that the kernel reads for the
raw pos, and the softmax does not depend on slot order.

Cross-attention (the audio family's decoder) takes its K/V from the
encoder output and applies no rope. Its decode writes nothing and masks
nothing (JAX's ``cross=True``: an unmasked softmax over all T slots); the
port calls the same `decode_attention` with pos = T - 1 for every row, and
since the kernel reads the slots <= min(pos, T - 1), that is every slot.
The cross K/V are formed once per prompt (`models.model.fill_cross_caches`)
and read in place by the prefill's cross-attention and by every step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import repeat_kv as _repeat_kv
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import ParamSpec, einsum

NEG_INF = -1e30


# ------------------------------------------------------------------ schema
def attention_schema(cfg, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 0.02
    std_o = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    s = {
        "wq": ParamSpec((d, h, hd), ("embed_fsdp", "heads", None), std=std),
        "wk": ParamSpec((d, kv, hd), ("embed_fsdp", "kv_heads", None), std=std),
        "wv": ParamSpec((d, kv, hd), ("embed_fsdp", "kv_heads", None), std=std),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed_fsdp"), std=std_o),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), ("heads", None), "zeros")
        s["bk"] = ParamSpec((kv, hd), ("kv_heads", None), "zeros")
        s["bv"] = ParamSpec((kv, hd), ("kv_heads", None), "zeros")
    return s


def _proj(x, w, b=None):
    """x (B,S,D) -> (B,S,heads,hd) through w (D,heads,hd), plus b."""
    y = einsum("bsd,dhk->bshk", x, w)
    return y if b is None else y + b


def kv_of(p, x):
    """The (K, V) an attention's weights form from x (B,T,D)."""
    return _proj(x, p["wk"], p.get("bk")), _proj(x, p["wv"], p.get("bv"))


def _qkv(cfg, p, x):
    return (_proj(x, p["wq"], p.get("bq")),) + kv_of(p, x)


# ------------------------------------------------------------------ naive
def _attend_naive(q, k, v, *, causal: bool, window: Optional[int],
                  q_offset: int = 0):
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = einsum("bshk,bthk->bhst", q, k).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bhst,bthk->bshk", w, v)


# ------------------------------------------------------------------ dispatch
def attend(q, k, v, *, causal=True, window=None, q_offset=0, impl="auto"):
    if impl in ("auto", "pallas"):
        if q.device.type == "cpu":
            return _attend_naive(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
        if q_offset:
            raise ValueError("the flash_attention kernel takes no q_offset "
                             f"(got {q_offset}); use impl='naive'")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "naive":
        return _attend_naive(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if impl == "chunked":
        raise NotImplementedError("the XLA-style chunked attention waits "
                                  "(ROADMAP.md, A26)")
    raise ValueError(f"unknown attention impl {impl!r}")


def apply_attention(cfg, p, x, positions, *, causal=True, window="cfg",
                    impl="auto"):
    """Full-sequence self-attention (train / prefill / encoder)."""
    if window == "cfg":
        window = cfg.sliding_window
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope != "none":
        rot = rope_mod.positional(cfg, positions)
        q, k = rot(q), rot(k)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    return einsum("bshk,hkd->bsd", o, p["wo"])


def apply_cross_attention(cfg, p, x, cross, *, impl="auto"):
    """Cross-attention (JAX's `apply_attention(..., xkv=enc)`: non-causal,
    no window, no rope) over K/V already formed from the encoder output:
    ``cross`` is {"k", "v"} (B,T,KV,hd), `kv_of` the encoder output or one
    layer's slice of the cross cache, read in place."""
    q = _proj(x, p["wq"], p.get("bq"))
    o = attend(q, cross["k"], cross["v"], causal=False, window=None,
               impl=impl)
    return einsum("bshk,hkd->bsd", o, p["wo"])


# ------------------------------------------------------------------ prefill
def apply_attention_prefill(cfg, p, x, positions, cache, *, causal=True,
                            window="cfg", impl="auto"):
    """Full-sequence attention that also fills the decode KV cache.

    Same math as `apply_attention`, but the (rope'd) K/V are written into
    ``cache`` — a zeroed {"k", "v"} of shape (B, T, KV, hd), one layer's
    view of the model's stacked cache, filled in place (JAX returns a new
    one) — at slot = position % T, the layout `apply_attention_decode`
    writes token by token. For ring caches (sliding window) only the last T
    prompt tokens are kept. Returns (out (B,S,D), cache)."""
    if window == "cfg":
        window = cfg.sliding_window
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope != "none":
        rot = rope_mod.positional(cfg, positions)
        q, k = rot(q), rot(k)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    out = einsum("bshk,hkd->bsd", o, p["wo"])

    b, s = k.shape[:2]
    t = cache["k"].shape[1]
    keep = min(s, t)
    rows = torch.arange(b, device=k.device)[:, None]
    slots = (positions[:, s - keep:] % t).long()          # (B, keep)
    cache["k"][rows, slots] = k[:, s - keep:].to(cache["k"].dtype)
    cache["v"][rows, slots] = v[:, s - keep:].to(cache["v"].dtype)
    return out, cache


# ------------------------------------------------------------------ decode
def apply_attention_decode(cfg, p, x, cache, pos, *, window="cfg",
                           cross=False):
    """One-token decode. x (B,1,D); cache k/v (B,T,KV,hd), updated in
    place; pos a scalar (every row at one position) or (B,) int (each cache
    row at its own position, the slot-indexed serving layout).

    Sliding-window configs keep a ring-buffer cache of size == window,
    written at slot pos % T and read through the same kernel call with the
    raw pos (the module docstring says why no ring mask is needed).
    cross=True: the cache holds the encoder's K/V and is not written; the
    caller passes pos = T - 1 for every row, so the kernel reads every slot
    (no mask), made once a step rather than once a layer.
    """
    if window == "cfg":
        window = cfg.sliding_window
    b = x.shape[0]
    t = cache["k"].shape[1]
    q = _proj(x, p["wq"], p.get("bq"))
    pos_r = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(b)
    if not cross:
        k1, v1 = kv_of(p, x)
        if cfg.rope != "none":
            rot = rope_mod.positional(cfg, pos_r[:, None])
            q, k1 = rot(q), rot(k1)
        # a frozen row past the cache end writes its last slot, as JAX's
        # dynamic_update_slice clamps
        slot = (pos_r % t if window is not None else pos_r).clamp(max=t - 1)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot.long()] = k1[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot.long()] = v1[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    dt = torch.promote_types(q.dtype, k.dtype)
    o = ops.decode_attention(q.to(dt), k.to(dt), v.to(dt), pos_r)
    return einsum("bshk,hkd->bsd", o, p["wo"]), cache
