"""Attention: GQA / MHA / sliding-window; full sequence, prefill and decode
(port of `repro/models/attention.py`).

Parameters are plain dicts of tensors with the JAX leaf names (`wq`, `wk`,
`wv`, `wo`, and `bq`/`bk`/`bv` with a qkv bias). `attend` picks an
implementation (``impl``):

  auto, pallas — on a CUDA tensor the hand-written `flash_attention`
                 kernel (`kernels.ops`), and nothing else; on a DTensor
                 `ops.flash_attention` too, on either device (each rank
                 runs the kernel, or on the CPU its plain version, on its
                 own heads). On a CPU tensor
                 "auto" picks as JAX does: `_attend_naive` below
                 ``CHUNKED_THRESHOLD`` query tokens, chunked from there;
                 "pallas" takes `_attend_naive`. "pallas" keeps the JAX
                 name so a reader finds the counterpart; the kernel takes
                 no q_offset and raises on one.
  naive        — one einsum over the full (S, T) score matrix.
  chunked      — JAX's XLA "flash" in plain PyTorch: a loop over q chunks,
                 each an online softmax over kv chunks (m, l and the
                 accumulator in fp32), never forming (S, T); with a sliding
                 window a banded variant reads only the keys a q chunk can
                 see. Below 2·``Q_CHUNK`` query tokens it is naive, as in
                 JAX. It is not a kernel and replaces none: the TPU
                 kernel's counterpart is `flash_attention`.

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

On a mesh the cache is a DTensor placed by `cache_axes` (its slots split
over "cache_seq"). Its writes, the prefill's K/V and each step's slot, go
through `scatter_slots`: each rank writes the slots of its own block of T
under `local_map` (DTensor's index_put on a sharded dim is not relied on),
and the step's attention is `ops.decode_attention` of the DTensor cache,
which combines the blocks' partial softmaxes without gathering the cache.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import repeat_kv as _repeat_kv
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import ParamSpec, einsum, pad_front
from repro_torch.sharding import is_dtensor, replicate_like, shard

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 512
KV_CHUNK = 1024


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


class _MergeHeads(torch.autograd.Function):
    """A DTensor's dims ``dim`` and ``dim + 1`` (heads and head_dim)
    merged; the backward places the gradient as the input is placed (a
    split of the heads is a split of the merged dim) before it unflattens
    it, which DTensor cannot do from a split inside a head (56, 36, 20 or 8
    heads over 16 ranks)."""

    @staticmethod
    def forward(ctx, x, dim: int):
        from torch.distributed.tensor import Shard
        ctx.shape = x.shape
        # the input's placements on the merged dims (a later dim one down)
        ctx.placements = tuple(Shard(p.dim - 1) if p.is_shard()
                               and p.dim > dim else p for p in x.placements)
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.shape), None


def _out_proj(o, wo):
    """o (B,S,H,hd) -> (B,S,D) through wo (H,hd,D); on DTensors over the
    merged heads·hd dim (`_MergeHeads`), whose backward would otherwise
    unflatten a gradient DTensor's product may split inside a head."""
    if not (is_dtensor(o) or is_dtensor(wo)):
        return einsum("bshk,hkd->bsd", o, wo)
    return einsum("bse,ed->bsd", _MergeHeads.apply(o, 2),
                  _MergeHeads.apply(wo, 0))


def _proj(x, w, b=None, heads: str = "heads"):
    """x (B,S,D) -> (B,S,heads,hd) through w (D,heads,hd), plus b. On
    DTensors the product runs over w's flattened heads·hd columns and is
    placed as the reference places the heads (``heads`` split over "model"
    only where they divide) before the unflatten: DTensor cannot unflatten
    a dim split inside a head, and its product may choose to split the
    columns anyhow."""
    if not (is_dtensor(x) or is_dtensor(w)):
        y = einsum("bsd,dhk->bshk", x, w)
        return y if b is None else y + b
    d, h, hd = w.shape
    y = einsum("bsd,de->bse", x, _MergeHeads.apply(w, 1) if is_dtensor(w)
               else w.reshape(d, h * hd))
    bb, s = y.shape[:2]
    mesh = y.device_mesh
    want = sharding.placements(sharding.spec_for(
        (bb, s, h, hd), ("batch", "seq", heads, None), mesh), mesh)
    if tuple(y.placements) != want:
        y = y.redistribute(mesh, want)
    y = y.view(bb, s, h, hd)
    return y if b is None else y + b


def kv_of(p, x):
    """The (K, V) an attention's weights form from x (B,T,D)."""
    return (_proj(x, p["wk"], p.get("bk"), "kv_heads"),
            _proj(x, p["wv"], p.get("bv"), "kv_heads"))


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
    mask = _mask(torch.arange(s, device=q.device) + q_offset,
                 torch.arange(t, device=q.device), causal, window)
    scores = torch.where(replicate_like(mask, scores), scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bhst,bthk->bshk", w, v)


# ------------------------------------------------------------------ chunked
def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int],
                    q_offset: int = 0, q_chunk: int = Q_CHUNK,
                    kv_chunk: int = KV_CHUNK):
    """Online softmax over kv chunks inside a loop over q chunks (JAX's two
    `lax.scan`s). Never forms (S, T). With a sliding window (causal, S = T,
    no offset) each q chunk reads only the ``band`` + ``q_chunk`` keys it
    can see, a slice of K/V padded in front by ``band`` keys whose
    positions are negative and masked.

    The casts are the reference's: the banded route casts the softmax
    weights to the input dtype before P·V; the unbanded one accumulates
    P·V in fp32 and casts the normalised output."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"{s} query tokens are not whole chunks of "
                         f"{q_chunk}")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    banded = window is not None and causal and t == s and q_offset == 0
    if banded:
        band = ((window + q_chunk - 1) // kv_chunk + 1) * kv_chunk
        kp, vp = pad_front(k, band), pad_front(v, band)
    n_kv = t // kv_chunk if t % kv_chunk == 0 else 1
    kv_len = t // n_kv
    chunks = []
    for qi in range(s // q_chunk):
        q0 = qi * q_chunk
        qc = q[:, q0:q0 + q_chunk]
        qpos = q0 + torch.arange(q_chunk, device=dev) + q_offset
        if banded:
            # keys visible to this q chunk: [q0 - band + 1, q0 + q_chunk),
            # at [q0, q0 + band + q_chunk) of the padded K/V
            kpos = q0 - band + torch.arange(band + q_chunk, device=dev)
            chunks.append(_online_block(
                qc, kp[:, q0:q0 + band + q_chunk],
                vp[:, q0:q0 + band + q_chunk], qpos, kpos, causal, window,
                scale))
            continue
        m = torch.full_like(qc[..., 0].transpose(1, 2), NEG_INF,
                            dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qc.transpose(1, 2), dtype=torch.float32)
        for kj in range(n_kv):
            kc = k[:, kj * kv_len:(kj + 1) * kv_len]
            vc = v[:, kj * kv_len:(kj + 1) * kv_len]
            kpos = kj * kv_len + torch.arange(kv_len, device=dev)
            sc = einsum("bshk,bthk->bhst", qc, kc).float() * scale
            sc = torch.where(replicate_like(_mask(qpos, kpos, causal,
                                                  window), sc), sc,
                             torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + einsum("bhst,bthk->bhsk", p,
                                                  vc.float())
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        chunks.append(o.transpose(1, 2))                 # (B,q_chunk,H,hd)
    return torch.cat(chunks, dim=1)


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    """(len(qpos), len(kpos)) bool: the keys each query may see."""
    msk = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                     device=qpos.device)
    if causal:
        msk &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        msk &= kpos[None, :] > qpos[:, None] - window
    return msk


def _online_block(qc, kc, vc, qpos, kpos, causal, window, scale):
    """Single-block softmax attention (the banded sliding-window route);
    padded keys have kpos < 0 and are masked."""
    sc = einsum("bshk,bthk->bhst", qc, kc).float() * scale
    msk = _mask(qpos, kpos, causal, window) & (kpos[None, :] >= 0)
    sc = torch.where(replicate_like(msk, sc), sc,
                     torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return einsum("bhst,bthk->bshk", w.to(qc.dtype), vc)


# ------------------------------------------------------------------ dispatch
def attend(q, k, v, *, causal=True, window=None, q_offset=0, impl="auto"):
    if impl not in ("auto", "pallas", "naive", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl in ("auto", "pallas") and (q.device.type != "cpu"
                                       or is_dtensor(q)):
        if q_offset:
            raise ValueError("the flash_attention kernel takes no q_offset "
                             f"(got {q_offset}); use impl='naive'")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "auto":
        impl = "chunked" if q.shape[1] >= CHUNKED_THRESHOLD else "naive"
    if impl == "chunked" and q.shape[1] >= 2 * Q_CHUNK:
        return _attend_chunked(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return _attend_naive(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def apply_attention(cfg, p, x, positions, *, causal=True, window="cfg",
                    impl="auto"):
    """Full-sequence self-attention (train / prefill / encoder)."""
    if window == "cfg":
        window = cfg.sliding_window
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope != "none":
        rot = rope_mod.positional(cfg, positions)
        q, k = rot(q), rot(k)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    o = shard(o, "batch", "seq", "heads", None)
    return _out_proj(o, p["wo"])


def apply_cross_attention(cfg, p, x, cross, *, impl="auto"):
    """Cross-attention (JAX's `apply_attention(..., xkv=enc)`: non-causal,
    no window, no rope) over K/V already formed from the encoder output:
    ``cross`` is {"k", "v"} (B,T,KV,hd), `kv_of` the encoder output or one
    layer's slice of the cross cache, read in place."""
    q = shard(_proj(x, p["wq"], p.get("bq")), "batch", "seq", "heads", None)
    k = shard(cross["k"], "batch", "seq", "kv_heads", None)
    o = attend(q, k, cross["v"], causal=False, window=None, impl=impl)
    o = shard(o, "batch", "seq", "heads", None)
    return _out_proj(o, p["wo"])


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
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    o = shard(o, "batch", "seq", "heads", None)
    out = _out_proj(o, p["wo"])

    s = k.shape[1]
    t = cache["k"].shape[1]
    keep = min(s, t)
    slots = positions[:, s - keep:] % t                   # (B, keep)
    scatter_slots(cache["k"], slots, k[:, s - keep:])
    scatter_slots(cache["v"], slots, v[:, s - keep:])
    return out, cache


def scatter_slots(cache, slots, vals) -> None:
    """cache[b, slots[b, j]] = vals[b, j] in place, cast to the cache's
    dtype: cache (B, T, ...), slots (B, n) int, vals (B, n, ...). On a
    DTensor cache each rank writes, under `local_map`, the entries whose
    slot lies in its own block of T, [r·T_l, (r+1)·T_l), into its own rows
    (the values go whole along n to every rank of the mesh dims that split
    T); nothing else is written or sent."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[rows, slots.long()] = vals.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.device_mesh
    pc = tuple(cache.placements)
    pv = tuple(Replicate() if p.is_shard(1) else p for p in pc)
    prow = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pc)
    t_l = cache.to_local().shape[1]
    block = sharding.block_index(mesh, pc, 1)
    if not is_dtensor(slots):
        slots = sharding.distribute(slots, (None, None), mesh)
    if not is_dtensor(vals):
        vals = sharding.distribute(vals, (None,) * vals.ndim, mesh)

    def local(c, sl, v):
        # an entry outside the block rewrites its row's first entry inside
        # it with the same value (or, with none inside, slot 0 with its own
        # content): duplicate indices that all write the same bits, with no
        # data-dependent shape (no host sync; the meta device runs it)
        sl = sl.long() - block * t_l
        ok = (sl >= 0) & (sl < t_l)
        rows = torch.arange(c.shape[0], device=c.device)
        first = ok.int().argmax(1)
        has = ok[rows, first]
        v = v.to(c.dtype)
        to = torch.where(has, sl[rows, first], torch.zeros_like(first))
        fill = torch.where(has.view((-1,) + (1,) * (v.ndim - 2)),
                           v[rows, first], c[rows, to])
        bcast = (-1, sl.shape[1]) + (1,) * (v.ndim - 2)
        c[rows[:, None], torch.where(ok, sl, to[:, None])] = torch.where(
            ok.view(bcast), v, fill[:, None])
        return c
    local_map(local, out_placements=list(pc), in_placements=(pc, prow, pv),
              device_mesh=mesh, redistribute_inputs=True)(cache, slots, vals)


# ------------------------------------------------------------------ decode
def cache_axes():
    """The logical axes of an attention cache's (B, T, KV, hd) leaves."""
    return {"k": ("batch", "cache_seq", "kv_heads", None),
            "v": ("batch", "cache_seq", "kv_heads", None)}


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
    pos_r = replicate_like(pos_r, x)
    if not cross:
        k1, v1 = kv_of(p, x)
        if cfg.rope != "none":
            rot = rope_mod.positional(cfg, pos_r[:, None])
            q, k1 = rot(q), rot(k1)
        # a frozen row past the cache end writes its last slot, as JAX's
        # dynamic_update_slice clamps
        slot = (pos_r % t if window is not None else pos_r).clamp(max=t - 1)
        scatter_slots(cache["k"], slot[:, None], k1)
        scatter_slots(cache["v"], slot[:, None], v1)
    k, v = cache["k"], cache["v"]
    dt = torch.promote_types(q.dtype, k.dtype)
    o = ops.decode_attention(q.to(dt), k.to(dt), v.to(dt), pos_r)
    return _out_proj(o, p["wo"]), cache
