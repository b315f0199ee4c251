"""Model assembly (port of `repro/models/model.py`): schema, parameter
init, forward, prefill and the decode step, for the six families: dense,
MoE, SSM, hybrid, VLM and audio (encoder-decoder).

Parameters are a plain dict with the JAX tree's names: ``embed`` ({"tok",
"unembed"}), ``layers`` and ``lnf``; for the hybrid family ``shared``, its
one weight-shared dense block; for the VLM family ``vision_proj``; for the
audio family ``enc_layers`` and ``enc_lnf``. Where JAX stacks the layers
on a leading axis and runs `lax.scan`, the port keeps ``layers`` (and
``enc_layers``) as a list of per-layer dicts and runs a Python loop. The
decode cache keeps JAX's stacked layout, {"attn": {"k", "v"}} with leaves
(layers, B, T, KV, hd) for the dense, MoE and VLM families, {"ssm":
{"conv": (layers, B, 3, conv_ch), "state": (layers, B, H, P, N) fp32}} for
the SSM family, both {"ssm": ...} and {"shared_attn": {"k", "v"}} with
leaves (groups, B, T, KV, hd) for the hybrid family, and {"self", "cross"}
(each {"k", "v"} of (layers, B, T, KV, hd)) for the audio family, and is
updated in place (JAX donates it), one layer's view at a time.

A hybrid model (Zamba2) runs its SSM layers in groups of
``shared_attn_period``; each group starts with the shared dense block,
which keeps one attention cache per group (the same weights see other
activations in every group).

A VLM (Qwen2-VL) projects ``inputs["vision_embeds"]`` (B, S_vis, D), the
stub vision tower's patch embeddings, through ``vision_proj`` and puts them
ahead of the text, so a prompt of S tokens fills `prefill_len` positions;
its M-RoPE sees one position id per token (t = h = w), as JAX's backbone
does. An audio model (Whisper) runs a bidirectional encoder over
``inputs["frames"]`` (B, S_enc, D), the stub conv front end's frames, plus
a sinusoid; the decoder adds a sinusoid at each token's position, and each
decoder layer attends to its own K/V of the encoder output, formed once
(`fill_cross_caches`).

An MoE layer routes at the config's capacity factor in `forward`,
`prefill` and `decode_step` alike, as JAX does: its capacity follows the
call's sequence length, so `forward` over S + 1 tokens may drop other
entries than a prefill over S (a decode step of one token drops none).

Every entry point takes ``device=`` (default "cuda") and raises without
that device. ``remat=True`` recomputes each block's activations in the
backward pass (`torch.utils.checkpoint`, JAX's `jax.checkpoint` around the
scanned block); the forward's values are the same bits either way.
`abstract_params` gives the schema's tensors on the ``meta`` device and
`input_specs` the inputs' shapes. `loss_fn` is the training loss (the
masked mean next-token NLL plus AUX_LOSS_WEIGHT times the MoE load-balance
loss). `param_axes` gives the parameters' logical axes (on a mesh
`sharding.distribute_tree` places them as DTensors) and `input_specs` the
inputs' (`INPUT_AXES`; beside DTensor parameters the forward places the
batch by them).

Sharded serving: with DTensor parameters `prefill` and `decode_step` place
the tokens by ("batch", None), keep pos replicated, and hold the cache as
DTensors placed by `decode_cache_axes` (its attention slots split over
"cache_seq"); `init_decode_caches(..., mesh=)` makes such a cache. The
reference's `shard` sites of the prefill are kept (no-ops without a mesh).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, apply_norm,
                                       count_from_schema, einsum,
                                       embed_schema, embed_tokens,
                                       init_from_schema, map_schema,
                                       norm_schema, stack_layers,
                                       torch_dtype, unembed)

WHISPER_ENC_FRAMES = 1500     # 30 s of audio at 50 Hz after the conv stub
VLM_VISION_FRACTION = 8       # 1/8 of the sequence is patch embeddings
AUX_LOSS_WEIGHT = 0.01
# the inputs' logical axes (`input_specs`; a loss mask is laid out as the
# labels)
INPUT_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "mask": ("batch", "seq"),
              "vision_embeds": ("batch", "seq", "embed"),
              "frames": ("batch", "seq", "embed")}
PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``'s family."""
    if cfg.family not in PORTED:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ===================================================================== schema
def _layer_schema(cfg: ArchConfig):
    if cfg.family in ("ssm", "hybrid"):
        return blocks.ssm_block_schema(cfg)
    if cfg.family == "moe":
        return blocks.moe_block_schema(cfg)
    if cfg.family == "audio":
        return blocks.decoder_block_schema(cfg)
    return blocks.dense_block_schema(cfg)


def _vision_proj_schema(cfg: ArchConfig):
    return {"w": ParamSpec((cfg.d_model, cfg.d_model), ("embed_fsdp", None),
                           std=0.02)}


def model_schema(cfg: ArchConfig):
    """The JAX schema (layers stacked on a leading axis), for counting."""
    check_family(cfg)
    s = {"embed": embed_schema(cfg)}
    if cfg.family == "audio":
        s["enc_layers"] = stack_layers(blocks.dense_block_schema(cfg),
                                       cfg.n_enc_layers)
        s["enc_lnf"] = norm_schema(cfg)
    s["layers"] = stack_layers(_layer_schema(cfg), cfg.n_layers)
    if _shared_period(cfg):
        s["shared"] = blocks.dense_block_schema(cfg)
    if cfg.family == "vlm":
        s["vision_proj"] = _vision_proj_schema(cfg)
    s["lnf"] = norm_schema(cfg)
    return s


def _shared_period(cfg: ArchConfig) -> int:
    """Layers in each group of a hybrid config (a group starts with the
    shared dense block); 0 for the other families."""
    if cfg.family != "hybrid":
        return 0
    period = cfg.shared_attn_period
    if period <= 0 or cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of shared_attn_period {period}")
    return period


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, *,
                device="cuda"):
    """Random weights from the schema, drawn on ``device`` from a
    `torch.Generator` seeded with ``seed``, in ``dtype`` (default the
    config's). The same distribution as JAX's `init_params`, not the same
    numbers: `convert.params_from_jax` carries JAX's weights across."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _port_tree(cfg, lambda schema: init_from_schema(schema, gen, dev,
                                                           dt))


def _port_tree(cfg: ArchConfig, fn):
    """The port's parameter tree (layers a list), ``fn`` of each part's
    schema, the parts taken in the order `init_params` draws them."""
    tree = {"embed": fn(embed_schema(cfg))}
    if cfg.family == "audio":
        tree["enc_layers"] = [fn(blocks.dense_block_schema(cfg))
                              for _ in range(cfg.n_enc_layers)]
        tree["enc_lnf"] = fn(norm_schema(cfg))
    layer = _layer_schema(cfg)
    tree["layers"] = [fn(layer) for _ in range(cfg.n_layers)]
    if _shared_period(cfg):
        tree["shared"] = fn(blocks.dense_block_schema(cfg))
    if cfg.family == "vlm":
        tree["vision_proj"] = fn(_vision_proj_schema(cfg))
    tree["lnf"] = fn(norm_schema(cfg))
    return tree


def param_axes(cfg: ArchConfig):
    """Each parameter's logical axes, a tree like `init_params`' (layers a
    list): the reference's `param_axes` without its leading "layers" axis,
    which replicates (`sharding.RULES["layers"]` is empty)."""
    check_family(cfg)
    return _port_tree(cfg, lambda schema: map_schema(lambda s: s.axes,
                                                     schema))


def abstract_params(cfg: ArchConfig, dtype=None):
    """The schema's tensors on the ``meta`` device, in ``dtype`` (default
    the config's): JAX's `abstract_params` tree (layers stacked on a
    leading axis, as `model_schema` lays them out), allocating nothing."""
    dt = torch_dtype(dtype or cfg.dtype)
    return map_schema(lambda spec: torch.empty(spec.shape, dtype=dt,
                                               device="meta"),
                      model_schema(cfg))


def param_count(cfg: ArchConfig, experts_only: bool = False) -> int:
    schema = model_schema(cfg)
    if experts_only:
        if not cfg.n_experts:
            return 0
        moe = schema["layers"]["moe"]
        return count_from_schema({k: moe[k] for k in ("wi_gate", "wi_up",
                                                      "wo")})
    return count_from_schema(schema)


# ===================================================================== utils
@contextlib.contextmanager
def unroll_scans(enable: bool = True):
    """JAX's switch that fully unrolls the layer scans (for XLA's cost
    analysis, which counts a scan body once). The port's layer loops are
    Python loops, which every layer runs through already, so this changes
    nothing; it is kept so that code written against the reference runs
    unchanged."""
    yield


def _block(remat: bool, fn, *args):
    """``fn(*args)``, through `torch.utils.checkpoint` when ``remat``: the
    same forward, its activations recomputed in the backward pass."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _device_inputs(params, tokens, device) -> Tuple[torch.device,
                                                    torch.Tensor]:
    dev = resolve_device(device)
    if params["embed"]["tok"].device != dev:
        raise ValueError(f"the parameters are on "
                         f"{params['embed']['tok'].device}, not on {dev}")
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.to(dev)
    else:
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    return dev, tokens.long()


def _on(x, dev) -> torch.Tensor:
    """An input array (numpy or tensor) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _input(params, name: str, x, dev) -> torch.Tensor:
    """Input ``name`` as a tensor on ``dev``; with DTensor parameters a
    DTensor placed by its logical axes (`INPUT_AXES`) on their mesh: every
    rank holds the whole batch and keeps its block."""
    return sharding.place_like(_on(x, dev), params["embed"]["tok"],
                               INPUT_AXES[name])


def _mesh_of(params):
    """The mesh of DTensor parameters, or None."""
    tok = params["embed"]["tok"]
    return tok.device_mesh if sharding.is_dtensor(tok) else None


def _positions(b: int, s: int, dev) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)


def _shared_view(cache, g: int):
    """Group ``g``'s {"k", "v"} of a hybrid cache's shared attention."""
    return {k: leaf[g] for k, leaf in cache["shared_attn"].items()}


def _layer_view(kv, i: int):
    """Layer ``i``'s {"k", "v"} of a stacked attention cache."""
    return {k: leaf[i] for k, leaf in kv.items()}


def sinusoid_at(pos, d: int) -> torch.Tensor:
    """pos (...) int -> (..., d) float32: sin then cos of the float32 angle
    pos / 10000^(2i/d), i < d/2, as JAX computes it with x64 off. The power
    and the sin and cos are taken in float64 and rounded once, as XLA's
    float32 results are correctly rounded there (ATen's float32 pow is an
    ulp off on some exponents); on the CPU through numpy, on the calling
    thread: ATen's sin on a large CPU tensor has returned one thread's
    share off by ~1e-4 at Whisper's angles of ~1,500 rad, in some runs
    only (as its exp did in ROADMAP F5)."""
    e = 2 * torch.arange(d // 2, device=pos.device) / d       # float32
    div = torch.pow(10_000.0, e.double()).float()
    ang = (pos[..., None].float() / div).double()
    if ang.device.type == "cpu":
        a = ang.numpy()
        return torch.from_numpy(np.concatenate([np.sin(a), np.cos(a)],
                                               axis=-1)).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def sinusoid(seq: int, d: int, offset=0, *, device="cuda") -> torch.Tensor:
    """(seq, d) float32: `sinusoid_at` positions offset .. offset + seq - 1."""
    pos = torch.arange(seq, dtype=torch.int32, device=resolve_device(device))
    return sinusoid_at(pos + offset, d)


def _embed(cfg: ArchConfig, params, inputs, tokens, dev):
    """Token embeddings; a VLM's projected patch embeddings ahead of them."""
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.family == "vlm":
        vis = einsum("bsd,de->bse",
                     _input(params, "vision_embeds", inputs["vision_embeds"],
                            dev), params["vision_proj"]["w"])
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    return x


def _embed_decoder(cfg: ArchConfig, params, tokens):
    """An audio decoder's token embeddings plus the sinusoid."""
    x = embed_tokens(cfg, params["embed"], tokens)
    pe = sinusoid(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
    return x + sharding.replicate_like(pe, x)[None]


# ===================================================================== forward
def forward(cfg: ArchConfig, params, inputs: Dict[str, Any], *,
            impl: str = "auto", remat: bool = False, device="cuda"):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss): the sum of
    the MoE layers' load-balance losses in fp32, 0.0 for other families. A
    VLM's logits cover the vision prefix too. ``remat`` checkpoints each
    block (`_block`)."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, inputs["tokens"], device)
    tokens = _input(params, "tokens", tokens, dev)
    if cfg.family == "audio":
        return _forward_audio(cfg, params, inputs, tokens, dev, impl=impl,
                              remat=remat)
    x = sharding.shard(_embed(cfg, params, inputs, tokens, dev), "batch",
                       "seq", "embed")
    b, s, _ = x.shape
    positions = _input(params, "tokens", _positions(b, s, dev), dev)
    aux = sharding.replicate_like(torch.zeros((), dtype=torch.float32,
                                              device=dev), x)
    period = _shared_period(cfg)

    def dense(p_l, h):
        return blocks.apply_dense_block(cfg, p_l, h, positions, impl=impl)

    def moe(p_l, h):
        return blocks.apply_moe_block(cfg, p_l, h, positions, impl=impl)

    def ssm(p_l, h):
        return blocks.apply_ssm_block(cfg, p_l, h)

    for i, p_l in enumerate(params["layers"]):
        if period and i % period == 0:
            x = _block(remat, dense, params["shared"], x)
        if cfg.family in ("ssm", "hybrid"):
            x = _block(remat, ssm, p_l, x)
        elif cfg.family == "moe":
            x, a_l = _block(remat, moe, p_l, x)
            aux = aux + a_l
        else:
            x = _block(remat, dense, p_l, x)
    x = apply_norm(cfg, params["lnf"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, aux


def encode_audio(cfg: ArchConfig, params, frames, *, impl: str = "auto",
                 remat: bool = False, device="cuda"):
    """Run the (bidirectional) audio encoder over stub frame embeddings
    (B, S_enc, D) -> (B, S_enc, D)."""
    dev = resolve_device(device)
    frames = _input(params, "frames", frames, dev)
    b, s_enc, _ = frames.shape
    pe = sinusoid(s_enc, cfg.d_model, device=dev).to(frames.dtype)
    enc = sharding.shard(frames + sharding.replicate_like(pe, frames)[None],
                         "batch", "seq", "embed")
    pos_enc = _input(params, "tokens", _positions(b, s_enc, dev), dev)

    def enc_block(p_l, h):
        return blocks.apply_dense_block(cfg, p_l, h, pos_enc, causal=False,
                                        impl=impl, window=None)
    for p_l in params["enc_layers"]:
        enc = _block(remat, enc_block, p_l, enc)
    return apply_norm(cfg, params["enc_lnf"], enc)


def fill_cross_caches(cfg: ArchConfig, params, enc):
    """The cross-attention K/V cache from the encoder output enc (B, T, D):
    {"k", "v"} of (layers, B, T, KV, hd) in enc's dtype, each layer's
    formed once and written into its slice (the enc-dec prefill hand-off
    the serving path uses before `decode_step`); DTensors placed by the
    cache's axes when enc is one."""
    b, t, _ = enc.shape
    shape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim)
    mesh = enc.device_mesh if sharding.is_dtensor(enc) else None
    dev = enc.to_local().device if mesh is not None else enc.device
    axes = _with_layers(attn_mod.cache_axes())
    cross = {n: _zeros(shape, axes[n], enc.dtype, dev, mesh)
             for n in ("k", "v")}
    for i, p_l in enumerate(params["layers"]):
        k, v = attn_mod.kv_of(p_l["cross"], enc)
        sharding.copy_into(cross["k"][i], k)
        sharding.copy_into(cross["v"][i], v)
    return cross


def _forward_audio(cfg, params, inputs, tokens, dev, *, impl="auto",
                   remat=False):
    enc = encode_audio(cfg, params, inputs["frames"], impl=impl, remat=remat,
                       device=dev)
    x = sharding.shard(_embed_decoder(cfg, params, tokens), "batch", "seq",
                       "embed")
    b, s, _ = x.shape
    pos_dec = _input(params, "tokens", _positions(b, s, dev), dev)

    def dec_block(p_l, h, enc):
        return blocks.apply_decoder_block(cfg, p_l, h, enc, pos_dec,
                                          impl=impl)
    for p_l in params["layers"]:
        x = _block(remat, dec_block, p_l, x, enc)
    x = apply_norm(cfg, params["lnf"], x)
    return (unembed(cfg, params["embed"], x),
            sharding.replicate_like(torch.zeros((), dtype=torch.float32,
                                                device=dev), x))


# ===================================================================== prefill
def prefill_len(cfg: ArchConfig, prompt_len: int) -> int:
    """Number of cache positions a prompt of ``prompt_len`` tokens occupies
    after `prefill` (VLM prompts carry a vision-patch prefix)."""
    if cfg.family == "vlm":
        return prompt_len + max(prompt_len // VLM_VISION_FRACTION, 1)
    return prompt_len


def prefill(cfg: ArchConfig, params, inputs: Dict[str, Any], max_len: int, *,
            impl: str = "auto", cache_dtype=None, device="cuda"):
    """Prompt forward that also emits the decode cache.

    One full-sequence forward over the prompt whose per-layer K/V
    (attention; per group for a hybrid model's shared block), final SSD
    state and conv window (Mamba2) and cross-attention K/V (enc-dec) are
    written straight into a fresh ``max_len``-long cache (the structure
    `init_decode_caches` allocates and `decode_step` advances; an audio
    model's cross cache has as many slots as ``inputs["frames"]`` has
    frames), so generation continues from position `prefill_len(cfg, S)`
    without replaying the prompt. An SSM prompt's length must be a
    multiple of the chunk or shorter than it.

    Returns (last_logits (B, V) — the next-token logits, cache)."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, inputs["tokens"], device)
    tokens = _input(params, "tokens", tokens, dev)
    if cfg.family == "audio":
        return _prefill_audio(cfg, params, inputs, tokens, dev, max_len,
                              impl=impl, cache_dtype=cache_dtype)
    x = _embed(cfg, params, inputs, tokens, dev)
    b, s, _ = x.shape
    x = sharding.shard(x, "batch", "seq", "embed")
    positions = _input(params, "tokens", _positions(b, s, dev), dev)
    cdt = torch_dtype(cache_dtype) if cache_dtype is not None else x.dtype
    cache = init_decode_caches(cfg, b, max_len, cdt, device=dev,
                               mesh=_mesh_of(params))
    if cfg.family in ("ssm", "hybrid"):
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        period = _shared_period(cfg)
        for i, p_l in enumerate(params["layers"]):
            if period and i % period == 0:
                x, _ = blocks.apply_dense_block_prefill(
                    cfg, params["shared"], x, positions,
                    _shared_view(cache, i // period), impl=impl)
            x, c = blocks.apply_ssm_block_prefill(cfg, p_l, x,
                                                  cache_dtype=cdt)
            sharding.copy_into(conv[i], c["conv"])
            sharding.copy_into(state[i], c["state"])
    else:
        block = (blocks.apply_moe_block_prefill if cfg.family == "moe" else
                 blocks.apply_dense_block_prefill)
        for i, p_l in enumerate(params["layers"]):
            x, _ = block(cfg, p_l, x, positions,
                         _layer_view(cache["attn"], i), impl=impl)
    x = apply_norm(cfg, params["lnf"], x[:, -1:])
    return unembed(cfg, params["embed"], x)[:, 0], cache


def _prefill_audio(cfg, params, inputs, tokens, dev, max_len, *,
                   impl="auto", cache_dtype=None):
    enc = encode_audio(cfg, params, inputs["frames"], impl=impl, device=dev)
    cross = fill_cross_caches(cfg, params, enc)
    x = sharding.shard(_embed_decoder(cfg, params, tokens), "batch", "seq",
                       "embed")
    b, s, _ = x.shape
    positions = _input(params, "tokens", _positions(b, s, dev), dev)
    cdt = torch_dtype(cache_dtype) if cache_dtype is not None else x.dtype
    self_c = _attn_cache(cfg, cfg.n_layers, b, _attn_len(cfg, max_len), cdt,
                         dev, _mesh_of(params))
    for i, p_l in enumerate(params["layers"]):
        x, _ = blocks.apply_decoder_block_prefill(
            cfg, p_l, x, _layer_view(cross, i), positions,
            _layer_view(self_c, i), impl=impl)
    # JAX casts the cross K/V to the cache's dtype: a copy only if it
    # differs from the activations'
    cache = {"self": self_c,
             "cross": {k: v.to(cdt) for k, v in cross.items()}}
    x = apply_norm(cfg, params["lnf"], x[:, -1:])
    return unembed(cfg, params["embed"], x)[:, 0], cache


# ===================================================================== loss
def loss_fn(cfg: ArchConfig, params, batch, *, impl: str = "auto",
            remat: bool = False, device="cuda"):
    """Training loss: (loss, {"nll", "aux"}). The NLL is the fp32
    logsumexp of each position's logits minus its gold logit, averaged
    over ``batch["mask"]`` (all ones when absent; at least 1 in the
    denominator); a VLM's loss covers its text positions only (the last
    ``labels.shape[1]``). The loss adds AUX_LOSS_WEIGHT times ``aux``, the
    MoE layers' load-balance loss (0 for other families)."""
    logits, aux = forward(cfg, params, batch, impl=impl, remat=remat,
                          device=device)
    dev = logits.device
    labels = _input(params, "labels", batch["labels"], dev).long()
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    mask = batch.get("mask")
    mask = (torch.ones_like(labels, dtype=torch.float32)
            if mask is None else _input(params, "mask", mask, dev).float())
    # every vocab entry on each rank: the gold logit's gather does not run
    # on vocab-sharded DTensor logits
    logits = sharding.shard(logits.float(), "batch", "seq", None)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + AUX_LOSS_WEIGHT * aux, {"nll": loss, "aux": aux}


# ===================================================================== decode
def _attn_len(cfg: ArchConfig, max_len: int) -> int:
    w = cfg.sliding_window
    return min(max_len, w) if w else max_len


def _with_layers(axes):
    """A cache part's axes with the leading stacked "layers" axis."""
    return {k: ("layers",) + ax for k, ax in axes.items()}


def _zeros(shape, logical, dtype, dev, mesh):
    """A zeroed cache leaf; a DTensor placed by ``logical`` on ``mesh``."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=dev)
    return sharding.zeros(shape, logical, mesh, dtype, dev)


def _attn_cache(cfg: ArchConfig, n: int, batch: int, t: int, dtype, dev,
                mesh=None):
    shape = (n, batch, t, cfg.n_kv_heads, cfg.head_dim)
    axes = _with_layers(attn_mod.cache_axes())
    return {k: _zeros(shape, axes[k], dtype, dev, mesh) for k in ("k", "v")}


def decode_cache_axes(cfg: ArchConfig):
    """The logical axes of `init_decode_caches`' tree, leaf by leaf: JAX's
    second return value of `init_decode_caches`, with its leading "layers"
    axis (the port's cache leaves are stacked as JAX's are)."""
    check_family(cfg)
    attn = _with_layers(attn_mod.cache_axes())
    if cfg.family == "audio":
        return {"self": attn, "cross": dict(attn)}
    axes = {}
    if cfg.family in ("ssm", "hybrid"):
        axes["ssm"] = _with_layers(ssm_mod.ssm_cache_axes())
    if cfg.family != "ssm":
        axes["shared_attn" if _shared_period(cfg) else "attn"] = attn
    return axes


def init_decode_caches(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, *, device="cuda",
                       enc_frames: int = WHISPER_ENC_FRAMES, mesh=None):
    """The zeroed decode cache: {"attn": {"k", "v"}} with leaves (layers,
    batch, T, KV, hd), T = max_len (or the window); for the SSM family
    {"ssm": {"conv", "state"}} with leaves (layers, batch, ...), the state
    in fp32 whatever ``dtype``; for the hybrid family both, as "ssm" and
    "shared_attn" with (groups, batch, T, KV, hd) leaves; for the audio
    family {"self", "cross"}, the cross cache at ``enc_frames`` slots (JAX's
    WHISPER_ENC_FRAMES; its engine sizes the slot cache from `prefill`'s
    output instead, at its own frame count). With a ``mesh`` the leaves are
    DTensors placed by `decode_cache_axes`, each rank allocating only its
    own block.

    JAX returns the leaves' logical axes beside the cache; the port returns
    the cache alone, and `decode_cache_axes` gives the axes. Its callers
    (the engine, the scheduler) take the cache as a tree of tensors to
    index, copy and clear slot by slot, so a pair here would change every
    one of them for a value only the sharded path reads."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    attn_len = _attn_len(cfg, max_len)
    if cfg.family == "audio":
        return {"self": _attn_cache(cfg, cfg.n_layers, batch, attn_len, dt,
                                    dev, mesh),
                "cross": _attn_cache(cfg, cfg.n_layers, batch, enc_frames, dt,
                                     dev, mesh)}
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.init_ssm_cache(cfg, batch, dt, "meta")
        axes = _with_layers(ssm_mod.ssm_cache_axes())
        cache["ssm"] = {k: _zeros((cfg.n_layers,) + tuple(v.shape), axes[k],
                                  v.dtype, dev, mesh)
                        for k, v in one.items()}
    if cfg.family != "ssm":
        period = _shared_period(cfg)
        n = cfg.n_layers // period if period else cfg.n_layers
        cache["shared_attn" if period else "attn"] = _attn_cache(
            cfg, n, batch, attn_len, dt, dev, mesh)
    return cache


def decode_step(cfg: ArchConfig, params, tokens, cache, pos, *,
                device="cuda"):
    """One decode step. tokens (B,1) int; pos an int OR (B,) ints.

    Per-row ``pos`` is the slot-cache layout: every row advances at its own
    position, so one step serves slots admitted at different times (an SSM
    layer carries its position in its state and ignores ``pos``; a hybrid
    model's shared attention block reads it; an audio decoder adds the
    sinusoid at each row's pos). The cache is updated in place. Returns
    (logits (B,1,V), cache)."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, tokens, device)
    tokens = _input(params, "tokens", tokens, dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)  # not per layer
    if cfg.family == "audio":
        b = x.shape[0]
        pe = sinusoid_at(pos.expand(b), cfg.d_model)[:, None].to(x.dtype)
        x = x + sharding.replicate_like(pe, x)
        # every cross slot is read: pos T - 1 on each row, one fill a step
        cross_pos = torch.full((b,), cache["cross"]["k"].shape[2] - 1,
                               dtype=torch.int32, device=dev)
        for i, p_l in enumerate(params["layers"]):
            x, _ = blocks.apply_decoder_block_decode(
                cfg, p_l, x, _layer_view(cache["self"], i),
                _layer_view(cache["cross"], i), pos, cross_pos)
    elif cfg.family in ("ssm", "hybrid"):
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        period = _shared_period(cfg)
        for i, p_l in enumerate(params["layers"]):
            if period and i % period == 0:
                x, _ = blocks.apply_dense_block_decode(
                    cfg, params["shared"], x, _shared_view(cache, i // period),
                    pos)
            x, _ = blocks.apply_ssm_block_decode(
                cfg, p_l, x, {"conv": conv[i], "state": state[i]})
    else:
        block = (blocks.apply_moe_block_decode if cfg.family == "moe" else
                 blocks.apply_dense_block_decode)
        for i, p_l in enumerate(params["layers"]):
            x, _ = block(cfg, p_l, x, _layer_view(cache["attn"], i), pos)
    x = apply_norm(cfg, params["lnf"], x)
    return unembed(cfg, params["embed"], x), cache


# ===================================================================== inputs
def input_specs(cfg: ArchConfig, shape: InputShape):
    """The model's inputs for ``shape`` as tensors on the ``meta`` device,
    and their logical axes: (inputs, axes), the names, shapes, dtypes and
    axes of JAX's abstract `input_specs` (tokens int32, embeddings in the
    config's dtype). Concrete batches of these shapes come from
    `data.pipeline.make_batch`."""
    b, s = shape.global_batch, shape.seq_len
    act = torch_dtype(cfg.dtype)

    def mk(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"tokens": mk((b, 1), torch.int32)}, {"tokens": ("batch",
                                                                None)}
    if cfg.family == "vlm":
        s_vis = s // VLM_VISION_FRACTION
        s = s - s_vis
        inputs = {"tokens": mk((b, s), torch.int32),
                  "vision_embeds": mk((b, s_vis, cfg.d_model), act)}
    elif cfg.family == "audio":
        inputs = {"frames": mk((b, WHISPER_ENC_FRAMES, cfg.d_model), act),
                  "tokens": mk((b, s), torch.int32)}
    else:
        inputs = {"tokens": mk((b, s), torch.int32)}
    if shape.kind == "train":
        inputs["labels"] = mk((b, s), torch.int32)
    return inputs, {k: INPUT_AXES[k] for k in inputs}
