"""Model assembly (port of `repro/models/model.py`): schema, parameter
init, forward, prefill and the decode step, for the dense, MoE and SSM
families.

Parameters are a plain dict with the JAX tree's names: ``embed`` ({"tok",
"unembed"}), ``layers`` and ``lnf``. Where JAX stacks the layers on a
leading axis and runs `lax.scan`, the port keeps ``layers`` as a list of
per-layer dicts and runs a Python loop. The decode cache keeps JAX's
stacked layout, {"attn": {"k", "v"}} with leaves (layers, B, T, KV, hd) for
the dense and MoE families and {"ssm": {"conv": (layers, B, 3, conv_ch),
"state": (layers, B, H, P, N) fp32}} for the SSM family, and is updated in
place (JAX donates it), one layer's view at a time.

An MoE layer routes at the config's capacity factor in `forward`,
`prefill` and `decode_step` alike, as JAX does: its capacity follows the
call's sequence length, so `forward` over S + 1 tokens may drop other
entries than a prefill over S (a decode step of one token drops none).

Every entry point takes ``device=`` (default "cuda") and raises without
that device. The other families raise `NotImplementedError` naming their
ROADMAP.md item; so do `loss_fn`, `input_specs`, `abstract_params` and
`param_axes`, which are not ported yet (A26).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, count_from_schema,
                                       embed_schema, embed_tokens,
                                       init_from_schema, norm_schema,
                                       stack_layers, torch_dtype, unembed)

VLM_VISION_FRACTION = 8       # 1/8 of the sequence is patch embeddings
PORTED = ("dense", "moe", "ssm")
_WAITING = {"hybrid": "A23 (the SSM backbone with a shared attention block)",
            "vlm": "A24 (M-RoPE and the vision projection)",
            "audio": "A25 (the encoder-decoder)"}


def check_family(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``'s family (dense, MoE or SSM, for
    now)."""
    if cfg.family not in PORTED:
        item = _WAITING.get(cfg.family, "none")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md, {item})")


# ===================================================================== schema
def _layer_schema(cfg: ArchConfig):
    if cfg.family == "ssm":
        return blocks.ssm_block_schema(cfg)
    if cfg.family == "moe":
        return blocks.moe_block_schema(cfg)
    return blocks.dense_block_schema(cfg)


def model_schema(cfg: ArchConfig):
    """The JAX schema (layers stacked on a leading axis), for counting."""
    check_family(cfg)
    return {"embed": embed_schema(cfg),
            "layers": stack_layers(_layer_schema(cfg), cfg.n_layers),
            "lnf": norm_schema(cfg)}


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
    layer = _layer_schema(cfg)
    return {"embed": init_from_schema(embed_schema(cfg), gen, dev, dt),
            "layers": [init_from_schema(layer, gen, dev, dt)
                       for _ in range(cfg.n_layers)],
            "lnf": init_from_schema(norm_schema(cfg), gen, dev, dt)}


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


def _positions(b: int, s: int, dev) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)


# ===================================================================== forward
def forward(cfg: ArchConfig, params, inputs: Dict[str, Any], *,
            impl: str = "auto", device="cuda"):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss): the sum of
    the MoE layers' load-balance losses in fp32, 0.0 for other families."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, inputs["tokens"], device)
    x = embed_tokens(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for p_l in params["layers"]:
        if cfg.family == "ssm":
            x = blocks.apply_ssm_block(cfg, p_l, x)
        elif cfg.family == "moe":
            x, a_l = blocks.apply_moe_block(cfg, p_l, x, positions,
                                            impl=impl)
            aux = aux + a_l
        else:
            x = blocks.apply_dense_block(cfg, p_l, x, positions, impl=impl)
    x = apply_norm(cfg, params["lnf"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, aux


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
    (attention) or final SSD state and conv window (Mamba2) are written
    straight into a fresh ``max_len``-long cache (the structure
    `init_decode_caches` allocates and `decode_step` advances), so
    generation continues from position `prefill_len(cfg, S)` without
    replaying the prompt. An SSM prompt's length must be a multiple of the
    chunk or shorter than it.

    Returns (last_logits (B, V) — the next-token logits, cache)."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, inputs["tokens"], device)
    x = embed_tokens(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, dev)
    cdt = torch_dtype(cache_dtype) if cache_dtype is not None else x.dtype
    cache = init_decode_caches(cfg, b, max_len, cdt, device=dev)
    if cfg.family == "ssm":
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        for i, p_l in enumerate(params["layers"]):
            x, c = blocks.apply_ssm_block_prefill(cfg, p_l, x,
                                                  cache_dtype=cdt)
            conv[i].copy_(c["conv"])
            state[i].copy_(c["state"])
    else:
        block = (blocks.apply_moe_block_prefill if cfg.family == "moe" else
                 blocks.apply_dense_block_prefill)
        ck, cv = cache["attn"]["k"], cache["attn"]["v"]
        for i, p_l in enumerate(params["layers"]):
            x, _ = block(cfg, p_l, x, positions, {"k": ck[i], "v": cv[i]},
                         impl=impl)
    x = apply_norm(cfg, params["lnf"], x[:, -1:])
    return unembed(cfg, params["embed"], x)[:, 0], cache


# ===================================================================== decode
def init_decode_caches(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, *, device="cuda"):
    """The zeroed decode cache: {"attn": {"k", "v"}} with leaves (layers,
    batch, T, KV, hd), T = max_len (or the window); for the SSM family
    {"ssm": {"conv", "state"}} with leaves (layers, batch, ...), the state
    in fp32 whatever ``dtype``. JAX also returns the leaves' logical axes;
    sharding waits (A18), so the port returns the cache alone."""
    check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, torch_dtype(dtype), dev)
        return {"ssm": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                       dtype=v.dtype, device=dev)
                        for k, v in one.items()}}
    w = cfg.sliding_window
    attn_len = min(max_len, w) if w else max_len
    shape = (cfg.n_layers, batch, attn_len, cfg.n_kv_heads, cfg.head_dim)
    return {"attn": {k: torch.zeros(shape, dtype=torch_dtype(dtype),
                                    device=dev) for k in ("k", "v")}}


def decode_step(cfg: ArchConfig, params, tokens, cache, pos, *,
                device="cuda"):
    """One decode step. tokens (B,1) int; pos an int OR (B,) ints.

    Per-row ``pos`` is the slot-cache layout: every row advances at its own
    position, so one step serves slots admitted at different times (an SSM
    layer carries its position in its state and ignores ``pos``). The
    cache is updated in place. Returns (logits (B,1,V), cache)."""
    check_family(cfg)
    dev, tokens = _device_inputs(params, tokens, device)
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.family == "ssm":
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        for i, p_l in enumerate(params["layers"]):
            x, _ = blocks.apply_ssm_block_decode(
                cfg, p_l, x, {"conv": conv[i], "state": state[i]})
    else:
        block = (blocks.apply_moe_block_decode if cfg.family == "moe" else
                 blocks.apply_dense_block_decode)
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)  # not per layer
        ck, cv = cache["attn"]["k"], cache["attn"]["v"]
        for i, p_l in enumerate(params["layers"]):
            x, _ = block(cfg, p_l, x, {"k": ck[i], "v": cv[i]}, pos)
    x = apply_norm(cfg, params["lnf"], x)
    return unembed(cfg, params["embed"], x), cache
