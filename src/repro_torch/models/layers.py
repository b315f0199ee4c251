"""Core layers and the parameter-schema system (port of
`repro/models/layers.py`).

A model is described by a *schema*: nested dicts whose leaves are
`ParamSpec`s (shape, logical axes, init). Parameters are plain dicts of
tensors with the JAX package's leaf names (``wq``, ``scale``, ...), not
`nn.Module`s, so `convert.params_from_jax` maps one tree onto the other
leaf for leaf. The logical axes place the parameters on a mesh
(`models.model.param_axes`, `sharding.distribute_tree`).

Weights are drawn here from an explicit `torch.Generator` on the target
device: the same distribution as `init_from_schema` in JAX, not the same
numbers (the tests carry JAX's weights across instead).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.sharding import shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones
    std: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_schema(fn, schema):
    """Apply ``fn`` to every `ParamSpec` of a nested dict, keeping its
    structure."""
    if is_spec(schema):
        return fn(schema)
    return {k: map_schema(fn, v) for k, v in schema.items()}


def spec_leaves(schema):
    if is_spec(schema):
        return [schema]
    return [leaf for v in schema.values() for leaf in spec_leaves(v)]


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]


def init_from_schema(schema, generator: torch.Generator, device,
                     dtype_override=None):
    """Materialise a schema: normal leaves are N(0, 1)·std drawn in float32
    from ``generator`` on ``device`` and cast, as JAX draws them."""
    def init(spec):
        dt = torch_dtype(dtype_override or spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(spec.std).to(dt)
    return map_schema(init, schema)


def count_from_schema(schema) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(schema))


def stack_layers(schema, n_layers: int):
    """Add a leading `layers` dim to every spec of a per-layer schema (the
    JAX layout; the port's parameters keep one dict per layer instead)."""
    return map_schema(
        lambda s: ParamSpec((n_layers,) + s.shape, ("layers",) + s.axes,
                            s.init, s.std, s.dtype), schema)


def pad_front(x, n: int):
    """``x`` (B, S, ...) with ``n`` zero rows in front along dim 1,
    concatenated rather than padded: a DTensor's pad takes a one-mesh-dim
    rule in some torch releases (2.11)."""
    front = torch.zeros_like(x[:, :1]).expand(-1, n, *x.shape[2:])
    return torch.cat([front, x], dim=1)


def einsum(eq: str, *operands):
    """`torch.einsum` after promoting the operands to one dtype, as
    `jnp.einsum` promotes (a bf16 weight against an f32 activation gives
    an f32 product)."""
    dt = operands[0].dtype
    for x in operands[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in operands))


# ----------------------------------------------------------------- norms
def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_schema(cfg, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), (None,), "ones"),
                "bias": ParamSpec((d,), (None,), "zeros")}
    return {"scale": ParamSpec((d,), (None,), "ones")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ----------------------------------------------------------------- mlp
def mlp_schema(cfg, d_model: Optional[int] = None, d_ff: Optional[int] = None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    std_in = 0.02
    std_out = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    if cfg.mlp_act == "swiglu":
        return {
            "wi_gate": ParamSpec((d, f), ("embed_fsdp", "mlp"), std=std_in),
            "wi_up": ParamSpec((d, f), ("embed_fsdp", "mlp"), std=std_in),
            "wo": ParamSpec((f, d), ("mlp", "embed_fsdp"), std=std_out),
        }
    return {
        "wi": ParamSpec((d, f), ("embed_fsdp", "mlp"), std=std_in),
        "bi": ParamSpec((f,), ("mlp",), "zeros"),
        "wo": ParamSpec((f, d), ("mlp", "embed_fsdp"), std=std_out),
        "bo": ParamSpec((d,), (None,), "zeros"),
    }


def apply_mlp(cfg, p, x):
    if cfg.mlp_act == "swiglu":
        g = einsum("...d,df->...f", x, p["wi_gate"])
        u = einsum("...d,df->...f", x, p["wi_up"])
        h = F.silu(g) * u
        h = shard(h, "batch", "seq", "mlp") if h.ndim == 3 else h
        return einsum("...f,fd->...d", h, p["wo"])
    h = einsum("...d,df->...f", x, p["wi"]) + p["bi"]
    h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    h = shard(h, "batch", "seq", "mlp") if h.ndim == 3 else h
    return einsum("...f,fd->...d", h, p["wo"]) + p["bo"]


# ----------------------------------------------------------------- embeddings
def embed_schema(cfg):
    s = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                          std=0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                 ("embed_fsdp", "vocab"), std=0.02)
    return s


def embed_tokens(cfg, p, tokens):
    """The token embeddings: ``p["tok"][tokens]``; a DTensor table through
    `_embed_on_shards`."""
    if sharding.is_dtensor(p["tok"]):
        return _embed_on_shards(p["tok"], tokens)
    return p["tok"][tokens]


def _embed_on_shards(tok, tokens):
    """``tok[tokens]`` of a DTensor table under `local_map`: the table whole
    over the mesh dims that do not split its vocab (an FSDP gather), each
    rank the rows of its own vocab block (zeros for a token outside it, so
    the output is a `Partial` sum over the dims that split the vocab) for
    its own rows of tokens; the table's gradient is each rank's block's,
    partial over the dims that split the tokens. DTensor's own rules for
    the lookup's backward fail on a 2-D mesh (torch 2.11's `index_put`,
    2.13's `embedding_dense_backward` from a partial gradient). Without a
    vocab split every row is in the block, and the rows are the plain
    lookup's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tok.device_mesh
    if not sharding.is_dtensor(tokens):
        tokens = sharding.distribute(tokens, (None,) * tokens.ndim, mesh)
    ptab = tuple(Shard(0) if q.is_shard(0) else Replicate()
                 for q in tok.placements)
    ptok = tuple(Shard(0) if q.is_shard(0) and not t.is_shard(0)
                 else Replicate() for q, t in zip(tokens.placements, ptab))
    pout = tuple(Partial() if t.is_shard(0) else q
                 for q, t in zip(ptok, ptab))
    n_blocks = math.prod(mesh.size(i) for i, t in enumerate(ptab)
                         if t.is_shard(0))
    v_l = tok.shape[0] // n_blocks
    first = sharding.block_index(mesh, ptab, 0) * v_l

    def local(t, ids):
        off = ids.long() - first
        ok = (off >= 0) & (off < v_l)
        rows = t[off.clamp(0, v_l - 1)]
        return torch.where(ok[..., None], rows, torch.zeros_like(rows))
    return local_map(local, out_placements=list(pout),
                     in_placements=(ptab, ptok),
                     in_grad_placements=(sharding.grad_placements(ptab, ptok),
                                         ptok),
                     device_mesh=mesh, redistribute_inputs=True)(tok, tokens)


def unembed(cfg, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return einsum("...d,dv->...v", x, w)
