"""Mamba2 (SSD, state-space duality): the chunked full-sequence path and the
O(1) decode step (port of `repro/models/ssm.py`).

Layer structure follows the Mamba2 paper: in_proj -> [z | xBC | dt],
depthwise causal conv over xBC, SSD core over heads, gated RMSNorm,
out_proj. The SSD core uses the chunkwise dual form: an intra-chunk
quadratic term and the chunks' own states come from `ops.ssd_chunk` (the
`ssd_chunk` kernel on the card, its plain version on the CPU), once per
layer; the inter-chunk state recurrence stays plain PyTorch, a loop over
the chunks where JAX runs an associative scan.

One difference from the JAX module: JAX's inline `ssd_chunked` forms C Bᵀ
in the input dtype (bf16 in a bf16 model) and casts it to fp32; the kernel
and `repro.kernels.ref.ssd_chunk` form it in fp32, and the port follows the
kernel on the card and on the CPU alike. In fp32 the two agree to the order
of sums.

The decode step updates its cache (the conv window and the fp32 state) in
place and returns the same tensors (JAX returns new arrays); on a mesh the
cache's leaves are DTensors placed by `ssm_cache_axes`, written through
`sharding.copy_into` (each rank its own block, under `local_map`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, einsum, pad_front, rmsnorm
from repro_torch.sharding import along, copy_into, shard

CONV_WIDTH = 4


def ssm_schema(cfg):
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    g = 1  # B/C groups
    conv_ch = di + 2 * g * n
    proj_out = 2 * di + 2 * g * n + h
    std_o = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_in": ParamSpec((d, proj_out), ("embed_fsdp", "mlp"), std=0.02),
        "conv_w": ParamSpec((CONV_WIDTH, conv_ch), (None, "mlp"), std=0.02),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), "zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), "ones"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), "zeros"),
        "norm": ParamSpec((di,), ("mlp",), "ones"),
        "w_out": ParamSpec((di, d), ("mlp", "embed_fsdp"), std=std_o),
    }


def _split_proj(cfg, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def _softplus(x):
    """`jax.nn.softplus` (logaddexp(x, 0)); torch's has a threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(xbc, w, b):
    """Depthwise causal conv, width CONV_WIDTH. xbc (B,S,C)."""
    s = xbc.shape[1]
    pad = pad_front(xbc, CONV_WIDTH - 1)
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(CONV_WIDTH))
    return F.silu(out + b)


def segsum_decay(da):
    """da (..., L) -> cumulative log decay A_cum (inclusive)."""
    return torch.cumsum(da, dim=-1)


def ssd_chunked(xh, dt, a, bmat, cmat, chunk: int, init_state=None,
                return_state: bool = False):
    """Chunked SSD core.

    xh   (B,S,H,P) head inputs
    dt   (B,S,H)   positive step sizes
    a    (H,)      negative decay rates (A = -exp(a_log))
    bmat (B,S,N), cmat (B,S,N)  (single B/C group, broadcast over heads)
    Returns y (B,S,H,P) fp32 [, final_state (B,H,P,N)]. S must be a
    multiple of the chunk or shorter than it (JAX asserts it; the port
    raises and does not pad)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    nc = s // chunk

    da = (dt * a).reshape(b, nc, chunk, h)                   # log decay/step
    xd = (xh * dt[..., None]).float().reshape(b, nc, chunk, h, p)
    bm = bmat.reshape(b, nc, chunk, n)
    cm = cmat.reshape(b, nc, chunk, n)
    acum = along(lambda t: torch.cumsum(t, dim=2), da.float(), 2)  # B,NC,L,H

    # intra-chunk term and each chunk's own state: the kernel
    y_intra, states = ops.ssd_chunk(xd, acum, bm, cm)

    # inter-chunk recurrence: the state entering chunk c, as a loop
    gtot = torch.exp(acum[:, :, -1, :])                      # (B,NC,H)
    run = (init_state.float() if init_state is not None else
           torch.zeros_like(states[:, 0]))
    prev = []
    for c in range(nc):
        prev.append(run)
        run = run * gtot[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                          # (B,NC,H,P,N)
    y_inter = torch.einsum("bcln,bchpn->bclhp", cm.float(), prev) \
        * torch.exp(acum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if return_state:
        return y, run
    return y


def _ssd_inputs(cfg, p, x):
    """in_proj, conv and the SSD inputs of a full-sequence layer."""
    b, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = einsum("bsd,dk->bsk", x, p["w_in"])
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xin, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    xh = xin.reshape(b, s, h, hp)
    dtv = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    return z, xbc_raw, xh, dtv, a, bmat, cmat


def _ssd_output(cfg, p, x, z, xh, y):
    """D skip, gated RMSNorm and out_proj."""
    b, s, _ = x.shape
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return einsum("bsk,kd->bsd", y, p["w_out"])


def apply_ssm(cfg, p, x, *, init_state=None, return_state: bool = False):
    """Full-sequence Mamba2 layer. x (B,S,D)."""
    z, _, xh, dtv, a, bmat, cmat = _ssd_inputs(cfg, p, x)
    out = ssd_chunked(xh, dtv, a, bmat, cmat, cfg.ssm_chunk,
                      init_state=init_state, return_state=return_state)
    y, final = out if return_state else (out, None)
    y = _ssd_output(cfg, p, x, z, xh, y)
    if return_state:
        return y, final
    return y


def apply_ssm_prefill(cfg, p, x, *, cache_dtype=None):
    """Full-sequence layer that also emits the decode cache hand-off: the
    final SSD state (fp32) and the last CONV_WIDTH-1 *raw* xBC columns (the
    conv window, zero-padded on the left for prompts shorter than it).
    Returns (y, {"conv", "state"})."""
    s = x.shape[1]
    z, xbc_raw, xh, dtv, a, bmat, cmat = _ssd_inputs(cfg, p, x)
    xh = shard(xh, "batch", "seq", "ssm_heads", None)
    y, final = ssd_chunked(xh, dtv, a, bmat, cmat, cfg.ssm_chunk,
                           return_state=True)
    y = _ssd_output(cfg, p, x, z, xh, y)

    w = CONV_WIDTH - 1
    keep = min(s, w)
    tail = xbc_raw[:, s - keep:]
    if keep < w:
        tail = pad_front(tail, w - keep)
    cache = {"conv": tail.to(cache_dtype or x.dtype),
             "state": final.float()}
    return y, cache


# --------------------------------------------------------------- decode
def init_ssm_cache(cfg, batch: int, dtype, device):
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = di + 2 * n
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, h, hp, n), dtype=torch.float32,
                             device=device),
    }


def ssm_cache_axes():
    """The logical axes of an SSM cache's leaves."""
    return {"conv": ("batch", None, "mlp"),
            "state": ("batch", "ssm_heads", None, "state")}


def apply_ssm_decode(cfg, p, x, cache):
    """Single-token step. x (B,1,D). The cache's "conv" and "state" are
    updated in place; returns (y (B,1,D), cache)."""
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = einsum("bsd,dk->bsk", x, p["w_in"])[:, 0]        # (B,K)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    wdt = torch.promote_types(cache["conv"].dtype, xbc.dtype)   # as jnp
    window = torch.cat([cache["conv"].to(wdt), xbc[:, None, :].to(wdt)],
                       dim=1)
    conv_out = einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    copy_into(cache["conv"], window[:, 1:])
    xin, bmat, cmat = (conv_out[..., :di], conv_out[..., di:di + n],
                       conv_out[..., di + n:])
    xh = xin.reshape(b, h, hp)
    dtv = _softplus(dt.float() + p["dt_bias"])                # (B,H)
    a = -torch.exp(p["a_log"].float())
    g = torch.exp(dtv * a)                                    # (B,H)
    xd = xh.float() * dtv[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xd, bmat.float())
    state = cache["state"] * g[..., None, None] + upd
    copy_into(cache["state"], state)
    y = torch.einsum("bhpn,bn->bhp", state, cmat.float())
    y = y + xh.float() * p["d_skip"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    y = einsum("bk,kd->bd", y, p["w_out"])[:, None, :]
    return y, cache
