"""Optimizers on the port's parameter trees (port of
`repro/train/optimizer.py`).

AdamW with fp32 master weights and a configurable moment dtype, and
SGD-momentum for tests and ablations. A tree is the port's parameters:
nested dicts and lists of tensors (`models.model.init_params`); every
function here returns new tensors and leaves its inputs as they are, as
the reference's pure functions do.

The step's scalars (the learning rate and the bias corrections) are
computed on the host from the step count, each transcendental in float64
and rounded once to float32, so the card and the CPU use the same bits.

On DTensor params (`sharding.distribute_tree`) the state's m, v and
master take each param's placements (`adamw_state_axes`: the params'
logical axes), every update is local to a rank's block, and `global_norm`
is a full reduction over the mesh. `abstract_adamw` gives the state's
tensors on the ``meta`` device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.sharding import is_dtensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    master_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ===================================================================== trees
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


# ================================================================== schedule
def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def lr_schedule(cfg: AdamWConfig, step) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the peak, at
    optimizer step ``step`` (an int or a 0-d tensor), as a float32 value.
    The reference takes each operation in float32; here the arithmetic is
    float32 too (numpy) and the cosine float64, rounded once."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(f32(1.0), (step + f32(1)) / f32(max(cfg.warmup_steps, 1)))
    prog = (step - f32(cfg.warmup_steps)) / f32(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = min(max(prog, f32(0.0)), f32(1.0))
    cos = f32(0.5) * (f32(1) + f32(math.cos(float(f32(math.pi) * prog))))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return _f32(f32(cfg.lr) * warm * frac)


# ===================================================================== AdamW
def init_adamw(cfg: AdamWConfig, params):
    """{"step": 0-d int32, "m", "v": zeros in ``moment_dtype``, "master": a
    copy of the params in ``master_dtype``}, on the params' device."""
    mdt = torch_dtype(cfg.moment_dtype)
    wdt = torch_dtype(cfg.master_dtype)
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "master": tree_map(lambda p: p.detach().to(wdt, copy=True), params),
    }


def abstract_adamw(cfg: AdamWConfig, abstract_p):
    """`init_adamw`'s tree as tensors on the ``meta`` device (nothing
    allocated), for a tree of (meta) params."""
    mdt = torch_dtype(cfg.moment_dtype)
    wdt = torch_dtype(cfg.master_dtype)

    def meta(p, dt):
        return torch.empty(p.shape, dtype=dt, device="meta")
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "m": tree_map(lambda p: meta(p, mdt), abstract_p),
            "v": tree_map(lambda p: meta(p, mdt), abstract_p),
            "master": tree_map(lambda p: meta(p, wdt), abstract_p)}


def adamw_state_axes(param_axes):
    """The optimizer state's logical axes: the params' (fully sharded like
    them); the step count's ()."""
    return {"step": (), "m": param_axes, "v": param_axes,
            "master": param_axes}


def _leaf_sq(g) -> torch.Tensor:
    """Σ g² in fp32, as a plain 0-d tensor: a DTensor's over the whole
    mesh."""
    sq = torch.sum(torch.square(g.float()))
    return sq.full_tensor() if is_dtensor(sq) else sq


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), in fp32: a 0-d tensor."""
    return torch.sqrt(sum(_leaf_sq(g) for g in tree_leaves(tree)))


def _bias_correction(beta: float, step: int) -> float:
    """1 − β^step with β as the float32 the reference multiplies by, the
    power in float64 rounded once."""
    b = float(np.float32(beta))
    return _f32(np.float32(1.0) - np.float32(b ** step))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step: the gradients clipped to a global norm of
    ``grad_clip`` (none when 0), moments updated, the fp32 master moved by
    lr · (m̂ / (sqrt(v̂) + eps) + weight_decay · master) (decoupled decay),
    and the params the master cast to their dtypes. Returns (new_params,
    new_state, {"grad_norm", "lr"})."""
    step0 = int(state["step"])
    step = step0 + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)
    lr = lr_schedule(cfg, step0)
    b1c = _bias_correction(cfg.b1, step)
    b2c = _bias_correction(cfg.b2, step)

    def upd(g, m, v, master):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        mw = master.float()
        mw = mw - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * mw)
        return m32.to(m.dtype), v32.to(v.dtype), mw.to(master.dtype)

    triples = []                         # (m, v, master) a leaf
    tree_map(lambda *a: triples.append(upd(*a)), grads, state["m"],
             state["v"], state["master"])

    def part(i):
        it = iter(t[i] for t in triples)
        return tree_map(lambda _: next(it), grads)
    m_new, v_new, master_new = part(0), part(1), part(2)
    # detached: a param of the master's dtype is a new tensor object on the
    # master's storage, so marking it as requiring grad leaves the master
    new_params = tree_map(lambda mw, p: mw.detach().to(p.dtype), master_new,
                          params)
    new_state = {"step": state["step"] + 1, "m": m_new, "v": v_new,
                 "master": master_new}
    lr_t = torch.tensor(lr, dtype=torch.float32, device=gnorm.device)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr_t}


# ============================================================== SGD-momentum
def init_sgdm(params, momentum: float = 0.9):
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(lambda p: torch.zeros(p.shape,
                                                 dtype=torch.float32,
                                                 device=p.device), params)}


@torch.no_grad()
def sgdm_update(grads, state, params, lr: float = 1e-2,
                momentum: float = 0.9):
    """mu = momentum · mu + g (fp32); params − lr · mu, in their dtypes."""
    mu = tree_map(lambda b, g: momentum * b + g.float(), state["mu"], grads)
    new_params = tree_map(lambda p, b: (p.float() - lr * b).to(p.dtype),
                          params, mu)
    return new_params, {"step": state["step"] + 1, "mu": mu}, {}
