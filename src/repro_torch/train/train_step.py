"""The train, prefill and serve steps (port of `repro/train/train_step.py`).

`make_train_step` differentiates `models.model.loss_fn` with autograd. On
the card its attention and SSD cores run the CUDA kernels through their
autograd Functions (`kernels.ops`): the forward is the kernel, the
backward differentiates the plain version, recomputed on the saved
inputs. ``remat=True`` checkpoints each block, so a block's forward (its
kernels included) runs again in the backward pass.

Under a mesh the parameters are DTensors placed by `models.model.
param_axes` (`sharding.distribute_tree`), and the optimizer state takes
their placements (`optimizer.init_adamw` of them); the batch comes whole to
every rank and is placed by `input_specs`' axes inside the forward; the
gradients come back in the parameters' placements; the loss and metrics
are plain tensors, the same on every rank. The step computes what the
one-device step computes.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt


def value_and_grad(cfg: ArchConfig, params, batch, *, impl: str = "auto",
                   remat: bool = True, device="cuda"):
    """(loss, metrics, grads) of `models.model.loss_fn` at ``params``: the
    loss and metrics detached (plain tensors also for DTensor params), the
    gradients a tree like ``params`` in the params' dtypes (and a
    DTensor's placements), None where a leaf does not reach the loss."""
    dev = resolve_device(device)
    leaves = opt.tree_leaves(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(xs)
    loss, metrics = M.loss_fn(cfg, opt.tree_map(lambda _: next(it), params),
                              batch, impl=impl, remat=remat, device=dev)
    grads = [_placed_like(g, p) for g, p in
             zip(torch.autograd.grad(loss, xs, allow_unused=True), xs)]
    it = iter(grads)
    return (_whole(loss), {k: _whole(v) for k, v in metrics.items()},
            opt.tree_map(lambda _: next(it), params))


def _whole(t) -> torch.Tensor:
    """A detached plain tensor (a DTensor's whole value)."""
    t = t.detach()
    return t.full_tensor() if sharding.is_dtensor(t) else t


def _placed_like(g, p):
    """A DTensor gradient in its parameter's placements (it may come back
    partial or otherwise placed)."""
    if g is None or not sharding.is_dtensor(g):
        return g
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig, *,
                    impl: str = "auto", remat: bool = True,
                    microbatch: int = 1, device="cuda") -> Callable:
    """One AdamW step: ``train_step(params, ostate, batch) -> (params,
    ostate, metrics)``. ``microbatch > 1`` splits the batch into that many
    slices along its first axis, one after another: their gradients are
    summed in fp32 and divided once, the loss is their mean, and the other
    metrics are the last slice's (the reference's scan). A leaf that does
    not reach the loss gets a zero gradient, as under `jax.grad`. The
    params that come out are leaves that require grad."""
    dev = resolve_device(device)

    def loss_grads(params, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch, impl=impl,
                                              remat=remat, device=dev)
        grads = opt.tree_map(lambda g, p: torch.zeros_like(p) if g is None
                             else g, grads, params)
        return loss, metrics, grads

    def train_step(params, ostate, batch):
        if microbatch == 1:
            loss, metrics, grads = loss_grads(params, batch)
        else:
            size = len(batch["tokens"]) // microbatch
            grads = opt.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatch):
                part = {k: v[i * size:(i + 1) * size]
                        for k, v in batch.items()}
                l_i, metrics, g_i = loss_grads(params, part)
                grads = opt.tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = opt.tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
        params, ostate, om = opt.adamw_update(ocfg, grads, ostate, params)
        params = opt.tree_map(lambda p: p.requires_grad_(True), params)
        return params, ostate, {**metrics, **om, "loss": loss}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, impl: str = "auto",
                      device="cuda") -> Callable:
    """``prefill_step(params, batch) -> (B, V)`` next-token logits of a
    full-sequence forward (no gradient)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch, impl=impl, remat=False,
                              device=dev)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, device="cuda") -> Callable:
    """``serve_step(params, tokens, cache, pos) -> (logits, cache)``: one
    `models.model.decode_step` (no gradient; the cache is updated in
    place)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos, device=dev)
    return serve_step
