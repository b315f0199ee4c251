"""The train, prefill and serve steps (port of `repro/train/train_step.py`).

`make_train_step` differentiates `models.model.loss_fn` with autograd. On
the card its attention and SSD cores run the CUDA kernels through their
autograd Functions (`kernels.ops`): the forward is the kernel, the
backward differentiates the plain version, recomputed on the saved
inputs. ``remat=True`` checkpoints each block, so a block's forward (its
kernels included) runs again in the backward pass. The reference's
distributed lowering (a mesh and its parameter shardings) waits for
ROADMAP A18b: these steps run on one device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt


def value_and_grad(cfg: ArchConfig, params, batch, *, impl: str = "auto",
                   remat: bool = True, device="cuda"):
    """(loss, metrics, grads) of `models.model.loss_fn` at ``params``: the
    loss and metrics detached, the gradients a tree like ``params`` in the
    params' dtypes, None where a leaf does not reach the loss."""
    dev = resolve_device(device)
    leaves = opt.tree_leaves(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(xs)
    loss, metrics = M.loss_fn(cfg, opt.tree_map(lambda _: next(it), params),
                              batch, impl=impl, remat=remat, device=dev)
    grads = iter(torch.autograd.grad(loss, xs, allow_unused=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            opt.tree_map(lambda _: next(grads), params))


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
            grads = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
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
