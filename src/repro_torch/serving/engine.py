"""Slot-indexed generation engine (port of `repro/serving/engine.py`):
prefill/decode over a persistent slot cache, plus the blocking
per-request `generate`.

  prefill(prompts) -> (next-token logits, cache_slice)
      One full-sequence forward (`models.model.prefill`) whose per-layer
      cache (K/V, an SSM layer's conv window and state, a hybrid model's
      both, or an audio model's self and cross K/V) comes back as a
      batch-shaped slice, ready to be written into free slots; on the card
      its attention runs the `flash_attention` kernel and its SSD core the
      `ssd_chunk` kernel. A VLM's prompt carries zero patch embeddings
      (1/8 of its length) and an audio model's ``enc_frames`` zero frames,
      the stubs' inputs, as JAX's engine gives them.

  decode_chunk(state, steps) -> state
      Advances ALL slots of the replica together, whichever request owns
      each: every slot carries its own position (`decode_step` takes a (B,)
      pos, and the `decode_attention` kernel reads each row's, in a
      sliding window's ring cache too; an SSM slot's state needs none), its
      own sampling key and step, and its own token budget.

  admit / release
      The slot manager. `admit` writes a prefill slice into free slot
      indices (a full-length overwrite, so reuse needs no clearing);
      `release` frees the slots.

Sampling: request row i samples step j with key
fold_in(fold_in(PRNGKey(seed), i), j) through a per-row categorical, so a
row's tokens depend only on (seed, i, its own logits), not on which rows
share the batch — what makes the slot path equal `generate` per request.

JAX jits these phases and donates the slot state; the port runs them
eagerly and updates the state's tensors in place, returning the same
object. The engine runs all six families (`models.model.check_family`);
an MoE or VLM model uses the attention cache, a hybrid one the SSM cache
and its shared block's attention cache, an audio one its self and cross
caches (the cross cache at ``enc_frames`` slots, as `prefill` gives it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray        # (B, max_new)
    out_lens: np.ndarray      # (B,) tokens generated incl. EOS
    logprobs: np.ndarray      # (B,) mean chosen-token logprob (quality proxy)


@dataclasses.dataclass
class SlotState:
    """Per-replica serving state: a slot-indexed cache plus per-slot decode
    bookkeeping. Cache leaves are (layers, slots, ...); the slot axis is the
    model batch axis, so `decode_step` advances every slot in one call."""
    cache: Any                 # {"attn": {"k", "v"}}, {"ssm": {"conv",
    #                            "state"}}, a hybrid's {"ssm",
    #                            "shared_attn"} or an audio model's {"self",
    #                            "cross"}, leaves (layers or groups, S, ...)
    last: torch.Tensor         # (S, V) f32 next-token logits
    out: torch.Tensor          # (S, max_out) i32 generated tokens (eos-filled)
    pos: torch.Tensor          # (S,) i32 next decode position
    step: torch.Tensor         # (S,) i32 decode steps taken (RNG index)
    max_new: torch.Tensor      # (S,) i32 per-slot token budget
    key: torch.Tensor          # (S, 2) int64 per-row sampling keys
    active: torch.Tensor       # (S,) bool slot occupied
    finished: torch.Tensor     # (S,) bool EOS emitted
    lp_sum: torch.Tensor       # (S,) f32 chosen-logprob sum
    n_out: torch.Tensor        # (S,) i32 tokens generated incl. EOS


def _row_keys(base_key, b: int):
    """Per-row sampling keys: fold_in(base, row). (b, 2) int64."""
    rows = torch.arange(b, device=base_key.device)
    return prng.fold_in(base_key.expand(b, 2), rows)


def _sample(keys, last, temperature):
    """One sampling step for a batch of rows; per-row categorical, so the
    result for row i depends only on (keys[i], last[i])."""
    logits = last.float()
    # a tensor divisor: with a Python scalar, torch multiplies by its
    # reciprocal, which is not JAX's correctly rounded division
    logits = logits / torch.full_like(logits, max(temperature, 1e-4))
    tok = prng.categorical(keys, logits)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = logp.gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), chosen


def _scatter_rows(big, sl, slot_ix) -> None:
    """Write every leaf of the cache slice ``sl`` into rows ``slot_ix`` of
    the matching leaf of ``big`` (JAX's `jax.tree.map` of `.at[].set`)."""
    if isinstance(big, dict):
        for name, leaf in big.items():
            _scatter_rows(leaf, sl[name], slot_ix)
        return
    big[:, slot_ix] = sl.to(big.dtype)


class Engine:
    """One replica's generation engine over any ArchConfig model whose
    parameters lie on ``device``."""

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 512,
                 eos_id: int = 1, temperature: float = 1.0,
                 dtype=torch.float32, enc_frames: Optional[int] = None,
                 device="cuda"):
        M.check_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.dtype = torch_dtype(dtype)      # the cache's dtype
        # audio: the encoder's length is an engine property (tests use
        # short stubs)
        self.enc_frames = enc_frames or M.WHISPER_ENC_FRAMES

    # ------------------------------------------------------------- internals
    def _tokens(self, prompts) -> torch.Tensor:
        if isinstance(prompts, torch.Tensor):
            return prompts.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)

    def _inputs(self, prompts):
        """The model's inputs for ``prompts`` (B, S): the tokens, and a
        VLM's zero patch embeddings or an audio model's zero frames."""
        cfg = self.cfg
        tokens = self._tokens(prompts)
        b, s = tokens.shape
        inputs = {"tokens": tokens}
        if cfg.family == "vlm":
            inputs["vision_embeds"] = torch.zeros(
                (b, max(s // M.VLM_VISION_FRACTION, 1), cfg.d_model),
                dtype=self.dtype, device=self.device)
        if cfg.family == "audio":
            inputs["frames"] = torch.zeros((b, self.enc_frames, cfg.d_model),
                                           dtype=self.dtype,
                                           device=self.device)
        return inputs

    def _decode(self, tok, cache, pos):
        lg, cache = M.decode_step(self.cfg, self.params, tok[:, None], cache,
                                  pos, device=self.device)
        return lg[:, 0], cache

    # ------------------------------------------------------------- slot API
    def init_slots(self, n_slots: int,
                   max_out: Optional[int] = None) -> SlotState:
        """Allocate the persistent slot cache (the structure `prefill`
        returns, with ``n_slots`` rows: an audio model's cross cache at
        this engine's ``enc_frames``)."""
        max_out = max_out or self.max_len
        dev = self.device

        def z_i():
            return torch.zeros((n_slots,), dtype=torch.int32, device=dev)

        return SlotState(
            cache=M.init_decode_caches(self.cfg, n_slots, self.max_len,
                                       self.dtype, device=dev,
                                       enc_frames=self.enc_frames),
            last=torch.zeros((n_slots, self.cfg.vocab), dtype=torch.float32,
                             device=dev),
            out=torch.full((n_slots, max_out), self.eos_id,
                           dtype=torch.int32, device=dev),
            pos=z_i(), step=z_i(), max_new=z_i(),
            key=torch.zeros((n_slots, 2), dtype=torch.int64, device=dev),
            active=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            finished=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            lp_sum=torch.zeros((n_slots,), dtype=torch.float32, device=dev),
            n_out=z_i())

    def prefill(self, prompts) -> Tuple[torch.Tensor, Any]:
        """Prompt phase: (next-token logits (B, V), cache_slice) — the slice
        `admit` writes into free slots."""
        return M.prefill(self.cfg, self.params, self._inputs(prompts),
                         self.max_len, cache_dtype=self.dtype,
                         device=self.device)

    def admit(self, state: SlotState, slot_ix, lg, cache_slice, *,
              prompt_len: int, max_new, seed: Optional[int] = None,
              rkeys=None) -> SlotState:
        """Write a prefilled slice into free slots ``slot_ix`` (B slot
        indices). Row i gets sampling key fold_in(PRNGKey(seed), i), the
        keys `generate` uses. For a bucket of stacked requests pass
        ``rkeys`` (B, 2), each request's own row keys, and ``max_new`` as a
        (B,) budget. The state is updated in place and returned."""
        slot_ix = torch.as_tensor(np.asarray(slot_ix), dtype=torch.int64,
                                  device=self.device)
        b = slot_ix.shape[0]
        pos0 = M.prefill_len(self.cfg, prompt_len)
        mn = np.broadcast_to(np.asarray(max_new, np.int32), (b,))
        # real exceptions, not asserts: these guard serving control flow
        # and must keep firing under `python -O`
        if mn.max() > state.out.shape[1]:
            raise ValueError(f"max_new {max_new} exceeds the slot out "
                             f"buffer {tuple(state.out.shape)}")
        if self.cfg.sliding_window is None and self.cfg.family != "ssm":
            if pos0 + int(mn.max()) > self.max_len:
                raise ValueError(
                    f"prompt_len {prompt_len} + max_new {max_new} exceeds "
                    f"the engine's max_len {self.max_len}")
        if rkeys is None:
            rkeys = _row_keys(prng.PRNGKey(seed, device=self.device), b)
        # JAX scatters into the donated state; the port writes in place
        _scatter_rows(state.cache, cache_slice, slot_ix)
        state.last[slot_ix] = lg.to(state.last.dtype)
        state.out[slot_ix] = self.eos_id
        state.pos[slot_ix] = pos0
        state.step[slot_ix] = 0
        state.max_new[slot_ix] = torch.as_tensor(mn.copy(),
                                                 device=self.device)
        state.key[slot_ix] = rkeys.to(self.device)
        state.active[slot_ix] = True
        state.finished[slot_ix] = False
        state.lp_sum[slot_ix] = 0.0
        state.n_out[slot_ix] = 0
        return state

    def decode_chunk(self, state: SlotState, steps: int) -> SlotState:
        """Advance every occupied slot ``steps`` tokens; the state is
        updated in place and returned."""
        for _ in range(steps):
            # a slot is live while occupied, un-finished and within budget;
            # finished slots are frozen (their remaining tokens are forced
            # EOS, which the eos-filled `out` buffer already holds)
            alive = state.active & ~state.finished & \
                (state.step < state.max_new)
            keys = prng.fold_in(state.key, state.step)
            tok, chosen = _sample(keys, state.last, self.temperature)
            tok = torch.where(alive, tok, torch.full_like(tok, self.eos_id))
            state.lp_sum += torch.where(alive, chosen,
                                        torch.zeros_like(chosen))
            state.n_out += alive.to(torch.int32)
            state.finished |= alive & (tok == self.eos_id)
            # write live rows' tokens at their step; a gather/scatter pair
            # instead of boolean indexing, which would wait for the card
            ix = torch.where(alive, state.step, 0).long()[:, None]
            state.out.scatter_(1, ix, torch.where(
                alive[:, None], tok[:, None], state.out.gather(1, ix)))
            # decode runs over ALL slots (one fixed shape); non-live rows
            # feed EOS at a frozen pos, their cache rows may rot, and admit
            # overwrites the full slice on reuse
            lg, state.cache = self._decode(tok, state.cache, state.pos)
            state.last.copy_(lg.to(state.last.dtype))
            state.pos += alive.to(torch.int32)
            state.step += alive.to(torch.int32)
        return state

    def release(self, state: SlotState, slot_ix) -> SlotState:
        """Free slots (admit fully overwrites, so this is just the flag)."""
        state.active[torch.as_tensor(np.asarray(slot_ix), dtype=torch.int64,
                                     device=self.device)] = False
        return state

    # ------------------------------------------------------------- public
    def generate(self, prompts, max_new: int, seed: int = 0) -> GenResult:
        """Blocking per-request path: prefill, then ``max_new`` sampled
        tokens. The last step's logits are never sampled, so its decode
        step is not run (JAX's scan runs and discards it)."""
        prompts = self._tokens(prompts)
        last, cache = self.prefill(prompts)
        b, s = prompts.shape
        pos0 = M.prefill_len(self.cfg, s)
        rkeys = _row_keys(prng.PRNGKey(seed, device=self.device), b)
        finished = torch.zeros((b,), dtype=torch.bool, device=self.device)
        lp_sum = torch.zeros((b,), dtype=torch.float32, device=self.device)
        n_out = torch.zeros((b,), dtype=torch.int32, device=self.device)
        toks = []
        for j in range(max_new):
            keys = prng.fold_in(rkeys, j)
            tok, chosen = _sample(keys, last, self.temperature)
            tok = torch.where(finished, torch.full_like(tok, self.eos_id),
                              tok)
            lp_sum = lp_sum + torch.where(finished, torch.zeros_like(chosen),
                                          chosen)
            n_out = n_out + (~finished).to(torch.int32)
            finished = finished | (tok == self.eos_id)
            toks.append(tok)
            if j + 1 < max_new:
                last, cache = self._decode(tok, cache, pos0 + j)
        tokens = (torch.stack(toks, dim=1) if toks else
                  torch.zeros((b, 0), dtype=torch.int32))
        logprobs = lp_sum / torch.clamp(n_out, min=1).to(torch.float32)
        return GenResult(tokens.cpu().numpy(), n_out.cpu().numpy(),
                         logprobs.cpu().numpy())
