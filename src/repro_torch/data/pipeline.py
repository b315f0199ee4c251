"""Deterministic synthetic LM data pipeline (port of
`repro/data/pipeline.py`; numpy only, so the same seeds give the same
tokens bit for bit).

Generates a learnable token stream (an order-1 Markov chain with a planted
transition structure): the serving stack's query stream and quality signal
(`router.service`), and a training stream whose loss floor is ln(branch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.model import VLM_VISION_FRACTION, WHISPER_ENC_FRAMES


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4          # out-degree of the planted Markov graph


class SyntheticLM:
    """Order-1 Markov stream: next ~ Uniform(succ[prev]).

    A bigram-learnable planted structure: entropy floor = ln(branch)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.succ = rng.integers(0, cfg.vocab,
                                 size=(cfg.vocab, cfg.branch), dtype=np.int32)

    def batch(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(hash((c.seed, step)) % (2**31))
        toks = np.empty((c.global_batch, c.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab, c.global_batch)
        pick = rng.integers(0, c.branch, (c.global_batch, c.seq_len + 1))
        for t in range(1, c.seq_len + 1):
            toks[:, t] = self.succ[toks[:, t - 1], pick[:, t]]
        return toks

    def batches(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start
        while True:
            toks = self.batch(step)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1


def make_batch(cfg: ArchConfig, shape: InputShape, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """A concrete training/prefill batch matching `models.model.
    input_specs`: numpy arrays, with a VLM's patch embeddings or an audio
    model's frames."""
    b, s = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(hash((seed, step, cfg.name)) % (2**31))
    if cfg.family == "vlm":
        s_vis = s // VLM_VISION_FRACTION
        s_txt = s - s_vis
        lm = SyntheticLM(DataConfig(cfg.vocab, s_txt, b, seed))
        toks = lm.batch(step)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "vision_embeds": rng.standard_normal(
                   (b, s_vis, cfg.d_model)).astype(np.float32) * 0.02}
    elif cfg.family == "audio":
        lm = SyntheticLM(DataConfig(cfg.vocab, s, b, seed))
        toks = lm.batch(step)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "frames": rng.standard_normal(
                   (b, WHISPER_ENC_FRAMES, cfg.d_model)).astype(np.float32)
               * 0.02}
    else:
        lm = SyntheticLM(DataConfig(cfg.vocab, s, b, seed))
        toks = lm.batch(step)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if shape.kind != "train":
        out.pop("labels", None)
    return out
