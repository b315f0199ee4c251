"""Drive the PyTorch port of C2MAB-V on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on any mismatch:

  1. card       the card's name and power limit (nvidia-smi)
  2. build      all five CUDA kernels, one nvcc per source, started together
  3. kernels    each kernel against its plain PyTorch version on the card, at
                the main paths' shapes and at edge, tie, ragged and (for
                ssd_chunk) steep-decay cases, the attention kernels also
                at head_dim 120 and 80 (`flash_attention`'s pad route,
                `decode_attention`'s own builds, at H2O-Danube-3-4B's and
                Zamba2-2.7B's decode over a 4,096-slot ring, with positions
                below, at and past its end) and per (row, head) output
                vector, `decode_attention` also with rows of pos -1
                (zeros); `ssd_chunk` also at Zamba2's width; the new
                shapes timed as the main ones; `topn_lp` and `awc_fw`'s costs
                bit-equal to theirs; times of calls made one by one
                with CUDA events (for `decode_attention` and the two fleet
                kernels, whose calls the host paces, also the device time
                over a CUDA graph of 50 calls, as `graph_ms`; `topn_lp` at
                each of its three shapes in a fleet round), the bound the
                card's rates allow
                (for ssd_chunk on the tensor cores, as it splits its
                products, beside the fp32 CUDA-core figure), and for the
                attention kernels the time of PyTorch's
                `scaled_dot_product_attention` on the same inputs;
                ssd_chunk's main shape is also held to 1e-5. The attention
                kernels also run, in bf16 and fp32, at Whisper-large-v3's
                shapes (its encoder's non-causal self-attention over 1,500
                frames, its cross-attention of 64 prompt tokens against
                them, its decode steps: cross over all 1,500 slots at pos
                1,499, self over its 448-slot context with a row of pos -1),
                at non-causal S != T pairs on the tile edges (S 7 / T 300,
                S 129 / T 77, S 300 / T 129), and at Qwen2-VL-72B's prefill
                (4 x 2,304) and decode step (64 / 8 heads of 128); those of
                the two models are timed too; and at a scheduler's shapes
                (phases 7e-7g): prefill buckets of 1 and 8 rows of 16
                tokens, a decode over 32 slots with idle ones at pos 0;
                `decode_attention_lse` (bf16, main shape and head_dims 64,
                80, 120, a row at pos -1): o `torch.equal` to
                `decode_attention`'s, lse within 1e-3 of its plain version,
                and T cut into 2 and 4 blocks merged by `merge_partials`
                against the whole-cache call (per-row gate); both entries'
                ms a call printed
  4. decision   a 4096-tenant mixed fleet runs 16 rounds on the card; from
                its state one `_tenant_act` runs on the card (kernels) and
                on the CPU (plain versions) with the same keys; the CPU's
                thread count is printed, and the plain `awc_fw` must give
                the same bits at 1 and 8 threads as the first call of a
                fresh interpreter (F5)
  5. fleet      the main path: `simulate_fleet` on the card, 4096 tenants in
                thirds of AWC, SUC and AIC on the paper's pool, 128 rounds;
                launch counts must match the round structure
  6. profile    where a fleet round's time goes (printed, not gated):
                host-clock times of its parts, and a `torch.profiler` trace
                of a few rounds for the device's busy share and the kernels
                launched per round
  7. quickstart examples/quickstart.py whole: `bandit.simulate` of
                "c2mabv" (the fleet path) and then "cucb" (the per-seed
                loop), AWC, T 2,000, 5 seeds; c2mabv's violation must stay
                within 1e-3 and its reward/violation ratio above twice
                cucb's
  7b. baselines every other policy of `make_policy` on the card, on the
                quickstart's configuration at T 256, 5 seeds: per-seed
                c2mabv (`use_fleet=False`), c2mabv_direct, thompson,
                egreedy, fixed (arm 0), offline_fixed (S* from
                `solve_direct`); set sizes gated against each matroid,
                direct's violation at most per-seed c2mabv's
  7c. per-seed  `simulate("c2mabv", use_fleet=False)` over 4,096 seeds for
                32 rounds, AWC and SUC: `topn_lp` / `awc_fw` launches a
                round gated exactly (24 / 8 for AWC, 4 / 0 for SUC), the
                first round's masks bit-equal to the CPU's on the same keys;
                rounds/s and a traced round's device share printed
  7d. protocol  the paper's split: one `LocalServer` and a
                `SchedulingCloud` over the paper pool (SUC, n 4) for 32
                rounds of relaxed_selection -> select -> record; its 9
                replicas share one engine of StarCoder2-7B at full width cut
                to 2 layers, and on 4 rounds every selected arm generates
                16 tokens for 2 prompts of 128 (`dispatch`); every kernel
                launch gated (4 `topn_lp` a round, 2 `flash_attention` a
                dispatch, 2 `decode_attention` a decode step)
  7e. service   the paper's Fig. 3 service: `MultiLLMService` over the same
                pool and a 2-layer engine like 7d's, SUC and AWC (n 4), each
                primed with the same records and run 32 rounds in the
                continuous mode (the scheduler, 32 slots, chunks of 8) and
                32 in the sequential one (`dispatch`), 2 x 16-token prompts,
                8 new tokens; every round drains, each observed arm is
                recorded once in its round, every launch is gated
                (`topn_lp` / `awc_fw` a solve, `flash_attention` a prefill
                bucket and `decode_attention` a decode step per layer,
                counted from the runners' tick logs); printed: s per tick,
                decode steps per tick, occupied slots, the share of
                completions token-equal between the modes and whether the
                bandit ends in the same state
  7f. driven-fleet  `simulate_fleet_driven`: 8 tenants (4 AWC, 4 SUC) over
                one shared scheduler of 9 replicas of StarCoder2-7B at full
                width and depth (phase 8's weights), 32 slots, chunks of 8,
                4 rounds, 16 new tokens a row; rewards and costs finite,
                key rows not zero, launches gated; printed: occupied slots
                per decode step and the decode batches that mix tenants
  7g. chaos     7e's SUC service at 16 new tokens (two chunks, so a doomed
                request can crash after its first) under per-replica
                `FaultPlan`s: failures at 0.2 everywhere, decode crashes on
                one replica, an outage over the first submissions of
                another; the drain ends every round, the outage replica
                walks quarantine -> probation -> healthy, every contained
                crash is one the plan injected, and every verdict is the
                one the card's uniforms give
  8. serve      the serving path: StarCoder2-7B at full width (bf16 weights
                from `init_params`, seed 0) behind `Engine`: `generate` on 4
                prompts of 2,048 tokens, then the slot API (8 slots, two
                admitted batches of 1,024 and 3,000 tokens, decode chunks of
                16 and 48, release); every prefill must launch one
                `flash_attention` per layer and every decode step one
                `decode_attention` per layer, and nothing else. Then
                (printed, not gated) a `torch.profiler` trace of one
                prefill and 3 decode steps
  9. consistency  at full width, prefill + one decode step against
                `forward` over the extended prompt
 10. card-cpu   the reduced StarCoder2 in float32 (TF32 off): the same
                weights through prefill, a decode step and
                `Engine.generate` on the card and on the CPU
 10b. h2o       phase 9 for H2O-Danube-3-4B at full width (24 layers,
                head_dim 120 through `flash_attention`'s pad route, window
                4,096) at a prompt of 4,200 tokens: one `flash_attention`
                per layer in its prefill, then one `decode_attention` per
                layer in a decode step at pos 4,200, past the ring's end
 11. serve-ssm  the same serving path for Mamba2-780M at full width (bf16,
                `generate` on 4 prompts of 2,048 tokens, the slot API with
                batches of 1,024 and 3,072 tokens): every prefill must launch
                one `ssd_chunk` per layer and a decode step no kernel; then
                the profiler trace of one prefill and 3 decode steps
 12. ssm-consistency  at full width, prefill of 1,024 tokens and 256
                teacher-forced decode steps against `forward` over all 1,280,
                with the launch counts gated
 13. ssm-card-cpu  phase 10 for the reduced Mamba2
 14. serve-moe  phase 8's serving path for OLMoE-1B-7B at full width (16
                layers, 16 / 16 heads of 128, 64 experts top 8; bf16): one
                `flash_attention` per layer a prefill and one
                `decode_attention` per layer a decode step (n_rep 1), and
                nothing else; then two identical 4 x 2,048 prefills must give
                the same bits (logits and cache)
 15. moe-consistency  phase 9 for OLMoE at the no-drop capacity factor 64
                (prompts of 512 tokens)
 16. moe-card-cpu  phase 10 for the reduced OLMoE at the configs' capacity
                factor (125 slots an expert for 200 tokens' 400 entries, so
                an expert chosen more often drops the rest)
 17. serve-hybrid  phase 8's serving path for Zamba2-2.7B at full width (54
                Mamba2 layers and one shared dense block every 6, 32 / 32
                heads of 80, window 4,096; bf16): each prefill launches 54
                `ssd_chunk` and 9 `flash_attention`, each decode step 9
                `decode_attention`, and nothing else
 18. hybrid-consistency  phase 12 for Zamba2: prefill of 4,096 tokens, then
                256 decode steps at pos 4,096..4,351 (every one on a wrapped
                ring) against `forward` over all 4,352
 19. hybrid-card-cpu  phase 10 for the reduced Zamba2 with a prompt of 64
                and max_len 256: its 64-slot ring wraps in decode
 20. serve-audio  phase 8's serving path for Whisper-large-v3 at full width
                (32 encoder and 32 decoder layers, 20 / 20 heads of 64;
                bf16) with `enc_frames` 1,500 and its 448-token context:
                `generate` on 4 prompts of 4 tokens for 224 new ones, then 8
                slots (prompts of 4 and 64 tokens, 128 steps); each prefill
                launches 96 `flash_attention` (encoder, self, cross), each
                decode step 64 `decode_attention` (self, cross), and nothing
                else
 21. audio-consistency  phase 9 for Whisper with random frames (seed 1):
                two 64-token prompts, one decode step
 22. audio-card-cpu  phase 10 for the reduced Whisper, frames from a seed
 23. serve-vlm  phase 8's serving path for Qwen2-VL-72B at every published
                width over 20 of its 80 layers (one of four pipeline
                stages; 40 GB of bf16 weights): prompts of 2,048 tokens
                behind 256 patch embeddings, 20 `flash_attention` a prefill
                and 20 `decode_attention` a step
 24. vlm-consistency  phase 9 for that Qwen2-VL with random patch
                embeddings: the decode step at `prefill_len` (1,152)
 25. vlm-card-cpu  phase 10 for the reduced Qwen2-VL
 26. relax-tail the grid engine's tail lowering (plain torch, no kernel) at
                the fleet's shape (phase 4's 4,096 mixed tenants after 16
                rounds), warm and cold Frank-Wolfe: λ brackets and z̃ equal
                to the same calls on the CPU bit for bit, the unified mixed
                batch equal to the single-kind rows bit for bit, warm
                against cold as the reference's own test holds them;
                printed: ms a solve for each lowering and the launches a
                solve. Then `LocalServer(lowering="tail")` for 32 rounds on
                the card beside the same on the CPU (z̃ within 1e-6)
 27. train-dense  StarCoder2-7B at full width (bf16) over 8 of its 32
                layers: 8 AdamW steps on 4 x 2,048 tokens of `SyntheticLM`
                with remat, `flash_attention` forward through its autograd
                Function (one launch a layer a forward, again in remat's
                recompute); every loss finite and the last below the first;
                at 1 x 256 tokens every leaf's gradient (none None, wq / wk
                / wv not zero) against the all-plain fp32 one (impl
                "naive"): fp32 within 1e-3 of each leaf's norm, bf16 within
                twice the all-plain bf16 gradient's own error plus 1e-2;
                printed: losses, s/step, tokens/s, peak GB, launches
                a step and the backward recompute's share of a step's
                device time (profiler)
 28. train-ssm  phase 27 for Mamba2-780M at full width and depth (48
                layers) on 4 x 1,024 tokens, `ssd_chunk` through its
                Function (the all-plain gradient with `ops.ssd_chunk`
                swapped for its plain version)
 29. serve-launch  `repro_torch.launch.serve.main` on the card: --kind awc
                --rounds 30 --pool h2o-danube-3-4b,mamba2-780m,starcoder2-7b
                --train-first 1 --dispatch continuous --tenants 4
                --fault-rate 0.2 --fault-seed 7 --crash-on-decode: the
                trained member's loss falls, the contained crashes equal
                the injected ones, and the Mamba2 replica behind the
                scheduler prefills through `ssd_chunk`; printed: mean
                observed reward, violation, selections and rounds/s
 30. fleet-resume  phase 4's 4,096 mixed tenants run to round 48
                checkpointing every 16 (`simulate_fleet(ckpt_dir=...)`), the
                newest checkpoint is deleted (the kill) and the run resumed
                to 64: it starts at round 32, and rounds 33..64 and the final
                state are bit-equal to an uninterrupted 64-round run;
                checkpoint 32 is bit-equal, by name, to the state that run
                held at round 32; launches gated; printed: save and restore
                ms, bytes a checkpoint, rounds/s
 31. fleet-sharded  the same fleet over 2 ranks sharing the card
                (`spawn_local`, gloo, host-copy gathers), 32 rounds
                checkpointing every 16, then checkpoint 32 deleted and the
                run resumed at 16: actions, observations, costs, stats, keys
                and t bit-equal to the one-process run (reward within 1e-6);
                printed: tenant-rounds/s a rank, as a function check
 32. train-resume  `repro_torch.launch.train.main` for Mamba2-780M at full
                width and depth: --steps 4 --batch 4 --seq 1024 --ckpt-every
                2, then checkpoint 4 deleted and the same command rerun: it
                restores step 2 and steps 2..3's losses equal the first
                run's bit for bit; one `ssd_chunk` a layer a step; printed:
                bytes a checkpoint (bf16 params, fp32 master, m, v), save and
                restore s
 33. moe-ep     OLMoE-1B-7B's MoE layer at its published widths (fp32) on a
                ("data", "model") mesh of 1 x 2 ranks sharing the card:
                `apply_moe_ep` at capacity factor 64 within 1e-5 of
                `apply_moe` on the card, its aux loss the mean of the two
                sequence slices' losses (the reference's pmean) within 1e-6;
                its gradients of (y . w).sum() + aux, summed over the two
                ranks (each covers its own blocks), within 1e-5 of the
                largest entry of the same function's on one process
                (`apply_moe`'s y, the slices' mean aux); printed: ms a call,
                as a function check
 34. train-sharded  phases 27-28's models (StarCoder2-7B at every
                published width over 8 layers, Mamba2-780M whole) and
                batches on a one-rank NCCL group's (1, 1) ("data", "model")
                CUDA mesh, params and AdamW state DTensors placed by
                `param_axes`: 3 steps each, `flash_attention` /
                `ssd_chunk` launched 2 x layers a step under `local_map`,
                losses within 1e-5 of phases 27-28's plain-tensor steps
                (printed: whether bit-equal, s/step, peak GB)
 35. serve-sharded  StarCoder2-7B at full width and Mamba2-780M whole on
                the same kind of one-rank (1, 1) CUDA mesh: a 4 x 2,048
                `prefill` and 16 `decode_step`s at each row's pos, params
                DTensors placed by `param_axes` and the cache by
                `decode_cache_axes`, against the same model on plain
                tensors from the same weights and tokens: logits within
                2e-5 (tests/test_torch_engine.py's tolerance; printed:
                whether bit-equal, ms a step, peak GB); launches gated: 32
                `flash_attention` a StarCoder2 prefill and 32
                `decode_attention` a step, 48 `ssd_chunk` a Mamba2 prefill
 36. dryrun     `repro_torch.launch.dryrun.run_case` on the pod256 mesh
                (rank 0 of a fake process group of 256, meta DTensors: no
                card) for one arch a family (StarCoder2-7B, Mamba2-780M,
                OLMoE-1B-7B, Zamba2-2.7B, Whisper-large-v3, Qwen2-VL-72B)
                at train_4k, prefill_32k and decode_32k: every case must
                give a record with FLOPs > 0 (printed: global FLOPs, a
                chip's, collective bytes, seconds). It runs in a
                subprocess started before phase 1, beside the card phases,
                and is collected here

Phases 30-33 write their checkpoints under `tempfile.mkdtemp()` and remove
them, on failure too.

The next-to-last line of output is one JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FLEET_KERNELS = ("topn_lp", "awc_fw")    # the fleet loop's kernels
# topn_lp's calls in a fleet round of 2,731 SUC/AIC and 1,365 AWC tenants:
# (label, rows, K, equality) of the octave round (2,731 × 25 λ's), the
# SUC/AIC mantissa rounds (2,731 × 64) and the AWC ones (1,365 × 64)
TOPN_SHAPES = (("octave", 68275, 9, True), ("main", 174784, 9, True),
               ("awc-grid", 87360, 9, False))
# F5: the plain awc_fw's bits at 1 and 8 CPU threads, each its process's
# first call: the fleet's AWC shape (B, K, G), and 200,000 rows of K = 9
# (one λ, which keeps the plain version's (B, G, K, K) ranks small)
F5_SHAPES = ((1365, 9, 25), (200000, 9, 1))
F5_THREADS = (1, 8)
TENANTS = 4096                   # the fleet: thirds of AWC, SUC, AIC
ROUNDS = 128                     # fleet rounds (phase 5)
DECISION_ROUNDS = 16             # rounds before the decision check (phase 4)
PROFILE_ROUNDS = 4               # rounds traced by the profiler (phase 6)
QUICKSTART_ROUNDS = 2000         # examples/quickstart.py's T (phase 7)
BASELINE_ROUNDS = 256            # the §6 baselines' T (phase 7b)
PER_SEED = 4096                  # per-seed C2MAB-V's seeds (phase 7c)
PER_SEED_ROUNDS = 32
# kernels a round of the per-seed path: the relaxed solve's octave round and
# 3 mantissa rounds (SUC), or 8 Frank-Wolfe steps of one awc_fw and 3
# mantissa rounds each (AWC), as in a fleet round
PER_SEED_LAUNCHES = {"suc": {"topn_lp": 4},
                     "awc": {"topn_lp": 24, "awc_fw": 8}}
PROTOCOL_ROUNDS = 32             # local server + scheduling cloud (phase 7d)
PROTOCOL_DISPATCH = (1, 9, 17, 25)   # rounds whose arms generate
PROTOCOL_LAYERS = 2              # StarCoder2-7B's 32 layers cut to 2
PROTOCOL_PROMPTS = (2, 128)      # prompts per dispatched arm, tokens
PROTOCOL_NEW = 16                # tokens generated per prompt
SERVICE_ROUNDS = 32              # rounds of each dispatch mode (phase 7e)
SERVICE_PROMPTS = (2, 16)        # rows of a request, prompt tokens (7e-7g)
SERVICE_NEW = 8                  # tokens a row generates in 7e: one chunk
DRIVEN_NEW = 16                  # ... in 7f and 7g: two chunks
SERVICE_SLOTS, SERVICE_CHUNK = 32, 8   # a runner's slots, decode chunk
DRIVEN_KINDS = ("awc",) * 4 + ("suc",) * 4   # phase 7f's tenants
DRIVEN_ROUNDS = 4
CHAOS_ROUNDS = 16                # phase 7g
CHAOS_CRASH, CHAOS_OUTAGE = 2, 8   # replicas: decode crashes, an outage
SERVE_ARCH = "starcoder2-7b"     # the serving path's model (phase 8)
WINDOW_ARCH = "h2o-danube-3-4b"  # head_dim 120, sliding window (phase 10b)
SSM_ARCH = "mamba2-780m"         # the SSM serving path's model (phase 11)
MOE_ARCH = "olmoe-1b-7b"         # the MoE serving path's model (phase 14)
HYBRID_ARCH = "zamba2-2.7b"      # the hybrid serving path's model (phase 17)
AUDIO_ARCH = "whisper-large-v3"  # the audio serving path's model (phase 20)
VLM_ARCH = "qwen2-vl-72b"        # the VLM serving path's model (phase 23)
VLM_LAYERS = 20                  # one of four pipeline stages of its 80
SERVE_MAX_LEN = 4096
TAIL_ROUNDS = 32                 # LocalServer on the tail lowering (26)
TRAIN_LAYERS = 8                 # StarCoder2-7B's 32 layers cut to 8 (27)
TRAIN_STEPS = 8                  # AdamW steps a training phase (27, 28)
TRAIN_LR = {"train-dense": 1e-4, "train-ssm": 1e-3}   # after 2 warm-up
TRAIN_DENSE = (4, 2048)          # batch rows, tokens (27)
TRAIN_SSM = (4, 1024)            # ... (28): a multiple of the chunk
GRAD_CHECK = (1, 256)            # the gradient check's batch (27, 28)
# the gradient check: every leaf's ||g − g_plain_fp32|| / ||g_plain_fp32||
# through the kernels at fp32 within GRAD_RTOL; at bf16 within
# GRAD_BF16_RATIO times the all-plain bf16 gradient's own error plus
# GRAD_BF16_SLACK (a bf16 gradient that is a difference of near-equal
# terms, as wq's and wk's through a near-uniform softmax at random weights
# are, errs by ~1e-1 in either path)
GRAD_RTOL = 1e-3
GRAD_BF16_RATIO, GRAD_BF16_SLACK = 2.0, 1e-2
SERVE_LAUNCH_ARGS = ["--kind", "awc", "--rounds", "30", "--pool",
                     "h2o-danube-3-4b,mamba2-780m,starcoder2-7b",
                     "--train-first", "1", "--dispatch", "continuous",
                     "--tenants", "4", "--fault-rate", "0.2",
                     "--fault-seed", "7", "--crash-on-decode"]
RESUME_T, RESUME_KILL, RESUME_EVERY = 64, 48, 16   # phase 30
SHARD_RANKS, SHARD_ROUNDS, SHARD_EVERY = 2, 32, 16  # phase 31
TRAIN_RESUME_ARGS = ["--arch", SSM_ARCH, "--steps", "4", "--batch", "4",
                     "--seq", "1024", "--ckpt-every", "2", "--log-every",
                     "1"]                           # phase 32
MOE_EP_MESH = (1, 2)             # ("data", "model") ranks (phase 33)
MOE_EP_TOKENS = (2, 64)          # batch rows, tokens of its layer input
MOE_EP_ATOL = 1e-5               # the reference test's bound
# phase 33's gradients: each leaf's max |diff| within MOE_EP_GRAD_RTOL of
# its largest reference entry (fp32, TF32 off, sums in another order)
MOE_EP_GRAD_RTOL = 1e-5
SHARDED_STEPS = 3                # AdamW steps a model (phase 34)
SERVE_SHARDED = (4, 2048)        # prompt rows, tokens (phase 35)
SERVE_SHARDED_STEPS = 16         # decode steps after the prefill (35)
SERVE_LOGIT_TOL = 2e-5           # tests/test_torch_engine.py's LOGIT_TOL
LSE_ATOL = 1e-3                  # decode_attention_lse's lse (phase 3)
LSE_SPLITS = (2, 4)              # blocks of T the split-and-merge cuts (3)
DRYRUN_ARCHS = ("starcoder2-7b", "mamba2-780m", "olmoe-1b-7b",
                "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-72b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")   # phase 36
DRYRUN_THREADS = 2               # its subprocess's CPU threads
TRAIN_LOSS_RTOL = 1e-5           # tests/test_torch_train.py's loss bound
DIST_LABEL = ("2 ranks on one H100 over gloo (host copies): a function "
              "check, not a speed figure")
# phase 3's timed attention shapes: the serving paths' (bf16)
FLASH_TIMED = ("main", "olmoe", "zamba2", "whisper-enc", "whisper-cross",
               "qwen2-vl")
DECODE_TIMED = ("main", "olmoe", "h2o", "zamba2", "whisper-cross",
                "whisper-self", "qwen2-vl")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
# tests/test_kernels.py's ATOL: fp32 sums in another order; bf16 output
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# per (row, head) output vector: max|out − want| <= ROW_RTOL · max|want| +
# ROW_ATOL. One bf16 ulp of a vector's largest value is <= 0.78% of it, so
# rounding passes; a row that loses its last 64 visible slots of ~1,100
# moves by 6–17% of its largest value
ROW_RTOL, ROW_ATOL = 1e-2, 1e-4
# ssd_chunk: fp32 products in another order than the plain version's
# einsums, over up to 256 + 128 terms; held to 1e-4 of the largest value
SSD_RTOL = 1e-4
# ...and at the main shape to 1e-5, which one TF32 pass (10 mantissa bits)
# cannot meet: it shows that the fp32-operand products are split
SSD_MAIN_RTOL = 1e-5
# ssd_chunk's cases (label, B, NC, L, H, P, N, B/C dtype, acum slope or 0
# for the model's decay, scale of B/C, scale of xd); "main" is the SSM
# prefill of 4 prompts of 2,048 tokens at Mamba2-780M's width, "zamba2" the
# same prefill at Zamba2-2.7B's (80 heads of 64, state 64), timed too
SSD_CASES = [("main", 4, 8, 256, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("zamba2", 4, 8, 256, 80, 64, 64, torch.bfloat16, 0.0, 1, 1),
             ("L100", 1, 1, 100, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("B1", 1, 8, 256, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("steep", 2, 2, 256, 48, 64, 128, torch.bfloat16, 30.0, 1, 1),
             ("reduced", 3, 2, 32, 16, 32, 16, torch.float32, 0.0, 1, 1),
             ("L1", 2, 3, 1, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("L37", 2, 1, 37, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("P16", 2, 2, 256, 24, 16, 128, torch.bfloat16, 0.0, 1, 1),
             ("P32", 2, 2, 256, 24, 32, 128, torch.bfloat16, 0.0, 1, 1),
             ("range", 2, 4, 256, 48, 64, 128, torch.bfloat16, 0.0, 1e2,
              1e-3)]


class FlashCase(NamedTuple):
    """A `flash_attention` case of phase 3: T keys, S by default."""
    label: str
    b: int
    s: int
    h: int
    kv: int
    hd: int
    causal: bool
    window: Optional[int]
    dtype: torch.dtype
    t: Optional[int] = None


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``n`` calls: the card's time without the host's launch pace."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topn_cost(b: int, k: int):
    """Bytes (score, cost, n read once; out written once) and operations
    (a compare-and-count per arm pair, a mask multiply and an add per arm)."""
    return 4.0 * (2 * b * k + 2 * b), float(b * k * k + 2 * b * k)


def flash_cost(q, k, causal: bool):
    """Bytes (q, k, v read once, o written once) and operations: the two
    products over the visible half of the S x T square when causal,
    2·S²·hd·H·B, else over all of it."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    ops = 2.0 * s * t * hd * h * b * (1 if causal else 2)
    return nbytes, ops


def decode_cost(q, k, pos):
    """Bytes (q once, K and V up to each row's pos once, o once) and
    operations (two products over the visible slots), for this run's
    positions."""
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    slots = float((torch.clamp(pos, max=t - 1) + 1).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * slots * kv * hd)
    return nbytes, 4.0 * slots * hd * h


def ssd_cost(xd, bm):
    """Bytes (xd, acum, bm, cm read once; y and the states written once)
    and operations (C Bᵀ once per chunk and the two L×L products over their
    causal half, and the state product: B·NC·(L²·N + L²·P·H + 2·L·N·P·H))."""
    b, nc, l, h, p = xd.shape
    n = bm.shape[-1]
    nbytes = (4.0 * (2 * xd.numel() + b * nc * l * h + b * nc * h * p * n)
              + 2 * bm.element_size() * b * nc * l * n)
    ops = float(b * nc) * (l * l * n + l * l * p * h + 2 * l * n * p * h)
    return nbytes, ops


def ssd_tensor_ops(xd, bm) -> float:
    """`ssd_cost`'s operations as the kernel runs them on the tensor cores,
    in TF32 operations: the scores product in three TF32 passes; the state
    product in two when B is bf16 (exact in TF32), else three; C Bᵀ in one
    bf16 pass (at 989/495 of the TF32 cost) when B/C are bf16, else three
    TF32 passes."""
    b, nc, l, h, p = xd.shape
    n = bm.shape[-1]
    cb = float(b * nc) * l * l * n
    scores = float(b * nc) * l * l * p * h
    state = float(b * nc) * 2 * l * n * p * h
    if bm.dtype == torch.bfloat16:
        return cb * TF32_OPS_PER_S / BF16_OPS_PER_S + 3 * scores + 2 * state
    return 3 * (cb + scores + state)


def awc_cost(b: int, k: int, g: int):
    """Bytes (z, μ, c, λ, n read once; g and costs written once) and
    operations (six per arm for the gradient; per λ and arm pair two
    subtractions, a multiply and a compare; per λ and arm a multiply, a
    compare, a mask multiply and an add)."""
    nbytes = 4.0 * (3 * b * k + b * g + b + b * k + b * g)
    ops = float(6 * b * k + 4 * b * g * k * k + 4 * b * g * k)
    return nbytes, ops


def topn_rows(b: int, k: int, gen, dev):
    """topn_lp's inputs as `relax._lagrangian_costs` forms them: per (w, c,
    n) row a batch of probe λ's, GRID_POINTS of a mantissa round when b
    allows, else the octave ladder 2^0..2^LAM_MAX_EXP when b allows, else
    one. A mantissa λ is an octave 2^e times a dyadic mantissa from 0 or 1,
    capped at 2^LAM_MAX_EXP, so most rows hold the large-λ regime where
    every score is negative; c has zeros (an unexplored arm's LCB)."""
    from repro_torch.core import relax
    octave = relax.LAM_MAX_EXP + 1
    g = (relax.GRID_POINTS if b % relax.GRID_POINTS == 0
         else octave if b % octave == 0 else 1)
    r = b // g
    w = torch.rand((r, k), generator=gen)
    c = torch.rand((r, k), generator=gen) * 0.8
    c[::3, ::4] = 0.0
    if g == octave:
        lams = (2.0 ** torch.arange(float(octave))).expand(r, g)
    else:
        e = torch.randint(0, relax.LAM_MAX_EXP + 1, (r, 1), generator=gen)
        m0 = torch.randint(0, 2, (r, 1), generator=gen).float()
        lams = torch.minimum(2.0 ** e.float() * (m0 + torch.arange(g) / g),
                             torch.tensor(2.0 ** relax.LAM_MAX_EXP))
    score = (w[:, None, :] - lams[:, :, None] * c[:, None, :])
    score = score.reshape(b, k)
    score[::7, 1::2] = score[::7, :1]                 # exact ties
    cost = c[:, None, :].expand(r, g, k).reshape(b, k)
    n = torch.randint(1, k + 1, (r, 1), generator=gen, dtype=torch.int32)
    n = n.expand(r, g).reshape(b)
    return tuple(x.contiguous().to(dev) for x in (score, cost, n))


def awc_rows(b: int, k: int, g: int, gen, dev):
    """awc_fw's inputs as the FW loop gives them: z̃ in [0, 1), μ̄ with
    clipped entries, c̲, and at G = 25 the octave ladder."""
    z = torch.rand((b, k), generator=gen)
    mu = 0.05 + 0.95 * torch.rand((b, k), generator=gen)
    mu[::5, :2] = 1.0
    c = 0.6 * torch.rand((b, k), generator=gen)
    if g == 25:
        lams = (2.0 ** torch.arange(25.0)).expand(b, g).contiguous()
    else:
        lams = 4 * torch.rand((b, g), generator=gen)
    n = torch.randint(1, k + 1, (b,), generator=gen, dtype=torch.int32)
    return tuple(x.to(dev) for x in (z, mu, c, lams, n))


# the plain `awc_fw` in a fresh interpreter at a given CPU thread count:
# the inputs from numpy (seed 0), the bits of g and costs as digests
_AWC_PLAIN_BITS = """
import hashlib, sys
import numpy as np, torch
b, k, g, threads = map(int, sys.argv[1:5])
torch.set_num_threads(threads)
from repro_torch.kernels.awc_fw import awc_fw_plain
rng = np.random.default_rng(0)
z = rng.uniform(size=(b, k)).astype(np.float32)
mu = rng.uniform(0.05, 1.0, (b, k)).astype(np.float32)
mu[::5, :2] = 1.0
c = rng.uniform(0.0, 0.6, (b, k)).astype(np.float32)
lams = np.broadcast_to(2.0 ** np.arange(g, dtype=np.float32), (b, g))
n = rng.integers(1, k + 1, b).astype(np.int32)
gk, costs = awc_fw_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                           for x in (z, mu, c, lams, n)))
print(torch.get_num_threads(), hashlib.sha256(gk.numpy().tobytes()).hexdigest(),
      hashlib.sha256(costs.numpy().tobytes()).hexdigest())
"""


def awc_plain_bits(b: int, k: int, g: int, threads: int):
    """(threads used, digest of g, digest of costs) of `awc_fw_plain`'s
    first call in a fresh interpreter with ``threads`` CPU threads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "")
                               .split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", _AWC_PLAIN_BITS, str(b),
                          str(k), str(g), str(threads)], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    used, g_bits, c_bits = out.stdout.split()
    return int(used), g_bits, c_bits


# ====================================================================== phases
@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_card() -> str:
    line = card_line()
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return line


def phase_build(ops) -> None:
    t0 = time.perf_counter()
    seconds = ops.build()
    for name in ops.KERNELS:
        ops.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v:.2f}s" for k, v in seconds.items()), flush=True)


def phase_kernels(ops, topn, awc, dev):
    """Kernel against plain version; returns per-kernel measurements."""
    gen = torch.Generator().manual_seed(0)
    results = {}

    cases = [(label, b, k) for label, b, k, _ in TOPN_SHAPES] + [
        ("B512K9", 512, 9), ("B4096K9", 4096, 9), ("K17", 255, 17),
        ("K32", 257, 32), ("B1024K128", 1024, 128), ("K130", 5, 130),
        ("B33", 33, 40)]
    path_eq = {label: eq for label, _, _, eq in TOPN_SHAPES}
    tie = (torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.1], [1.0] * 5], device=dev),
           torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0]] * 2, device=dev),
           torch.tensor([3, 2], dtype=torch.int32, device=dev))
    worst, main, shapes = 0.0, None, {}
    for label, b, k in cases + [("ties", 2, 5)]:
        args = tie if label == "ties" else topn_rows(b, k, gen, dev)
        for eq in (True, False):
            out = ops.topn_lp(*args, equality=eq)
            want = topn.topn_lp_plain(*args, equality=eq)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            worst = max(worst, err)
            if err > 1e-6 or not torch.equal(out, want):
                fail(f"topn_lp {label} equality={eq}: not bit-equal to the "
                     f"plain version, max|diff| {err}")
            if label == "ties" and eq and out.tolist() != [11.0, 3.0]:
                fail(f"topn_lp tie order: {out.tolist()}")
            ms = cuda_ms(lambda: ops.topn_lp(*args, equality=eq))
            plain_ms = cuda_ms(lambda: topn.topn_lp_plain(*args, equality=eq),
                               iters=5)
            b_ms, b_by = bound(*topn_cost(b, k))
            dev_ms = None
            if path_eq.get(label) == eq:
                dev_ms = graph_ms(lambda: ops.topn_lp(*args, equality=eq))
                shapes[f"{b}x{k}"] = dev_ms
            graph = "" if dev_ms is None else f" graph={dev_ms:.5f}ms"
            print(f"topn_lp {label:9s} B={b:6d} K={k:3d} eq={eq!s:5s} "
                  f"max|diff|={err:.3g} kernel={ms:.4f}ms{graph} "
                  f"plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
                  flush=True)
            if label == "main" and eq:
                main = (ms, plain_ms, b_ms, b_by, dev_ms)
    results["topn_lp"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                              bound_ms=main[2], bound_by=main[3],
                              graph_ms=main[4], graph_ms_shapes=shapes)

    cases = [("main", 1365, 9, 25), ("B64K9G25", 64, 9, 25),
             ("B512K9G25", 512, 9, 25), ("B257K17G8", 257, 17, 8),
             ("B256K64G8", 256, 64, 8)]
    tie = tuple(x.to(dev) for x in (
        torch.zeros((2, 4)),
        torch.tensor([[0.5, 0.5, 0.25, 0.5], [0.5, 0.25, 0.125, 0.0625]]),
        torch.tensor([[1.0, 2.0, 1.0, 4.0], [1.0, 1.0, 1.0, 1.0]]),
        torch.tensor([[0.0, 0.25], [0.0, 0.25]]),
        torch.tensor([3, 2], dtype=torch.int32)))
    worst, main = 0.0, None
    for label, b, k, g in cases + [("ties", 2, 4, 2)]:
        args = tie if label == "ties" else awc_rows(b, k, g, gen, dev)
        gk, ck = ops.awc_fw(*args)
        gp, cp = awc.awc_fw_plain(*args)
        torch.cuda.synchronize()
        err_g = (gk - gp).abs().max().item()
        err_c = (ck - cp).abs().max().item()
        worst = max(worst, err_g, err_c)
        if err_g > 2e-6 or err_c > 1e-6 or not torch.equal(ck, cp):
            fail(f"awc_fw {label}: max|diff| g {err_g} costs {err_c} (costs "
                 "must equal the plain version's)")
        if label == "ties" and ck[0, 1].item() != 1.0:
            fail(f"awc_fw positivity: {ck.tolist()}")
        ms = cuda_ms(lambda: ops.awc_fw(*args))
        plain_ms = cuda_ms(lambda: awc.awc_fw_plain(*args), iters=5)
        b_ms, b_by = bound(*awc_cost(b, k, g))
        dev_ms = graph_ms(lambda: ops.awc_fw(*args)) if label == "main" \
            else None
        graph = "" if dev_ms is None else f" graph={dev_ms:.5f}ms"
        print(f"awc_fw  {label:9s} B={b:6d} K={k:3d} G={g:2d} "
              f"max|diff| g={err_g:.3g} costs={err_c:.3g} kernel={ms:.4f}ms"
              f"{graph} plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
              flush=True)
        if label == "main":
            main = (ms, plain_ms, b_ms, b_by, dev_ms)
    results["awc_fw"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                             bound_ms=main[2], bound_by=main[3],
                             graph_ms=main[4])
    print(f"kernels: {sorted(results)}", flush=True)
    return results


def mixed_fleet(pool, m: int, T: int, device):
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho
    from repro_torch.router import fleet
    third = max(m // 3, 1)            # 4096 -> 1365 AWC, 1365 SUC, 1366 AIC
    kinds = [("awc", "suc", "aic")[min(i // third, 2)] for i in range(m)]
    pcfgs = [PolicyConfig(kind=k, k=pool.k, n=4, rho=default_rho(pool, k, 4),
                          delta=1 / T) for k in kinds]
    return kinds, pcfgs, fleet.fleet_config(pcfgs, device=device)


def round_margin(z, key) -> float:
    """Smallest distance between a decision quantity and its threshold in
    the pairwise rounding of one row (z (K,), key (2,), on the CPU): each
    merge's uniform against q/(p+q), the final uniform against the
    fractional coordinate, and every coordinate against the EPS band."""
    from repro_torch import prng
    from repro_torch.core import rounding
    z = torch.clamp(z.to(torch.float32), 0.0, 1.0)[None]
    key = key[None]
    eps = torch.tensor([rounding.EPS, 1.0 - rounding.EPS])
    margin = float("inf")
    for _ in range(z.shape[-1] - 1):
        margin = min(margin, (z[0, :, None] - eps).abs().min().item())
        f = rounding._frac_mask(z)
        if f.sum() >= 2:
            i, j = torch.nonzero(f[0])[:2, 0].tolist()
            zi, zj = z[0, i], z[0, j]
            p = torch.minimum(1.0 - zi, zj)
            q = torch.minimum(zi, 1.0 - zj)
            u = prng.uniform(prng.split(key)[:, 1])[0]
            margin = min(margin, (u - q / torch.clamp(p + q, min=1e-12))
                         .abs().item())
        z, key = rounding._merge_step(z, key)
    margin = min(margin, (z[0, :, None] - eps).abs().min().item())
    f = rounding._frac_mask(z)[0]
    if f.any():
        u = prng.uniform(prng.split(key)[:, 1])[0]
        margin = min(margin, (u - z[0, f]).abs().min().item())
    return margin


def phase_decision(pool, dev, m: int, rounds: int):
    """Card against CPU on one decision; returns the fleet (cfg, state)."""
    from repro_torch import prng
    from repro_torch.core import confidence as cb
    from repro_torch.core import relax
    from repro_torch.router import fleet
    _, _, cfg = mixed_fleet(pool, m, 128, dev)
    res = fleet.simulate_fleet(pool, cfg, T=rounds, seed=1, device=dev)
    st = res.state
    t = rounds + 1
    ka = prng.split(st.key, 4)[:, 1]
    t_row = torch.full_like(st.t, float(t))

    def act(stats, t_row, ka, cfg):
        """`_tenant_act`'s mask, and z̃ from the same UCB/LCB."""
        mu_bar = cb.reward_ucb(stats, t_row, cfg.delta, cfg.alpha_mu)
        c_low = cb.cost_lcb(stats, t_row, cfg.delta, cfg.alpha_c)
        z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho)
        return fleet._tenant_act(stats, t_row, ka, cfg), z

    mask_g, z_g = act(st.stats, t_row, ka, cfg)
    cpu = torch.device("cpu")
    cfg_c = fleet.FleetConfig(*(f.to(cpu) for f in cfg))
    mask_c, z_c = act({k: v.to(cpu) for k, v in st.stats.items()},
                      t_row.cpu(), ka.cpu(), cfg_c)
    z_g, mask_g = z_g.cpu(), mask_g.cpu()
    print(f"decision: CPU half on {torch.get_num_threads()} threads",
          flush=True)
    for b, k, g in F5_SHAPES:
        bits = {t: awc_plain_bits(b, k, g, t) for t in F5_THREADS}
        print(f"decision: plain awc_fw {b}x{k}x{g}, first call in a fresh "
              "interpreter: " + "; ".join(
                  f"{used} threads g {gb[:16]} costs {cb[:16]}"
                  for used, gb, cb in bits.values()), flush=True)
        if len({v[1:] for v in bits.values()}) != 1:
            fail(f"the plain awc_fw at {b}x{k}x{g} depends on the CPU "
                 "thread count (F5)")
    dz = (z_g - z_c).abs().max(-1).values
    print(f"decision: {m} tenants after {rounds} rounds; max|z_card - z_cpu| "
          f"= {dz.max().item():.3g}; rows with z̃ differing: "
          f"{int((dz > 0).sum())}", flush=True)
    if dz.max().item() > 1e-4:
        bad = torch.nonzero(dz > 1e-4)[:, 0].tolist()
        fail(f"z̃ differs by more than 1e-4 on rows {bad[:20]}")
    rows = torch.nonzero((mask_g != mask_c).any(-1))[:, 0].tolist()
    print(f"decision: rows whose masks differ: {len(rows)}", flush=True)
    for r in rows:
        mg, mc = round_margin(z_g[r], ka[r].cpu()), round_margin(z_c[r],
                                                                 ka[r].cpu())
        print(f"  row {r}: |Δz̃|={dz[r].item():.3g}, rounding margin "
              f"card={mg:.3g} cpu={mc:.3g}", flush=True)
        if min(mg, mc) > 1e-6:
            fail(f"row {r}: masks differ and no rounding draw lies within "
                 "1e-6 of its threshold")
    return cfg, st


def phase_fleet(pool, ops, dev, m: int, T: int):
    from repro_torch.core import metrics
    from repro_torch.router import fleet
    kinds, pcfgs, cfg = mixed_fleet(pool, m, T, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fleet.simulate_fleet(pool, cfg, T=T, seed=0, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in FLEET_KERNELS}
    print(f"fleet: {m} tenants x {T} rounds in {secs:.2f} s: "
          f"{T / secs:.2f} rounds/s, {m * T / secs:.1f} tenant-rounds/s",
          flush=True)
    print(f"fleet: launches {launches}", flush=True)
    want = {"topn_lp": (4 + 3 * 8) * T, "awc_fw": 8 * T}
    if launches != want:
        fail(f"launch counts {launches}, the round structure implies {want}")
    if not np.isfinite(res.reward).all() or (res.cost < 0).any():
        fail("fleet produced non-finite rewards or negative costs")
    sizes = res.action.sum(-1)
    for kind in ("awc", "suc", "aic"):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        if kind == "awc" and (sizes[idx] > 4).any():
            fail("an AWC action exceeds n")
        if kind != "awc" and (sizes[idx] != 4).any():
            fail(f"a {kind} action is not of size n")
        rho = pcfgs[idx[0]].rho
        vio = metrics.violation_curve(res.cost[idx], rho)[:, -1].mean()
        print(f"fleet: {kind} reward/round {res.reward[idx].mean():.4f} "
              f"final violation {vio:.4f} (rho {rho:.3f})", flush=True)
    if (res.observed > res.action).any():
        fail("feedback outside the selected set")
    return launches


def phase_profile(pool, dev, cfg, state, rounds: int) -> None:
    """Where a fleet round's time goes (printed, not gated), from the
    decision phase's fleet ``cfg`` and ``state``."""
    from repro_torch import prng
    from repro_torch.core import confidence as cb
    from repro_torch.core import relax, rounding
    from repro_torch.env import cost_model, feedback
    from repro_torch.router import fleet
    rows = relax.kind_rows(cfg.kind_ix)
    mu = torch.tensor(pool.mu, dtype=torch.float32, device=dev)
    mean_cost = torch.tensor(pool.mean_cost, dtype=torch.float32,
                             device=dev)
    t_row = state.t + 1.0

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ks = prng.split(state.key, 4)
    ka, kr, kc = ks[:, 1], ks[:, 2], ks[:, 3]
    mu_bar = cb.reward_ucb(state.stats, t_row, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(state.stats, t_row, cfg.delta, cfg.alpha_c)
    eq_rows, awc_rows = rows
    z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho,
                          rows=rows)
    mask = rounding.pairwise_round_batch(z, ka)
    x = cost_model.sample_rewards(kr, mu, pool.reward_levels)
    y = cost_model.sample_costs(kc, mean_cost)
    parts = {
        "prng.split(key, 4)": lambda: prng.split(state.key, 4),
        "UCB + LCB": lambda: (cb.reward_ucb(state.stats, t_row, cfg.delta,
                                            cfg.alpha_mu),
                              cb.cost_lcb(state.stats, t_row, cfg.delta,
                                          cfg.alpha_c)),
        "solve: SUC/AIC rows (lp_topn)": lambda: relax.lp_topn(
            mu_bar[eq_rows], c_low[eq_rows], cfg.n[eq_rows],
            cfg.rho[eq_rows], True),
        "solve: AWC rows (8 FW steps)": lambda: relax._awc_fw(
            mu_bar[awc_rows], c_low[awc_rows], cfg.n[awc_rows],
            cfg.rho[awc_rows]),
        "pairwise rounding + padding": lambda: rounding.pad_to_n_dyn(
            rounding.pairwise_round_batch(z, ka), mu_bar, cfg.n,
            cfg.kind_ix != 0),
        "reward + cost draws": lambda: (
            cost_model.sample_rewards(kr, mu, pool.reward_levels),
            cost_model.sample_costs(kc, mean_cost)),
        "feedback + Eq. 6 update": lambda: cb.update_stats(
            state.stats, feedback.observe_ix(cfg.kind_ix, mask, x, mean_cost),
            x, y),
    }
    for name, fn in parts.items():
        print(f"profile: {name:32s} {host_ms(fn):8.3f} ms (host clock)",
              flush=True)
    device_trace("profile", "round", rounds, lambda: fleet.simulate_fleet(
        pool, cfg, T=rounds, state=state, device=dev))


def device_profile(fn):
    """Run ``fn`` under `torch.profiler`; returns (wall ms with the
    profiler on, the `key_averages()` entries of the device's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]


def device_trace(tag: str, unit: str, n: int, fn, top: int = 8) -> None:
    """Run ``fn`` (n units of work) under `torch.profiler` and print the
    wall time per unit (profiler on), the device's busy time and idle
    share, the kernels per unit, and the ``top`` kernels by device time."""
    wall_ms, kernels = device_profile(fn)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{tag}: {unit} x {n} traced: wall {wall_ms / n:.2f} ms/{unit} "
          f"(profiler on), device busy {busy_us / 1e3 / n:.3f} ms/{unit}, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.4f}, "
          f"{launches / n:.0f} kernels/{unit}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{tag}:   {e.count / n:7.0f}/{unit} "
              f"{e.self_device_time_total / 1e3 / n:8.3f} ms/{unit}  "
              f"{e.key[:90]}", flush=True)


def quickstart_config(pool, T: int):
    """examples/quickstart.py's AWC configuration."""
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho
    rho = default_rho(pool, "awc", n=4)
    return PolicyConfig(kind="awc", k=pool.k, n=4, rho=rho, delta=1 / T,
                        alpha_mu=0.3, alpha_c=0.01)


def run_policy(tag: str, name: str, pool, pcfg, ops, dev, T: int,
               seeds: int = 5, **kw):
    """`bandit.simulate(name)` on the card; prints reward per round,
    violation and ratio; returns (result, summary, launches)."""
    from repro_torch.core import bandit, metrics, rewards
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bandit.simulate(name, pool, pcfg, T=T, seeds=seeds, device=dev,
                          **kw)
    secs = time.perf_counter() - t0
    s = metrics.summarize(res.reward, res.cost, pcfg.rho,
                          bandit.optimal_value(pool, pcfg),
                          float(rewards.ALPHA[pcfg.kind]))
    launches = {k: ops.LAUNCHES[k] for k in FLEET_KERNELS}
    label = name + ("" if kw.get("use_fleet", True) else " (per seed)")
    print(f"{tag}: [{label}] T={T} seeds={seeds} in {secs:.1f} s "
          f"({T / secs:.2f} rounds/s): reward/round {s['reward_mean']:.4f} "
          f"violation "
          f"{s['violation_final']:.5f} ratio {s['ratio_final']:.1f} "
          f"launches {launches}", flush=True)
    if not np.isfinite(res.reward).all() or (res.cost < 0).any():
        fail(f"{tag}: {label} produced non-finite rewards or negative costs")
    if (res.observed > res.action).any():
        fail(f"{tag}: {label} observed outside the selected set")
    return res, s, launches


def phase_quickstart(pool, ops, dev, T: int) -> None:
    """examples/quickstart.py: C2MAB-V (the fleet path), then CUCB."""
    pcfg = quickstart_config(pool, T)
    _, ours, launches = run_policy("quickstart", "c2mabv", pool, pcfg, ops,
                                   dev, T)
    if min(launches.values()) == 0:
        fail("the quickstart ran without a kernel launch")
    if ours["violation_final"] > 1e-3:
        fail(f"quickstart verdict not reached: violation "
             f"{ours['violation_final']}")
    _, blind, _ = run_policy("quickstart", "cucb", pool, pcfg, ops, dev, T)
    if not ours["ratio_final"] > 2 * blind["ratio_final"]:
        fail(f"c2mabv's ratio {ours['ratio_final']} is not above twice "
             f"cucb's {blind['ratio_final']}")


def phase_baselines(pool, ops, dev, T: int) -> None:
    """Every other policy of `make_policy` on the card, on the quickstart's
    AWC configuration: per-seed C2MAB-V, C2MAB-V-Direct, Thompson
    sampling, ε-greedy, a fixed arm (0) and the offline-best set S*."""
    from repro_torch.core import metrics
    from repro_torch.core.relax import solve_direct
    pcfg = quickstart_config(pool, T)
    s_star, _ = solve_direct("awc", pool.mu, pool.mean_cost, pcfg.n,
                             pcfg.rho)
    runs = (("c2mabv", {"use_fleet": False}), ("c2mabv_direct", {}),
            ("thompson", {}), ("egreedy", {}), ("fixed", {"arm": 0}),
            ("offline_fixed", {"mask": s_star}))
    vio = {}
    for name, kw in runs:
        res, s, launches = run_policy("baselines", name, pool, pcfg, ops,
                                      dev, T, **kw)
        sizes = res.action.sum(-1)
        want = {"fixed": 1, "offline_fixed": int(s_star.sum()),
                "thompson": pcfg.n, "egreedy": pcfg.n}.get(name)
        if want is not None and (sizes != want).any():
            fail(f"baselines: {name} chose sets of {np.unique(sizes)}, "
                 f"not {want}")
        if (sizes > pcfg.n).any() or (sizes < 0).any():
            fail(f"baselines: {name} broke the matroid (|S| <= {pcfg.n})")
        if name == "c2mabv" and min(launches.values()) == 0:
            fail("baselines: per-seed c2mabv ran without a kernel launch")
        vio[name] = metrics.violation_curve(res.cost, pcfg.rho)[:, -1].mean()
    if vio["c2mabv_direct"] > vio["c2mabv"] + 1e-6:
        fail(f"baselines: direct's violation {vio['c2mabv_direct']} above "
             f"the relaxed policy's {vio['c2mabv']}")


def phase_per_seed(pool, ops, dev, seeds: int, T: int) -> None:
    """`simulate("c2mabv", use_fleet=False)` at the fleet's scale, AWC and
    SUC: exact kernel launches a round, the first round's masks bit-equal
    to the CPU's (plain kernels) on the same keys, and a traced round's
    device share."""
    from repro_torch import prng
    from repro_torch.core import bandit
    from repro_torch.core import confidence as cb
    from repro_torch.core.policies import PolicyConfig, make_policy
    from repro_torch.env.llm_profiles import default_rho
    for kind in ("awc", "suc"):
        pcfg = PolicyConfig(kind=kind, k=pool.k, n=4,
                            rho=default_rho(pool, kind, 4), delta=1 / T)
        res, _, launches = run_policy("per-seed", "c2mabv", pool, pcfg, ops,
                                      dev, T, seeds=seeds, use_fleet=False)
        want = {k: v * T for k, v in PER_SEED_LAUNCHES[kind].items()}
        expect_launches(ops, want, f"per-seed {kind}")
        keys = prng.split(prng.PRNGKey(0, device=dev), seeds)
        ka = prng.split(keys, 4)[:, 1].cpu()
        cpu_mask = make_policy("c2mabv", pcfg, device="cpu")(
            cb.init_stats_batch(seeds, pool.k, "cpu"), ka, 1).numpy()
        bad = np.nonzero((res.action[:, 0] != cpu_mask).any(-1))[0]
        print(f"per-seed: {kind} round-1 masks, card against CPU: "
              f"{len(bad)} of {seeds} rows differ", flush=True)
        if len(bad):
            fail(f"per-seed {kind}: round-1 masks differ on rows "
                 f"{bad[:20].tolist()}")
        device_trace(f"per-seed {kind}", "round", 4, lambda: bandit.simulate(
            "c2mabv", pool, pcfg, T=4, seeds=seeds, use_fleet=False,
            device=dev))


def phase_protocol(pool, ops, dev) -> None:
    """The paper's split (§4, Fig. 3): one `LocalServer` solves the
    relaxation, one `SchedulingCloud` over the paper pool rounds it and
    dispatches generation; the K replicas share one engine of StarCoder2-7B
    at full width over `PROTOCOL_LAYERS` layers (bf16)."""
    from repro_torch.router.local_server import LocalServer
    from repro_torch.serving.engine import Engine
    cfg, params = full_width(SERVE_ARCH, dev, "protocol", PROTOCOL_LAYERS)
    eng = Engine(cfg, params, max_len=256, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    pcfg, cloud = paper_cloud(pool, "suc", eng, dev, PROTOCOL_ROUNDS)
    local = LocalServer(pcfg, device=dev)
    rng = np.random.default_rng(0)
    b, plen = PROTOCOL_PROMPTS
    eng.generate(rng.integers(0, cfg.vocab, (1, 16)), 2)      # warm-up
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dispatched, spent = 0, 0.0
    for r in range(1, PROTOCOL_ROUNDS + 1):
        z = local.relaxed_selection()
        mask = cloud.select(z, rng)
        if not np.isfinite(z).all() or mask.sum() != pcfg.n:
            fail(f"protocol: round {r} gave z̃ {z} and a set of "
                 f"{int(mask.sum())}, not {pcfg.n}")
        for arm in np.flatnonzero(mask):
            cost = float(pool.mean_cost[arm] * rng.uniform(0.5, 1.5))
            if r in PROTOCOL_DISPATCH:
                prompts = rng.integers(0, cfg.vocab, (b, plen))
                out, bill = cloud.dispatch(int(arm), prompts, PROTOCOL_NEW,
                                           seed=r)
                if out.tokens.shape != (b, PROTOCOL_NEW) or bill <= 0:
                    fail(f"protocol: arm {arm} returned {out.tokens.shape} "
                         f"tokens at a cost of {bill}")
                dispatched += 1
                spent += bill
            reward = float(rng.uniform() < pool.mu[arm])
            local.record(int(arm), reward, cost)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = dispatched * (PROTOCOL_NEW - 1)
    print(f"protocol: {PROTOCOL_ROUNDS} rounds in {secs:.2f} s, "
          f"{dispatched} dispatches ({b} x {plen} tokens, {PROTOCOL_NEW} "
          f"new) billed {spent:.4f}; t = {local.t}, mu_hat "
          f"{np.round(local.mu_hat, 3).tolist()}; launches "
          f"{dict(ops.LAUNCHES)}", flush=True)
    expect_launches(ops, {"topn_lp": 4 * PROTOCOL_ROUNDS,
                          "flash_attention": dispatched * PROTOCOL_LAYERS,
                          "decode_attention": steps * PROTOCOL_LAYERS},
                    "protocol")
    if local.t != PROTOCOL_ROUNDS or len(local.log) != PROTOCOL_ROUNDS * 4:
        fail(f"protocol: the local server is at t = {local.t} with "
             f"{len(local.log)} records")
    del eng, params
    torch.cuda.empty_cache()


def paper_cloud(pool, kind: str, eng, dev, rounds: int = SERVICE_ROUNDS):
    """(pcfg, cloud): ``kind`` at n 4 with its default ρ and δ = 1/rounds,
    and a `SchedulingCloud` of the paper pool's replicas, each ``eng`` at
    Table 3's price ($ per 1k tokens, per token in the pool's units)."""
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import TABLE3, default_rho
    from repro_torch.router.cloud import Replica, SchedulingCloud
    pcfg = PolicyConfig(kind=kind, k=pool.k, n=4,
                        rho=default_rho(pool, kind, 4), delta=1 / rounds)
    price = np.asarray([p for _, p in TABLE3]) / 1000.0 / pool.cost_scale
    return pcfg, SchedulingCloud(pcfg, [Replica(name, eng, float(p))
                                        for name, p in zip(pool.names, price)],
                                 device=dev)


def service_data(cfg):
    """The services' query stream: 2 rows of 16 tokens a round."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    b, plen = SERVICE_PROMPTS
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=plen,
                                  global_batch=b, seed=0))


def prime(svc, pool) -> None:
    """Two records an arm: reward μ, cost a request's tokens at its price."""
    b, plen = SERVICE_PROMPTS
    for arm in np.tile(np.arange(pool.k), 2):
        svc.local.record(int(arm), float(pool.mu[arm]),
                         b * (plen + svc.max_new)
                         * float(svc.cloud.prices[arm]))


def tick_totals(sched) -> dict:
    """Sums over every runner's tick log (`ReplicaRunner.tick_log`)."""
    log = [t for r in sched.runners for t in r.tick_log]
    steps = sum(t.decode_steps for t in log)
    return {"ticks": len(log), "buckets": sum(t.buckets for t in log),
            "steps": steps,
            "occupied": sum(t.occupied * t.decode_steps for t in log)
            / max(steps, 1),
            "mixed": sum(1 for t in log if len(t.tenants) > 1),
            "batches": sum(1 for t in log if t.decode_steps)}


def serving_launches(cfg, solves: dict, buckets: int, steps: int) -> dict:
    """The launches of ``solves`` ({kind: count}) one-row relaxed solves,
    ``buckets`` prefills and ``steps`` decode steps."""
    want = {"flash_attention": buckets * cfg.n_layers,
            "decode_attention": steps * cfg.n_layers}
    for kind, n in solves.items():     # a one-row solve: a per-seed round
        for name, per in PER_SEED_LAUNCHES[kind].items():
            want[name] = want.get(name, 0) + n * per
    return want


def check_records(tag: str, svc, logs, first: int) -> None:
    """Each observed arm of each round recorded once, in its round."""
    by_round = {}
    for rec in svc.local.log[first:]:
        by_round.setdefault(rec.round, []).append(rec.arm)
    for i, log in enumerate(logs):
        got = sorted(by_round.get(svc._round - len(logs) + i + 1, []))
        if got != np.flatnonzero(log.observed).tolist():
            fail(f"{tag}: round {i + 1} recorded arms {got}, observed "
                 f"{np.flatnonzero(log.observed).tolist()}")
    if len(svc.local.log) - first != sum(int(l.observed.sum()) for l in logs):
        fail(f"{tag}: {len(svc.local.log) - first} records for "
             f"{sum(int(l.observed.sum()) for l in logs)} observations")


def phase_service(pool, ops, dev, eng, cfg) -> None:
    """Phase 7e: `MultiLLMService` in both dispatch modes, SUC and AWC."""
    from repro_torch.router.service import MultiLLMService
    data = service_data(cfg)
    plen = SERVICE_PROMPTS[1]
    for kind in ("suc", "awc"):
        pcfg, cloud = paper_cloud(pool, kind, eng, dev)
        runs = {}
        for mode in ("continuous", "sequential"):
            svc = MultiLLMService(pcfg, cloud, data, prompt_len=plen,
                                  max_new=SERVICE_NEW, seed=0,
                                  dispatch=mode)
            prime(svc, pool)
            first = len(svc.local.log)
            tokens = {}
            if mode == "sequential":      # keep each dispatch's tokens
                def dispatch(arm, prompts, max_new, seed=0,
                             _run=cloud.dispatch):
                    out, cost = _run(arm, prompts, max_new, seed=seed)
                    tokens[(seed, int(arm))] = out.tokens
                    return out, cost
                cloud.dispatch = dispatch
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = []
            for _ in range(SERVICE_ROUNDS):
                if mode == "sequential":
                    logs.append(svc.step())
                    continue
                svc.begin_round()
                for c in svc.sched.drain():
                    tokens[(c.request.seed, c.request.arm)] = c.result.tokens
                logs.append(svc.finish_round())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if mode == "sequential":
                del cloud.dispatch
            tag = f"service {kind} {mode}"
            if svc._cur is not None or len(logs) != SERVICE_ROUNDS:
                fail(f"{tag}: a round did not finish")
            check_records(tag, svc, logs, first)
            if kind == "suc" and any((l.observed != l.action).any()
                                     for l in logs):
                fail(f"{tag}: a selected arm was not observed")
            obs = sum(int(l.observed.sum()) for l in logs)
            if mode == "continuous":
                tt = tick_totals(svc.sched)
                buckets, steps = tt["buckets"], tt["steps"]
                extra = (f"{tt['ticks']} ticks, {secs / tt['ticks']:.4f} s "
                         f"a tick, {steps / tt['ticks']:.2f} decode steps a "
                         f"tick, {tt['occupied']:.2f} occupied slots a "
                         f"decode step, {buckets} prefill buckets")
            else:
                buckets, steps = obs, obs * (SERVICE_NEW - 1)
                extra = f"{obs} dispatches"
            print(f"{tag}: {SERVICE_ROUNDS} rounds in {secs:.2f} s, {obs} "
                  f"completions; {extra}; launches {dict(ops.LAUNCHES)}",
                  flush=True)
            expect_launches(ops, serving_launches(
                cfg, {kind: SERVICE_ROUNDS}, buckets, steps), tag)
            runs[mode] = (svc, logs, tokens)
        (con, clogs, ctok), (seq, slogs, stok) = runs["continuous"], \
            runs["sequential"]
        common = sorted(set(ctok) & set(stok))
        equal = sum(np.array_equal(ctok[k], stok[k]) for k in common)
        same_logs = all(np.array_equal(a.action, b.action)
                        and np.array_equal(a.observed, b.observed)
                        and np.array_equal(a.rewards, b.rewards)
                        and a.cost == b.cost for a, b in zip(clogs, slogs))
        same_state = all(np.array_equal(getattr(con.local, n),
                                         getattr(seq.local, n))
                         for n in ("mu_hat", "c_hat", "t_mu", "t_c"))
        print(f"service {kind}: continuous vs sequential: token-equal "
              f"completions {equal}/{len(common)} "
              f"({equal / max(len(common), 1):.4f}); round logs equal: "
              f"{same_logs}; final bandit state equal: {same_state}; "
              f"mean observed reward {con.summary()['mean_observed_reward']:.4f}"
              f" / {seq.summary()['mean_observed_reward']:.4f}", flush=True)


def phase_driven_fleet(pool, ops, dev, cfg, params) -> None:
    """Phase 7f: `simulate_fleet_driven`, 8 mixed tenants over one shared
    scheduler of full-depth StarCoder2-7B replicas."""
    from repro_torch.router import fleet
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, max_len=64, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    pcfgs = [paper_cloud(pool, k, eng, dev, DRIVEN_ROUNDS)[0]
             for k in DRIVEN_KINDS]
    _, cloud = paper_cloud(pool, "suc", eng, dev, DRIVEN_ROUNDS)
    made = []

    def make_scheduler(_make=cloud.make_scheduler, **kw):
        made.append(_make(**kw))       # keep the fleet's scheduler to read
        return made[-1]
    cloud.make_scheduler = make_scheduler
    b, plen = SERVICE_PROMPTS
    eng.generate(np.ones((b, plen), np.int64), 2)         # warm-up
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.simulate_fleet_driven(
        pcfgs, cloud, service_data(cfg), T=DRIVEN_ROUNDS, prompt_len=plen,
        max_new=DRIVEN_NEW, n_slots=SERVICE_SLOTS, chunk=SERVICE_CHUNK,
        seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tt = tick_totals(made[0])
    solves = {k: DRIVEN_ROUNDS * DRIVEN_KINDS.count(k)
              for k in set(DRIVEN_KINDS)}
    print(f"driven-fleet: {len(pcfgs)} tenants ({DRIVEN_KINDS.count('awc')} "
          f"AWC, {DRIVEN_KINDS.count('suc')} SUC) x {DRIVEN_ROUNDS} rounds "
          f"over {cfg.name} ({cfg.n_layers} layers, bf16) in {secs:.2f} s "
          f"({secs / DRIVEN_ROUNDS:.2f} s a round); {tt['ticks']} ticks, "
          f"{secs / max(tt['ticks'], 1):.4f} s a tick, "
          f"{tt['steps'] / max(tt['ticks'], 1):.2f} decode steps a tick; "
          f"{tt['batches']} decode batches, {tt['mixed']} of them mixing "
          f"tenants; {tt['occupied']:.2f} of {SERVICE_SLOTS} slots occupied "
          f"a decode step; {tt['buckets']} prefill buckets; observed "
          f"{int(res.observed.sum())} of {int(res.action.sum())} selected; "
          f"mean reward {res.reward.mean():.4f}, mean cost "
          f"{res.cost.mean():.5f}; launches {dict(ops.LAUNCHES)}",
          flush=True)
    expect_launches(ops, serving_launches(cfg, solves, tt["buckets"],
                                          tt["steps"]), "driven-fleet")
    if not (np.isfinite(res.reward).all() and np.isfinite(res.cost).all()):
        fail("driven-fleet: non-finite reward or cost")
    if res.reward.shape != (len(pcfgs), DRIVEN_ROUNDS) or \
            not (res.cost > 0).all():
        fail(f"driven-fleet: a tenant round with no cost "
             f"{res.cost.tolist()}")
    if not (res.state.key != 0).any(dim=1).all():
        fail("driven-fleet: a tenant's key row is zero")
    del eng, made
    torch.cuda.empty_cache()


def card_verdict(plan, rep: int, rid: int, attempt: int, dev):
    """`FaultPlan.draw`'s verdict from uniforms drawn on ``dev``."""
    from repro_torch import prng
    from repro_torch.serving.faults import NO_FAULT, FaultDraw
    lo, hi = plan.rid_window or (rid, rid + 1)
    if not plan.enabled or not lo <= rid < hi:
        return NO_FAULT
    key = prng.PRNGKey(plan.fault_seed, device=dev)
    for x in (rep, rid, attempt):
        key = prng.fold_in(key, x)
    u = prng.uniform(key, (3,)).cpu().numpy()
    fails = bool(u[0] < plan.fail_prob(rep))
    return FaultDraw(fails=fails, crash=fails and plan.crash_on_decode,
                     fail_tick=int(u[2] * (plan.fail_tick_max + 1)),
                     spike=plan.spike_ticks if u[1] < plan.spike_prob else 0)


def phase_chaos(pool, ops, dev, eng, cfg) -> None:
    """Phase 7g: 7e's SUC service under per-replica fault plans."""
    from repro_torch.router.service import MultiLLMService
    from repro_torch.serving.faults import EngineCrash, FaultPlan, HealthPolicy
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               ReplicaRunner)
    pcfg, cloud = paper_cloud(pool, "suc", eng, dev)
    plans = {i: FaultPlan(fault_seed=7, fail_prob=0.2,
                          crash_on_decode=i == CHAOS_CRASH)
             for i in range(pool.k)}
    plans[CHAOS_OUTAGE] = FaultPlan(fault_seed=7, fail_prob=1.0,
                                    fail_tick_max=0, rid_window=(0, 2))
    draws = []
    for i, plan in plans.items():
        def draw(rep, rid, attempt, _draw=plan.draw, _plan=plan):
            d = _draw(rep, rid, attempt)
            draws.append((_plan, rep, rid, attempt, d))
            return d
        plan.draw = draw
    hp = HealthPolicy(max_retries=1, quarantine_after=3, probation_ticks=2,
                      readmit_successes=1)
    runners = [ReplicaRunner(r.engine, n_slots=SERVICE_SLOTS,
                             chunk=SERVICE_CHUNK, replica_ix=i,
                             fault_plan=plans[i], health=hp)
               for i, r in enumerate(cloud.replicas)]
    injected = [0]

    def counted(_check=runners[CHAOS_CRASH]._maybe_injected_crash):
        try:
            _check()
        except EngineCrash:
            injected[0] += 1
            raise
    runners[CHAOS_CRASH]._maybe_injected_crash = counted
    sched = ContinuousScheduler(runners, tick_budget=1000)
    svc = MultiLLMService(pcfg, cloud, service_data(cfg),
                          prompt_len=SERVICE_PROMPTS[1], max_new=DRIVEN_NEW,
                          seed=0, dispatch="continuous", scheduler=sched)
    prime(svc, pool)
    first = len(svc.local.log)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = svc.run(CHAOS_ROUNDS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tt = tick_totals(sched)
    stats = sched.stats()
    out_log = [s.value for _, s in runners[CHAOS_OUTAGE].health_log]
    failed = sum(int(l.failed.sum()) for l in logs)
    print(f"chaos: {CHAOS_ROUNDS} rounds in {secs:.2f} s, {tt['ticks']} "
          f"ticks; {failed} failed of "
          f"{sum(int(l.observed.sum()) for l in logs)} observations; "
          f"crashes on replica {CHAOS_CRASH}: {stats[CHAOS_CRASH]['crashes']}"
          f" contained, {injected[0]} injected; outage replica "
          f"{CHAOS_OUTAGE}: {out_log}; {len(draws)} fault draws; per "
          f"replica {[(s['failures'], s['retries'], s['quarantines']) for s in stats]}"
          f"; launches {dict(ops.LAUNCHES)}", flush=True)
    if svc._cur is not None or len(logs) != CHAOS_ROUNDS:
        fail("chaos: a round did not finish")
    check_records("chaos", svc, logs, first)
    expect_launches(ops, serving_launches(cfg, {"suc": CHAOS_ROUNDS},
                                          tt["buckets"], tt["steps"]),
                    "chaos")
    want = ["quarantined", "probation", "healthy"]
    if not any(out_log[i:i + 3] == want for i in range(len(out_log))) or \
            out_log[-1] != "healthy":
        fail(f"chaos: replica {CHAOS_OUTAGE}'s health went {out_log}")
    if stats[CHAOS_CRASH]["crashes"] != injected[0] or not injected[0]:
        fail(f"chaos: {stats[CHAOS_CRASH]['crashes']} crashes contained, "
             f"{injected[0]} injected")
    if sum(s["crashes"] for s in stats) != injected[0]:
        fail("chaos: a crash was contained on a replica without crashes")
    # every verdict the run drew, again from uniforms drawn on the card
    for plan, rep, rid, attempt, d in draws:
        if card_verdict(plan, rep, rid, attempt, dev) != d:
            fail(f"chaos: verdict {d} of ({rep}, {rid}, {attempt}) is not "
                 "the one the card's uniforms give")
    print(f"chaos: {len(draws)} verdicts equal to the card's draws",
          flush=True)


def phase_attention_kernels(ops, dev):
    """flash_attention and decode_attention against their plain versions at
    the serving path's shapes and at small, ragged and masked ones; returns
    per-kernel measurements at the main shapes."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa_fn
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # FlashCase(label, B, S, H, KV, hd, causal, window, dtype, T = S);
    # "main" is a prefill of 4 prompts of 2,048 tokens at StarCoder2-7B's
    # heads; S129 to win100 sit on the bf16 kernel's 128-row and 128-key
    # tile edges; "h2o" is H2O-Danube-3-4B's prefill of 4 x 1,024 (head_dim
    # 120, window 4,096), h2o to hd80 take the pad route; "olmoe" is
    # OLMoE-1B-7B's prefill of 4 x 2,048 at n_rep 1 (16 / 16 heads of 128),
    # timed as "main" is, and "zamba2" Zamba2-2.7B's shared block's (32 /
    # 32 heads of 80, window 4,096, the pad route), timed too; from
    # "whisper-enc" on, the shapes of Whisper-large-v3 (20 / 20 heads of
    # 64: its encoder over 1,500 frames and its decoder's cross-attention,
    # 64 prompt tokens against them, both non-causal), S != T pairs on the
    # tile edges, and Qwen2-VL-72B's prefill of 4 x (256 vision + 2,048
    # text) positions (64 / 8 heads of 128), the three timed; "bucket16"
    # is a scheduler's prefill bucket of 1 or 8 rows of 16 tokens at
    # StarCoder2-7B's heads (phases 7e-7g), far below the 128-row tiles
    F = FlashCase
    cases = [F("main", 4, 2048, 36, 4, 128, True, None, bf16),
             F("olmoe", 4, 2048, 16, 16, 128, True, None, bf16),
             F("zamba2", 4, 2048, 32, 32, 80, True, 4096, bf16),
             F("B1S128", 1, 128, 4, 4, 64, True, None, f32),
             F("B1S128", 1, 128, 4, 4, 64, True, None, bf16),
             F("ragged", 2, 200, 9, 1, 128, True, None, f32),
             F("ragged", 2, 200, 9, 1, 128, True, None, bf16),
             F("win32", 1, 256, 4, 2, 64, True, 32, f32),
             F("win32", 1, 256, 4, 2, 64, True, 32, bf16),
             F("full", 1, 128, 2, 2, 64, False, None, f32),
             F("fullwin", 2, 77, 8, 2, 128, False, 40, bf16),
             F("S1025", 2, 1025, 36, 4, 128, True, None, bf16),
             F("S129", 1, 129, 9, 1, 128, True, None, bf16),
             F("S257", 1, 257, 9, 1, 128, True, None, bf16),
             F("S127", 2, 127, 8, 2, 64, True, None, bf16),
             F("S255", 1, 255, 4, 4, 64, False, None, bf16),
             F("win100", 1, 300, 8, 2, 128, True, 100, bf16),
             F("h2o", 4, 1024, 32, 8, 120, True, 4096, bf16),
             F("h2o", 4, 1024, 32, 8, 120, True, 4096, f32),
             F("ragged120", 2, 200, 32, 8, 120, True, None, bf16),
             F("ragged120", 2, 200, 32, 8, 120, True, None, f32),
             F("hd80", 2, 129, 32, 32, 80, True, None, bf16),
             F("hd80", 2, 129, 32, 32, 80, True, None, f32)]
    cases += [F(*c[:8], dt, *c[8:]) for c in [
        ("whisper-enc", 4, 1500, 20, 20, 64, False, None),
        ("whisper-cross", 4, 64, 20, 20, 64, False, None, 1500),
        ("S7T300", 2, 7, 8, 2, 64, False, None, 300),
        ("S129T77", 1, 129, 9, 1, 128, False, None, 77),
        ("S300T129", 1, 300, 8, 2, 128, False, None, 129),
        ("qwen2-vl", 4, 2304, 64, 8, 128, True, None),
        ("bucket16x1", 1, 16, 36, 4, 128, True, None),
        ("bucket16x8", 8, 16, 36, 4, 128, True, None)] for dt in (bf16, f32)]
    errs, worst, main, worst_row, shapes = [], 0.0, None, 0.0, {}
    for label, b, s, h, kv, hd, causal, window, dt, t in cases:
        t = t or s
        q = rnd((b, s, h, hd), dt)
        k, v = rnd((b, t, kv, hd), dt), rnd((b, t, kv, hd), dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        row = fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if dt == bf16:
            errs.append(f"{label}={err:.3g}")
        if not err <= ATTN_ATOL[dt]:
            fail(f"flash_attention {label} {dt}: max|diff| {err}")
        if not row <= 1:
            fail(f"flash_attention {label} {dt}: a (row, head) vector is "
                 f"{row:.3g} x its per-row tolerance")
        print(f"flash_attention {label:9s} B={b} S={s} T={t} H={h} KV={kv} "
              f"hd={hd} causal={causal} window={window} {dt}: "
              f"max|diff|={err:.3g} row ratio={row:.3g}", flush=True)
        if label == "h2o" and dt == bf16:
            flash_pad_route(ops, fa, q, k, v, window)
        if label in FLASH_TIMED and dt == bf16:
            # (a window of 4,096 over 2,048 keys masks nothing beyond the
            # causal mask, so SDPA's is_causal is the same function)
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                     window=window))
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), iters=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: sdpa_fn(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            nbytes, flops = flash_cost(q, k, causal)
            b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
            if label == "main":
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
            else:
                shapes[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
            print(f"flash_attention {label}: kernel={ms:.4f}ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                  f"bound) plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by})", flush=True)
    print(f"flash_attention bf16 P design: two bf16 parts (hi + lo); "
          f"max|diff| {' '.join(errs)}", flush=True)
    print(f"flash_attention per-row check: worst ratio {worst_row:.3g} "
          f"(gate 1: max|diff| <= {ROW_RTOL} max|want| + {ROW_ATOL} per "
          "(row, head))", flush=True)
    results["flash_attention"] = dict(max_abs_err=worst, **main,
                                      shapes=shapes)

    # (label, B, T, H, KV, hd, pos, dtype); "main" is a decode step of the
    # slot phase: 8 slots of a 4,096-slot cache, 4 near 1,100, 4 near 3,040;
    # nrep16 and nrep32 fill two M tiles of the bf16 kernel's products,
    # "edge" puts pos on the 256-slot split edge of its shape, and "noslot"
    # has a row with pos -1, which must come out as zeros (the plain version
    # gives the mean of V there, so such rows are held to 0 instead);
    # "olmoe" is OLMoE-1B-7B's decode step at n_rep 1 (one of the products'
    # 16 M rows in use), timed as "main" is, and "whisper" Whisper's layout;
    # "h2o" (head_dim 120, n_rep 4) and "zamba2" (head_dim 80, n_rep 1) are
    # the sliding-window decode steps of H2O-Danube-3-4B and Zamba2-2.7B's
    # shared block over a full 4,096-slot ring (every pos at or past T - 1),
    # timed, and their "-ring" cases hold ring positions below T, at T - 1,
    # past T and far past it, with a row of pos -1 (held to zeros); the
    # last three are Whisper-large-v3's cross-attention step (every row at
    # pos T - 1 over 1,500 encoder frames: all of them), its self-attention
    # step over its 448-slot context with a row of pos -1, and Qwen2-VL-72B's
    # step (64 / 8 heads of 128), each timed in bf16; "slots32" is a
    # scheduler's decode over 32 slots of a 64-slot cache: 8 never
    # admitted (pos 0), 16 mid-request, 8 frozen at the budget's end
    main_pos = [1100, 1110, 1120, 1130, 3040, 3041, 3047, 3055]
    whisper_pos = [3, 67, 130, 200, 227, 300, 447, -1]
    full_ring = [4095, 4096, 4200, 5000, 6143, 7000, 8191, 9000]
    ring = [100, 4095, 4200, 9000, -1, 0, 2047, 5000]
    slots_pos = [0] * 8 + list(range(16, 32)) + [32] * 8
    cases = [("main", 8, 4096, 36, 4, 128, main_pos, bf16),
             ("olmoe", 8, 4096, 16, 16, 128, main_pos, bf16),
             ("h2o", 8, 4096, 32, 8, 120, full_ring, bf16),
             ("zamba2", 8, 4096, 32, 32, 80, full_ring, bf16),
             ("h2o-ring", 8, 4096, 32, 8, 120, ring, bf16),
             ("h2o-ring", 8, 4096, 32, 8, 120, ring, f32),
             ("zamba2-ring", 8, 4096, 32, 32, 80, ring, bf16),
             ("zamba2-ring", 8, 4096, 32, 32, 80, ring, f32),
             ("nrep17", 2, 1024, 17, 1, 120, [1023, 500], bf16),
             ("nrep25", 2, 1024, 25, 1, 80, [1023, 500], bf16),
             ("whisper", 2, 512, 20, 20, 64, [0, 511], bf16),
             ("rows", 4, 128, 4, 2, 64, [0, 5, 63, 127], f32),
             ("rows", 4, 128, 4, 2, 64, [0, 5, 63, 127], bf16),
             ("scalar", 2, 256, 4, 2, 64, 100, f32),
             ("ragged", 3, 77, 9, 1, 128, [76, 200, 3], f32),
             ("mixed", 8, 4096, 36, 4, 128, [0, 1, 63, 64, 4095, 5000, 17,
                                             2048], bf16),
             ("nrep16", 2, 1024, 16, 1, 128, [0, 1023], bf16),
             ("nrep32", 2, 512, 32, 1, 64, [100, 511], bf16),
             ("edge", 3, 4096, 36, 4, 128, [255, 256, 257], bf16),
             ("noslot", 2, 4096, 36, 4, 128, [-1, 100], f32),
             ("noslot", 2, 4096, 36, 4, 128, [-1, 100], bf16)]
    cases += [(*c, dt) for c in [
        ("whisper-cross", 8, 1500, 20, 20, 64, [1499] * 8),
        ("whisper-self", 8, 448, 20, 20, 64, whisper_pos),
        ("qwen2-vl", 8, 4096, 64, 8, 128, main_pos),
        ("slots32", 32, 64, 36, 4, 128, slots_pos)] for dt in (bf16, f32)]
    worst, main, worst_row, shapes = 0.0, None, 0.0, {}
    for label, b, t, h, kv, hd, pos, dt in cases:
        q = rnd((b, 1, h, hd), dt)
        k, v = rnd((b, t, kv, hd), dt), rnd((b, t, kv, hd), dt)
        pos_t = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
        out = ops.decode_attention(q, k, v, pos_t)
        want = dec.decode_attention_plain(q, k, v, pos_t)
        torch.cuda.synchronize()
        if isinstance(pos, list) and min(pos) < 0:
            none = pos_t < 0
            if torch.count_nonzero(out[none]).item():
                fail(f"decode_attention {label} {dt}: a row with pos -1 is "
                     f"not zero (max|o| {out[none].abs().max().item():.3g})")
            out, want = out[~none], want[~none]
        err = (out.float() - want.float()).abs().max().item()
        row = fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if not err <= ATTN_ATOL[dt]:
            fail(f"decode_attention {label} {dt}: max|diff| {err}")
        if not row <= 1:
            fail(f"decode_attention {label} {dt}: a (row, head) vector is "
                 f"{row:.3g} x its per-row tolerance")
        print(f"decode_attention {label:7s} B={b} T={t} H={h} KV={kv} "
              f"hd={hd} pos={pos} {dt}: max|diff|={err:.3g} "
              f"row ratio={row:.3g}", flush=True)
        if label in DECODE_TIMED and dt == bf16:

            def call():
                return ops.decode_attention(q, k, v, pos_t)
            ms = cuda_ms(call, iters=100)
            dev_ms = graph_ms(call)
            plain_ms = cuda_ms(lambda: dec.decode_attention_plain(
                q, k, v, pos_t))
            mask = (torch.arange(t, device=dev)[None, :] <= pos_t[:, None])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return sdpa_fn(
                    qt, kt, vt, attn_mask=mask[:, None, None, :],
                    enable_gqa=True)
            lib_ms = cuda_ms(sdpa, iters=100)
            lib_dev_ms = graph_ms(sdpa)
            b_ms, b_by = bound(*decode_cost(q, k, pos_t), BF16_OPS_PER_S)
            numbers = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms, graph_ms=dev_ms,
                           library_graph_ms=lib_dev_ms)
            if label == "main":
                main = numbers
            else:
                shapes[label] = numbers
            print(f"decode_attention {label}: kernel={ms:.4f}ms one by one, "
                  f"{dev_ms:.4f}ms from a CUDA graph ({b_ms / dev_ms:.3f} "
                  f"of the bound) plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"one by one, {lib_dev_ms:.4f}ms from a CUDA graph "
                  f"bound={b_ms:.5f}ms ({b_by})", flush=True)
    print(f"decode_attention per-row check: worst ratio {worst_row:.3g} "
          "(gate 1)", flush=True)
    results["decode_attention"] = dict(max_abs_err=worst, **main,
                                       shapes=shapes,
                                       lse=decode_lse_check(ops, dev, rnd))
    return results


def decode_lse_check(ops, dev, rnd) -> dict:
    """Phase 3's log-sum-exp entry, in bf16 with per-row pos and a row at
    pos -1: `decode_attention_lse` at the main decode shape (8 x 4,096,
    36/4 x 128) and at head_dims 64, 80 and 120. Its o must be
    `torch.equal` to `decode_attention`'s (the same kernel, one more
    output), its lse within LSE_ATOL of `decode_attention_lse_plain`'s (and
    -inf where that is); then T cut into m = 2 and 4 blocks (one wholly
    past some rows' pos), the kernel on each at its local pos and
    `merge_partials` without a group must meet the whole-cache call under
    the per-(row, head) gate. Returns the main shape's numbers."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    main_pos = [-1, 1110, 1120, 1130, 3040, 3041, 3047, 3055]
    ring = [100, 4095, 4200, 9000, -1, 0, 2047, 5000]
    whisper_pos = [3, 67, 130, 200, 227, 300, 447, -1]
    cases = [("main", 8, 4096, 36, 4, 128, main_pos),
             ("hd64", 8, 448, 20, 20, 64, whisper_pos),
             ("hd80", 8, 4096, 32, 32, 80, ring),
             ("hd120", 8, 4096, 32, 8, 120, ring)]
    numbers, worst_lse, worst_row = {}, 0.0, 0.0
    for label, b, t, h, kv, hd, pos in cases:
        q = rnd((b, 1, h, hd), bf16)
        k, v = rnd((b, t, kv, hd), bf16), rnd((b, t, kv, hd), bf16)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        whole = ops.decode_attention(q, k, v, pos_t)
        o, lse = ops.decode_attention_lse(q, k, v, pos_t)
        _, lse_plain = dec.decode_attention_lse_plain(q, k, v, pos_t)
        torch.cuda.synchronize()
        if not torch.equal(o, whole):
            fail(f"decode_attention_lse {label}: o is not decode_attention's")
        if not torch.equal(torch.isneginf(lse), torch.isneginf(lse_plain)):
            fail(f"decode_attention_lse {label}: -inf rows differ")
        fin = torch.isfinite(lse_plain)
        err = (lse[fin] - lse_plain[fin]).abs().max().item()
        worst_lse = max(worst_lse, err)
        if not err <= LSE_ATOL:
            fail(f"decode_attention_lse {label}: lse max|diff| {err}")
        last = torch.clamp(pos_t, max=t - 1)
        ratios = []
        for m in LSE_SPLITS:
            t_l = t // m
            parts = [ops.decode_attention_lse(
                q, k[:, r * t_l:(r + 1) * t_l].contiguous(),
                v[:, r * t_l:(r + 1) * t_l].contiguous(),
                (last - r * t_l).clamp(-1, t_l - 1)) for r in range(m)]
            merged = dec.merge_partials(torch.stack([x[0] for x in parts]),
                                        torch.stack([x[1] for x in parts]))
            past = sum(bool(((last >= 0) & (last < r * t_l)).any())
                       for r in range(m))
            if not past:
                fail(f"decode_attention_lse {label} m={m}: no block lies "
                     "wholly past a row's pos")
            ratio = fa.row_error_ratio(merged, whole, ROW_RTOL, ROW_ATOL)
            ratios.append(ratio)
            if not ratio <= 1:
                fail(f"decode_attention_lse {label} m={m}: the merged blocks "
                     f"are {ratio:.3g} x the per-row tolerance from the "
                     "whole-cache call")
        worst_row = max([worst_row] + ratios)
        print(f"decode_attention_lse {label:5s} B={b} T={t} H={h} KV={kv} "
              f"hd={hd} pos={pos}: o torch.equal decode_attention's, lse "
              f"max|diff|={err:.3g} (bound {LSE_ATOL}); split into "
              f"{'/'.join(map(str, LSE_SPLITS))} blocks and merged: row "
              f"ratio {' / '.join(f'{x:.3g}' for x in ratios)} (gate 1)",
              flush=True)
        if label != "main":
            continue

        def plain_call():
            return ops.decode_attention(q, k, v, pos_t)

        def lse_call():
            return ops.decode_attention_lse(q, k, v, pos_t)
        ms, lse_ms = cuda_ms(plain_call, iters=100), cuda_ms(lse_call,
                                                              iters=100)
        dev_ms, lse_dev_ms = graph_ms(plain_call), graph_ms(lse_call)
        plain_ms = cuda_ms(lambda: dec.decode_attention_lse_plain(
            q, k, v, pos_t))
        nbytes, flops = decode_cost(q, k, pos_t)
        b_ms, b_by = bound(nbytes + 4.0 * b * h, flops, BF16_OPS_PER_S)
        numbers = dict(ms=lse_ms, graph_ms=lse_dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
        print(f"decode_attention_lse main: {lse_ms:.4f} ms one by one, "
              f"{lse_dev_ms:.4f} ms from a CUDA graph; decode_attention "
              f"{ms:.4f} / {dev_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}) [{card_line()}]", flush=True)
    numbers.update(max_abs_err=worst_lse, worst_row_ratio=worst_row)
    return numbers


def flash_pad_route(ops, fa, q, k, v, window) -> None:
    """Printed, not gated: what the pad route costs at H2O-Danube-3-4B's
    prefill: the route as called, the hd-128 kernel on inputs padded
    beforehand, the pad and slice copies alone, and SDPA on the hd-120
    inputs."""
    import torch.nn.functional as F
    hd = q.shape[3]
    qp, kp, vp, _ = fa.pad_head_dim(q, k, v)
    padded_out = torch.empty_like(qp)
    route_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
    kernel_ms = cuda_ms(lambda: ops.flash_attention(qp, kp, vp, causal=True,
                                                    window=window))
    copy_ms = cuda_ms(lambda: (fa.pad_head_dim(q, k, v),
                               padded_out[..., :hd].contiguous()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    b_ms, b_by = bound(*flash_cost(q, k, True), BF16_OPS_PER_S)
    print(f"flash_attention h2o pad route: {route_ms:.4f}ms = hd-128 kernel "
          f"{kernel_ms:.4f}ms + pad/slice copies {copy_ms:.4f}ms; "
          f"sdpa={lib_ms:.4f}ms bound={b_ms:.5f}ms ({b_by}, hd {hd})",
          flush=True)


def phase_ssd_kernel(ops, dev):
    """ssd_chunk against its plain version at the SSM prefill's shape and
    at ragged (L 100, 37, 1), single-row, steep-decay, narrow-head (P 16,
    32), wide-range (B/C ×1e2, xd ×1e-3) and reduced ones; returns its
    measurements at the main shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, nc, l, h, p, n, bc_dtype, slope, bc_scale):
        """As `ssd_chunked` forms them: xd = x·dt, acum the cumulative sum
        of dt·a (dt a softplus, a = -exp(·) per head, or -slope·U(0, 1)
        when ``slope`` is set), bm/cm views into one wider conv output of
        N(0, bc_scale²) values."""
        x = torch.randn((b, nc, l, h, p), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, nc, l, h), generator=gen,
                                    device=dev))
        if slope:
            da = -slope * torch.rand((b, nc, l, h), generator=gen,
                                     device=dev)
        else:
            a = -torch.exp(0.5 * torch.randn((h,), generator=gen,
                                             device=dev))
            da = dt * a
        wide = (bc_scale * torch.randn((b, nc * l, 2 * n + 64),
                                       generator=gen, device=dev)
                ).to(bc_dtype)
        return ((x * dt[..., None]).contiguous(), torch.cumsum(da, dim=2),
                wide[..., 64:64 + n].reshape(b, nc, l, n),
                wide[..., 64 + n:].reshape(b, nc, l, n))

    worst, main, shapes = 0.0, None, {}
    for (label, b, nc, l, h, p, n, bc_dtype, slope, bc_scale,
         x_scale) in SSD_CASES:
        xd, acum, bm, cm = inputs(b, nc, l, h, p, n, bc_dtype, slope,
                                  bc_scale)
        args = (xd * x_scale, acum, bm, cm)
        y, st = ops.ssd_chunk(*args)
        wy, wst = ssd.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            fail(f"ssd_chunk {label}: non-finite output")
        rel = max((y - wy).abs().max().item() / wy.abs().max().item(),
                  (st - wst).abs().max().item() / wst.abs().max().item())
        err = max((y - wy).abs().max().item(), (st - wst).abs().max().item())
        worst = max(worst, err)
        print(f"ssd_chunk {label:7s} B={b} NC={nc} L={l} H={h} P={p} N={n} "
              f"B/C {bc_dtype} x{bc_scale:g}, xd x{x_scale:g}: max|diff| "
              f"{err:.3g}, relative {rel:.3g}", flush=True)
        if not rel <= SSD_RTOL:
            fail(f"ssd_chunk {label}: relative max|diff| {rel:.3g} > "
                 f"{SSD_RTOL}")
        if label == "main" and not rel <= SSD_MAIN_RTOL:
            fail(f"ssd_chunk main: relative max|diff| {rel:.3g} > "
                 f"{SSD_MAIN_RTOL}")
        if label in ("main", "zamba2"):
            ms = cuda_ms(lambda: ops.ssd_chunk(*args))
            plain_ms = cuda_ms(lambda: ssd.ssd_chunk_plain(*args), iters=5)
            nbytes, nops = ssd_cost(args[0], args[2])
            b_ms, b_by = bound(nbytes, ssd_tensor_ops(args[0], args[2]),
                               TF32_OPS_PER_S)
            core_ms, _ = bound(nbytes, nops)
            numbers = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None,
                           bound_cuda_core_ms=core_ms)
            if label == "main":
                main = numbers
            else:
                shapes[label] = numbers
            print(f"ssd_chunk {label}: kernel={ms:.4f}ms "
                  f"plain={plain_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by}; tensor cores: bf16 C Bᵀ, "
                  f"split TF32 products), {core_ms:.5f}ms with every "
                  "product on fp32 CUDA cores; no single PyTorch call "
                  "computes it", flush=True)
    return {"ssd_chunk": dict(max_abs_err=worst, **main, shapes=shapes)}


def serve_kernels(cfg):
    """The kernels one prefill and one decode step of ``cfg`` launch, per
    kernel (every other kernel must stay at 0): a hybrid model's shared
    block runs once per group of `shared_attn_period` SSM layers; an audio
    model's prefill attends in every encoder layer and twice (self, cross)
    in every decoder layer, and so does its decode step in the decoder."""
    layers = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssd_chunk": layers}, {}
    if cfg.family == "hybrid":
        groups = layers // cfg.shared_attn_period
        return ({"ssd_chunk": layers, "flash_attention": groups},
                {"decode_attention": groups})
    if cfg.family == "audio":
        return ({"flash_attention": cfg.n_enc_layers + 2 * layers},
                {"decode_attention": 2 * layers})
    return {"flash_attention": layers}, {"decode_attention": layers}


def stub_inputs(cfg, b: int, s: int, seed: int, dtype, dev):
    """A VLM's patch embeddings (1/8 of a prompt of ``s`` tokens) or an
    audio model's 1,500 frames, N(0, 1) drawn with numpy from ``seed``, in
    ``dtype`` on ``dev``; no entries for the other families."""
    from repro_torch.models import model as M
    if cfg.family == "vlm":
        name, n = "vision_embeds", max(s // M.VLM_VISION_FRACTION, 1)
    elif cfg.family == "audio":
        name, n = "frames", M.WHISPER_ENC_FRAMES
    else:
        return {}
    x = np.random.default_rng(seed).standard_normal((b, n, cfg.d_model),
                                                    dtype=np.float32)
    return {name: torch.from_numpy(x).to(dev, dtype)}


def expect_launches(ops, want, what: str) -> None:
    """Fail unless the launch counts since the last reset are ``want``'s,
    and every other kernel's are 0."""
    want = {k: want.get(k, 0) for k in ops.KERNELS}
    if dict(ops.LAUNCHES) != want:
        fail(f"{what}: launches {dict(ops.LAUNCHES)}, expected {want}")


def numel(tree) -> int:
    """Elements of every tensor in nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def full_width(arch: str, dev, tag: str, layers: Optional[int] = None):
    """(cfg, params): ``arch`` at its published width (cut to ``layers``
    layers if given), bf16 weights from `init_params` seed 0, counted
    against the schema."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    cut = ""
    if layers is not None:
        cut = (f" cut to {layers} of its {cfg.n_layers} layers (one of "
               f"{cfg.n_layers // layers} pipeline stages), every width as "
               "published,")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = numel(params)                 # a hybrid's `shared` block included
    print(f"{tag}: {cfg.name}{cut} {n:,} parameters (bf16, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if n != M.param_count(cfg):
        fail(f"{n} parameters, the schema counts {M.param_count(cfg)}")
    return cfg, params


class Traffic(NamedTuple):
    """A serving phase's requests: `generate` on 4 prompts of ``gen_len``
    tokens for ``gen_new`` new ones, then two batches of 4 slot requests,
    (prompt tokens, decode steps after its admission) each, with a budget
    of ``max_out`` tokens a slot; a traced prefill of 4 x ``trace_len``."""
    slots: Tuple[Tuple[int, int], ...]
    gen_len: int = 2048
    gen_new: int = 64
    max_out: int = 64
    trace_len: int = 1024
    max_len: int = SERVE_MAX_LEN


# StarCoder2's traffic, and the others' with their long slot prompt
SERVE_TRAFFIC = Traffic(slots=((1024, 16), (3000, 48)))
LONG_TRAFFIC = Traffic(slots=((1024, 16), (3072, 48)))
# speech-to-text over 30-second windows: 1,500 frames, short prompts (task
# and language tokens), up to Whisper's 448-token decoder context
AUDIO_TRAFFIC = Traffic(slots=((4, 64), (64, 64)), gen_len=4, gen_new=224,
                        max_out=128, trace_len=64, max_len=448)


def phase_serve(ops, dev, arch: str, tag: str, traffic: Traffic,
                layers: Optional[int] = None, built=None):
    """A serving path at full width (``built``: its (cfg, params) already
    made); returns (launches, params, cfg)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    cfg, params = built or full_width(arch, dev, tag, layers)
    eng = Engine(cfg, params, max_len=traffic.max_len, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    per_prefill, per_step = serve_kernels(cfg)
    # warm-up: cuBLAS handles and the kernels' first launches
    eng.generate(rng.integers(0, cfg.vocab, (1, 64)), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def expect(prefills: int, steps: int, what: str) -> None:
        expect_launches(ops, {k: prefills * per_prefill.get(k, 0)
                              + steps * per_step.get(k, 0)
                              for k in ops.KERNELS}, what)

    def check_tokens(tokens, what: str) -> None:
        if tokens.min() < 0 or tokens.max() >= cfg.vocab:
            fail(f"{what}: a token outside the vocabulary")

    def check_logits(lg, what: str) -> None:
        if not torch.isfinite(lg).all():
            fail(f"{what}: non-finite logits")

    # ---- generate: 4 prompts, gen_new new tokens each
    glen, gnew = traffic.gen_len, traffic.gen_new
    prompts = rng.integers(0, cfg.vocab, (4, glen))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = eng.prefill(prompts)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check_logits(lg, "generate prefill")
    expect(1, 0, "prefill")
    t0 = time.perf_counter()
    res = eng.generate(prompts, gnew)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    expect(2, gnew - 1, f"generate (one prefill, {gnew - 1} decode steps)")
    check_tokens(res.tokens, "generate")
    if not np.isfinite(res.logprobs).all():
        fail("generate: non-finite logprobs")
    print(f"{tag}: generate 4 x {glen} prompt tokens, {gnew} new: "
          f"{t_gen:.2f} s; prefill alone {t_pre * 1e3:.1f} ms = "
          f"{4 * glen / t_pre:,.0f} prompt tokens/s; decode "
          f"{(t_gen - t_pre) / (gnew - 1) * 1e3:.2f} ms/step; mean logprob "
          f"{res.logprobs.mean():.3f}", flush=True)

    # ---- the slot API: 8 slots, two admitted batches
    state = eng.init_slots(8, max_out=traffic.max_out)
    prefills, steps = 2, gnew - 1
    for j, (plen, chunk) in enumerate(traffic.slots):
        slots = list(range(4 * j, 4 * j + 4))
        p = rng.integers(0, cfg.vocab, (4, plen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, sl = eng.prefill(p)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        prefills += 1
        expect(prefills, steps, f"slot prefill {plen}")
        check_logits(lg, f"slot prefill {plen}")
        state = eng.admit(state, slots, lg, sl, prompt_len=plen,
                          max_new=traffic.max_out, seed=j + 1)
        del lg, sl
        t0 = time.perf_counter()
        state = eng.decode_chunk(state, chunk)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        steps += chunk
        expect(prefills, steps, f"decode_chunk({chunk})")
        check_logits(state.last, f"decode_chunk({chunk})")
        print(f"{tag}: slots {slots}: prefill 4 x {plen} in "
              f"{t_pre * 1e3:.1f} ms = {4 * plen / t_pre:,.0f} prompt "
              f"tokens/s; decode_chunk({chunk}) over 8 slots "
              f"{t_dec / chunk * 1e3:.2f} ms/step", flush=True)
    out = state.out.cpu().numpy()
    check_tokens(out, "slots")
    n_out = state.n_out.cpu().tolist()
    finished = state.finished.cpu().tolist()
    for i, (got, done) in enumerate(zip(n_out, finished)):
        # the tokens the chunks after the slot's admission allow
        budget = min(traffic.max_out,
                     sum(c for _, c in traffic.slots[i // 4:]))
        if got > budget or (got < budget and not done):
            fail(f"slot {i}: {got} tokens of {budget}, finished={done}")
    state = eng.release(state, list(range(8)))
    if state.active.any():
        fail("release left a slot active")
    launches = dict(ops.LAUNCHES)
    print(f"{tag}: slots n_out {n_out}; launches {launches}; peak memory "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    # where the time goes (printed, not gated; after the launch counts):
    # one 4 x trace_len prefill, then 3 decode steps over the 8 slots' cache
    p = rng.integers(0, cfg.vocab, (4, traffic.trace_len))
    device_trace(f"{tag}-profile", "prefill", 1, lambda: eng.prefill(p))
    tok = torch.full((8, 1), eng.eos_id, dtype=torch.int64, device=dev)
    device_trace(f"{tag}-profile", "decode step", 3, lambda: [
        M.decode_step(cfg, params, tok, state.cache, state.pos, device=dev)
        for _ in range(3)])
    del state
    return launches, params, cfg


def phase_consistency(ops, params, cfg, dev, tag: str = "consistency",
                      prompt_len: int = 1024):
    """Full width, bf16: prefill of two ``prompt_len``-token prompts (one
    `flash_attention` launch per layer, and no other kernel) + one decode
    step (one `decode_attention` launch per layer, and no other kernel;
    with a sliding window shorter than the prompt, on a ring that has
    wrapped) against `forward` over the prompt_len + 1 tokens (flash over
    the whole sequence; its window then holds the ring's positions). Both
    flows round their activations to bf16 at every matmul and norm, in
    another order and at other shapes, through every layer of the model.
    A VLM's prompt carries random patch embeddings ahead of it, so its step
    is at `prefill_len`; an audio model's, 1,500 random frames (`serve_kernels`
    counts its launches: encoder, self and cross attention)."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, prompt_len))
    extra = stub_inputs(cfg, 2, prompt_len, 1, torch.bfloat16, dev)
    pos = M.prefill_len(cfg, prompt_len)
    per_prefill, per_step = serve_kernels(cfg)
    ops.reset_launches()
    last, cache = M.prefill(cfg, params, {"tokens": toks, **extra},
                            2 * prompt_len, device=dev)
    torch.cuda.synchronize()
    expect_launches(ops, per_prefill, f"{tag}: prefill")
    nxt = last.float().argmax(-1)[:, None]
    ops.reset_launches()
    lg, _ = M.decode_step(cfg, params, nxt, cache, pos, device=dev)
    torch.cuda.synchronize()
    expect_launches(ops, per_step, f"{tag}: decode step at pos {pos}")
    del cache
    ext = np.concatenate([toks, nxt.cpu().numpy()], axis=1)
    full, _ = M.forward(cfg, params, {"tokens": ext, **extra}, device=dev)
    full = full.float()
    d_pre = (last.float() - full[:, -2]).abs().max().item()
    d_dec = (lg[:, 0].float() - full[:, -1]).abs().max().item()
    scale = full[:, -2:].abs().max().item()
    agree = int((lg[:, 0].float().argmax(-1) == full[:, -1].argmax(-1))
                .sum())
    print(f"{tag}: {cfg.name} ({cfg.n_layers} layers, head_dim "
          f"{cfg.head_dim}, prompt {prompt_len}, decode at {pos}): launches "
          f"{per_prefill} in the prefill, {per_step} in the decode step; "
          f"max|logit| {scale:.3f}; prefill vs "
          f"forward max|diff| {d_pre:.4g}; decode step vs forward max|diff| "
          f"{d_dec:.4g}; argmax agrees on {agree}/2 rows", flush=True)
    # A fault in either kernel (a wrong mask, head or row) moves logits by
    # about their own size. bf16 rounding does not: each flow rounds the
    # residual stream and every product to 8 bits (2^-9 relative) ~6 times
    # a layer (~200 times over StarCoder2's 32 layers), a random walk of a
    # few percent of a logit, and the two flows share most of those
    # roundings. So the gate is 1/8 of the largest logit.
    tol = scale / 8
    if not max(d_pre, d_dec) <= tol:
        fail(f"{tag}: prefill/decode differ from forward by more than "
             f"{tol:.4g}")


def phase_moe_determinism(params, cfg, dev) -> None:
    """Two identical bf16 prefills of 4 x 2,048 tokens give the same bits:
    the MoE combine sums a token's k outputs in a fixed order, with no
    atomics (and cuBLAS is deterministic at fixed shapes)."""
    from repro_torch.models import model as M
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (4, 2048))
    (la, ca), (lb, cb) = (M.prefill(cfg, params, {"tokens": toks}, 2048,
                                    device=dev) for _ in range(2))
    same = torch.equal(la, lb) and all(
        torch.equal(ca["attn"][n], cb["attn"][n]) for n in ("k", "v"))
    print(f"moe-determinism: two 4 x 2048 bf16 prefills: logits and cache "
          f"bit-equal: {same}", flush=True)
    if not same:
        fail("two identical bf16 MoE prefills differ")


def phase_window(ops, dev) -> None:
    """H2O-Danube-3-4B at its published width (head_dim 120, window 4,096)
    through phase 9's check at a prompt of 4,200 tokens: the decode step at
    pos 4,200 reads a wrapped 4,096-slot ring through `decode_attention`;
    its weights are freed after."""
    cfg, params = full_width(WINDOW_ARCH, dev, "h2o")
    phase_consistency(ops, params, cfg, dev, "h2o", prompt_len=4200)
    del params
    torch.cuda.empty_cache()


def phase_ssm_consistency(ops, params, cfg, dev, tag: str = "ssm-consistency",
                          prompt_len: int = 1024, steps: int = 256) -> None:
    """Full width, bf16: prefill of ``prompt_len`` tokens, then ``steps``
    decode steps fed the next tokens of the sequence, against `forward`
    over all of it (the prefill's state and conv tail, and a hybrid's
    shared-attention ring, hand off to decode); the prefill and every
    decode step launch `serve_kernels`' counts, and nothing else."""
    from repro_torch.models import model as M
    total = prompt_len + steps
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, total))
    full, _ = M.forward(cfg, params, {"tokens": toks}, device=dev)
    per_prefill, per_step = serve_kernels(cfg)
    ops.reset_launches()
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :prompt_len]},
                            total, device=dev)
    torch.cuda.synchronize()
    expect_launches(ops, per_prefill, f"{tag}: prefill")
    d_pre = (last.float() - full[:, prompt_len - 1].float()).abs().max().item()
    d_dec, agree = 0.0, 0
    scale = full[:, prompt_len - 1].float().abs().max().item()
    tok = torch.as_tensor(toks, device=dev)
    ops.reset_launches()
    for i in range(prompt_len, total):
        lg, cache = M.decode_step(cfg, params, tok[:, i:i + 1], cache, i,
                                  device=dev)
        want = full[:, i].float()
        d_dec = max(d_dec, (lg[:, 0].float() - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        agree += int((lg[:, 0].float().argmax(-1) == want.argmax(-1)).sum())
    torch.cuda.synchronize()
    expect_launches(ops, {k: steps * n for k, n in per_step.items()},
                    f"{tag}: {steps} decode steps")
    del cache, full
    print(f"{tag}: {cfg.name} max|logit| {scale:.3f}; prefill of "
          f"{prompt_len} vs forward max|diff| {d_pre:.4g}; {steps} decode "
          f"steps (pos {prompt_len}..{total - 1}) vs forward max|diff| "
          f"{d_dec:.4g}; argmax agrees on {agree}/{2 * steps}", flush=True)
    # as phase_consistency argues: a fault in the hand-off (a stale conv
    # window, a wrong state, a ring slot out of place) moves logits by about
    # their own size; bf16 rounding in two flows over 48–63 blocks by a few
    # percent
    tol = scale / 8
    if not max(d_pre, d_dec) <= tol:
        fail(f"{tag}: prefill/decode differ from forward by more than "
             f"{tol:.4g}")


def phase_card_cpu(dev, arch: str, prompt_len: int, tag: str) -> None:
    """A reduced config, float32, TF32 off: the same weights through
    prefill, a decode step and `Engine.generate` on the card (kernels) and
    on the CPU (plain versions); a VLM's patch embeddings and an audio
    model's frames drawn from a seed for the prefill (the engines give
    zeros)."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(2).integers(2, cfg.vocab,
                                                (3, prompt_len))
    extra = stub_inputs(cfg, 3, prompt_len, 2, torch.float32, "cpu")
    last_c, cache_c = M.prefill(
        cfg, card, {"tokens": prompts,
                    **{k: v.to(dev) for k, v in extra.items()}}, 256,
        device=dev)
    last, cache = M.prefill(cfg, params, {"tokens": prompts, **extra}, 256,
                            device="cpu")
    nxt = last.argmax(-1)[:, None]
    pos = M.prefill_len(cfg, prompt_len)
    step_c, _ = M.decode_step(cfg, card, nxt, cache_c, pos, device=dev)
    step, _ = M.decode_step(cfg, params, nxt, cache, pos, device="cpu")
    d_pre = (last_c.cpu() - last).abs().max().item()
    d_dec = (step_c.cpu() - step).abs().max().item()
    res_c = Engine(cfg, card, max_len=256, temperature=0.7,
                   device=dev).generate(prompts, 32)
    res = Engine(cfg, params, max_len=256, temperature=0.7,
                 device="cpu").generate(prompts, 32)
    agree = int((res_c.tokens == res.tokens).sum())
    print(f"{tag}: prefill logits max|diff| {d_pre:.3g}, first decode "
          f"step {d_dec:.3g}; generate tokens equal {agree}/"
          f"{res.tokens.size}", flush=True)
    # float32 on both sides; sums in other orders over two layers move a
    # logit of size ~1 by ~1e-6
    if not max(d_pre, d_dec) <= 1e-4:
        fail("card and CPU logits differ by more than 1e-4")


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall milliseconds a call of ``fn`` (after one untimed call),
    the card synchronised around it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_relax_tail(pool, ops, dev, cfg, state) -> None:
    """Phase 26: the tail lowering on the card against the CPU, at the
    fleet's shape, from phase 4's fleet ``cfg`` and ``state``."""
    from repro_torch.core import confidence as cb
    from repro_torch.core import relax
    from repro_torch.core import rewards as R
    from repro_torch.router.local_server import LocalServer
    cpu = torch.device("cpu")
    t_row = state.t + 1.0
    mu = cb.reward_ucb(state.stats, t_row, cfg.delta, cfg.alpha_mu)
    c = cb.cost_lcb(state.stats, t_row, cfg.delta, cfg.alpha_c)
    args = (cfg.kind_ix, mu, c, cfg.n, cfg.rho)
    args_c = tuple(a.to(cpu) for a in args)
    times, launches, z = {}, {}, {}
    for name, kw in (("wide", {}),
                     ("tail-warm", {"lowering": "tail", "fw_warm": True}),
                     ("tail-cold", {"lowering": "tail", "fw_warm": False})):
        def solve(kw=kw):
            return relax.solve_batch(*args, **kw)
        times[name] = host_ms(solve)
        ops.reset_launches()
        z[name] = solve().cpu()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in ops.LAUNCHES.items() if v}
        if name != "wide":
            z_c = relax.solve_batch(*args_c, **kw)
            if not torch.equal(z[name], z_c):
                bad = torch.nonzero((z[name] != z_c).any(-1))[:, 0]
                fail(f"relax-tail: {name} z̃ differs card vs CPU on rows "
                     f"{bad[:20].tolist()}")
    # the brackets of the first LP, every kind's weights, card vs CPU
    awc = cfg.kind_ix == relax.AWC_IX
    w = torch.where((cfg.kind_ix == relax.AIC_IX)[:, None],
                    R.log_f32(torch.clamp(mu, R.EPS, 1.0)), mu)
    w = torch.where(awc[:, None],
                    R.awc_multilinear_grad(torch.zeros_like(mu), mu), w)
    rows = relax._rows(w, c, cfg.n, cfg.rho)
    got = relax._grid_tail_bracket(*rows, ~awc)
    want = relax._grid_tail_bracket(*(r.to(cpu) for r in rows), ~awc.cpu())
    for name, a, b in zip(("z", "lo", "hi"), got, want):
        if not torch.equal(a.cpu(), b):
            fail(f"relax-tail: bracket {name} differs card vs CPU")
    # the unified batch's rows against the single-kind solves
    for k in range(3):
        sel = torch.nonzero(cfg.kind_ix == k)[:, 0]
        one = relax.solve_batch(*(a[sel] for a in args), lowering="tail")
        if not torch.equal(one.cpu(), z["tail-warm"][sel.cpu()]):
            fail(f"relax-tail: kind {k}'s rows differ from the unified "
                 "batch")
    # warm against cold on the AWC rows, as the reference's test holds them
    sel = awc.cpu()
    mu_a = mu.cpu()[sel]
    obj = {n_: R.relaxed_reward("awc", z[n_][sel], mu_a)
           for n_ in ("tail-warm", "tail-cold")}
    gap = obj["tail-warm"] - obj["tail-cold"]
    same = (z["tail-warm"][sel] == z["tail-cold"][sel]).all(-1)
    dz = (z["tail-warm"] - z["wide"]).abs().max().item()
    print(f"relax-tail: {cfg.kind_ix.numel()} tenants; ms a solve "
          + ", ".join(f"{n_} {v:.2f}" for n_, v in times.items())
          + f"; launches a solve {launches}; warm - cold objective "
          f"{gap.min().item():.3g} .. {gap.max().item():.3g} (within 2e-6 "
          f"on {int((gap.abs() <= 2e-6).sum())} of {int(sel.sum())} AWC "
          f"rows, z̃ equal on {int(same.sum())}); max|tail - wide| "
          f"{dz:.3g}; brackets and z̃ card = CPU, unified = single-kind "
          f"[{card_line()}]", flush=True)
    if launches["tail-warm"] or launches["tail-cold"]:
        fail("relax-tail: the tail lowering launched a kernel")
    if gap.min().item() < -2e-4 or same.float().mean().item() < 0.9:
        fail("relax-tail: warm Frank-Wolfe parts from cold")
    # the local server on the tail lowering, card beside CPU
    pcfg = quickstart_config(pool, TAIL_ROUNDS)
    servers = [LocalServer(pcfg, device=d, lowering="tail")
               for d in (dev, "cpu")]
    rng = np.random.default_rng(0)
    worst, equal = 0.0, 0
    t0 = time.perf_counter()
    for _ in range(TAIL_ROUNDS):
        zg, zc = (s_.relaxed_selection() for s_ in servers)
        worst = max(worst, float(np.abs(zg - zc).max()))
        equal += int(np.array_equal(zg, zc))
        arm = int(rng.choice(pool.k, p=(zc + 1e-3) / (zc + 1e-3).sum()))
        reward = float(rng.uniform() < pool.mu[arm])
        cost = float(pool.mean_cost[arm] * rng.uniform(0.5, 1.5))
        for s_ in servers:
            s_.record(arm, reward, cost)
    print(f"relax-tail: LocalServer(lowering='tail') {TAIL_ROUNDS} rounds "
          f"card and CPU in {time.perf_counter() - t0:.2f} s; z̃ equal on "
          f"{equal} rounds, max|card - CPU| {worst:.3g} [{card_line()}]",
          flush=True)
    if worst > 1e-6:
        fail(f"relax-tail: the local servers part by {worst}")


def leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's path ("layers.3.attn.wq"), in `tree_leaves`' order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grad_errors(got, want) -> list:
    """Each leaf's ||got − want|| / ||want||, in fp32."""
    from repro_torch.train import optimizer as opt
    return [(g.float() - w.float()).norm().item()
            / max(w.float().norm().item(), 1e-30)
            for g, w in zip(opt.tree_leaves(got), opt.tree_leaves(want))]


def check_gradients(ops, tag: str, cfg, params, dev, plain) -> None:
    """The gradient check of phases 27–28 at GRAD_CHECK: every leaf's
    gradient through the kernels' Functions against the all-plain one
    (``plain`` a context for it), fp32 then bf16 against fp32."""
    import contextlib
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import value_and_grad
    b, s = GRAD_CHECK
    toks = SyntheticLM(DataConfig(cfg.vocab, s, b, seed=1)).batch(0)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    p32 = opt.tree_map(lambda p: p.detach().float(), params)
    grads = {}
    for name, p_, ctx in (("kernel-fp32", p32, contextlib.nullcontext()),
                          ("plain-fp32", p32, plain()),
                          ("kernel-bf16", params, contextlib.nullcontext()),
                          ("plain-bf16", params, plain())):
        with ctx:
            ops.reset_launches()
            _, _, g = value_and_grad(cfg, p_, batch, impl="naive"
                                     if name.startswith("plain") else "auto",
                                     remat=True, device=dev)
            torch.cuda.synchronize()
            used = {k: v for k, v in ops.LAUNCHES.items() if v}
        nones = [i for i, x in enumerate(opt.tree_leaves(g)) if x is None]
        if nones:
            fail(f"{tag}: {name}: leaves {nones} have no gradient")
        if name.startswith("plain") == bool(used):
            fail(f"{tag}: {name} launched {used}")
        grads[name] = g
    for layer in grads["kernel-bf16"]["layers"]:
        for w in ("wq", "wk", "wv"):
            if "attn" in layer and not layer["attn"][w].abs().max().item():
                fail(f"{tag}: a zero gradient for {w}")
    del p32
    names = leaf_names(params)
    ref = grads["plain-fp32"]
    err = {k: grad_errors(grads[k], ref) for k in ("kernel-fp32",
                                                   "kernel-bf16",
                                                   "plain-bf16")}
    i32 = int(np.argmax(err["kernel-fp32"]))
    i16 = int(np.argmax(np.asarray(err["kernel-bf16"])
                        - GRAD_BF16_RATIO * np.asarray(err["plain-bf16"])))
    print(f"{tag}: gradients at {b} x {s} against the all-plain fp32 ones, "
          f"||diff|| / ||plain|| a leaf: kernel fp32 worst "
          f"{err['kernel-fp32'][i32]:.3g} ({names[i32]}; bound "
          f"{GRAD_RTOL}); kernel bf16 worst "
          f"{max(err['kernel-bf16']):.3g}, plain bf16 worst "
          f"{max(err['plain-bf16']):.3g}; the leaf nearest its bound "
          f"{names[i16]}: kernel bf16 {err['kernel-bf16'][i16]:.3g} against "
          f"plain bf16 {err['plain-bf16'][i16]:.3g} (bound "
          f"{GRAD_BF16_RATIO} x plain + {GRAD_BF16_SLACK})", flush=True)
    if err["kernel-fp32"][i32] > GRAD_RTOL:
        fail(f"{tag}: the kernels' fp32 gradients part from the plain ones")
    if any(k > GRAD_BF16_RATIO * p + GRAD_BF16_SLACK
           for k, p in zip(err["kernel-bf16"], err["plain-bf16"])):
        fail(f"{tag}: the kernels' bf16 gradients err beyond bf16's own")


def backward_share(events, fn_name: str) -> float:
    """Device ms under the autograd Function's backward nodes (its
    recompute of the plain version and the gradient), from the profiler's
    averages."""
    return sum(getattr(e, "device_time_total", 0) for e in events
               if e.key == fn_name) / 1e3


def plain_attention_context():
    """The all-plain dense gradient needs no swap: impl "naive"."""
    import contextlib
    return contextlib.nullcontext()


def plain_ssd_context(ops):
    """A context factory swapping `ops.ssd_chunk` for its plain version
    (the all-plain SSM gradient)."""
    import contextlib
    from repro_torch.kernels import ssd_scan

    @contextlib.contextmanager
    def swapped():
        kernel = ops.ssd_chunk
        ops.ssd_chunk = ssd_scan.ssd_chunk_plain
        try:
            yield
        finally:
            ops.ssd_chunk = kernel
    return swapped


def phase_train(ops, dev, arch: str, tag: str, kernel: str, shape,
                layers: Optional[int], plain) -> dict:
    """Phases 27–28: TRAIN_STEPS AdamW steps of ``arch`` at full width
    (bf16, remat) through ``kernel``'s autograd Function; returns the
    kernel's launches in the timed steps and the steps' losses."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = full_width(arch, dev, tag, layers)
    b, s = shape
    data = SyntheticLM(DataConfig(cfg.vocab, s, b, seed=0))
    ocfg = opt.AdamWConfig(lr=TRAIN_LR[tag], warmup_steps=2,
                           total_steps=TRAIN_STEPS)
    ost = opt.init_adamw(ocfg, params)
    step = make_train_step(cfg, ocfg, impl="auto", remat=True, device=dev)
    n_kern = cfg.n_layers
    with torch.no_grad():                 # one forward: a launch a layer
        toks = data.batch(0)
        ops.reset_launches()
        M.forward(cfg, params, {"tokens": toks[:, :-1]}, device=dev)
        torch.cuda.synchronize()
        if ops.LAUNCHES[kernel] != n_kern:
            fail(f"{tag}: a forward launched {ops.LAUNCHES[kernel]} "
                 f"{kernel}, expected {n_kern}")
    losses, secs = [], []
    ops.reset_launches()
    for i in range(TRAIN_STEPS):
        toks = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, ost, m = step(params, ost, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]})
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    want = {kernel: 2 * n_kern * TRAIN_STEPS}     # forward + remat recompute
    expect_launches(ops, want, tag)
    peak = torch.cuda.max_memory_allocated() / 1e9
    spt = float(np.median(secs[1:]))
    print(f"{tag}: {TRAIN_STEPS} steps of {b} x {s} tokens, losses "
          f"{[round(x, 4) for x in losses]}; {spt:.3f} s/step (median of "
          f"steps 2..{TRAIN_STEPS}; first {secs[0]:.3f}), {b * s / spt:,.0f} "
          f"tokens/s, peak {peak:.2f} GB; {kernel} launches a step "
          f"{launches[kernel] // TRAIN_STEPS} ({n_kern} a forward, as many "
          f"again in remat's recompute) [{card_line()}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{tag}: losses {losses}")
    # one more step under the profiler: the Function backward's share
    toks = data.batch(TRAIN_STEPS)
    fn_name = {"flash_attention": "FlashAttentionFnBackward",
               "ssd_chunk": "SSDChunkFnBackward"}[kernel]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, ost, _ = step(params, ost, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3
    back = backward_share(avg, fn_name)
    print(f"{tag}: traced step: wall {wall:.1f} ms (profiler on), device "
          f"busy {busy:.1f} ms; {fn_name} (plain recompute + its gradient) "
          + (f"{back:.1f} ms, {back / busy:.4f} of busy" if back else
             "not measured (no such node in the trace)")
          + f" [{card_line()}]", flush=True)
    del ost, step
    torch.cuda.empty_cache()
    check_gradients(ops, tag, cfg, params, dev, plain)
    del params
    torch.cuda.empty_cache()
    return {kernel: launches[kernel]}, losses


def phase_serve_launch(ops, dev) -> None:
    """Phase 29: the serving launcher on the card."""
    from repro_torch.launch import serve
    from repro_torch.serving.faults import EngineCrash
    from repro_torch.serving.scheduler import ReplicaRunner
    losses, pool, injected = [], [], [0]
    make, build = serve.make_train_step, serve.build_pool
    check = ReplicaRunner._maybe_injected_crash

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(*b):
            out = step(*b)
            losses.append(float(out[2]["loss"]))
            return out
        return run

    def building(*a, **kw):
        pool.extend(build(*a, **kw))
        return pool

    def counted(self):
        try:
            check(self)
        except EngineCrash:
            injected[0] += 1
            raise
    serve.make_train_step, serve.build_pool = recording, building
    ReplicaRunner._maybe_injected_crash = counted
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        s = serve.main(SERVE_LAUNCH_ARGS, device=dev)
    finally:
        serve.make_train_step, serve.build_pool = make, build
        ReplicaRunner._maybe_injected_crash = check
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    crashes = sum(st["crashes"] for st in s["replica_stats"])
    families = [r.engine.cfg.family for r in pool]
    print(f"serve-launch: {' '.join(SERVE_LAUNCH_ARGS)}: {secs:.1f} s in "
          f"all; trained losses {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps; mean observed reward "
          f"{s['mean_observed_reward']:.4f}, violation {s['violation']:.4f}, "
          f"selections {s['selections']}, {s['rounds_per_s']:.2f} rounds/s; "
          f"crashes {crashes} contained, {injected[0]} injected; "
          f"{s['failed']} failed observations of tenant 0; replicas "
          f"{families}; launches {dict(ops.LAUNCHES)} [{card_line()}]",
          flush=True)
    if not losses or not losses[-1] < losses[0]:
        fail(f"serve-launch: the trained member's loss went {losses}")
    if crashes != injected[0]:
        fail(f"serve-launch: {crashes} crashes contained, {injected[0]} "
             "injected")
    if s["rounds"] != 30 or not np.isfinite(s["mean_cost"]):
        fail(f"serve-launch: summary {s}")
    if "ssm" not in families or not ops.LAUNCHES["ssd_chunk"]:
        fail("serve-launch: the SSM replica served nothing")
    del pool
    torch.cuda.empty_cache()


def _fleet_arrays(res) -> dict:
    """A FleetResult's logs and final state as host arrays, by name."""
    st = res.state
    out = {"reward": res.reward, "cost": res.cost, "action": res.action,
           "observed": res.observed, "prev_mask": st.prev_mask.cpu().numpy(),
           "t": st.t.cpu().numpy(), "key": st.key.cpu().numpy()}
    out.update({f"stats/{k}": v.cpu().numpy() for k, v in st.stats.items()})
    return out


def _fleet_diff(tag: str, got: dict, want: dict, t0: int,
                state: dict) -> None:
    """Fail unless ``got``'s rounds t0+1.. equal the same rounds of
    ``want`` (reward within the reference's 1e-6 caveat) and its final state
    equals ``state``'s, bit for bit."""
    t1 = t0 + got["action"].shape[1]
    for name in ("action", "observed", "cost"):
        if not np.array_equal(got[name], want[name][:, t0:t1]):
            fail(f"{tag}: {name} differs from the uninterrupted run")
    if not np.allclose(got["reward"], want["reward"][:, t0:t1], atol=1e-6,
                       rtol=0):
        fail(f"{tag}: reward differs from the uninterrupted run by more "
             "than 1e-6")
    for name in ("prev_mask", "t", "key",
                 *(k for k in state if k.startswith("stats/"))):
        if not np.array_equal(got[name], state[name]):
            fail(f"{tag}: final {name} differs from the uninterrupted run")


def _timed(store: list, fn):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out
    return run


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def phase_fleet_resume(pool, ops, dev):
    """Phase 30: kill and resume through checkpoints. Returns the
    uninterrupted run's arrays, those of its first RESUME_T // 2 rounds and
    its tenant-rounds/s (for phase 31)."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.router import fleet
    _, _, cfg = mixed_fleet(pool, TENANTS, RESUME_T, dev)
    t0 = time.perf_counter()
    full = _fleet_arrays(fleet.simulate_fleet(pool, cfg, T=RESUME_T, seed=0,
                                              device=dev))
    single_rate = TENANTS * RESUME_T / (time.perf_counter() - t0)
    half_res = fleet.simulate_fleet(pool, cfg, T=RESUME_T // 2, seed=0,
                                    device=dev)
    half = _fleet_arrays(half_res)
    saves, restores = [], []
    save, restore = checkpoint.save, checkpoint.restore
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    d = os.path.join(tmp, "ck")
    try:
        checkpoint.save = _timed(saves, save)
        checkpoint.restore = _timed(restores, restore)
        t0 = time.perf_counter()
        fleet.simulate_fleet(pool, cfg, T=RESUME_KILL, seed=0, ckpt_dir=d,
                             ckpt_every=RESUME_EVERY, device=dev)
        torch.cuda.synchronize()
        secs_killed = time.perf_counter() - t0
        steps = sorted(int(x) for x in os.listdir(d) if x.isdigit())
        if steps != list(range(RESUME_EVERY, RESUME_KILL + 1, RESUME_EVERY)):
            fail(f"fleet-resume: checkpoints at {steps}")
        nbytes = _dir_bytes(os.path.join(d, str(RESUME_T // 2)))
        shutil.rmtree(os.path.join(d, str(RESUME_KILL)))        # the kill
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fleet.simulate_fleet(pool, cfg, T=RESUME_T, seed=0, ckpt_dir=d,
                                   ckpt_every=RESUME_EVERY, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] for k in FLEET_KERNELS}
        checkpoint.save, checkpoint.restore = save, restore
        if res.t0 != RESUME_T // 2:
            fail(f"fleet-resume: resumed at round {res.t0}, expected "
                 f"{RESUME_T // 2}")
        _fleet_diff("fleet-resume", _fleet_arrays(res), full, res.t0, full)
        like = fleet._ckpt_tree(half_res.state)
        got, _ = checkpoint.restore(d, like, step=RESUME_T // 2)
        pairs = zip(checkpoint._flatten_with_paths(got),
                    checkpoint._flatten_with_paths(like))
        names = []
        for (path, a), (_, b) in pairs:
            names.append("/".join(path))
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"fleet-resume: checkpoint {RESUME_T // 2}'s "
                     f"{names[-1]} is not the uninterrupted run's")
    finally:
        checkpoint.save, checkpoint.restore = save, restore
        shutil.rmtree(tmp, ignore_errors=True)
    rounds = RESUME_T - res.t0
    want = {"topn_lp": (4 + 3 * 8) * rounds, "awc_fw": 8 * rounds}
    if launches != want:
        fail(f"fleet-resume: launches {launches}, expected {want}")
    print(f"fleet-resume: {TENANTS} mixed tenants killed at round "
          f"{RESUME_KILL} (checkpoint {RESUME_KILL} deleted), resumed at "
          f"{res.t0} to {RESUME_T}: rounds {res.t0 + 1}..{RESUME_T} and the "
          f"final state bit-equal to the uninterrupted run; checkpoint "
          f"{RESUME_T // 2} bit-equal by name ({', '.join(names)}); "
          f"{nbytes:,} bytes a checkpoint; save "
          f"{np.mean(saves) * 1e3:.2f} ms (mean of {len(saves)}), restore "
          f"{np.mean(restores) * 1e3:.2f} ms; {RESUME_KILL / secs_killed:.2f}"
          f" rounds/s checkpointing, {rounds / secs:.2f} resumed; launches "
          f"{launches} [{card_line()}]", flush=True)
    return full, half, single_rate


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def sharded_fleet_rank(m: int, T: int, every: int, ckpt_dir: str,
                       device: str) -> dict:
    """One rank of phase 31 (`spawn_local`): the tenant-sharded fleet on
    ``device``, T rounds checkpointing every ``every``; then the newest
    checkpoint deleted and the run resumed."""
    import torch.distributed as dist
    from repro_torch.env.llm_profiles import paper_pool
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.router import fleet
    dev = torch.device(device)
    pool = paper_pool("sciq")
    _, _, cfg = mixed_fleet(pool, m, RESUME_T, dev)
    mesh = make_fleet_mesh()
    out = {"axes": fleet.fleet_mesh_axes(m, mesh)}
    for tag in ("run", "resumed"):
        ops.reset_launches()
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = fleet.simulate_fleet(pool, cfg, T=T, seed=0, mesh=mesh,
                                   ckpt_dir=ckpt_dir, ckpt_every=every,
                                   device=dev)
        _sync(dev)
        out[tag] = {"secs": time.perf_counter() - t0, "t0": res.t0,
                    "launches": {k: ops.LAUNCHES[k] for k in FLEET_KERNELS},
                    **_fleet_arrays(res)}
        dist.barrier()
        if tag == "run" and dist.get_rank() == 0:
            shutil.rmtree(os.path.join(ckpt_dir, str(T)))       # the kill
    return out


def phase_fleet_sharded(ops, dev, full: dict, half: dict,
                        single_rate: float):
    """Phase 31: the fleet over SHARD_RANKS ranks sharing the card."""
    from repro_torch.launch.hostdev import spawn_local
    if dev.type == "cuda":
        ops.build(list(FLEET_KERNELS))       # built here, not raced by ranks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sharded-")
    try:
        t0 = time.perf_counter()
        recs = spawn_local(SHARD_RANKS, sharded_fleet_rank, TENANTS,
                           SHARD_ROUNDS, SHARD_EVERY,
                           os.path.join(tmp, "ck"), str(dev), timeout=600)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(r[tag]["launches"][k] for r in recs
                       for tag in ("run", "resumed")) for k in FLEET_KERNELS}
    for rank, rec in enumerate(recs):
        if rec["axes"] != ("data",):
            fail(f"fleet-sharded: rank {rank} split the tenants over "
                 f"{rec['axes']}")
        _fleet_diff(f"fleet-sharded rank {rank}", rec["run"], full, 0, half)
        if rec["resumed"]["t0"] != SHARD_ROUNDS - SHARD_EVERY:
            fail(f"fleet-sharded: rank {rank} resumed at "
                 f"{rec['resumed']['t0']}")
        _fleet_diff(f"fleet-sharded rank {rank} resumed", rec["resumed"],
                    full, SHARD_ROUNDS - SHARD_EVERY, half)
    if min(launches.values()) == 0:
        fail(f"fleet-sharded: a fleet kernel never launched: {launches}")
    rates = [TENANTS * SHARD_ROUNDS / r["run"]["secs"] for r in recs]
    print(f"fleet-sharded: {TENANTS} mixed tenants over {SHARD_RANKS} ranks "
          f"(tenant rows split on 'data'), {SHARD_ROUNDS} rounds "
          f"checkpointing every {SHARD_EVERY}, then checkpoint "
          f"{SHARD_ROUNDS} deleted and resumed at "
          f"{SHARD_ROUNDS - SHARD_EVERY}: actions, observations, costs, "
          f"stats, keys, t bit-equal to the one-process card run (reward "
          f"within 1e-6); tenant-rounds/s by rank "
          f"{[round(r, 1) for r in rates]}, one process "
          f"{single_rate:.1f}; launches (all ranks) {launches}; "
          f"{wall:.1f} s with the ranks' start [{DIST_LABEL}] "
          f"[{card_line()}]", flush=True)


def phase_train_resume(ops, dev) -> None:
    """Phase 32: `launch.train.main` killed (its newest checkpoint deleted)
    and rerun."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    saves, restores = [], []
    save, restore = checkpoint.save, checkpoint.restore
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-")
    d = os.path.join(tmp, "ck")
    args = TRAIN_RESUME_ARGS + ["--ckpt-dir", d]
    steps = int(args[args.index("--steps") + 1])
    every = int(args[args.index("--ckpt-every") + 1])
    layers = get_config(SSM_ARCH).n_layers        # one ssd_chunk a layer
    try:
        checkpoint.save = _timed(saves, save)
        checkpoint.restore = _timed(restores, restore)
        ops.reset_launches()
        t0 = time.perf_counter()
        first = train.main(args, device=dev)
        secs = time.perf_counter() - t0
        expect_launches(ops, {"ssd_chunk": layers * steps}, "train-resume")
        nbytes = _dir_bytes(os.path.join(d, str(steps)))
        on_disk = sorted(int(x) for x in os.listdir(d) if x.isdigit())
        shutil.rmtree(os.path.join(d, str(steps)))             # the kill
        ops.reset_launches()
        second = train.main(args, device=dev)
        expect_launches(ops, {"ssd_chunk": layers * every},
                        "train-resume rerun")
    finally:
        checkpoint.save, checkpoint.restore = save, restore
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"train-resume: {' '.join(TRAIN_RESUME_ARGS)}: losses "
          f"{first}, after the kill (checkpoint {steps} deleted) "
          f"{second}; checkpoints on disk {on_disk}, {nbytes:,} bytes each "
          f"(bf16 params, fp32 master, m, v); save "
          f"{[round(x, 2) for x in saves]} s, restore "
          f"{[round(x, 2) for x in restores]} s; first run {secs:.1f} s "
          f"with its saves; ssd_chunk {layers} launches a step "
          f"[{card_line()}]",
          flush=True)
    if not np.isfinite(first).all() or len(first) != steps:
        fail(f"train-resume: losses {first}")
    if second != first[steps - every:]:
        fail(f"train-resume: steps {steps - every}..{steps - 1} after the "
             f"restore gave {second}, the first run {first[steps - every:]}")


def moe_layer_inputs(cfg, b: int, s: int, seed: int, dev):
    """One MoE layer's fp32 weights and a (b, s, d_model) input, drawn on
    the card from ``seed`` (the same on every process)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import init_from_schema
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = init_from_schema(moe.moe_schema(cfg), gen, dev, "float32")
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    return p, x


def moe_ep_rank(cfg, b: int, s: int, seed: int, device: str,
                reps: int = 3):
    """One rank of phase 33 (`spawn_local`): `apply_moe_ep` on ``device``
    over a MOE_EP_MESH ("data", "model") mesh; (y, aux, ms per call, this
    rank's gradients of (y · w).sum() + aux as x and the weights, on the
    host)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    p, x = moe_layer_inputs(cfg, b, s, seed, dev)
    mesh = init_device_mesh("cpu", MOE_EP_MESH,
                            mesh_dim_names=("data", "model"))
    times = []
    with torch.no_grad():
        y, aux = moe.apply_moe_ep(cfg, p, x, mesh=mesh, batch_axes=("data",))
        for _ in range(reps):
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            moe.apply_moe_ep(cfg, p, x, mesh=mesh, batch_axes=("data",))
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    grads = moe_ep_grads(lambda p_, x_: moe.apply_moe_ep(
        cfg, p_, x_, mesh=mesh, batch_axes=("data",)), p, x, seed)
    return y.cpu().numpy(), float(aux), times, grads


def moe_ep_grads(fn, p, x, seed: int) -> list:
    """The gradients of (y · w).sum() + aux, (y, aux) = fn(p, x), as x and
    p's leaves in `moe_schema`'s order, on the host; w drawn from
    ``seed`` + 1 on x's device."""
    gen = torch.Generator(device=x.device).manual_seed(seed + 1)
    w = torch.randn(x.shape, generator=gen, device=x.device)
    ps = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xs = x.detach().clone().requires_grad_()
    y, aux = fn(ps, xs)
    return [g.cpu().numpy() for g in torch.autograd.grad(
        (y * w).sum() + aux, [xs, *ps.values()])]


def moe_ep_function(cfg, p, x, m: int):
    """The reference's EP function on one process at a no-drop capacity
    over a 1 x m mesh: `apply_moe`'s y, and the mean of the load-balance
    losses of the m sequence slices (its pmean)."""
    from repro_torch.models import moe
    y, _ = moe.apply_moe(cfg, p, x)
    s = x.shape[1]
    parts = []
    for i in range(m):
        _, idx, probs = moe.route(cfg, p, x[:, i * s // m:(i + 1) * s // m])
        parts.append(moe.load_balance_loss(cfg, probs, idx))
    return y, sum(parts) / m


def phase_moe_ep(dev) -> None:
    """Phase 33: OLMoE's MoE layer, expert-parallel over 2 ranks of the
    card, against `apply_moe` on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.hostdev import spawn_local
    from repro_torch.models import moe
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH), capacity_factor=64.0)
    b, s = MOE_EP_TOKENS
    p, x = moe_layer_inputs(cfg, b, s, 0, dev)
    m = MOE_EP_MESH[1]
    with torch.no_grad():
        y_ref, aux_one = moe.apply_moe(cfg, p, x)
        one_ms = cuda_ms(lambda: moe.apply_moe(cfg, p, x), iters=5)
        # the EP aux is the mean of each expert-axis rank's loss on its
        # sequence slice (the reference's pmean)
        aux_want = float(moe_ep_function(cfg, p, x, m)[1])
    g_ref = moe_ep_grads(lambda p_, x_: moe_ep_function(cfg, p_, x_, m), p,
                         x, 0)
    y_ref = y_ref.cpu().numpy()
    del p, x
    torch.cuda.empty_cache()
    recs = spawn_local(m * MOE_EP_MESH[0], moe_ep_rank, cfg, b, s, 0,
                       str(dev), timeout=600)
    errs = [float(np.abs(y - y_ref).max()) for y, _, _, _ in recs]
    auxes = [aux for _, aux, _, _ in recs]
    # a rank's gradients cover its own blocks: their sum is the gradient
    g_errs = [float(np.abs(sum(r[3][i] for r in recs) - g).max()
                    / max(np.abs(g).max(), 1e-30))
              for i, g in enumerate(g_ref)]
    print(f"moe-ep: {cfg.name}'s MoE layer at published widths (d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts, top {cfg.top_k}, moe_d_ff "
          f"{cfg.moe_d_ff}; fp32, TF32 off) on {b} x {s} tokens, "
          f"capacity factor 64, a {MOE_EP_MESH[0]} x {MOE_EP_MESH[1]} "
          f"('data', 'model') mesh: max|y_ep - y_apply_moe| by rank {errs} "
          f"(bound {MOE_EP_ATOL}); aux by rank {auxes}, expected "
          f"{aux_want} (one device: {float(aux_one)}); ms a call by rank "
          f"{[[round(t, 2) for t in ts] for _, _, ts, _ in recs]}, apply_moe "
          f"on one process {one_ms:.2f}; gradients of (y . w).sum() + aux "
          f"summed over the ranks against the same function on one process "
          f"(apply_moe's y, the slices' mean aux), max|diff| / max|g| for "
          f"x, router, wi_gate, wi_up, wo {[f'{e:.3g}' for e in g_errs]} "
          f"(bound {MOE_EP_GRAD_RTOL}) [{DIST_LABEL}] [{card_line()}]",
          flush=True)
    if max(errs) > MOE_EP_ATOL:
        fail(f"moe-ep: apply_moe_ep differs from apply_moe by {max(errs)}")
    if max(abs(a - aux_want) for a in auxes) > 1e-6:
        fail(f"moe-ep: aux {auxes}, expected {aux_want}")
    if max(g_errs) > MOE_EP_GRAD_RTOL:
        fail(f"moe-ep: gradients part from one process's: {g_errs}")


def one_rank_group(tmp: str) -> None:
    """A process group of this process alone on NCCL (phase 34), its
    rendezvous a file under ``tmp``."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "rendezvous"), world_size=1, rank=0)


def sharded_train(ops, dev, arch: str, tag: str, kernel: str, shape,
                  layers: Optional[int], plain_losses: list) -> dict:
    """Phase 34 for one model: ``arch`` at full width (as phases 27–28 build
    it) on the current one-rank mesh, its params and AdamW state DTensors,
    SHARDED_STEPS steps of phases 27–28's batches; the losses against
    those phases' plain-tensor steps from the same weights and batches."""
    from repro_torch import sharding
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = full_width(arch, dev, tag, layers)
    mesh = sharding.current_mesh()
    params = sharding.distribute_tree(params, M.param_axes(cfg), mesh)
    b, s = shape
    data = SyntheticLM(DataConfig(cfg.vocab, s, b, seed=0))
    ocfg = opt.AdamWConfig(lr=TRAIN_LR[tag.replace("-sharded", "")],
                           warmup_steps=2, total_steps=TRAIN_STEPS)
    ost = opt.init_adamw(ocfg, params)
    step = make_train_step(cfg, ocfg, impl="auto", remat=True, device=dev)
    losses, secs = [], []
    ops.reset_launches()
    for i in range(SHARDED_STEPS):
        toks = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, ost, m = step(params, ost, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]})
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    want = {kernel: 2 * cfg.n_layers * SHARDED_STEPS}
    placed = all(sharding.is_dtensor(t) for t in opt.tree_leaves(params)) \
        and all(sharding.is_dtensor(t) for t in opt.tree_leaves(ost["m"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    spt = float(np.median(secs[1:]))
    ref = plain_losses[:SHARDED_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    print(f"{tag}: {cfg.name} on a 1 x 1 ('data', 'model') CUDA mesh "
          f"(one-rank NCCL group), params and AdamW state DTensors "
          f"(param_axes), {SHARDED_STEPS} steps of {b} x {s} tokens: losses "
          f"{losses}, the plain-tensor steps' {ref} (max rel diff "
          f"{rel:.3g}, bound {TRAIN_LOSS_RTOL}; bit-equal "
          f"{losses == ref}); {spt:.3f} s/step (median of steps "
          f"2..{SHARDED_STEPS}; first {secs[0]:.3f}), {b * s / spt:,.0f} "
          f"tokens/s, peak {peak:.2f} GB; {kernel} launches a step "
          f"{launches[kernel] // SHARDED_STEPS} (under local_map) "
          f"[{card_line()}]", flush=True)
    expect_launches(ops, want, tag)
    if not placed:
        fail(f"{tag}: a param or moment left its mesh")
    if rel > TRAIN_LOSS_RTOL:
        fail(f"{tag}: the sharded losses part from the plain ones")
    del params, ost, step
    torch.cuda.empty_cache()
    return {kernel: launches[kernel]}


def phase_train_sharded(ops, dev, dense_losses: list,
                        ssm_losses: list) -> dict:
    """Phase 34: phases 27–28's models and batches on a one-rank CUDA mesh
    with DTensor params and state. (Two ranks sharing the card would meet
    over gloo, which does not run a DTensor step on CUDA tensors:
    `tools/gloo_cuda_probe.py`; the multi-rank step is held on the CPU.)"""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.sharding import use_mesh
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    try:
        one_rank_group(tmp)
        with use_mesh(make_cpu_mesh()):        # (1, 1) on "cuda" over NCCL
            launches = sharded_train(ops, dev, SERVE_ARCH,
                                     "train-dense-sharded", "flash_attention",
                                     TRAIN_DENSE, TRAIN_LAYERS, dense_losses)
            launches.update(sharded_train(ops, dev, SSM_ARCH,
                                          "train-ssm-sharded", "ssd_chunk",
                                          TRAIN_SSM, None, ssm_losses))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def sharded_serve(ops, dev, arch: str, tag: str, kernels: dict,
                  layers: Optional[int] = None) -> dict:
    """Phase 35 for one model at full width on the current one-rank mesh:
    a SERVE_SHARDED prefill, then SERVE_SHARDED_STEPS decode steps at each
    row's pos, first on plain tensors, then with the params DTensors placed
    by `param_axes` and the cache DTensors placed by `decode_cache_axes`,
    from the same weights and tokens; the sharded run's logits against the
    plain run's (SERVE_LOGIT_TOL), and its launches a prefill (``kernels``)
    and a decode step (one `decode_attention` an attention layer)."""
    from repro_torch import sharding
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    torch.cuda.empty_cache()
    cfg, params = full_width(arch, dev, tag, layers)
    b, s = SERVE_SHARDED
    steps = SERVE_SHARDED_STEPS
    gen = torch.Generator(device=dev).manual_seed(35)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    step_toks = torch.randint(0, cfg.vocab, (steps, b, 1), generator=gen,
                              device=dev)
    pos0 = torch.full((b,), s, dtype=torch.int32, device=dev)

    def serve(p):
        with torch.no_grad():
            ops.reset_launches()
            last, cache = M.prefill(cfg, p, {"tokens": toks}, s + steps,
                                    device=dev)
            torch.cuda.synchronize()
            pre = dict(ops.LAUNCHES)
            logits, secs = [last], []
            ops.reset_launches()
            for i in range(steps):
                t0 = time.perf_counter()
                lg, cache = M.decode_step(cfg, p, step_toks[i], cache,
                                          pos0 + i, device=dev)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                logits.append(lg[:, 0])
            dec = dict(ops.LAUNCHES)
        whole = [x.full_tensor() if sharding.is_dtensor(x) else x
                 for x in logits]
        placed = all(sharding.is_dtensor(t) for t in opt.tree_leaves(cache))
        return whole, pre, dec, secs, placed

    plain, _, _, plain_secs, _ = serve(params)
    mesh = sharding.current_mesh()
    dparams = sharding.distribute_tree(params, M.param_axes(cfg), mesh)
    torch.cuda.reset_peak_memory_stats()
    got, pre, dec, secs, placed = serve(dparams)
    peak = torch.cuda.max_memory_allocated() / 1e9
    err = max((a.float() - w.float()).abs().max().item()
              for a, w in zip(got, plain))
    bit = all(torch.equal(a, w) for a, w in zip(got, plain))
    n_attn = {"ssm": 0}.get(cfg.family, cfg.n_layers)
    want_dec = {"decode_attention": n_attn * steps} if n_attn else {}
    ms = 1e3 * float(np.median(secs[1:]))
    plain_ms = 1e3 * float(np.median(plain_secs[1:]))
    print(f"{tag}: {cfg.name} on a 1 x 1 ('data', 'model') CUDA mesh "
          f"(one-rank NCCL group), params DTensors (param_axes), cache "
          f"DTensors (decode_cache_axes): a {b} x {s} prefill then {steps} "
          f"decode steps; logits max|diff| {err:.3g} against the plain "
          f"run's (bound {SERVE_LOGIT_TOL}; bit-equal {bit}); launches a "
          f"prefill {pre}, over the steps {dec}; {ms:.3f} ms a step "
          f"(median of steps 2..{steps}; plain tensors {plain_ms:.3f}), peak "
          f"{peak:.2f} GB [{card_line()}]", flush=True)
    for name, n in kernels.items():
        if pre.get(name) != n:
            fail(f"{tag}: {pre.get(name)} {name} launches a prefill, want "
                 f"{n}")
    for name, n in want_dec.items():
        if dec.get(name) != n:
            fail(f"{tag}: {dec.get(name)} {name} launches over {steps} "
                 f"steps, want {n}")
    if not placed:
        fail(f"{tag}: a cache leaf left its mesh")
    if not err <= SERVE_LOGIT_TOL:
        fail(f"{tag}: the sharded logits part from the plain ones")
    del params, dparams
    torch.cuda.empty_cache()
    return {**pre, **{k: pre.get(k, 0) + v for k, v in dec.items()}}


def phase_serve_sharded(ops, dev) -> dict:
    """Phase 35: StarCoder2-7B at full width and Mamba2-780M whole served
    (`prefill`, `decode_step`) on a one-rank NCCL group's (1, 1) CUDA mesh
    with DTensor params and cache, held to the same models on plain
    tensors."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.sharding import use_mesh
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    try:
        one_rank_group(tmp)
        with use_mesh(make_cpu_mesh()):        # (1, 1) on "cuda" over NCCL
            launches = sharded_serve(ops, dev, SERVE_ARCH, "serve-sharded",
                                     {"flash_attention": 32})
            for k, v in sharded_serve(ops, dev, SSM_ARCH,
                                      "serve-ssm-sharded",
                                      {"ssd_chunk": 48}).items():
                launches[k] = launches.get(k, 0) + v
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


DRYRUN_SCRIPT = r"""
import json, sys, time
import torch
torch.set_num_threads(int(sys.argv[2]))
from repro_torch.launch import dryrun as D
with D.fake_group(256):
    for arch, shape in json.loads(sys.argv[1]):
        t0 = time.perf_counter()
        try:
            r = D.run_case(arch, shape, save=False, verbose=False)
            out = {"arch": arch, "shape": shape, "ok": True,
                   "flops_global": r["flops_global"], "flops": r["flops"],
                   "collective_bytes": r["collective_bytes"],
                   "counts": r["collective_counts"],
                   "argument_bytes": r["memory"]["argument_bytes"],
                   "peak_bytes": r["memory"]["peak_bytes"]}
        except Exception as e:
            out = {"arch": arch, "shape": shape, "ok": False,
                   "error": repr(e)[:600]}
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
"""


def start_dryrun() -> subprocess.Popen:
    """Phase 36's dry run, started at once in a subprocess on the CPU
    (rank 0 of a fake process group of 256, meta DTensors: it touches no
    card and is kept from it), DRYRUN_THREADS threads, while the card
    phases run; `phase_dryrun` collects it. It is killed at exit if still
    running."""
    import atexit
    cases = [(a, s) for a in DRYRUN_ARCHS for s in DRYRUN_SHAPES]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT,
                             json.dumps(cases), str(DRYRUN_THREADS)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def phase_dryrun(proc: subprocess.Popen) -> None:
    """Phase 36: the dry run's records (`launch.dryrun.run_case` on the
    pod256 mesh, one arch a family at train_4k, prefill_32k and
    decode_32k); every case must give a record with FLOPs > 0."""
    out, err = proc.communicate(timeout=900)
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for r in recs:
        if not r["ok"]:
            print(f"dryrun: FAIL {r['arch']} x {r['shape']}: {r['error']}",
                  flush=True)
            continue
        print(f"dryrun: {r['arch']} x {r['shape']} [pod256]: flops_global "
              f"{r['flops_global']:.6g}, flops a chip {r['flops']:.6g}, "
              f"collective bytes {r['collective_bytes']:.6g} "
              f"{r['counts']}, argument bytes a chip "
              f"{r['argument_bytes']:.6g}, peak {r['peak_bytes']:.6g}; "
              f"{r['s']:.1f} s", flush=True)
    want = len(DRYRUN_ARCHS) * len(DRYRUN_SHAPES)
    if proc.returncode != 0 or len(recs) != want:
        fail(f"dryrun: exited {proc.returncode} after {len(recs)} of {want} "
             f"cases: {err[-2000:]}")
    bad = [f"{r['arch']} x {r['shape']}" for r in recs
           if not (r["ok"] and r["flops_global"] > 0 and r["flops"] > 0)]
    if bad:
        fail(f"dryrun: no record with FLOPs > 0 for {bad}")
    print(f"dryrun: {want} cases on torch {torch.__version__}, "
          f"{sum(r['s'] for r in recs):.1f} s in all", flush=True)


def stamp(t_start: float, phases: str) -> None:
    """The run's elapsed seconds at the end of ``phases``."""
    print(f"time: {time.perf_counter() - t_start:.1f} s after phases "
          f"{phases}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.env.llm_profiles import paper_pool
    from repro_torch.kernels import awc_fw as awc
    from repro_torch.kernels import ops
    from repro_torch.kernels import topn_lp as topn
    from repro_torch.serving.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    dryrun = start_dryrun()
    phase_card()
    phase_build(ops)
    measured = phase_kernels(ops, topn, awc, dev)
    measured.update(phase_attention_kernels(ops, dev))
    measured.update(phase_ssd_kernel(ops, dev))
    stamp(t_start, "1-3")
    pool = paper_pool("sciq")
    fleet_cfg, fleet_state = phase_decision(pool, dev, TENANTS,
                                            DECISION_ROUNDS)
    cfg, state = fleet_cfg, fleet_state
    launches = phase_fleet(pool, ops, dev, TENANTS, ROUNDS)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    phase_profile(pool, dev, cfg, state, PROFILE_ROUNDS)
    phase_quickstart(pool, ops, dev, QUICKSTART_ROUNDS)
    phase_baselines(pool, ops, dev, BASELINE_ROUNDS)
    phase_per_seed(pool, ops, dev, PER_SEED, PER_SEED_ROUNDS)
    phase_protocol(pool, ops, dev)
    small_cfg, small = full_width(SERVE_ARCH, dev, "service", PROTOCOL_LAYERS)
    eng = Engine(small_cfg, small, max_len=64, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    phase_service(pool, ops, dev, eng, small_cfg)
    cfg, params = full_width(SERVE_ARCH, dev, "serve")
    phase_driven_fleet(pool, ops, dev, cfg, params)
    phase_chaos(pool, ops, dev, eng, small_cfg)
    stamp(t_start, "4-7g")
    del eng, small
    serve_launches, params, cfg = phase_serve(ops, dev, SERVE_ARCH, "serve",
                                              SERVE_TRAFFIC,
                                              built=(cfg, params))
    for name in ("flash_attention", "decode_attention"):
        if serve_launches[name] == 0:
            fail(f"{name} never launched on the serving path")
    launches.update({k: serve_launches[k] for k in ("flash_attention",
                                                    "decode_attention")})
    phase_consistency(ops, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, SERVE_ARCH, 200, "card-cpu")
    phase_window(ops, dev)
    ssm_launches, params, cfg = phase_serve(ops, dev, SSM_ARCH, "serve-ssm",
                                            LONG_TRAFFIC)
    if ssm_launches["ssd_chunk"] == 0:
        fail("ssd_chunk never launched on the SSM serving path")
    launches["ssd_chunk"] = ssm_launches["ssd_chunk"]
    phase_ssm_consistency(ops, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, SSM_ARCH, 64, "ssm-card-cpu")
    moe_launches, params, cfg = phase_serve(ops, dev, MOE_ARCH, "serve-moe",
                                            SERVE_TRAFFIC)
    for name in ("flash_attention", "decode_attention"):
        if moe_launches[name] == 0:
            fail(f"{name} never launched on the MoE serving path")
    phase_moe_determinism(params, cfg, dev)
    phase_consistency(ops, params,
                      dataclasses.replace(cfg, capacity_factor=64.0), dev,
                      "moe-consistency", prompt_len=512)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, MOE_ARCH, 200, "moe-card-cpu")
    hybrid_launches, params, cfg = phase_serve(ops, dev, HYBRID_ARCH,
                                               "serve-hybrid", LONG_TRAFFIC)
    for name in ("ssd_chunk", "flash_attention", "decode_attention"):
        if hybrid_launches[name] == 0:
            fail(f"{name} never launched on the hybrid serving path")
    phase_ssm_consistency(ops, params, cfg, dev, "hybrid-consistency",
                          prompt_len=4096, steps=256)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, HYBRID_ARCH, 64, "hybrid-card-cpu")
    audio_launches, params, cfg = phase_serve(ops, dev, AUDIO_ARCH,
                                              "serve-audio", AUDIO_TRAFFIC)
    for name in ("flash_attention", "decode_attention"):
        if audio_launches[name] == 0:
            fail(f"{name} never launched on the audio serving path")
    phase_consistency(ops, params, cfg, dev, "audio-consistency",
                      prompt_len=64)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, AUDIO_ARCH, 64, "audio-card-cpu")
    vlm_launches, params, cfg = phase_serve(ops, dev, VLM_ARCH, "serve-vlm",
                                            SERVE_TRAFFIC, layers=VLM_LAYERS)
    for name in ("flash_attention", "decode_attention"):
        if vlm_launches[name] == 0:
            fail(f"{name} never launched on the VLM serving path")
    phase_consistency(ops, params, cfg, dev, "vlm-consistency",
                      prompt_len=1024)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, VLM_ARCH, 200, "vlm-card-cpu")
    stamp(t_start, "8-25")
    phase_relax_tail(pool, ops, dev, fleet_cfg, fleet_state)
    _, dense_losses = phase_train(ops, dev, SERVE_ARCH, "train-dense",
                                  "flash_attention", TRAIN_DENSE,
                                  TRAIN_LAYERS, plain_attention_context)
    _, ssm_losses = phase_train(ops, dev, SSM_ARCH, "train-ssm", "ssd_chunk",
                                TRAIN_SSM, None, plain_ssd_context(ops))
    phase_serve_launch(ops, dev)
    stamp(t_start, "26-29")
    full, half, single_rate = phase_fleet_resume(pool, ops, dev)
    phase_fleet_sharded(ops, dev, full, half, single_rate)
    phase_train_resume(ops, dev)
    phase_moe_ep(dev)
    stamp(t_start, "30-33")
    sharded = phase_train_sharded(ops, dev, dense_losses, ssm_losses)
    for name, n in sharded.items():
        if n == 0:
            fail(f"{name} never launched on the sharded training path")
    stamp(t_start, "34")
    served = phase_serve_sharded(ops, dev)
    for name in ("flash_attention", "decode_attention", "ssd_chunk"):
        if not served.get(name):
            fail(f"{name} never launched on the sharded serving path")
    stamp(t_start, "35")
    phase_dryrun(dryrun)
    stamp(t_start, "36")

    kernels = []
    for name, mod in ops.KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": str(mod.SOURCE.relative_to(ROOT)),
                        "replaces": mod.REPLACES,
                        "launches": launches[name],
                        **{"library_ms": None, **measured[name]}})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
