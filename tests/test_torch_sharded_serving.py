"""The port's sharded serving (`models.model.decode_cache_axes`,
`init_decode_caches(..., mesh=)`, the prefill's `shard` sites, the cache
writes under `local_map`, and `ops.decode_attention` of a cache split over
"cache_seq" through `decode_attention_lse` and `merge_partials`) against
the JAX package, on the CPU.

* `decode_cache_axes`, `attention.cache_axes` and `ssm.ssm_cache_axes`
  against JAX's `init_decode_caches` axes and the two functions, for all
  10 archs (and the cache's shapes, at the reduced sizes).
* The prefill's `shard` sites, JAX's (`model.py:273, 338`, `blocks.py:92,
  105, 112, 127`, `attention.py:234-237`, `ssm.py:172`, and the forward's
  where an audio prefill runs its encoder), in order, each returning its
  input unchanged without a mesh.
* `decode_attention_lse_plain` over m = 2 and 4 blocks of T at each
  block's local pos, then `merge_partials` without a group, against
  `decode_attention_plain` on the whole cache at 1e-5 (fp32) and 2e-2
  (bf16, one more rounding of each block's output), with random per-row
  pos and -1 (no slot: the plain mean of v), T - 1, pos past T (a frozen
  row, or a wrapped ring's raw pos) among them; a block past a row's pos
  gets lse -inf.
* One spawn of 2 × 2 gloo ranks (`tests/_torch_dist.py:sharded_serving`):
  `prefill` of a 32-token prompt and 4 `decode_step`s at per-row pos (one
  row reaching T, frozen) of the six reduced families (StarCoder2,
  Mamba2, OLMoE at the no-drop capacity 64, Zamba2, Qwen2-VL, Whisper over
  64 frames), with JAX's weights placed by `param_axes` and the cache by
  `decode_cache_axes` (its T = 64 slots split over "model"), against JAX's
  one-device `prefill` and `decode_step`: logits and the final cache at
  atol = rtol = 2e-5, `tests/test_torch_engine.py`'s logit tolerance. The
  T-split is asserted: each rank makes one `decode_attention_lse` call an
  attention layer a step.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import convert, sharding
from repro_torch.configs.base import get_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.launch.hostdev import spawn_local
from repro_torch.models import attention, blocks, ssm
from repro_torch.models import model as M

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, MAX_LEN, FRAMES, STEPS = 4, 32, 64, 64, 4
FAMILIES = {"dense": "starcoder2-7b", "ssm": "mamba2-780m",
            "moe": "olmoe-1b-7b", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-large-v3"}
ATTN_FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat(t, prefix + (i,)).items()}
    return {prefix: tree}


# ================================================================ cache axes
def test_cache_axes_functions_are_the_reference():
    assert attention.cache_axes() == jattn.cache_axes()
    assert ssm.ssm_cache_axes() == jssm.ssm_cache_axes()


@pytest.mark.parametrize("arch", list_archs())
def test_decode_cache_axes_and_shapes_are_the_reference(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jcache, jaxes = JM.init_decode_caches(jcfg, 2, 48, jnp.bfloat16,
                                          abstract=True)
    axes = M.decode_cache_axes(cfg)
    assert _flat(axes) == {k: tuple(v) for k, v in _flat(
        jax.tree.map(tuple, jaxes, is_leaf=lambda x: isinstance(x, tuple))
    ).items()}
    cache = M.init_decode_caches(cfg, 2, 48, torch.bfloat16, device="cpu",
                                 enc_frames=JM.WHISPER_ENC_FRAMES)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(cache).items()}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(
        jax.tree.map(lambda a: a, jcache)).items()}
    assert got == want
    assert set(_flat(axes)) == set(_flat(cache))


# ================================================================ shard sites
BSE = ("batch", "seq", "embed")
Q = ("batch", "seq", "heads", None)
K = ("batch", "seq", "kv_heads", None)
XH = ("batch", "seq", "ssm_heads", None)


def _expected_sites(cfg):
    """JAX's `shard` sites a prefill passes, in order."""
    layers = cfg.n_layers
    if cfg.family in ("dense", "vlm", "moe"):
        return [BSE] + [Q, K, Q, BSE] * layers
    if cfg.family == "ssm":
        return [BSE] + [XH, BSE] * layers
    if cfg.family == "hybrid":
        period = cfg.shared_attn_period
        return [BSE] + ([Q, K, Q, BSE] + [XH, BSE] * period) * (
            layers // period)
    # audio: the encoder's forward sites, then the decoder's, each layer's
    # self-attention prefill and cross-attention
    return ([BSE] + [Q, K, Q, BSE] * cfg.n_enc_layers + [BSE]
            + [Q, K, Q, Q, K, Q, BSE] * layers)


def _inputs(cfg, seed, s=S, b=B):
    rng = np.random.default_rng(seed)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        n_vis = M.prefill_len(cfg, s) - s
        inputs["vision_embeds"] = rng.standard_normal(
            (b, n_vis, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        inputs["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return inputs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_shard_sites_are_the_reference_and_no_ops(family,
                                                          monkeypatch):
    cfg = get_config(FAMILIES[family]).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    inputs = _inputs(cfg, 1, s=8, b=2)
    want_logits, want_cache = M.prefill(cfg, params, inputs, 16,
                                        device="cpu")
    seen = []
    real = sharding.shard

    def recording(x, *logical):
        out = real(x, *logical)
        assert out is x                 # no mesh: the input itself
        seen.append(tuple(logical))
        return out
    for mod in (sharding, attention, blocks, ssm):
        monkeypatch.setattr(mod, "shard", recording)
    logits, cache = M.prefill(cfg, params, inputs, 16, device="cpu")
    assert seen == _expected_sites(cfg)
    assert torch.equal(logits, want_logits)
    for k, v in _flat(cache).items():
        assert torch.equal(v, _flat(want_cache)[k]), k


# ====================================================== split and merge
def _split_case(seed, dtype, t=64, b=8, h=4, kv=2, hd=16):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, hd), generator=gen).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen).to(dtype)
    pos = torch.randint(0, t, (b,), generator=gen, dtype=torch.int32)
    # no slot; the last slot; past T (a frozen row, a wrapped ring's raw
    # pos); the first slot
    pos[:4] = torch.tensor([-1, t - 1, t + 37, 0])
    return q, k, v, pos


def _split_merge(q, k, v, pos, m):
    t = k.shape[1]
    t_l = t // m
    outs, lses = [], []
    for r in range(m):
        lp = (torch.clamp(pos, max=t - 1) - r * t_l).clamp(-1, t_l - 1)
        o, lse = dec.decode_attention_lse_plain(
            q, k[:, r * t_l:(r + 1) * t_l], v[:, r * t_l:(r + 1) * t_l], lp)
        outs.append(o)
        lses.append(lse)
    return dec.merge_partials(torch.stack(outs), torch.stack(lses)), lses


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_split_and_merge_is_the_whole_cache(m, dtype, tol):
    q, k, v, pos = _split_case(10 + m, dtype)
    got, lses = _split_merge(q, k, v, pos, m)
    want = dec.decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=0)
    # pos -1: no slot on any block, the whole call's mean of v
    vm = v.float().mean(1).repeat_interleave(q.shape[2] // k.shape[2], 1)
    np.testing.assert_allclose(got[0, 0].float().numpy(), vm[0].numpy(),
                               atol=tol, rtol=0)
    t_l = k.shape[1] // m
    for r, lse in enumerate(lses):
        past = torch.clamp(pos, max=k.shape[1] - 1) < r * t_l
        assert torch.isneginf(lse[past]).all()
        assert torch.isfinite(lse[~past]).all()


def test_lse_is_the_log_sum_exp_of_the_valid_scores():
    q, k, v, pos = _split_case(3, torch.float32)
    o, lse = dec.decode_attention_lse_plain(q, k, v, pos)
    assert torch.equal(o, dec.decode_attention_plain(q, k, v, pos))
    assert lse.shape == (q.shape[0], q.shape[2]) and lse.dtype == \
        torch.float32
    n_rep = q.shape[2] // k.shape[2]
    for b in range(q.shape[0]):
        last = min(int(pos[b]), k.shape[1] - 1)
        for h in range(q.shape[2]):
            if last < 0:
                assert torch.isneginf(lse[b, h])
                continue
            sc = (k[b, :last + 1, h // n_rep].double()
                  @ q[b, 0, h].double()) / np.sqrt(q.shape[3])
            np.testing.assert_allclose(float(lse[b, h]),
                                       float(torch.logsumexp(sc, 0)),
                                       rtol=1e-6)


# ============================================================ 2 × 2 ranks
def _pos_rows(p, t):
    """Per-row pos of each step: rows at the prompt's end, behind it, ahead
    of it, and one that reaches T (its last step frozen)."""
    start = np.array([p, p - 7, p + 9, t - STEPS + 1], np.int32)
    return [start + i for i in range(STEPS)]


def _reference(jcfg, jparams, inputs, toks, poss):
    """JAX's one-device prefill and decode steps (jitted): the logits and
    the final cache."""
    prefill = jax.jit(JM.prefill, static_argnums=(0, 3))
    step = jax.jit(JM.decode_step, static_argnums=0)
    last, cache = prefill(jcfg, jparams, {k: jnp.asarray(v)
                                          for k, v in inputs.items()},
                          MAX_LEN)
    logits = [np.asarray(last)]
    for tok, pos in zip(toks, poss):
        lg, cache = step(jcfg, jparams, jnp.asarray(tok), cache,
                         jnp.asarray(pos))
        logits.append(np.asarray(lg)[:, 0])
    return logits, jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def served():
    """One spawn of 2 × 2 gloo ranks, and JAX's one-device prefill and
    decode steps beside it (in this process while the ranks run)."""
    init = jax.jit(JM.init_params, static_argnums=0)
    cases, refs = [], []
    for family, arch in FAMILIES.items():
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        cf = 64.0 if family == "moe" else None
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        jparams = init(jcfg, jax.random.PRNGKey(0))
        params = convert.params_from_jax(cfg, jax.tree.map(np.asarray,
                                                           jparams),
                                         device="cpu")
        inputs = _inputs(cfg, 30)
        rng = np.random.default_rng(31)
        toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                for _ in range(STEPS)]
        poss = _pos_rows(M.prefill_len(cfg, S), MAX_LEN)
        cases.append((arch, cf, params, inputs, MAX_LEN, toks, poss))
        refs.append((jcfg, jparams, inputs, toks, poss))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_local, 4, _torch_dist.sharded_serving,
                            cases, timeout=150)
        want = {family: _reference(*ref)
                for family, ref in zip(FAMILIES, refs)}
        return {"ranks": ranks.result(), "want": want}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_prefill_and_decode_match_the_reference(served, family):
    logits, cache = served["want"][family]
    i = list(FAMILIES).index(family)
    for r in served["ranks"]:
        got = r["cases"][i]
        assert got["arch"] == FAMILIES[family] and got["dtensor"]
        assert len(got["logits"]) == STEPS + 1
        for n, (a, w) in enumerate(zip(got["logits"], logits)):
            np.testing.assert_allclose(a, w, err_msg=f"logits {n}", **TOL)
        flat = _flat(got["cache"])
        want = _flat(cache)
        assert set(flat) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(flat[k], w, err_msg=str(k), **TOL)


def test_decode_splits_the_cache_over_cache_seq(served):
    for r in served["ranks"]:
        for family, got in zip(FAMILIES, r["cases"]):
            pl = _flat(got["placements"])
            cfg = get_config(FAMILIES[family]).reduced()
            n_attn = {"hybrid": cfg.n_layers // max(cfg.shared_attn_period,
                                                    1),
                      "audio": 2 * cfg.n_layers}.get(family, cfg.n_layers)
            if family not in ATTN_FAMILIES:
                assert got["lse_calls"] == 0
                assert pl[("ssm", "state")] == "S(1) S(2)"
                continue
            # (layers, B, T, KV, hd): B over "data", T over "model"
            for k, p in pl.items():
                if k[-1] in ("k", "v"):
                    assert p == "S(1) S(2)", (family, k, p)
            assert got["lse_calls"] == n_attn * STEPS, family
