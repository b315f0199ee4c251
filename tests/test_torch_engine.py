"""The port's sampling and serving engine against the JAX package, on the
CPU.

* `prng.gumbel` evaluates its two logs in float64 and rounds once (so the
  card and the CPU draw the same noise). XLA's float32 log on the CPU is not
  correctly rounded — it is an ulp off on about one input in seven — so the
  draws are held to atol 1e-6 + rtol 2.4e-7 (two ulps of the value), not
  bit for bit. `prng.categorical`, an argmax over logits + noise, is held
  bit-equal to `jax.random.categorical` over a grid of keys and shapes.
* `Engine.generate` on the reduced StarCoder2 with JAX's weights: tokens
  and `out_lens` equal to JAX's `Engine.generate`, logprobs within 1e-5. If
  a token differs, the test shows that the two candidates' sampling scores
  lay within the logits' tolerance (2e-5, `tests/test_torch_model.py`)
  scaled by 1/temperature, and compares the streams up to that step only.
* The slot API (two prefill/admit batches at different prompt lengths,
  decode chunks, release) gives each request, bit for bit, what `generate`
  gives for that request alone, as `tests/test_engine.py` pins for JAX.
* Both again for the reduced OLMoE (the MoE family) at its configs'
  capacity factor: dispatch is grouped by batch row, so a slot's tokens
  never compete with another slot's for an expert's capacity.
* Both again for the reduced Zamba2 (the hybrid family) at 4 layers, two
  groups each with its own shared-attention ring cache of 64 slots;
  `generate` from prompts of 64 tokens (two SSD chunks), so every decode
  step's attention wraps the ring.
* Both again for the reduced Qwen2-VL (the VLM family: zero patch
  embeddings, 1/8 of the prompt, ahead of the text, so decoding starts at
  `prefill_len`) and the reduced Whisper (the audio family) with engines of
  `enc_frames` 64, as JAX's tests size the stub frames: the slot cache's
  cross K/V have 64 slots, and `admit` writes a prefill's into them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.serving import engine as jengine
from repro_torch import convert, prng
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.serving import engine

torch.set_num_threads(1)
LOGIT_TOL = 2e-5
MAX_LEN = 64
ENC_FRAMES = 64          # the audio engines' stub frames


def row_keys(seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(keys), convert.key_rows(np.asarray(keys), "cpu")


@pytest.mark.parametrize("seed,rows,shape", [(0, 1, (7,)), (1, 4, (3, 5)),
                                             (2, 16, (512,)),
                                             (3, 2, (49152,))])
def test_gumbel_matches_jax_to_two_ulps(seed, rows, shape):
    jkeys, keys = row_keys(seed, rows)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(jkeys))
    got = prng.gumbel(keys, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.4e-7)


@pytest.mark.parametrize("seed,rows,vocab", [(0, 64, 8), (1, 64, 512),
                                             (2, 8, 49152)])
def test_categorical_is_bit_equal_to_jax(seed, rows, vocab):
    jkeys, keys = row_keys(seed, rows)
    logits = np.random.default_rng(seed).standard_normal(
        (rows, vocab), dtype=np.float32) * 3
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                       jnp.asarray(logits)))
    got = prng.categorical(keys, torch.tensor(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold_in_takes_one_datum_per_row():
    jkeys, keys = row_keys(4, 5)
    data = np.array([0, 1, 7, 2 ** 31 + 3, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jkeys, data))
    got = prng.fold_in(keys, torch.tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(convert.key_rows_to_numpy(got), want)


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_sample_matches_jax(temperature):
    jkeys, keys = row_keys(5, 6)
    last = np.random.default_rng(6).standard_normal((6, 512),
                                                    dtype=np.float32)
    jtok, jchosen = jengine._sample(jnp.asarray(jkeys), jnp.asarray(last),
                                    temperature, 1)
    tok, chosen = engine._sample(keys, torch.tensor(last), temperature)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(chosen.numpy(), np.asarray(jchosen),
                               atol=1e-5, rtol=0)


def reduced_pair(arch, **changes):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch`` reduced,
    with ``changes`` to its fields, JAX's weights."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def engines():
    """The reduced StarCoder2."""
    return reduced_pair("starcoder2-7b")


@pytest.fixture(scope="module")
def moe_engines():
    """The reduced OLMoE."""
    return reduced_pair("olmoe-1b-7b")


@pytest.fixture(scope="module")
def hybrid_engines():
    """The reduced Zamba2 at 4 layers: two groups of the shared block."""
    return reduced_pair("zamba2-2.7b", n_layers=4)


@pytest.fixture(scope="module")
def vlm_engines():
    """The reduced Qwen2-VL."""
    return reduced_pair("qwen2-vl-72b")


@pytest.fixture(scope="module")
def audio_engines():
    """The reduced Whisper (engines at `ENC_FRAMES` frames)."""
    return reduced_pair("whisper-large-v3")


def first_difference(a, b):
    """(row, step) of the first differing token, or None."""
    diff = np.argwhere(a != b)
    if not len(diff):
        return None
    step = diff[:, 1].min()
    return int(diff[diff[:, 1] == step][0, 0]), int(step)


def stub_inputs(cfg, prompts):
    """The zero patch embeddings or frames an engine gives ``prompts``."""
    b, s = prompts.shape
    if cfg.family == "vlm":
        return {"vision_embeds": np.zeros(
            (b, max(s // M.VLM_VISION_FRACTION, 1), cfg.d_model), np.float32)}
    if cfg.family == "audio":
        return {"frames": np.zeros((b, ENC_FRAMES, cfg.d_model), np.float32)}
    return {}


def port_scores(cfg, params, prompts, tokens, row, step, seed, temperature):
    """The port's sampling scores (logits / T + Gumbel noise) for ``row``
    at ``step``, on the shared prefix ``tokens[:, :step]``."""
    ext = np.concatenate([prompts, tokens[:, :step]], axis=1)
    logits, _ = M.forward(cfg, params, {"tokens": ext,
                                        **stub_inputs(cfg, prompts)},
                          device="cpu")
    base = prng.PRNGKey(seed, device="cpu")
    key = prng.fold_in(prng.fold_in(base, row), step)
    lg = logits[row, -1].float() / max(temperature, 1e-4)
    return (lg + prng.gumbel(key, lg.shape)).numpy()


def check_generate(engines, temperature, prompt_len=10):
    jcfg, jparams, cfg, params = engines
    prompts = np.random.default_rng(7).integers(2, cfg.vocab,
                                                (3, prompt_len)
                                                ).astype(np.int32)
    max_new, seed = 12, 5
    want = jengine.Engine(jcfg, jparams, max_len=MAX_LEN,
                          temperature=temperature,
                          enc_frames=ENC_FRAMES).generate(prompts, max_new,
                                                          seed=seed)
    got = engine.Engine(cfg, params, max_len=MAX_LEN,
                        temperature=temperature, enc_frames=ENC_FRAMES,
                        device="cpu").generate(prompts, max_new, seed=seed)
    at = first_difference(got.tokens, want.tokens)
    if at is None:
        np.testing.assert_array_equal(got.out_lens, want.out_lens)
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-5,
                                   rtol=0)
        return
    row, step = at
    scores = port_scores(cfg, params, prompts, want.tokens, row, step, seed,
                         temperature)
    gap = scores[got.tokens[row, step]] - scores[want.tokens[row, step]]
    assert 0 <= gap <= 2 * LOGIT_TOL / max(temperature, 1e-4), (at, gap)
    np.testing.assert_array_equal(got.tokens[:, :step],
                                  want.tokens[:, :step])


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_generate_matches_reference(engines, temperature):
    check_generate(engines, temperature)


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_moe_generate_matches_reference(moe_engines, temperature):
    check_generate(moe_engines, temperature)


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_hybrid_generate_matches_reference(hybrid_engines, temperature):
    check_generate(hybrid_engines, temperature, prompt_len=64)


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_vlm_generate_matches_reference(vlm_engines, temperature):
    check_generate(vlm_engines, temperature)


@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_audio_generate_matches_reference(audio_engines, temperature):
    check_generate(audio_engines, temperature)


def harvest(state, slots, max_new):
    slots = torch.tensor(slots)
    n_out = state.n_out[slots]
    return engine.GenResult(
        state.out[slots, :max_new].numpy(), n_out.numpy(),
        (state.lp_sum[slots] / torch.clamp(n_out, min=1).float()).numpy())


def check_slots(engines):
    _, _, cfg, params = engines
    eng = engine.Engine(cfg, params, max_len=MAX_LEN, temperature=0.7,
                        enc_frames=ENC_FRAMES, device="cpu")
    rng = np.random.default_rng(8)
    req_a = dict(prompts=rng.integers(2, cfg.vocab, (2, 6)).astype(np.int32),
                 max_new=10, seed=11, slots=[0, 1])
    req_b = dict(prompts=rng.integers(2, cfg.vocab, (2, 9)).astype(np.int32),
                 max_new=8, seed=12, slots=[4, 6])
    state = eng.init_slots(8, max_out=12)
    for req, chunk in ((req_a, 3), (req_b, 12)):
        lg, sl = eng.prefill(req["prompts"])
        state = eng.admit(state, req["slots"], lg, sl,
                          prompt_len=req["prompts"].shape[1],
                          max_new=req["max_new"], seed=req["seed"])
        state = eng.decode_chunk(state, chunk)
    for req in (req_a, req_b):
        got = harvest(state, req["slots"], req["max_new"])
        want = eng.generate(req["prompts"], req["max_new"], seed=req["seed"])
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.out_lens, want.out_lens)
        np.testing.assert_array_equal(got.logprobs, want.logprobs)
    state = eng.release(state, req_a["slots"] + req_b["slots"])
    assert not state.active.any()


def test_slot_api_matches_generate_per_request(engines):
    check_slots(engines)


def test_moe_slot_api_matches_generate_per_request(moe_engines):
    check_slots(moe_engines)


def test_hybrid_slot_api_matches_generate_per_request(hybrid_engines):
    check_slots(hybrid_engines)


def test_vlm_slot_api_matches_generate_per_request(vlm_engines):
    check_slots(vlm_engines)


def test_audio_slot_api_matches_generate_per_request(audio_engines):
    """The slot cache's cross K/V at the engine's 64 frames."""
    _, _, cfg, params = audio_engines
    state = engine.Engine(cfg, params, enc_frames=ENC_FRAMES,
                          device="cpu").init_slots(3)
    assert tuple(state.cache["cross"]["k"].shape) == (
        cfg.n_layers, 3, ENC_FRAMES, cfg.n_kv_heads, cfg.head_dim)
    check_slots(audio_engines)


def test_admit_checks_are_real_exceptions(engines):
    _, _, cfg, params = engines
    eng = engine.Engine(cfg, params, max_len=16, device="cpu")
    state = eng.init_slots(2, max_out=8)
    lg, sl = eng.prefill(np.full((1, 10), 3, np.int32))
    with pytest.raises(ValueError, match="out buffer"):
        eng.admit(state, [0], lg, sl, prompt_len=10, max_new=9, seed=0)
    with pytest.raises(ValueError, match="max_len"):
        eng.admit(state, [0], lg, sl, prompt_len=10, max_new=7, seed=0)
