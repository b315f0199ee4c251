"""The port's Mamba2 path (`repro_torch.models.ssm`, the SSM family of
`models.model`, `Engine` over it, and the `ssd_chunk` kernel's plain
version) against the JAX package, on the CPU, with JAX's own weights
carried across by `convert.params_from_jax`.

Tolerances:

* `ssd_chunk_plain` against `repro.kernels.ref.ssd_chunk` (and the Pallas
  kernel in interpret mode) at atol 1e-4, `tests/test_kernels.py`'s own.
* Everything else in float32 at atol = rtol = 2e-5 (`tests/
  test_torch_model.py`'s tolerance): both sides compute the same sums in
  other orders; the chunked form against a float64 sequential recurrence
  at the same 2e-5.
* One decode step after prefill against `forward` on the extended sequence
  at 2e-3, as `tests/test_torch_model.py` holds the dense family.
* `apply_ssm` in bfloat16 at atol 2e-2, `tests/test_kernels.py`'s bf16
  tolerance (five bf16 ulps of outputs below 1; the two differ by about
  one): JAX forms C Bᵀ in bf16 and rounds at other places than the port,
  which forms it in fp32 as the kernel does (`models/ssm.py`'s docstring).
* `Engine.generate` token for token against JAX's; the slot API bit for bit
  against `generate` per request.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.serving import engine

torch.set_num_threads(1)
ARCH = "mamba2-780m"
TOL = dict(atol=2e-5, rtol=2e-5)
B, MAX_LEN = 2, 128


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced Mamba2:
    d_model 256, d_inner 512, 16 heads of head_dim 32, state 16, chunk 32."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


# ============================================================ ssd_chunk
def chunk_inputs(b, nc, l, h, p, n, seed, slope=0.1):
    """tests/test_kernels.py's recipe from a numpy seed: xd, bm, cm normal,
    acum the cumulative sum of -|normal| * slope along the chunk."""
    rng = np.random.default_rng(seed)
    xd = rng.standard_normal((b, nc, l, h, p), dtype=np.float32)
    a = -np.abs(rng.standard_normal((b, nc, l, h), dtype=np.float32)) * slope
    acum = np.cumsum(a, axis=2, dtype=np.float32)
    bm = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    cm = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    return xd, acum, bm, cm


@pytest.mark.parametrize("b,nc,l,h,p,n", [(1, 2, 32, 2, 16, 8),
                                          (2, 4, 64, 4, 32, 16),
                                          (1, 1, 128, 8, 64, 64)])
def test_ssd_chunk_plain_matches_reference(b, nc, l, h, p, n):
    args = chunk_inputs(b, nc, l, h, p, n, seed=l + h)
    y, st = ssd_scan.ssd_chunk_plain(*map(t, args))
    wy, wst = jref.ssd_chunk(*map(jnp.asarray, args))
    assert y.shape == (b, nc, l, h, p) and st.shape == (b, nc, h, p, n)
    assert y.dtype == st.dtype == torch.float32
    close(y, wy, dict(atol=1e-4))
    close(st, wst, dict(atol=1e-4))


def test_ssd_chunk_plain_matches_the_pallas_kernel():
    """The Pallas kernel itself, in interpret mode, at the smallest shape."""
    args = chunk_inputs(1, 2, 32, 2, 16, 8, seed=3)
    y, st = ops.ssd_chunk(*map(t, args))          # CPU: the plain version
    wy, wst = jops.ssd_chunk(*map(jnp.asarray, args))
    close(y, wy, dict(atol=1e-4))
    close(st, wst, dict(atol=1e-4))
    assert ops.LAUNCHES["ssd_chunk"] == 0


def test_ssd_chunk_plain_steep_decay_stays_finite():
    """acum falling by ~30 a row: exp(acum_i - acum_j) above the diagonal
    overflows to inf, which a multiply by the mask would turn into NaN. The
    plain version selects it away and matches a float64 evaluation."""
    xd, acum, bm, cm = chunk_inputs(1, 2, 64, 3, 16, 8, seed=4, slope=30.0)
    with np.errstate(over="ignore"):           # above the diagonal: inf
        assert np.isinf(np.exp(acum[0, 0, 0, 0] - acum[0, 0, -1, 0]))
    y, st = ssd_scan.ssd_chunk_plain(*map(t, (xd, acum, bm, cm)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    a64 = acum.astype(np.float64)
    diff = a64[:, :, :, None, :] - a64[:, :, None, :, :]
    lmat = np.where(np.tril(np.ones((64, 64), bool))[None, None, :, :, None],
                    np.exp(np.minimum(diff, 0.0)), 0.0)
    cb = np.einsum("bcin,bcjn->bcij", cm.astype(np.float64), bm)
    want_y = np.einsum("bcij,bcijh,bcjhp->bcihp", cb, lmat, xd)
    want_st = np.einsum("bcln,bclh,bclhp->bchpn", bm,
                        np.exp(a64[:, :, -1:, :] - a64), xd)
    close(y, want_y, dict(atol=1e-4))
    close(st, want_st, dict(atol=1e-4))


# ============================================================ ssd_chunked
def chunked_inputs(s, seed, b=2, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.abs(rng.standard_normal((h,), dtype=np.float32))
    bmat = rng.standard_normal((b, s, n), dtype=np.float32)
    cmat = rng.standard_normal((b, s, n), dtype=np.float32)
    init = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt, a, bmat, cmat, init


@pytest.mark.parametrize("s", [16, 64])                  # NC = 1, NC = 4
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_reference(s, with_init, return_state):
    x, dt, a, bmat, cmat, init = chunked_inputs(s, seed=s + 2 * with_init)
    kw = dict(return_state=return_state)
    want = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bmat, cmat)), 16,
                            init_state=jnp.asarray(init) if with_init
                            else None, **kw)
    got = ssm.ssd_chunked(*map(t, (x, dt, a, bmat, cmat)), 16,
                          init_state=t(init) if with_init else None, **kw)
    if return_state:
        close(got[1], want[1])
        got, want = got[0], want[0]
    assert got.shape == (2, s, 3, 8)
    close(got, want)


def sequential(x, dt, a, bmat, cmat, init):
    """h_t = exp(a dt_t) h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t C_t, in
    float64 (`tests/test_kernels.py::test_ssd_chunked_matches_sequential_
    scan`'s recurrence)."""
    x, dt, a, bmat, cmat, st = (np.asarray(v, np.float64)
                                for v in (x, dt, a, bmat, cmat, init))
    ys = []
    for i in range(x.shape[1]):
        decay = np.exp(a * dt[:, i])                          # (B,H)
        st = st * decay[..., None, None] + (
            dt[:, i, :, None, None] * x[:, i, :, :, None]
            * bmat[:, i, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", st, cmat[:, i]))
    return np.stack(ys, axis=1), st


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_sequential_recurrence(with_init):
    x, dt, a, bmat, cmat, init = chunked_inputs(64, seed=9)
    if not with_init:
        init = np.zeros_like(init)
    want_y, want_st = sequential(x, dt, a, bmat, cmat, init)
    y, st = ssm.ssd_chunked(*map(t, (x, dt, a, bmat, cmat)), 16,
                            init_state=t(init) if with_init else None,
                            return_state=True)
    close(y, want_y)
    close(st, want_st)


def test_prompt_length_off_the_chunk_raises(pair):
    """Neither a multiple of the chunk (32) nor shorter: JAX asserts, the
    port raises ValueError and does not pad."""
    _, _, cfg, params = pair
    x, dt, a, bmat, cmat, _ = chunked_inputs(40, seed=1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(*map(t, (x, dt, a, bmat, cmat)), 32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        M.prefill(cfg, params, {"tokens": tokens(cfg, (1, 40), 0)}, MAX_LEN,
                  device="cpu")


# ============================================================ the layer
def layer_params(pair, dtype=np.float32):
    jcfg, jparams, cfg, _ = pair
    jp = jax.tree.map(lambda v: jnp.asarray(v[0], dtype),
                      jparams["layers"]["ssm"])
    p = {k: convert._tensor(np.asarray(v), torch.device("cpu"))
         for k, v in jp.items()}
    return jcfg, jp, cfg, p


def activations(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,), dtype=np.float32)


@pytest.mark.parametrize("s", [20, 64])
def test_apply_ssm_matches_reference(pair, s):
    jcfg, jp, cfg, p = layer_params(pair)
    x = activations(cfg, (B, s), seed=s)
    init = np.random.default_rng(s).standard_normal(
        (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        dtype=np.float32)
    want = jssm.apply_ssm(jcfg, jp, jnp.asarray(x))
    close(ssm.apply_ssm(cfg, p, t(x)), want)
    want_y, want_st = jssm.apply_ssm(jcfg, jp, jnp.asarray(x),
                                     init_state=jnp.asarray(init),
                                     return_state=True)
    y, st = ssm.apply_ssm(cfg, p, t(x), init_state=t(init),
                          return_state=True)
    close(y, want_y)
    close(st, want_st)


@pytest.mark.parametrize("s", [2, 64])        # shorter than the conv window
def test_apply_ssm_prefill_matches_reference(pair, s):
    jcfg, jp, cfg, p = layer_params(pair)
    x = activations(cfg, (B, s), seed=s + 1)
    want_y, want_c = jssm.apply_ssm_prefill(jcfg, jp, jnp.asarray(x))
    y, c = ssm.apply_ssm_prefill(cfg, p, t(x))
    close(y, want_y)
    for name in ("conv", "state"):
        assert tuple(c[name].shape) == want_c[name].shape
        assert c[name].dtype == torch.float32
        close(c[name], want_c[name])


def test_apply_ssm_decode_matches_reference_in_place(pair):
    jcfg, jp, cfg, p = layer_params(pair)
    x = activations(cfg, (B, 64), seed=5)
    _, jcache = jssm.apply_ssm_prefill(jcfg, jp, jnp.asarray(x))
    _, cache = ssm.apply_ssm_prefill(cfg, p, t(x))
    step = activations(cfg, (B, 1), seed=6)
    want, jnew = jssm.apply_ssm_decode(jcfg, jp, jnp.asarray(step), jcache)
    state = cache["state"]
    got, new = ssm.apply_ssm_decode(cfg, p, t(step), cache)
    close(got, want)
    assert new["state"] is state                  # updated in place
    for name in ("conv", "state"):
        close(new[name], jnew[name])


def test_apply_ssm_bf16_close_to_reference(pair):
    jcfg, jp, cfg, p = layer_params(pair, jnp.bfloat16)
    x = activations(cfg, (B, 64), seed=7)
    want = jssm.apply_ssm(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    got = ssm.apply_ssm(cfg, p, t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), dict(atol=2e-2, rtol=0))


# ============================================================ the model
def test_param_count_and_tree_of_mamba2_780m(pair):
    cfg = get_config(ARCH)
    assert M.param_count(cfg) == JM.param_count(jget_config(ARCH)) \
        == 857_379_072
    _, jparams, rcfg, _ = pair
    params = M.init_params(rcfg, seed=3, device="cpu")
    assert len(params["layers"]) == rcfg.n_layers
    for name, leaf in jparams["layers"]["ssm"].items():
        got = params["layers"][1]["ssm"][name]
        assert tuple(got.shape) == leaf.shape[1:], name
    assert set(params["layers"][0]) == {"ln1", "ssm"}
    assert set(params["embed"]) == {"tok", "unembed"}


def test_forward_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, 64), seed=1)
    want, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    assert got.shape == (B, 64, cfg.vocab) and float(aux) == 0.0
    close(got, want)


@pytest.mark.parametrize("s", [20, 64])
def test_prefill_and_decode_step_match_reference(pair, s):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, s), seed=s)
    jlast, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               MAX_LEN)
    last, cache = M.prefill(cfg, params, {"tokens": toks}, MAX_LEN,
                            device="cpu")
    close(last, jlast)
    for name in ("conv", "state"):
        assert tuple(cache["ssm"][name].shape) == jcache["ssm"][name].shape
        close(cache["ssm"][name], jcache["ssm"][name])
    nxt = tokens(cfg, (B, 1), seed=s + 1)
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache, s)
    lg, cache = M.decode_step(cfg, params, nxt, cache, s, device="cpu")
    close(lg, jlg)
    for name in ("conv", "state"):
        close(cache["ssm"][name], jcache["ssm"][name])


def test_init_decode_caches_has_the_reference_layout(pair):
    jcfg, _, cfg, _ = pair
    jcache, _ = JM.init_decode_caches(jcfg, 3, MAX_LEN, jnp.bfloat16)
    cache = M.init_decode_caches(cfg, 3, MAX_LEN, torch.bfloat16,
                                 device="cpu")
    for name, dt in (("conv", torch.bfloat16), ("state", torch.float32)):
        assert tuple(cache["ssm"][name].shape) == jcache["ssm"][name].shape
        assert cache["ssm"][name].dtype == dt
        assert not cache["ssm"][name].any()


@pytest.mark.parametrize("s,steps", [(20, 12), (64, 32)])
def test_prefill_then_decode_matches_forward(pair, s, steps):
    """The port against itself: decode steps teacher-forced after a prefill
    (its final state and conv tail) give `forward`'s logits over the whole
    sequence (`tests/test_torch_model.py`'s check, at every step)."""
    _, _, cfg, params = pair
    toks = tokens(cfg, (B, s + steps), seed=s)
    full, _ = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :s]}, MAX_LEN,
                            device="cpu")
    close(last, full[:, s - 1], dict(atol=2e-3, rtol=2e-3))
    for i in range(s, s + steps - 1):
        lg, cache = M.decode_step(cfg, params, toks[:, i:i + 1], cache, i,
                                  device="cpu")
        close(lg[:, 0], full[:, i], dict(atol=2e-3, rtol=2e-3))


# ============================================================ the engine
@pytest.mark.parametrize("temperature", [0.7, 1e-4])
def test_generate_matches_reference(pair, temperature):
    jcfg, jparams, cfg, params = pair
    prompts = tokens(cfg, (3, 20), seed=11)
    max_new, seed = 10, 5
    want = jengine.Engine(jcfg, jparams, max_len=MAX_LEN,
                          temperature=temperature).generate(prompts, max_new,
                                                            seed=seed)
    got = engine.Engine(cfg, params, max_len=MAX_LEN,
                        temperature=temperature, device="cpu").generate(
        prompts, max_new, seed=seed)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.out_lens, want.out_lens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-5,
                               rtol=0)


def harvest(state, slots, max_new):
    slots = torch.tensor(slots)
    n_out = state.n_out[slots]
    return engine.GenResult(
        state.out[slots, :max_new].numpy(), n_out.numpy(),
        (state.lp_sum[slots] / torch.clamp(n_out, min=1).float()).numpy())


def test_slot_api_matches_generate_per_request(pair):
    """Two admitted batches (prompts of 20 and 64 tokens) into an 8-slot
    cache, decode chunks, release: each request gets, bit for bit, what
    `generate` gives it alone; admit wrote its conv and state rows."""
    _, _, cfg, params = pair
    eng = engine.Engine(cfg, params, max_len=MAX_LEN, temperature=0.7,
                        device="cpu")
    rng = np.random.default_rng(12)
    req_a = dict(prompts=rng.integers(2, cfg.vocab, (2, 20)).astype(np.int32),
                 max_new=10, seed=11, slots=[0, 1])
    req_b = dict(prompts=rng.integers(2, cfg.vocab, (2, 64)).astype(np.int32),
                 max_new=8, seed=12, slots=[4, 6])
    state = eng.init_slots(8, max_out=12)
    for req, chunk in ((req_a, 3), (req_b, 12)):
        lg, sl = eng.prefill(req["prompts"])
        state = eng.admit(state, req["slots"], lg, sl,
                          prompt_len=req["prompts"].shape[1],
                          max_new=req["max_new"], seed=req["seed"])
        if req is req_a:
            for name in ("conv", "state"):
                assert torch.equal(state.cache["ssm"][name][:, [0, 1]],
                                   sl["ssm"][name])
        state = eng.decode_chunk(state, chunk)
    for req in (req_a, req_b):
        got = harvest(state, req["slots"], req["max_new"])
        want = eng.generate(req["prompts"], req["max_new"], seed=req["seed"])
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.out_lens, want.out_lens)
        np.testing.assert_array_equal(got.logprobs, want.logprobs)
    state = eng.release(state, req_a["slots"] + req_b["slots"])
    assert not state.active.any()
