"""Training in the port (`repro_torch.models.model.loss_fn`,
`repro_torch.train.train_step`, the kernels' autograd Functions and
`repro_torch.launch.serve`) against the JAX package, on the CPU, at
reduced configs (2 layers, fp32, 32 tokens) with JAX's weights carried
across.

Tolerances: the loss of every family at 1e-5 (float32 in both, sums in
another order); gradients, leaf by leaf, within 1e-4 of the leaf's
largest reference entry plus 1e-7 (a backward pass sums in other orders
again); two AdamW train steps' params at 1e-5 absolute (each step moves a
weight by up to lr = 1e-3, from gradients held as above) except on one
entry in 10^4 at most, where a gradient of ~0 leaves Adam's step sign to
rounding noise, which is then held to 2 lr; the steps' loss, grad norm and
lr at 1e-5 relative; `build_pool`'s loss sequence at 1e-4 (five steps at
lr up to 3e-3)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)
B, S, FRAMES = 2, 32, 64
FAMILIES = {"dense": "starcoder2-7b", "moe": "olmoe-1b-7b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-large-v3"}


def _pair(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed=0, b=B):
    """A training batch as numpy arrays: tokens and labels of S, a VLM's
    patch embeddings (S / 8 of them, ahead of the text), an audio model's
    FRAMES stub frames; a mask with the last 5 labels of row 0 off."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mask = np.ones((b, S), np.float32)
    mask[0, -5:] = 0.0
    out["mask"] = mask
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (b, S // 8, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal(
            (b, FRAMES, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_fn_matches_the_reference(family):
    jcfg, jparams, cfg, params = _pair(FAMILIES[family])
    batch = _batch(cfg)
    jloss, jm = JM.loss_fn(jcfg, jparams, _jbatch(batch))
    loss, m = M.loss_fn(cfg, params, batch, device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5)
    if family == "moe":
        assert float(m["aux"]) > 0
    # the mask's all-ones default
    del batch["mask"]
    np.testing.assert_allclose(
        float(M.loss_fn(cfg, params, batch, device="cpu")[0]),
        float(JM.loss_fn(jcfg, jparams, _jbatch(batch))[0]), rtol=1e-5,
        atol=1e-5)


def _grads_close(got, want):
    want = opt.tree_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, want), "cpu"))
    got = opt.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_gradients_match_jax_grad(family):
    jcfg, jparams, cfg, params = _pair(FAMILIES[family])
    batch = _batch(cfg, seed=1)
    want = jax.jit(jax.grad(lambda p: JM.loss_fn(jcfg, p, _jbatch(batch))[0])
                   )(jparams)
    for remat in (False, True):
        _, _, grads = ts.value_and_grad(cfg, params, batch, remat=remat,
                                        device="cpu")
        _grads_close(grads, want)
    for p in opt.tree_leaves(params):       # the caller's leaves untouched
        assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_the_reference(microbatch):
    jcfg, jparams, cfg, params = _pair(FAMILIES["dense"])
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**kw),
                                        remat=False, microbatch=microbatch))
    step = ts.make_train_step(cfg, opt.AdamWConfig(**kw), remat=False,
                              microbatch=microbatch, device="cpu")
    jst = jopt.init_adamw(jopt.AdamWConfig(**kw), jparams)
    st = convert.adamw_state_from_jax(jst, device="cpu")
    for i in range(2):
        batch = _batch(cfg, seed=10 + i, b=4)
        jparams, jst, jm = jstep(jparams, jst, _jbatch(batch))
        params, st, m = step(params, st, batch)
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    want = opt.tree_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    got = opt.tree_leaves(params)
    assert all(p.requires_grad and p.is_leaf for p in got)
    diff = np.concatenate([np.abs(p.detach().numpy() - w.numpy()).ravel()
                           for p, w in zip(got, want)])
    # Adam divides by sqrt(v̂): where a gradient entry is ~0, its sign is
    # rounding noise and the step moves by up to lr either way
    assert diff.max() <= 2 * kw["lr"]
    assert (diff > 1e-5).mean() <= 1e-4, (diff > 1e-5).sum()


def test_prefill_and_serve_steps_match_the_model():
    _, _, cfg, params = _pair(FAMILIES["dense"])
    toks = _batch(cfg)["tokens"]
    logits = ts.make_prefill_step(cfg, device="cpu")(params, {"tokens": toks})
    full, _ = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    assert torch.equal(logits, full[:, -1])
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :-1]}, S,
                            device="cpu")
    step, _ = ts.make_serve_step(cfg, device="cpu")(params, toks[:, -1:],
                                                    cache, S - 1)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def _grads_through(fn, xs, seed):
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    cot = [torch.randn(o.shape, generator=g) for o in outs]
    return torch.autograd.grad(outs, xs, cot)


@pytest.mark.parametrize("causal, window", [(True, None), (True, 5),
                                            (False, None)])
def test_flash_attention_function_is_the_plain_gradient(causal, window):
    """The Function with the plain version as its forward gives autograd's
    gradient straight through the plain version (GQA: 4 heads over 2)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).requires_grad_()
               for s in ((2, 9, 4, 16), (2, 11, 2, 16), (2, 11, 2, 16)))

    def fn(q, k, v):
        return fa.FlashAttentionFn.apply(fa.flash_attention_plain, q, k, v,
                                         causal, window)
    got = _grads_through(fn, (q, k, v), 1)
    want = _grads_through(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window), (q, k, v), 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_chunk_function_is_the_plain_gradient():
    """bf16 B/C keep their dtype through the Function: their gradients come
    back in bf16, as autograd gives them through the plain version."""
    g = torch.Generator().manual_seed(0)
    xd = torch.randn((2, 2, 8, 3, 16), generator=g).requires_grad_()
    acum = torch.cumsum(-torch.rand((2, 2, 8, 3), generator=g),
                        2).requires_grad_()
    bm, cm = (torch.randn((2, 2, 8, 16), generator=g).to(torch.bfloat16)
              .requires_grad_() for _ in range(2))
    xs = (xd, acum, bm, cm)
    got = _grads_through(lambda *a: ssd.SSDChunkFn.apply(
        ssd.ssd_chunk_plain, *a), xs, 2)
    want = _grads_through(ssd.ssd_chunk_plain, xs, 2)
    for a, b, x in zip(got, want, xs):
        assert a.dtype == x.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_chunk_plain_gradient_is_finite_under_a_steep_decay():
    """At Mamba2's width a chunk's decay spans hundreds of nats, so
    exp(acum_i − acum_j) above the diagonal overflows; the plain version
    masks before the exp, so its values are unchanged and its gradient
    stays finite (the reference's `where` after the exp gives NaN there)."""
    g = torch.Generator().manual_seed(4)
    xd = torch.randn((1, 1, 64, 2, 16), generator=g).requires_grad_()
    acum = torch.cumsum(-3.0 * torch.ones((1, 1, 64, 2)),
                        2).requires_grad_()              # spans 189 nats
    bm, cm = (torch.randn((1, 1, 64, 8), generator=g).requires_grad_()
              for _ in range(2))
    y, states = ssd.ssd_chunk_plain(xd, acum, bm, cm)
    grads = torch.autograd.grad((y.sum() + states.sum()), (xd, acum, bm, cm))
    assert all(torch.isfinite(t).all() for t in grads)
    diff = acum[0, 0, :, None, :] - acum[0, 0, None, :, :]
    lmat = torch.where(torch.ones(64, 64, dtype=torch.bool).tril()[..., None],
                       torch.exp(diff), torch.zeros(()))
    want = torch.einsum("ij,ijh,jhp->ihp", cm[0, 0] @ bm[0, 0].T, lmat,
                        xd[0, 0])
    assert torch.equal(y[0, 0], want)


def test_build_pool_follows_the_reference_loss(monkeypatch):
    """Five AdamW steps of the pool's trained member (reduced StarCoder2 at
    the shared vocabulary, JAX's weights) give the reference's losses."""
    losses = {"jax": [], "port": []}

    def recording(make, key):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(*b):
                out = step(*b)
                losses[key].append(float(out[2]["loss"]))
                return out
            return run
        return wrapped
    def jit(fn):                  # the reference jits its step: record
        step = jax.jit(fn)        # the loss outside the trace

        def run(*b):
            out = step(*b)
            losses["jax"].append(float(out[2]["loss"]))
            return out
        return run
    monkeypatch.setattr(jserve, "jax", types.SimpleNamespace(
        jit=jit, random=jax.random))
    monkeypatch.setattr(serve, "make_train_step",
                        recording(serve.make_train_step, "port"))

    def jax_init(cfg, seed, device):
        jcfg = dataclasses.replace(jget_config(cfg.name[:-len("-smoke")])
                                   .reduced(), vocab=cfg.vocab)
        return convert.params_from_jax(cfg, jax.tree.map(
            np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed))),
            device=device)
    monkeypatch.setattr(serve.M, "init_params", jax_init)
    names = ["starcoder2-7b"]
    jdata = jserve.SyntheticLM(jserve.DataConfig(vocab=serve.VOCAB,
                                                 seq_len=32, global_batch=8))
    data = SyntheticLM(DataConfig(vocab=serve.VOCAB, seq_len=32,
                                  global_batch=8))
    jserve.build_pool(names, jdata, 1, train_steps=5)
    (rep,) = serve.build_pool(names, data, 1, train_steps=5, device="cpu")
    assert len(losses["port"]) == 5
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-4,
                               rtol=0)
    assert losses["port"][-1] < losses["port"][0]
    assert rep.price_per_token == 0.001
    assert not any(p.requires_grad
                   for p in opt.tree_leaves(rep.engine.params))


def test_serve_main_runs_on_the_cpu():
    s = serve.main(["--rounds", "2", "--tenants", "2", "--fault-rate", "0.2",
                    "--fault-seed", "7", "--pool",
                    "mamba2-780m,starcoder2-7b", "--train-first", "0"],
                   device="cpu")
    assert s["rounds"] == 2
    assert set(s["selections"]) == {"mamba2-780m", "starcoder2-7b"}
    assert len(s["replica_stats"]) == 2
    assert np.isfinite(s["mean_cost"]) and s["rounds_per_s"] > 0


def test_training_entry_points_default_to_the_card():
    """Without a CUDA device every new entry point raises by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("starcoder2-7b").reduced()
    for make in (lambda: ts.make_train_step(cfg, opt.AdamWConfig()),
                 lambda: ts.make_prefill_step(cfg),
                 lambda: ts.make_serve_step(cfg),
                 lambda: serve.main(["--rounds", "1"]),
                 lambda: serve.build_pool(["starcoder2-7b"], None, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
