"""The rest of the port's dense path and its numpy data (`repro_torch.
configs.shapes`, `models.model.abstract_params` / `input_specs` /
`unroll_scans` / ``remat=``, `data.pipeline`) against the JAX package, on
the CPU.

* `abstract_params`: for every registered config at full size, in its own
  dtype and in bfloat16, the names, shapes and dtypes of JAX's
  `abstract_params`, as tensors on the ``meta`` device (nothing
  allocated).
* `input_specs`: the names, shapes, dtypes and logical axes of JAX's
  abstract `input_specs` for every config and shape.
* ``remat=True``: the forward's logits and aux loss bit-equal to
  ``remat=False`` and the parameters' gradients equal, on reduced dense,
  MoE, hybrid and audio models (float32, one thread); `unroll_scans`
  changes nothing.
* `shapes.SHAPES` and `applicable`, `SyntheticLM` (its graph and batches)
  and `make_batch` bit-equal to the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.data import pipeline as jpipeline
from repro.models import model as JM
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline
from repro_torch.models import model as M

torch.set_num_threads(1)


def _flat(tree, prefix=()):
    """{path: (shape, dtype name)} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            assert v.device.type == "meta", (prefix, k)
            out[prefix + (k,)] = (tuple(v.shape),
                                  str(v.dtype).replace("torch.", ""))
    return out


def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(p.key for p in path): (tuple(v.shape), str(v.dtype))
            for path, v in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_are_the_reference_tree(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for dtype in (None, "bfloat16"):
        got = _flat(M.abstract_params(cfg, dtype))
        assert got == _jflat(JM.abstract_params(jcfg, dtype))
    assert sum(np.prod(s) for s, _ in got.values()) == M.param_count(cfg)


def test_input_specs_are_the_reference_shapes():
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in shapes.SHAPES.values():
            want, want_axes = JM.input_specs(jcfg, jshapes.SHAPES[shape.name])
            got, axes = M.input_specs(cfg, shape)
            assert _flat(got) == \
                {(k,): v for (k,), v in _jflat(want).items()}, (arch, shape)
            assert axes == want_axes, (arch, shape)


def test_shapes_are_the_reference_shapes():
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, shape in shapes.SHAPES.items():
        assert dataclasses.astuple(shape) == \
            dataclasses.astuple(jshapes.get_shape(name))
        assert shapes.get_shape(name) is shape
        for arch in list_archs():
            assert shapes.applicable(get_config(arch), shape) == \
                jshapes.applicable(jget_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("seed,branch", [(0, 4), (3, 2)])
def test_synthetic_lm_is_bit_equal(seed, branch):
    want = jpipeline.SyntheticLM(jpipeline.DataConfig(50, 12, 3, seed, branch))
    got = pipeline.SyntheticLM(pipeline.DataConfig(50, 12, 3, seed, branch))
    np.testing.assert_array_equal(got.succ, want.succ)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(got.batch(step), want.batch(step))
    a, b = next(got.batches(5)), next(want.batches(5))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-vl-72b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_make_batch_is_bit_equal(arch, kind):
    from repro.configs.base import InputShape as JInputShape
    from repro_torch.configs.base import InputShape
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    got = pipeline.make_batch(cfg, InputShape("s", 16, 2, kind), step=3,
                              seed=1)
    want = jpipeline.make_batch(jcfg, JInputShape("s", 16, 2, kind), step=3,
                                seed=1)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _inputs(cfg, rng):
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, 16))}
    if cfg.family == "audio":
        inputs["frames"] = torch.tensor(rng.standard_normal(
            (2, 24, cfg.d_model), dtype=np.float32))
    return inputs


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["starcoder2-7b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_remat_keeps_the_forward_and_its_gradients(arch):
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=4, ssm_chunk=8)
    inputs = _inputs(cfg, np.random.default_rng(0))
    runs = []
    for remat in (False, True):
        params = M.init_params(cfg, seed=0, device="cpu")
        leaves = _leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        with M.unroll_scans():
            logits, aux = M.forward(cfg, params, inputs, remat=remat,
                                    device="cpu")
        (logits.square().mean() + aux).backward()
        runs.append((logits.detach(), aux.detach(),
                     [x.grad for x in leaves]))
    (l0, a0, g0), (l1, a1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert len(g0) == len(g1) and all(g is not None for g in g0)
    for x, y in zip(g0, g1):
        assert torch.equal(x, y)
