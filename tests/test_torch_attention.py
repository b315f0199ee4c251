"""The port's attention kernels' plain versions against the JAX package, on
the CPU, and `attend`'s dispatch.

Inputs are built with numpy from a seed in the kernels' own (B, S, H, hd)
layout. `flash_attention_plain` and `decode_attention_plain` are held
against `repro.kernels.ref` and against the Pallas kernels run in interpret
mode, at atol 2e-5 in float32 (`tests/test_kernels.py`'s ATOL): the sums
are the same but taken in another order. GQA ratios 1, 4 and 9, head_dim 64
and 128, causal, window 32 and non-causal masks, ragged S = T = 200 and
the bf16 CUDA kernel's tile edges S = 127, 129 and 257 (against `ref` only:
the Pallas wrapper needs S % bq == 0), and per-row and scalar decode
positions. The CUDA kernels are held against these plain
versions on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

torch.set_num_threads(1)
ATOL = 2e-5


def qkv(b, s, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32),
            rng.standard_normal((b, t, kv, hd), dtype=np.float32))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 128, 4, 4, 64),       # MHA
    (2, 128, 8, 2, 64),       # GQA 4x
    (1, 64, 9, 1, 128),       # n_rep 9 (StarCoder2-7B's ratio), wide head
    (2, 200, 9, 1, 64),       # ragged S = T
    (1, 129, 9, 1, 128),      # one row past the CUDA kernel's 128-row tile
    (1, 257, 9, 1, 128),      # one row past two tiles
    (2, 127, 8, 2, 64),       # one row short of a tile
])
@pytest.mark.parametrize("mask", ["causal", "window32", "full"])
def test_flash_plain_matches_ref(b, s, h, kv, hd, mask):
    q, k, v = qkv(b, s, s, h, kv, hd, seed=s + h + hd)
    causal = mask != "full"
    window = 32 if mask == "window32" else None
    got = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal,
                                   window=window)
    want = ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window)
    close(got, want)


@pytest.mark.parametrize("b,s,h,kv,hd,mask", [
    (1, 128, 8, 2, 64, "causal"),
    (1, 128, 9, 1, 128, "window32"),
    (1, 64, 4, 4, 64, "full"),
])
def test_flash_plain_matches_pallas_interpret(b, s, h, kv, hd, mask):
    q, k, v = qkv(b, s, s, h, kv, hd, seed=7 * s + h)
    causal = mask != "full"
    window = 32 if mask == "window32" else None
    got = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal,
                                   window=window)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                bq=64, bk=64)
    close(got, want)


@pytest.mark.parametrize("pos", [[0, 5, 63, 127], 17])
@pytest.mark.parametrize("h,kv,hd", [(4, 2, 64), (9, 1, 128)])
def test_decode_plain_matches_ref_and_pallas(pos, h, kv, hd):
    b, t = 4, 128
    q, k, v = qkv(b, 1, t, h, kv, hd, seed=h * hd)
    pos_j = jnp.asarray(pos, jnp.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    got = dec.decode_attention_plain(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), pos_t)
    want = ref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos_j)
    close(got, want)
    pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), pos_j, bk=64)
    close(got, pallas)


def test_ops_on_cpu_take_the_plain_versions_and_count_nothing():
    q, k, v = (torch.tensor(x) for x in qkv(2, 16, 16, 4, 1, 64, seed=3))
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       fa.flash_attention_plain(q, k, v, causal=True))
    pos = torch.tensor([3, 15], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, pos),
                       dec.decode_attention_plain(q[:, :1], k, v, pos))
    assert ops.LAUNCHES == before


def test_attend_on_cpu_takes_the_plain_path():
    """impl auto and pallas on a CPU tensor run `_attend_naive`, bit for
    bit, and launch nothing."""
    q, k, v = (torch.tensor(x) for x in qkv(2, 24, 24, 8, 2, 64, seed=5))
    want = attn._attend_naive(q, k, v, causal=True, window=None)
    before = dict(ops.LAUNCHES)
    for impl in ("auto", "pallas", "naive"):
        assert torch.equal(attn.attend(q, k, v, causal=True, impl=impl), want)
    assert ops.LAUNCHES == before
    # and `_attend_naive` is the reference's attention
    close(want, ref.flash_attention(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), causal=True))
    with pytest.raises(NotImplementedError, match="A26"):
        attn.attend(q, k, v, impl="chunked")


def test_kernel_wrappers_reject_what_they_do_not_take():
    """Checked before any launch, so these run without a card."""
    q, k, v = (torch.tensor(x) for x in qkv(1, 8, 8, 4, 2, 64, seed=1))
    with pytest.raises(TypeError, match="share a dtype"):
        fa.check_qkv("flash_attention", q, k.double(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.check_qkv("flash_attention", q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_qkv("flash_attention", q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.check_qkv("flash_attention", q[..., :32].contiguous(),
                     k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        fa.check_qkv("flash_attention", q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="pos must be"):
        dec.row_positions(torch.zeros(3, dtype=torch.int32), 2, q.device)
