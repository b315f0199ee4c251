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
positions, the decode also at head_dim 120 (GQA 4, H2O-Danube's) and 80
(n_rep 1, Zamba2's shared block). The CUDA kernels are held against these plain
versions on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

`attend`'s chunked route (JAX's `_attend_chunked`, plain PyTorch on every
device) is held against the reference's at small q / kv chunks, banded and
unbanded, GQA and an offset query block, at atol 1e-5 in float32 and 2e-2
in bfloat16; "auto" on a CPU tensor takes it from `CHUNKED_THRESHOLD`.
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
@pytest.mark.parametrize("h,kv,hd", [(4, 2, 64), (9, 1, 128), (8, 2, 120),
                                     (4, 4, 80)])
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
    # below 2·Q_CHUNK query tokens "chunked" is naive, as in JAX
    assert torch.equal(attn.attend(q, k, v, causal=True, impl="chunked"),
                       want)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.attend(q, k, v, impl="flash")


# (B, S, T, H, KV, hd, causal, window, q_offset, q_chunk, kv_chunk): the
# banded sliding-window route (causal, S = T, no offset; a band of one or
# two kv chunks), the unbanded online softmax over several kv chunks (one
# chunk when T is not a multiple), GQA 1 / 4, an offset query block,
# non-causal S != T
CHUNKED = [
    (2, 64, 64, 4, 1, 16, True, 20, 0, 16, 16),
    (1, 96, 96, 4, 4, 32, True, 40, 0, 32, 16),
    (2, 64, 64, 8, 2, 16, True, None, 0, 16, 16),
    (2, 32, 64, 4, 1, 16, True, None, 32, 16, 16),
    (2, 32, 64, 4, 2, 16, True, 12, 32, 8, 16),
    (2, 48, 40, 4, 4, 16, False, None, 0, 16, 8),
    (1, 48, 50, 4, 2, 16, False, None, 0, 16, 16),
]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,q_offset,q_chunk,"
                         "kv_chunk", CHUNKED)
def test_chunked_matches_the_reference(dtype, atol, b, s, t, h, kv, hd,
                                       causal, window, q_offset, q_chunk,
                                       kv_chunk):
    from repro.models import attention as jattn
    q, k, v = qkv(b, s, t, h, kv, hd, seed=s + t + h)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = jattn._attend_chunked(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                 **kw)
    tdt = getattr(torch, dtype)
    got = attn._attend_chunked(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                               **kw)
    assert got.dtype == tdt and got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_auto_on_cpu_takes_chunked_from_the_threshold(monkeypatch):
    """On a CPU tensor "auto" is naive below CHUNKED_THRESHOLD query tokens
    and chunked from it, as JAX's `attend` picks (the threshold lowered so
    the test stays small); "pallas" stays naive."""
    monkeypatch.setattr(attn, "CHUNKED_THRESHOLD", 64)
    monkeypatch.setattr(attn, "Q_CHUNK", 16)
    calls = []
    chunked = attn._attend_chunked
    monkeypatch.setattr(attn, "_attend_chunked",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or chunked(*a, q_chunk=16, kv_chunk=32, **kw))
    for s in (32, 63, 64, 96):
        q, k, v = (torch.tensor(x) for x in qkv(1, s, s, 4, 2, 16, seed=s))
        out = attn.attend(q, k, v, causal=True, window=24)
        naive = attn._attend_naive(q, k, v, causal=True, window=24)
        np.testing.assert_allclose(out.numpy(), naive.numpy(), atol=1e-5,
                                   rtol=0)
        assert torch.equal(attn.attend(q, k, v, causal=True, window=24,
                                       impl="pallas"), naive)
    assert calls == [64, 96]


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


# the F4 reproducer's shapes: H2O-Danube-3-4B's 32 query / 8 KV heads of
# head_dim 120; head_dim 32 is built by neither kernel (flash_attention
# takes 80 and 120 through its pad route, decode_attention builds them)
@pytest.mark.parametrize("name,hd,takes", [
    ("flash_attention", 120, True), ("flash_attention", 80, True),
    ("flash_attention", 32, False), ("decode_attention", 120, True),
    ("decode_attention", 80, True), ("decode_attention", 32, False)])
def test_check_qkv_takes_each_kernels_head_dims(name, hd, takes):
    """Each kernel module passes its own head_dims to `check_qkv`."""
    mod = {fa.NAME: fa, dec.NAME: dec}[name]
    q = torch.zeros((1, 8, 32, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 8, hd), dtype=torch.bfloat16)
    if takes:
        fa.check_qkv(name, q, k, k.clone(), mod.HEAD_DIMS)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            fa.check_qkv(name, q, k, k.clone(), mod.HEAD_DIMS)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 40, 8, 2, 120, None),     # H2O-Danube-3-4B's head_dim, GQA 4x
    (2, 33, 4, 1, 120, 16),       # with a window, as its prefill has
    (1, 24, 4, 4, 80, None)])     # Zamba2-2.7B's head_dim
def test_pad_route_is_the_attention_at_the_true_head_dim(b, s, h, kv, hd,
                                                         window):
    """What `flash_attention_cuda` does for head_dim 120 and 80: the
    plain attention of the inputs zero-padded to 128 columns, scaled by
    1/sqrt of the true head_dim, is the attention at that head_dim in its
    first columns, and zero in the rest; both match the JAX reference."""
    q, k, v = (torch.tensor(x) for x in qkv(b, s, s, h, kv, hd, seed=hd + s))
    qp, kp, vp, scale = fa.pad_head_dim(q, k, v)
    assert qp.shape[3] == kp.shape[3] == vp.shape[3] == fa.PAD_TO
    assert scale == 1.0 / np.sqrt(hd)
    got = fa.flash_attention_plain(qp, kp, vp, causal=True, window=window,
                                   scale=scale)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    close(got[..., :hd], want)
    assert not got[..., hd:].any()
    close(got[..., :hd], ref.flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, window=window))
    # a built head_dim is not padded
    q64, k64, v64 = (x[..., :64].contiguous() for x in (q, k, v))
    assert fa.pad_head_dim(q64, k64, v64)[0] is q64


MAIN_POS = [1100, 1110, 1120, 1130, 3040, 3041, 3047, 3055]


@pytest.fixture(scope="module")
def main_decode():
    """The serving path's decode shape (chip_smoke.py phase 3's "main"):
    q (8, 1, 36, 128), cache (8, 4,096, 4, 128), float32, and the plain
    output at its positions (a row at a time, to keep the CPU's memory
    small)."""
    q, k, v = (torch.tensor(x) for x in qkv(8, 1, 4096, 36, 4, 128, seed=16))
    pos = torch.tensor(MAIN_POS, dtype=torch.int32)
    want = torch.cat([dec.decode_attention_plain(q[i:i + 1], k[i:i + 1],
                                                 v[i:i + 1], pos[i])
                      for i in range(len(MAIN_POS))])
    return q, k, v, pos, want


def test_row_check_passes_bf16_rounding(main_decode):
    """`row_error_ratio` at chip_smoke.py's per-row tolerance passes the
    plain output rounded to bf16, the kernel's own output rounding."""
    *_, want = main_decode
    assert fa.row_error_ratio(want.bfloat16(), want, 1e-2, 1e-4) <= 1


@pytest.mark.parametrize("row", [0, 3, 4, 7])
def test_row_check_fails_a_row_without_its_last_64_slots(main_decode, row):
    """A kernel that drops one row's last 64 visible slots (one tile)
    fails the per-row check, though it may pass the 2e-2 max gate."""
    q, k, v, pos, want = main_decode
    out = want.clone()
    out[row] = dec.decode_attention_plain(q[row:row + 1], k[row:row + 1],
                                          v[row:row + 1], pos[row] - 64)[0]
    assert fa.row_error_ratio(out, want, 1e-2, 1e-4) > 1


@pytest.mark.parametrize("t,bkv,dtype,want", [
    (4096, 32, torch.bfloat16, (7, 10)),   # the serving path's decode step
    (4096, 12, torch.bfloat16, (4, 16)),   # 256-slot splits: the floor
    (32768, 1, torch.bfloat16, (8, 64)),   # no more than 64 splits
    (77, 3, torch.bfloat16, (2, 1)),       # a cache shorter than a split
    (4096, 32, torch.float32, (8, 8))])    # fp32 keeps 512-slot splits
def test_decode_split_plan(t, bkv, dtype, want):
    """The split of T the wrapper launches on a 132-SM card: (tiles of 64
    slots per split, splits); the splits cover the cache."""
    per, splits = dec.split_plan(t, bkv, dtype, 132)
    assert (per, splits) == want
    assert (splits - 1) * per * dec.TILE < t <= splits * per * dec.TILE
