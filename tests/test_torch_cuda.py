"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present, so on a
machine without a card they count as skips. This file imports no JAX, so it
runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import awc_fw as awc
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import topn_lp as topn
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _topn_rows(b, k, seed, dev):
    g = torch.Generator().manual_seed(seed)
    score = torch.randn((b, k), generator=g)
    score[::4, 1::3] = score[::4, :1]
    cost = torch.rand((b, k), generator=g)
    n = torch.randint(1, k + 1, (b,), generator=g, dtype=torch.int32)
    return score.to(dev), cost.to(dev), n.to(dev)


@pytest.mark.parametrize("b,k", [(4, 9), (33, 40), (5, 130), (1024, 128),
                                 (174784, 9)])
@pytest.mark.parametrize("equality", [True, False])
def test_topn_lp_kernel_matches_plain(dev, b, k, equality):
    score, cost, n = _topn_rows(b, k, b + k, dev)
    before = ops.LAUNCHES["topn_lp"]
    out = ops.topn_lp(score, cost, n, equality=equality)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topn_lp"] == before + 1
    want = topn.topn_lp_plain(score, cost, n, equality=equality)
    assert torch.equal(out, want)


@pytest.mark.parametrize("b,k,g", [(4, 9, 25), (1365, 9, 25), (256, 64, 8),
                                   (5, 130, 3)])
def test_awc_fw_kernel_matches_plain(dev, b, k, g):
    gen = torch.Generator().manual_seed(b * 7 + k + g)
    z = torch.rand((b, k), generator=gen).to(dev)
    mu = (0.05 + 0.94 * torch.rand((b, k), generator=gen)).to(dev)
    cost = (0.01 + 0.59 * torch.rand((b, k), generator=gen)).to(dev)
    lams = (4 * torch.rand((b, g), generator=gen)).to(dev)
    n = torch.randint(1, k + 1, (b,), generator=gen, dtype=torch.int32).to(dev)
    gk, ck = ops.awc_fw(z, mu, cost, lams, n)
    gp, cp = awc.awc_fw_plain(z, mu, cost, lams, n)
    torch.cuda.synchronize()
    assert (gk - gp).abs().max().item() <= 2e-6
    assert (ck - cp).abs().max().item() <= 1e-6


# the fleet kernels' paths: a thread per row (per (row, λ) in awc_fw) at
# K <= 16 and K <= 32, a warp per row above; blocks of 256 rows in topn_lp
EDGE_K = [1, 16, 17, 31, 32, 33]
EDGE_B = [1, 255, 257]
LAM_CAP = 2.0 ** 24          # relax.LAM_MAX_EXP


def _topn_edge_rows(b, k, seed, dev):
    """Scores with ties inside rows, all-tie rows, negative scores;
    zero-cost arms; n from 0 to K + 1."""
    g = torch.Generator().manual_seed(seed)
    score = torch.randn((b, k), generator=g)
    score[::4, 1::3] = score[::4, :1]
    score[1::3] = 0.25
    cost = torch.rand((b, k), generator=g)
    cost[:, ::4] = 0.0
    n = torch.randint(0, k + 2, (b,), generator=g, dtype=torch.int32)
    return score.to(dev), cost.to(dev), n.to(dev)


def _awc_edge_rows(b, k, g_pts, seed, dev):
    """The FW loop's inputs with all-tie rows (z̃ = 0, equal μ and c, so
    λ = 0 ties every pair), zero-cost arms, clipped μ, and λ = 0, the
    2^24 cap and the octave ladder between."""
    g = torch.Generator().manual_seed(seed)
    z = torch.rand((b, k), generator=g)
    mu = 0.05 + 0.95 * torch.rand((b, k), generator=g)
    mu[::5, :2] = 1.0
    c = 0.6 * torch.rand((b, k), generator=g)
    c[:, ::4] = 0.0
    z[1::3], mu[1::3], c[1::3] = 0.0, 0.5, 0.3
    lams = torch.cat([torch.zeros(1), 2.0 ** torch.arange(1.0, g_pts - 1),
                      torch.tensor([LAM_CAP])]).expand(b, g_pts).contiguous()
    n = torch.randint(1, k + 1, (b,), generator=g, dtype=torch.int32)
    return tuple(x.to(dev) for x in (z, mu, c, lams, n))


@pytest.mark.parametrize("b", EDGE_B)
@pytest.mark.parametrize("k", EDGE_K)
def test_topn_lp_paths_equal_plain_at_their_edges(dev, b, k):
    args = _topn_edge_rows(b, k, 31 * b + k, dev)
    for equality in (True, False):
        out = ops.topn_lp(*args, equality=equality)
        want = topn.topn_lp_plain(*args, equality=equality)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (equality,
                                        (out - want).abs().max().item())


@pytest.mark.parametrize("b", EDGE_B)
@pytest.mark.parametrize("k", EDGE_K)
def test_awc_fw_paths_equal_plain_at_their_edges(dev, b, k):
    args = _awc_edge_rows(b, k, 25, 37 * b + k, dev)
    gk, ck = ops.awc_fw(*args)
    gp, cp = awc.awc_fw_plain(*args)
    torch.cuda.synchronize()
    assert (gk - gp).abs().max().item() <= 2e-6
    assert torch.equal(ck, cp), (ck - cp).abs().max().item()


def test_fleet_kernels_replay_from_a_cuda_graph(dev):
    """Calls captured in a CUDA graph give the eager calls' outputs, and
    after new inputs are copied into the captured tensors, the plain
    version's on those inputs."""
    def calls(tensors, topn_lp=ops.topn_lp, awc_fw=ops.awc_fw):
        """[(is awc_fw's g, output), ...] of every call."""
        outs = []
        for score, cost, n in tensors["topn"]:
            outs.append((False, topn_lp(score, cost, n, equality=False)))
        for args in tensors["awc"]:
            g, costs = awc_fw(*args)
            outs += [(True, g), (False, costs)]
        return outs

    def inputs(seed):
        return {"topn": [_topn_edge_rows(b, k, seed + b, dev)
                         for b, k in ((4096, 9), (300, 33))],
                "awc": [_awc_edge_rows(b, k, g, seed + b, dev)
                        for b, k, g in ((1365, 9, 25), (40, 33, 4))]}

    live = inputs(1)
    eager = calls(live)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls(live)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls(live)
    graph.replay()
    torch.cuda.synchronize()
    for (_, got), (_, want) in zip(captured, eager):
        assert torch.equal(got, want)
    fresh = inputs(2)
    for group in ("topn", "awc"):
        for dst, src in zip(live[group], fresh[group]):
            for d, s in zip(dst, src):
                d.copy_(s)
    graph.replay()
    torch.cuda.synchronize()
    want = calls(fresh, topn.topn_lp_plain, awc.awc_fw_plain)
    for (is_g, got), (_, w) in zip(captured, want):
        if is_g:
            assert (got - w).abs().max().item() <= 2e-6
        else:
            assert torch.equal(got, w)


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros((4, 9), device=dev)
    n = torch.ones((4,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ops.topn_lp(x.double(), x.double(), n)
    with pytest.raises(ValueError):
        ops.topn_lp(x.t().contiguous().t(), x, n)
    with pytest.raises(TypeError):
        ops.topn_lp(x, x, n.long())
    with pytest.raises(ValueError):
        ops.awc_fw(x, x, x, x[:, :3], n[:2])
    q = torch.zeros((1, 8, 4, 64), device=dev)
    kv = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kv, kv, 3)          # 8 query tokens
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :1, :, :32].contiguous(),
                             kv[..., :32].contiguous(),
                             kv[..., :32].contiguous(), 3)


# ATOL of `tests/test_kernels.py`: fp32 sums in another order; bf16 output
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(shapes, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to(dev, dtype) for s in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (1, 128, 4, 4, 64, True, None), (2, 200, 9, 1, 128, True, None),
    (1, 256, 4, 2, 64, True, 32), (1, 128, 2, 2, 64, False, None),
    (2, 77, 8, 2, 128, False, 40), (4, 2048, 36, 4, 128, True, None),
    # the bf16 kernel's 128-row and 128-key tile edges, and a window that
    # crosses one
    (1, 129, 9, 1, 128, True, None), (1, 129, 9, 1, 128, False, None),
    (1, 257, 9, 1, 128, True, None), (2, 127, 8, 2, 64, True, None),
    (1, 300, 8, 2, 128, True, 100),
    # head_dim 120 (H2O-Danube-3-4B's prefill, a ragged one) and 80: the
    # pad route to the hd-128 build
    (4, 1024, 32, 8, 120, True, 4096), (2, 200, 32, 8, 120, True, None),
    (2, 129, 32, 32, 80, True, None),
    # n_rep 1: OLMoE-1B-7B's prefill (16 / 16 heads of 128)
    (4, 2048, 16, 16, 128, True, None)])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, s, h, kv, hd,
                                              causal, window):
    q, k, v = _attn_inputs([(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)],
                           dtype, s + h, dev)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= \
        ATTN_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,hd,pos", [
    (4, 128, 4, 2, 64, [0, 5, 63, 127]), (2, 256, 4, 2, 64, 100),
    (3, 77, 9, 1, 128, [76, 200, 3]),
    (8, 4096, 36, 4, 128, [1100, 1110, 1120, 1130, 3040, 3041, 3047, 0]),
    # n_rep 16 at hd 128 and 32 at hd 64 (two M tiles of the bf16
    # kernel's products), and pos on the 256-slot split edge
    (2, 1024, 16, 1, 128, [0, 1023]), (2, 512, 32, 1, 64, [100, 511]),
    (3, 4096, 36, 4, 128, [255, 256, 257]),
    # n_rep 1 (one of the products' 16 M rows in use): OLMoE-1B-7B's decode
    # step at per-row pos, and Whisper's layout (20 / 20 heads of 64)
    (8, 4096, 16, 16, 128, [1030, 1031, 1035, 1039, 3010, 3011, 3020, 3047]),
    (2, 512, 20, 20, 64, [0, 511])])
def test_decode_attention_kernel_matches_plain(dev, dtype, b, t, h, kv, hd,
                                               pos):
    q, k, v = _attn_inputs([(b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)],
                           dtype, t + h, dev)
    if isinstance(pos, list):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = dec.decode_attention_plain(q, k, v, pos)
    assert (out.float() - want.float()).abs().max().item() <= \
        ATTN_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_row_without_a_slot_is_zero(dev, dtype):
    """A row with pos < 0 attends to nothing and returns zeros (the plain
    version would return the mean of V there), at the main shape, where
    the other row's slots span several splits."""
    q, k, v = _attn_inputs([(2, 1, 36, 128), (2, 4096, 4, 128),
                            (2, 4096, 4, 128)], dtype, 7, dev)
    pos = torch.tensor([-1, 100], dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, k, v, pos)
    want = dec.decode_attention_plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]).item() == 0
    assert (out[1].float() - want[1].float()).abs().max().item() <= \
        ATTN_ATOL[dtype]


# per (row, head) output vector, as chip_smoke.py holds the attention
# kernels: max|out - want| <= 1e-2 max|want| + 1e-4
ROW_RTOL, ROW_ATOL = 1e-2, 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd,t,m", [(36, 4, 128, 4096, 2),
                                         (20, 20, 64, 448, 4),
                                         (32, 32, 80, 4096, 4),
                                         (32, 8, 120, 4096, 2)])
def test_decode_attention_lse_splits_and_merges(dev, dtype, h, kv, hd, t, m):
    """`decode_attention_lse`: its o equal to `decode_attention`'s (one
    launch of the same kernel), its lse within 1e-3 of the plain
    version's (-inf at pos -1), and T cut into m blocks, each a kernel call
    at its local pos, merged by `merge_partials` to the whole-cache call
    per (row, head) vector."""
    b = 8
    q, k, v = _attn_inputs([(b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)],
                           dtype, t + hd, dev)
    pos = torch.tensor([-1, 3, t // 3, t - 1, t + 5, 7, t // 2, 2 * t],
                       dtype=torch.int32, device=dev)
    whole = ops.decode_attention(q, k, v, pos)
    before = ops.LAUNCHES["decode_attention"]
    o, lse = ops.decode_attention_lse(q, k, v, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert torch.equal(o, whole)
    _, want = dec.decode_attention_lse_plain(q, k, v, pos)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert (lse[fin] - want[fin]).abs().max().item() <= 1e-3
    t_l = t // m
    last = torch.clamp(pos, max=t - 1)
    parts = [ops.decode_attention_lse(
        q, k[:, r * t_l:(r + 1) * t_l].contiguous(),
        v[:, r * t_l:(r + 1) * t_l].contiguous(),
        (last - r * t_l).clamp(-1, t_l - 1)) for r in range(m)]
    merged = dec.merge_partials(torch.stack([x[0] for x in parts]),
                                torch.stack([x[1] for x in parts]))
    torch.cuda.synchronize()
    assert torch.count_nonzero(merged[0]).item() == 0
    assert fa.row_error_ratio(merged, whole, ROW_RTOL, ROW_ATOL) <= 1
# ring positions of a 4,096-slot cache: below T, at T - 1, past it, far
# past it, and a row with no slot
RING_POS = [100, 4095, 4200, 9000, -1, 0, 2047, 5000]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd", [
    (32, 8, 120),        # H2O-Danube-3-4B's decode: n_rep 4
    (32, 32, 80),        # Zamba2-2.7B's shared attention block: n_rep 1
    (32, 8, 80), (8, 8, 120),
    (17, 1, 120), (25, 1, 80)])    # the most M rows each takes (two tiles)
def test_decode_attention_head_dims_80_and_120(dev, dtype, h, kv, hd):
    """The built head_dims 80 and 120 at ring positions (< T, T - 1, > T,
    >> T), with a row of pos -1 that must come out as zeros."""
    b, t = len(RING_POS), 4096
    q, k, v = _attn_inputs([(b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)],
                           dtype, h + hd, dev)
    pos = torch.tensor(RING_POS, dtype=torch.int32, device=dev)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = dec.decode_attention_plain(q, k, v, pos)
    live = pos >= 0
    assert torch.count_nonzero(out[~live]).item() == 0
    out, want = out[live], want[live]
    assert out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= \
        ATTN_ATOL[dtype]
    assert fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL) <= 1


@pytest.mark.parametrize("h,kv,hd", [(32, 8, 120), (32, 32, 80)])
def test_decode_attention_head_dims_80_and_120_replay_from_a_graph(dev, h, kv,
                                                                   hd):
    """One bf16 call at each new head_dim captured in a CUDA graph replays
    to the eager call's bits."""
    pos = torch.tensor(RING_POS, dtype=torch.int32, device=dev)
    b = len(RING_POS)
    q, k, v = _attn_inputs([(b, 1, h, hd), (b, 4096, kv, hd),
                            (b, 4096, kv, hd)], torch.bfloat16, hd, dev)
    first = ops.decode_attention(q, k, v, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = ops.decode_attention(q, k, v, pos)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    want = dec.decode_attention_plain(q, k, v, pos)
    assert fa.row_error_ratio(first[:4], want[:4], ROW_RTOL, ROW_ATOL) <= 1


def test_decode_attention_in_a_cuda_graph_and_on_two_streams(dev):
    """The bf16 kernel's split counters belong to the call: a captured
    graph still replays right after an eager call at a larger B·KV, and
    calls on two streams at once each match their plain version."""
    pos = torch.tensor([1100, 3050], dtype=torch.int32, device=dev)
    q, k, v = _attn_inputs([(2, 1, 36, 128), (2, 4096, 4, 128),
                            (2, 4096, 4, 128)], torch.bfloat16, 5, dev)
    first = ops.decode_attention(q, k, v, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = ops.decode_attention(q, k, v, pos)
    pos8 = torch.tensor([4095, 3000, 2048, 1500, 700, 300, 64, 4095],
                        dtype=torch.int32, device=dev)
    q8, k8, v8 = _attn_inputs([(8, 1, 64, 128), (8, 4096, 16, 128),
                               (8, 4096, 16, 128)], torch.bfloat16, 6, dev)
    wide = ops.decode_attention(q8, k8, v8, pos8)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    assert (wide.float() - dec.decode_attention_plain(q8, k8, v8, pos8)
            .float()).abs().max().item() <= ATTN_ATOL[torch.bfloat16]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, args in zip(streams, [(q, k, v, pos), (q8, k8, v8, pos8)]):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([ops.decode_attention(*args) for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs[0])
    assert all(torch.equal(o, wide) for o in outs[1])


def test_serving_path_runs_the_attention_kernels(dev):
    """The reduced StarCoder2 in float32: `generate` launches one flash
    kernel per layer for its prefill and one decode kernel per layer per
    decode step, and its first tokens' logits match the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("starcoder2-7b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (3, 40))
    ops.reset_launches()
    Engine(cfg, card, max_len=64, device=dev).generate(prompts, 6)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["decode_attention"] == cfg.n_layers * 5
    last_c, _ = M.prefill(cfg, card, {"tokens": prompts}, 64, device=dev)
    last, _ = M.prefill(cfg, params, {"tokens": prompts}, 64, device="cpu")
    assert (last_c.cpu() - last).abs().max().item() <= 1e-4


def test_moe_serving_path_runs_the_attention_kernels(dev):
    """The reduced OLMoE in float32: `generate` launches one flash kernel
    per layer for its prefill and one decode kernel per layer per decode
    step, and its logits match the CPU's (the expert products and the
    dispatch stay PyTorch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("olmoe-1b-7b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (3, 40))
    ops.reset_launches()
    Engine(cfg, card, max_len=64, device=dev).generate(prompts, 6)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["decode_attention"] == cfg.n_layers * 5
    assert ops.LAUNCHES["ssd_chunk"] == 0
    last_c, _ = M.prefill(cfg, card, {"tokens": prompts}, 64, device=dev)
    last, _ = M.prefill(cfg, params, {"tokens": prompts}, 64, device="cpu")
    assert (last_c.cpu() - last).abs().max().item() <= 1e-4


def test_apply_moe_is_deterministic_on_the_card(dev):
    """bf16: two calls on the same inputs give the same bits (a token's k
    outputs are summed in a fixed order, no atomics); fp32: the card
    within 1e-5 of the CPU, at drops (capacity 0.25) and without."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("olmoe-1b-7b").reduced()
    g = torch.Generator().manual_seed(0)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": torch.randn((d, e), generator=g) * 0.05,
         "wi_gate": torch.randn((e, d, f), generator=g) * 0.05,
         "wi_up": torch.randn((e, d, f), generator=g) * 0.05,
         "wo": torch.randn((e, f, d), generator=g) * 0.05}
    x = torch.randn((4, 256, d), generator=g)
    pc = {k: w.to(dev) for k, w in p.items()}
    for cf in (0.25, None):
        y, aux = moe.apply_moe(cfg, p, x, capacity_factor=cf)
        yc, auxc = moe.apply_moe(cfg, pc, x.to(dev), capacity_factor=cf)
        assert (yc.cpu() - y).abs().max().item() <= 1e-5
        assert abs(auxc.item() - aux.item()) <= 1e-5
    pb = {k: w.to(torch.bfloat16) for k, w in pc.items()}
    xb = x.to(dev, torch.bfloat16)
    first, _ = moe.apply_moe(cfg, pb, xb)
    again, _ = moe.apply_moe(cfg, pb, xb)
    assert first.dtype == torch.bfloat16 and torch.equal(first, again)


# ssd_chunk: fp32 products in another order than the plain version's
# einsums, over up to 256 + 128 terms; held to 1e-4 of the largest value
SSD_RTOL = 1e-4


# ...and at the main shape to 1e-5, which one TF32 pass cannot meet
SSD_MAIN_RTOL = 1e-5


def ssd_inputs(b, nc, l, h, p, n, bc_dtype, slope, seed, dev, bc_scale=1.0,
               x_scale=1.0):
    """xd, acum as the model forms them (slope 0: the model's own decay,
    dt·a with dt a softplus and a = -exp(·) per head, xd = x·dt; else
    -slope·U(0, 1) a step); bm/cm as views into one wider (B, S, 2N + 8)
    tensor of N(0, bc_scale²) values, like the conv output they are cut
    from; xd scaled by x_scale."""
    g = torch.Generator().manual_seed(seed)
    xd = torch.randn((b, nc, l, h, p), generator=g)
    if slope:
        da = -slope * torch.rand((b, nc, l, h), generator=g)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, nc, l, h), generator=g))
        da = dt * -torch.exp(0.5 * torch.randn((h,), generator=g))
        xd = xd * dt[..., None]
    xd = xd * x_scale
    acum = torch.cumsum(da, dim=2)
    wide = (bc_scale * torch.randn((b, nc * l, 2 * n + 8), generator=g)
            ).to(bc_dtype)
    wide = wide.to(dev)
    bm = wide[..., 8:8 + n].reshape(b, nc, l, n)
    cm = wide[..., 8 + n:].reshape(b, nc, l, n)
    return xd.to(dev), acum.to(dev), bm, cm


@pytest.mark.parametrize("b,nc,l,h,p,n,bc_dtype,slope", [
    (1, 2, 32, 2, 16, 8, torch.float32, 0.1),
    (2, 4, 64, 4, 32, 16, torch.float32, 0.1),
    (1, 1, 128, 8, 64, 64, torch.float32, 0.1),
    (1, 1, 100, 48, 64, 128, torch.bfloat16, 2.0),      # ragged L
    (2, 3, 256, 12, 64, 40, torch.float32, 30.0),       # steep decay
    (4, 8, 256, 48, 64, 128, torch.bfloat16, 2.0),      # the serving shape
    (4, 8, 256, 48, 64, 128, torch.bfloat16, 0.0),      # ...model's decay
    (2, 3, 1, 48, 64, 128, torch.bfloat16, 0.0),        # L = 1
    (2, 1, 37, 48, 64, 128, torch.bfloat16, 0.0),       # ragged L = 37
    (2, 2, 256, 24, 16, 128, torch.bfloat16, 2.0),      # P = 16
    (2, 2, 256, 24, 32, 128, torch.bfloat16, 2.0)])     # P = 32
def test_ssd_chunk_kernel_matches_plain(dev, b, nc, l, h, p, n, bc_dtype,
                                        slope):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ssd_inputs(b, nc, l, h, p, n, bc_dtype, slope, l + h, dev)
    before = ops.LAUNCHES["ssd_chunk"]
    y, st = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunk"] == before + 1
    wy, wst = ssd.ssd_chunk_plain(*args)
    for got, want in ((y, wy), (st, wst)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= SSD_RTOL * want.abs().max().item(), err


def _ssd_rel_err(args):
    """Largest |kernel − plain| of y and of the states, each over its
    largest |plain| value."""
    y, st = ops.ssd_chunk(*args)
    wy, wst = ssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    for got in (y, st):
        assert torch.isfinite(got).all()
    return max(((got - want).abs().max() / want.abs().max()).item()
               for got, want in ((y, wy), (st, wst)))


def test_ssd_chunk_keeps_a_wide_range(dev):
    """B/C ×1e2 and xd ×1e-3: the split products keep their relative
    accuracy across the operands' range."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ssd_inputs(2, 4, 256, 48, 64, 128, torch.bfloat16, 0.0, 7, dev,
                      bc_scale=1e2, x_scale=1e-3)
    assert _ssd_rel_err(args) <= SSD_RTOL


def test_ssd_chunk_main_shape_within_1e5(dev):
    """At the serving shape with the model's decay, 1e-5 of the largest
    value: fp32 accuracy, which one TF32 pass (10 mantissa bits) of the
    fp32-operand products cannot give."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ssd_inputs(4, 8, 256, 48, 64, 128, torch.bfloat16, 0.0, 3, dev)
    assert _ssd_rel_err(args) <= SSD_MAIN_RTOL


def test_ssd_chunk_rejects_what_it_does_not_take(dev):
    xd, acum, bm, cm = ssd_inputs(1, 1, 32, 2, 16, 8, torch.float32, 0.1, 0,
                                  dev)
    with pytest.raises(ValueError, match="head dims"):
        ops.ssd_chunk(xd[..., :8].contiguous(), acum, bm, cm)
    with pytest.raises(TypeError):
        ops.ssd_chunk(xd, acum, bm, cm.bfloat16())
    big = ssd_inputs(1, 1, 300, 2, 16, 8, torch.float32, 0.1, 0, dev)
    with pytest.raises(ValueError, match="chunks of 1..256"):
        ops.ssd_chunk(*big)


def test_ssm_serving_path_runs_ssd_chunk(dev):
    """The reduced Mamba2 in float32: every prefill launches one ssd_chunk
    per layer, a decode step none, and the logits match the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mamba2-780m").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (3, 64))
    ops.reset_launches()
    Engine(cfg, card, max_len=128, device=dev).generate(prompts, 6)
    assert ops.LAUNCHES["ssd_chunk"] == cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["decode_attention"] == 0
    last_c, _ = M.prefill(cfg, card, {"tokens": prompts}, 128, device=dev)
    last, _ = M.prefill(cfg, params, {"tokens": prompts}, 128, device="cpu")
    assert (last_c.cpu() - last).abs().max().item() <= 1e-4


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-2.7b"])
def test_windowed_serving_path_runs_decode_attention(dev, arch):
    """The reduced H2O-Danube (sliding window) and Zamba2 (hybrid) in
    float32, with prompts that fill their 64-slot rings: `generate`'s
    prefill launches one flash kernel per attention block (and Zamba2 one
    ssd_chunk per layer), each decode step, on the wrapped ring, one decode
    kernel per attention block; the logits match the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (3, 64))
    blocks = (cfg.n_layers // cfg.shared_attn_period
              if cfg.family == "hybrid" else cfg.n_layers)
    ops.reset_launches()
    Engine(cfg, card, max_len=128, device=dev).generate(prompts, 6)
    assert ops.LAUNCHES["flash_attention"] == blocks
    assert ops.LAUNCHES["decode_attention"] == blocks * 5
    assert ops.LAUNCHES["ssd_chunk"] == (cfg.n_layers
                                         if cfg.family == "hybrid" else 0)
    last_c, cache_c = M.prefill(cfg, card, {"tokens": prompts}, 128,
                                device=dev)
    last, cache = M.prefill(cfg, params, {"tokens": prompts}, 128,
                            device="cpu")
    assert (last_c.cpu() - last).abs().max().item() <= 1e-4
    nxt = last.argmax(-1)[:, None]
    pos = torch.tensor([64, 100, 63], dtype=torch.int32)
    step_c, _ = M.decode_step(cfg, card, nxt, cache_c, pos.to(dev),
                              device=dev)
    step, _ = M.decode_step(cfg, params, nxt, cache, pos, device="cpu")
    assert (step_c.cpu() - step).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd", [
    # ragged S != T on the bf16 kernel's 128-row and 128-key tile edges
    (2, 7, 300, 8, 2, 64), (1, 129, 77, 9, 1, 128), (1, 300, 129, 8, 2, 128),
    # Whisper's cross-attention in prefill: a 64-token prompt against
    # 1,500 encoder frames (20 / 20 heads of 64), and its encoder's
    # self-attention (11 tiles of 128 rows and 92)
    (4, 64, 1500, 20, 20, 64), (1, 1500, 1500, 20, 20, 64)])
def test_flash_attention_non_causal_s_not_t_matches_plain(dev, dtype, b, s, t,
                                                          h, kv, hd):
    """Non-causal attention of S queries over T keys, keys past T masked by
    the kernel (no padding of T outside it)."""
    q, k, v = _attn_inputs([(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)],
                           dtype, s + t, dev)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=False)
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= \
        ATTN_ATOL[dtype]
    assert fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 65, 1499, 1500])
def test_decode_attention_whole_cache_at_ragged_t(dev, dtype, t):
    """Cross-attention decode: every row at pos T - 1 reads all T slots,
    T ragged against the 64-slot tile (Whisper's 1,500 frames among
    them), against the plain version's unmasked softmax."""
    b, h, kv, hd = 8, 20, 20, 64
    q, k, v = _attn_inputs([(b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)],
                           dtype, t, dev)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, k, v, pos)
    want = dec.decode_attention_plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() <= \
        ATTN_ATOL[dtype]
    assert fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL) <= 1


def _reduced_on_card(arch, dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    return cfg, params, convert.params_to(params, dev)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-large-v3"])
def test_vlm_and_audio_serving_paths_run_the_attention_kernels(dev, arch):
    """The reduced Qwen2-VL and Whisper in float32: `generate`'s prefill
    launches one flash kernel per attention (Whisper: encoder, self and
    cross), each decode step one decode kernel per attention (Whisper: self
    and cross); the prefill's logits match the CPU's."""
    cfg, params, card = _reduced_on_card(arch, dev)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (3, 40))
    audio = cfg.family == "audio"
    ops.reset_launches()
    Engine(cfg, card, max_len=64, enc_frames=64, device=dev).generate(
        prompts, 6)
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers if audio else \
        cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == per_prefill
    assert ops.LAUNCHES["decode_attention"] == \
        (2 if audio else 1) * cfg.n_layers * 5
    gen = np.random.default_rng(1)
    extra = ({"frames": gen.standard_normal((3, 64, cfg.d_model),
                                            dtype=np.float32)} if audio else
             {"vision_embeds": gen.standard_normal((3, 5, cfg.d_model),
                                                   dtype=np.float32)})
    inputs = {"tokens": prompts, **extra}
    last_c, _ = M.prefill(cfg, card, inputs, 64, device=dev)
    last, _ = M.prefill(cfg, params, inputs, 64, device="cpu")
    assert (last_c.cpu() - last).abs().max().item() <= 1e-4


def test_whisper_decode_step_replays_from_a_cuda_graph(dev):
    """One decode step of the reduced Whisper (self and cross attention
    through `decode_attention`) captured in a CUDA graph replays to the
    eager step's logits and self cache, bit for bit."""
    cfg, _, card = _reduced_on_card("whisper-large-v3", dev)
    prompts = np.random.default_rng(2).integers(2, cfg.vocab, (4, 12))
    frames = np.random.default_rng(3).standard_normal((4, 64, cfg.d_model),
                                                      dtype=np.float32)
    _, cache = M.prefill(cfg, card, {"tokens": prompts, "frames": frames},
                         32, device=dev)
    tok = torch.full((4, 1), 5, dtype=torch.int64, device=dev)
    pos = torch.tensor([12, 12, 20, 7], dtype=torch.int32, device=dev)

    def clone(c):
        return {n: {k: v.clone() for k, v in part.items()}
                for n, part in c.items()}

    eager_cache = clone(cache)
    eager, _ = M.decode_step(cfg, card, tok, eager_cache, pos, device=dev)
    graph_cache = clone(cache)
    M.decode_step(cfg, card, tok, clone(cache), pos, device=dev)   # warm-up
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    ops.reset_launches()
    with torch.cuda.graph(graph, stream=side):
        captured, _ = M.decode_step(cfg, card, tok, graph_cache, pos,
                                    device=dev)
    assert ops.LAUNCHES["decode_attention"] == 2 * cfg.n_layers
    for k in ("k", "v"):
        graph_cache["self"][k].copy_(cache["self"][k])
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    for k in ("k", "v"):
        assert torch.equal(graph_cache["self"][k], eager_cache["self"][k])


# ============================================ policies and the protocol split
def _corpus_rows(k, m, seed):
    """(stats, t) rows as `tests/test_torch_fleet.py:_corpus` makes them."""
    rng = np.random.default_rng(seed)
    t_mu = rng.integers(0, 30, (m, k)).astype(np.float32)
    stats = {"mu_hat": rng.uniform(0, 1, (m, k)) * (t_mu > 0),
             "c_hat": rng.uniform(0, 0.6, (m, k)) * (t_mu > 0),
             "t_mu": t_mu, "t_c": t_mu}
    stats = {n: torch.tensor(v, dtype=torch.float32) for n, v in
             stats.items()}
    return stats, torch.tensor(rng.integers(1, 200, m), dtype=torch.float32)


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_per_seed_c2mabv_masks_equal_card_and_cpu(dev, kind):
    """Per-seed C2MAB-V through the kernels on the card picks, row for row,
    the masks the plain versions pick on the CPU from the same stats and
    keys (every transcendental rounded from float64, the kernels bit-equal
    to their plain versions)."""
    from repro_torch import prng
    from repro_torch.core.policies import PolicyConfig, make_policy
    from repro_torch.env.llm_profiles import default_rho, paper_pool
    pool = paper_pool("sciq")
    pc = PolicyConfig(kind=kind, k=pool.k, n=4,
                      rho=default_rho(pool, kind, 4), delta=1 / 60)
    stats, t = _corpus_rows(pool.k, 512, 11)
    keys = prng.split(prng.PRNGKey(5, "cpu"), 512)
    ops.reset_launches()
    card = make_policy("c2mabv", pc, device=dev)(
        {n: v.to(dev) for n, v in stats.items()}, keys.to(dev), t.to(dev))
    assert ops.LAUNCHES["topn_lp"] > 0
    assert (ops.LAUNCHES["awc_fw"] > 0) == (kind == "awc")
    cpu = make_policy("c2mabv", pc, device="cpu")(stats, keys, t)
    assert torch.equal(card.cpu(), cpu)


def test_baselines_simulate_on_the_card(dev):
    """Every policy through the per-seed loop on the card; the
    deterministic ones pick the CPU's actions."""
    from repro_torch.core import bandit
    from repro_torch.core.policies import NAMES, PolicyConfig
    from repro_torch.env.llm_profiles import default_rho, paper_pool
    pool = paper_pool("sciq")
    pc = PolicyConfig(kind="awc", k=pool.k, n=4,
                      rho=default_rho(pool, "awc", 4), delta=1 / 16)
    for name in NAMES:
        kw = {"arm": 8} if name == "fixed" else (
            {"mask": np.eye(pool.k)[2]} if name == "offline_fixed" else {})
        res = bandit.simulate(name, pool, pc, T=16, seeds=3, use_fleet=False,
                              device=dev, **kw)
        assert np.isfinite(res.reward).all() and (res.action.sum(-1) <= 4).all()
        if name in ("cucb", "fixed", "offline_fixed", "c2mabv_direct"):
            ref = bandit.simulate(name, pool, pc, T=16, seeds=3,
                                  use_fleet=False, device="cpu", **kw)
            assert np.array_equal(res.action[:, 0], ref.action[:, 0]), name


def test_local_server_and_cloud_on_the_card(dev):
    """`LocalServer` and `SchedulingCloud` on the card give the CPU's z̃ and
    masks over a recorded sequence."""
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho, paper_pool
    from repro_torch.router.cloud import Replica, SchedulingCloud
    from repro_torch.router.local_server import LocalServer
    pool = paper_pool("sciq")
    for kind in ("awc", "suc"):
        pc = PolicyConfig(kind=kind, k=pool.k, n=4,
                          rho=default_rho(pool, kind, 4), delta=1 / 16)
        servers = [LocalServer(pc, device=d) for d in (dev, "cpu")]
        clouds = [SchedulingCloud(pc, [Replica(f"m{i}", None, 1e-3)
                                       for i in range(pool.k)], device=d)
                  for d in (dev, "cpu")]
        rng = np.random.default_rng(0)
        for _ in range(12):
            zs = [s.relaxed_selection() for s in servers]
            assert np.array_equal(zs[0], zs[1])
            masks = [c.select(zs[0], np.random.default_rng(7))
                     for c in clouds]
            assert np.array_equal(masks[0], masks[1])
            for arm in np.flatnonzero(masks[0]):
                reward, cost = float(rng.uniform()), float(rng.uniform())
                for s in servers:
                    s.record(int(arm), reward, cost)
        assert np.array_equal(servers[0].mu_hat, servers[1].mu_hat)
        assert servers[0].state.stats["mu_hat"].device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_flash_attention_at_a_16_token_prefill_bucket(dev, dtype, b):
    """A scheduler's prefill bucket of b requests' rows of 16 tokens at
    StarCoder2-7B's heads: far below the kernel's 128-row tiles."""
    g = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn((b, 16, 36, 128), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, 16, 4, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - want.float()).abs().max().item() <= atol


def test_scheduler_ticks_on_the_card_match_the_cpu(dev):
    """The same requests through a `ReplicaRunner` on the card and on the
    CPU (reduced StarCoder2, float32, TF32 off, the same weights): after
    every tick the same slot progress and tokens, logits within 1e-4,
    and the same completions; the card's ticks launch the kernels the
    tick log counts."""
    from repro_torch.serving.scheduler import ReplicaRunner, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("starcoder2-7b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    engines = [Engine(cfg, p, max_len=48, temperature=0.7, device=d)
               for p, d in ((convert.params_to(params, dev), dev),
                            (params, "cpu"))]
    runners = [ReplicaRunner(e, n_slots=6, chunk=4) for e in engines]
    rng = np.random.default_rng(1)
    for i, (rows, s, mn) in enumerate([(2, 16, 12), (1, 16, 8), (2, 9, 16),
                                       (3, 16, 6)]):
        p = rng.integers(2, cfg.vocab, (rows, s))
        for r in runners:
            r.submit(Request(tenant=i, arm=0, prompts=p, max_new=mn,
                             seed=10 + i))
    done = [[], []]
    ops.reset_launches()
    while any(r.busy for r in runners):
        for r, sink in zip(runners, done):
            sink.extend(r.step())
        card, cpu = (r.state for r in runners)
        for name in ("out", "n_out", "step", "pos", "finished", "active"):
            assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
        assert (card.last.cpu() - cpu.last).abs().max().item() <= 1e-4
    assert [c.request.seed for c in done[0]] == \
        [c.request.seed for c in done[1]]
    for a, b in zip(*done):
        np.testing.assert_array_equal(a.result.tokens, b.result.tokens)
        np.testing.assert_array_equal(a.result.out_lens, b.result.out_lens)
    log = runners[0].tick_log
    assert ops.LAUNCHES["flash_attention"] == \
        cfg.n_layers * sum(t.buckets for t in log)
    assert ops.LAUNCHES["decode_attention"] == \
        cfg.n_layers * sum(t.decode_steps for t in log)


def test_kernels_without_a_gradient_raise_under_grad(dev):
    """decode_attention, topn_lp and awc_fw have no gradient: on the card
    they raise rather than return an output that drops one; under
    no_grad, or with inputs that need none, they launch."""
    q = torch.randn((2, 1, 4, 64), device=dev)
    kv = torch.randn((2, 16, 2, 64), device=dev)
    x = torch.rand((4, 9), device=dev)
    n = torch.full((4,), 3, dtype=torch.int32, device=dev)
    lams = torch.rand((4, 5), device=dev)
    calls = {"decode_attention": lambda a: ops.decode_attention(a, kv, kv, 7),
             "topn_lp": lambda a: ops.topn_lp(a, x, n),
             "awc_fw": lambda a: ops.awc_fw(a, x, x, lams, n)}
    for name, call in calls.items():
        arg = (q if name == "decode_attention" else x).clone()
        before = ops.LAUNCHES[name]
        call(arg)
        with pytest.raises(RuntimeError, match="has no gradient"):
            call(arg.requires_grad_())
        with torch.no_grad():
            call(arg)
        assert ops.LAUNCHES[name] == before + 2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_functions_give_the_plain_gradient_on_the_card(dev, dtype):
    """flash_attention and ssd_chunk under autograd on the card: the
    forward launches the kernel once, the backward differentiates the plain
    version (no launch), so the gradients are the plain version's on the
    kernel's inputs (fp32 exactly; bf16 to a bf16 rounding)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 200, 8, 64), generator=g).to(dev, dtype)
    k, v = (torch.randn((2, 200, 2, 64), generator=g).to(dev, dtype)
            for _ in range(2))
    xs = [t.requires_grad_() for t in (q, k, v)]
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(*xs, causal=True, window=None)
    cot = torch.randn(out.shape, generator=g).to(dev, dtype)
    got = torch.autograd.grad(out, xs, cot)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = torch.autograd.grad(fa.flash_attention_plain(*xs), xs, cot)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    xd = torch.randn((2, 2, 64, 4, 16), generator=g).to(dev)
    acum = torch.cumsum(-torch.rand((2, 2, 64, 4), generator=g),
                        2).to(dev)
    bm, cm = (torch.randn((2, 2, 64, 32), generator=g).to(dev, dtype)
              for _ in range(2))
    xs = [t.requires_grad_() for t in (xd, acum, bm, cm)]
    before = ops.LAUNCHES["ssd_chunk"]
    y, states = ops.ssd_chunk(*xs)
    cots = [torch.randn(t.shape, generator=g).to(dev) for t in (y, states)]
    got = torch.autograd.grad((y, states), xs, cots)
    assert ops.LAUNCHES["ssd_chunk"] == before + 1
    want = torch.autograd.grad(ssd.ssd_chunk_plain(*xs), xs, cots)
    for a, b, x in zip(got, want, xs):
        assert a.dtype == x.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
