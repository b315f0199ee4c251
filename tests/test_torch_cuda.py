"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present, so on a
machine without a card they count as skips. This file imports no JAX, so it
runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import awc_fw as awc
from repro_torch.kernels import ops
from repro_torch.kernels import topn_lp as topn

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
