"""The port's kernel modules on the CPU: each plain version against
`repro.kernels.ref` at the shapes and tie/positivity cases of
`tests/test_kernels.py`, and the device dispatch of `kernels.ops` — a CPU
tensor takes the plain version, a CUDA tensor the kernel or an error, never
the plain version. Masks are held exact; gradients to atol 2e-6 (log1p/exp
may differ from XLA's in the last bit); costs to atol 1e-6 at the fleet's
K = 9, and at wider K to the float32 error of two summation orders over the
same selected terms, K·2⁻²⁴·Σ|cost| (the plain versions sum in arm-index
order, as the kernels do; XLA sums in its own order). The kernels
themselves are held against these plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ranks as jranks
from repro.kernels import ref
from repro_torch.core import ranks
from repro_torch.kernels import awc_fw as awc
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import topn_lp as topn

torch.set_num_threads(1)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def assert_costs_close(got, want, cost):
    """atol 1e-6 at K <= 9; else the two-order float32 summation bound."""
    k = cost.shape[-1]
    bound = 1e-6 if k <= 9 else k * 2.0 ** -24 * np.abs(cost).sum(-1)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def topn_inputs(b, k, seed):
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(b, k)).astype(np.float32)
    score[::4, 1::3] = score[::4, :1]          # exact ties inside rows
    cost = rng.uniform(size=(b, k)).astype(np.float32)
    n = rng.integers(1, k + 1, b).astype(np.int32)
    return score, cost, n


@pytest.mark.parametrize("b,k", [(4, 9), (8, 128), (5, 130), (33, 40)])
@pytest.mark.parametrize("equality", [True, False])
def test_topn_lp_plain_matches_ref(b, k, equality):
    score, cost, n = topn_inputs(b, k, b * 100 + k)
    want = np.asarray(ref.topn_lp(jnp.asarray(score), jnp.asarray(cost),
                                  jnp.asarray(n), equality=equality))
    got = topn.topn_lp_plain(t(score), t(cost), t(n, torch.int32),
                             equality=equality).numpy()
    assert_costs_close(got, want, cost)
    mask_w = np.asarray(jranks.topn_mask(jnp.asarray(score), jnp.asarray(n),
                                         equality))
    mask_p = ranks.topn_mask(t(score), t(n, torch.int32), equality).numpy()
    assert np.array_equal(mask_w, mask_p)
    assert np.array_equal(got, ops.topn_lp(t(score), t(cost),
                                           t(n, torch.int32),
                                           equality=equality).numpy())


def test_topn_lp_plain_tie_order():
    score = np.float32([[0.5, 0.7, 0.5, 0.7, 0.1], [1.0] * 5])
    cost = np.float32([[1.0, 2.0, 4.0, 8.0, 16.0]] * 2)
    n = np.int32([3, 2])
    got = topn.topn_lp_plain(t(score), t(cost), t(n, torch.int32)).numpy()
    assert np.array_equal(got, np.float32([11.0, 3.0]))
    want = np.asarray(ref.topn_lp(jnp.asarray(score), jnp.asarray(cost),
                                  jnp.asarray(n)))
    assert np.array_equal(got, want)


def awc_inputs(b, k, g, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(size=(b, k)).astype(np.float32)
    mu = rng.uniform(0.05, 0.99, (b, k)).astype(np.float32)
    mu[::5, :2] = 1.0                          # clipped to 1 − 1e−6
    cost = rng.uniform(0.01, 0.6, (b, k)).astype(np.float32)
    lams = rng.uniform(0.0, 4.0, (b, g)).astype(np.float32)
    n = rng.integers(1, k + 1, b).astype(np.int32)
    return z, mu, cost, lams, n


@pytest.mark.parametrize("b,k,g", [(4, 9, 25), (8, 128, 4), (5, 130, 3),
                                   (33, 40, 2)])
def test_awc_fw_plain_matches_ref(b, k, g):
    z, mu, cost, lams, n = awc_inputs(b, k, g, b * 1000 + k + g)
    gw, cw = ref.awc_fw(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(cost),
                        jnp.asarray(lams), jnp.asarray(n))
    gp, cp = awc.awc_fw_plain(t(z), t(mu), t(cost), t(lams),
                              t(n, torch.int32))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gw), atol=2e-6, rtol=0)
    assert_costs_close(cp.numpy(), np.asarray(cw), cost[:, None, :])
    # masks exact: the plain version's vertices on the reference's gradient
    mask_w = np.asarray(jax.vmap(lambda a, c, l, m: jranks.lagrangian_topn_mask(
        a, c, l, m, False))(gw, jnp.asarray(cost), jnp.asarray(lams),
                            jnp.asarray(n)))
    mask_p = ranks.lagrangian_topn_mask(t(np.asarray(gw)), t(cost), t(lams),
                                        t(n, torch.int32), False).numpy()
    assert np.array_equal(mask_w, mask_p)
    go, co = ops.awc_fw(t(z), t(mu), t(cost), t(lams), t(n, torch.int32))
    assert np.array_equal(go.numpy(), gp.numpy())
    assert np.array_equal(co.numpy(), cp.numpy())


def test_awc_fw_plain_tie_order_and_positivity():
    z = np.zeros((2, 4), np.float32)           # gradient == clipped mu
    mu = np.float32([[0.5, 0.5, 0.25, 0.5], [0.5, 0.25, 0.125, 0.0625]])
    cost = np.float32([[1.0, 2.0, 1.0, 4.0], [1.0, 1.0, 1.0, 1.0]])
    lams = np.float32([[0.0, 0.25], [0.0, 0.25]])
    n = np.int32([3, 2])
    _, cw = ref.awc_fw(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(cost),
                       jnp.asarray(lams), jnp.asarray(n))
    _, cp = awc.awc_fw_plain(t(z), t(mu), t(cost), t(lams), t(n, torch.int32))
    assert np.array_equal(cp.numpy(), np.asarray(cw))
    assert cp[0, 1] == 1.0     # row 0, λ=0.25: only arm 0 has a positive score


def test_awc_fw_plain_gradient_is_exact_on_the_z0_rows():
    """At z̃ = 0 the gradient is the clipped μ exactly (log1p(0) = 0 and
    exp(0) = 1) — the rows the first FW step of every tenant sees."""
    mu = np.float32([[0.3, 1.0, 0.999999, 0.0, 0.5]])
    g, _ = awc.awc_fw_plain(t(np.zeros_like(mu)), t(mu), t(np.ones_like(mu)),
                            t(np.float32([[1.0]])), t(np.int32([2]),
                                                      torch.int32))
    assert np.array_equal(g.numpy(), np.clip(mu, 0, np.float32(1 - 1e-6)))


def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("b,k,g", [(1365, 9, 25), (200000, 9, 1)])
def test_awc_fw_plain_bits_do_not_depend_on_the_thread_count(b, k, g):
    """F5: the plain awc_fw, each time the first call of a fresh
    interpreter, at 1 and at 8 CPU threads gives the same g and costs to
    the bit, at the fleet's AWC shape and at 200,000 rows (above ATen's
    32,768-element grain, so its elementwise ops split over the threads).
    `chip_smoke.py` runs the same check in phase 4 on the card's host."""
    smoke = _chip_smoke()
    runs = [smoke.awc_plain_bits(b, k, g, threads)
            for threads in smoke.F5_THREADS]
    assert [used for used, _, _ in runs] == list(smoke.F5_THREADS)
    assert runs[0][1:] == runs[1][1:]


# ================================================== dispatch: no fallback
class _ClaimsCuda:
    """A stand-in tensor that says it lives on CUDA (this host has none)."""
    device = torch.device("cuda", 0)
    dtype = torch.float32
    shape = (2, 9)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(topn, "topn_lp_plain", boom)
    monkeypatch.setattr(awc, "awc_fw_plain", boom)
    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    monkeypatch.setattr(dec, "decode_attention_plain", boom)
    monkeypatch.setattr(ssd, "ssd_chunk_plain", boom)
    x = _ClaimsCuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.topn_lp(x, x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.awc_fw(x, x, x, x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.flash_attention(x, x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.decode_attention(x, x, x, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.ssd_chunk(x, x, x, x)
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNELS}


def test_other_devices_raise():
    x = torch.zeros((2, 9), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.topn_lp(x, x, torch.zeros((2,), dtype=torch.int32,
                                      device="meta"))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never substitutes anything."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path / "kernels")
    import pathlib
    real = pathlib.Path.is_file
    monkeypatch.setattr(pathlib.Path, "is_file",
                        lambda p: False if p.name == "nvcc" else real(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.build(["topn_lp"])


def test_kernel_sources_and_build_flags():
    """Each kernel is CUDA C++ in the repo, built for sm_90a with a plain C
    entry; the library name follows the source's content; REPLACES names
    the line of the JAX package's Pallas kernel function of that name."""
    root = Path(__file__).resolve().parents[1]
    for name, mod in ops.KERNELS.items():
        src = mod.SOURCE.read_text()
        assert mod.SOURCE.suffix == ".cu"
        assert f'extern "C" int {mod.ENTRY}' in src
        assert "cudaGetLastError" in src
        assert name in ops.library_path(name).name
        path, line = mod.REPLACES.rsplit(":", 1)
        assert path.startswith("src/repro/kernels/")
        body = (root / path).read_text()
        assert body.splitlines()[int(line) - 1].startswith(f"def {name}(")
        assert "pl.pallas_call" in body
    assert "arch=compute_90a,code=sm_90a" in ops.NVCC_FLAGS
    assert ops.BUILD_DIR.parts[-2:] == ("build", "kernels")


# ============================================================ ssd_chunk
def test_ssd_chunk_products_run_on_the_tensor_cores():
    """One kernel: bf16 C Bᵀ by an m16n8k16 mma, the fp32-operand products
    by m16n8k8 TF32 mmas on split operands; no CUDA-core product loops."""
    src = ssd.SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert src.count("__global__") == 1
    assert "fmaf(" not in src


def test_ssd_cost_counts_the_main_shape():
    """`chip_smoke.ssd_cost` and the tensor-core bound at the SSM prefill's
    shape (B 4, NC 8, L 256, H 48, P 64, N 128, B/C bf16), counted by hand:
    bytes 4·(2·25,165,824 + 393,216 + 12,582,912) + 2·2·1,048,576;
    operations 32·(256²·128 + 256²·64·48 + 2·256·128·64·48)."""
    smoke = _chip_smoke()
    xd = torch.empty((4, 8, 256, 48, 64), device="meta")
    bm = torch.empty((4, 8, 256, 128), dtype=torch.bfloat16, device="meta")
    nbytes, nops = smoke.ssd_cost(xd, bm)
    assert nbytes == 257_425_408
    assert nops == 13_153_337_344
    # fp32 CUDA cores: operations, 13.15 GFLOP at 67 TFLOP/s
    ms, by = smoke.bound(nbytes, nops)
    assert by == "operations" and ms == pytest.approx(0.196318, rel=1e-5)
    # tensor cores: C Bᵀ 268,435,456 at 989 TFLOP/s; the scores product
    # 6,442,450,944 three times and the state product 6,442,450,944 twice
    # at 495: 0.06534 ms, under the 0.07684 ms the bytes take
    tops = smoke.ssd_tensor_ops(xd, bm)
    assert tops == pytest.approx(
        268_435_456 * 495 / 989 + 5 * 6_442_450_944, rel=1e-12)
    ms, by = smoke.bound(nbytes, tops, smoke.TF32_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.076843, rel=1e-4)
    assert tops / smoke.TF32_OPS_PER_S * 1e3 == pytest.approx(0.065342,
                                                            rel=1e-4)
    # fp32 B/C: every product in three TF32 passes
    bm32 = torch.empty((4, 8, 256, 128), device="meta")
    assert smoke.ssd_tensor_ops(xd, bm32) == 3 * nops


def test_ssd_check_inputs_states_alignment_and_width():
    """The kernel copies B/C rows with 16-byte cp.async: their base and
    strides must be multiples of 16 bytes, and N at most MAX_N; the
    model's views (row stride 3,328 bf16, offsets 3,072 and 3,200) pass."""
    def views(width, off, n, dtype=torch.bfloat16, l=32):
        wide = torch.zeros((1, 2 * l, width), dtype=dtype)
        return (wide[..., off:off + n].reshape(1, 2, l, n),
                wide[..., off + n:off + 2 * n].reshape(1, 2, l, n))
    xd = torch.zeros((1, 2, 32, 4, 64))
    acum = torch.zeros((1, 2, 32, 4))
    ssd.check_inputs(xd, acum, *views(3328, 3072, 128)[::-1])
    ssd.check_inputs(xd, acum, *views(3328, 3072, 128))
    ssd.check_inputs(xd, acum, *views(544, 512, 16, torch.float32))
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ssd.check_inputs(xd, acum, *views(3328, 3071, 128))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd.check_inputs(xd, acum, *views(3330, 3072, 128))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd.check_inputs(xd, acum, *views(546, 512, 16, torch.float32))
    with pytest.raises(ValueError, match="states of 1..128"):
        ssd.check_inputs(xd, acum, *views(3328, 2816, 256))
