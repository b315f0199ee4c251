// awc_fw: fused AWC Frank-Wolfe gradient + lambda-probe costs, one warp per
// row (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/awc_fw.py:awc_fw.
// For each row b of (B, K) z, mu, c, a row of G lambdas and a cardinality n:
//
//   muc_k = min(max(mu_k, 0), 1 - 1e-6)
//   g_k   = muc_k * exp(T - log1p(-muc_k z_k)),  T = sum_j log1p(-muc_j z_j)
//   cost_bg = sum_k c_k [rank_k(g - lam_g c) < n] [g_k > lam_g c_k]
//
// log1p and exp are evaluated in double and rounded once to float, as the
// plain version (rewards.log1p_f32 / exp_f32) does on any device: CUDA's
// log1pf/expf and the CPU's differ in the last bit on some inputs, and one
// ulp in g can flip a degenerate LP vertex of the Frank-Wolfe step.
//
// The ranks use the crossing form of core/ranks.py: "j beats i" is
// (g_j - g_i) > lam (c_j - c_i), or equality and j < i, with __fsub_rn and
// __fmul_rn, and positivity is g_i > __fmul_rn(lam, c_i). The score
// g - lam c is never formed: nvcc's default --fmad=true would contract it
// into an FMA in some copies and not others, and near a crossing two arms
// could then both beat each other.
//
// Bound on the H100: launches. At the main path's shape (1,365 rows,
// K = 9, G = 25) a call moves ~0.5 MB (~0.15 us at 3.35 TB/s) and does
// ~11 M compares (~0.2 us at 67 TFLOP/s fp32), far below the cost of the
// launch, and the FW loop issues 8 of them per round.
//
// Design: one warp per row, 8 rows per block while they fit in 48 KB of
// shared memory. The warp stages c, the gradient and a scratch row in
// shared memory; lanes compute the log terms, lane 0 sums them in arm-index
// order and broadcasts the total, lanes form g; then for each lambda each
// lane ranks its arms with a loop over j, writes its masked cost, and lane 0
// sums the row in arm-index order. The plain PyTorch version sums in the
// same order. The ragged K edge is handled by loop bounds.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kMuMax = 0.999999f;  // 1 - 1e-6 rounded to float

__global__ void awc_fw_kernel(const float* __restrict__ z,
                              const float* __restrict__ mu,
                              const float* __restrict__ c,
                              const float* __restrict__ lams,
                              const int* __restrict__ n,
                              float* __restrict__ g_out,
                              float* __restrict__ costs,
                              long long rows, int k, int g_pts) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // uniform across the warp
  float* gs = smem + (size_t)warp * 3 * k;
  float* cs = gs + k;
  float* v = cs + k;
  const long long base = row * k;

  for (int i = lane; i < k; i += kWarp) {
    const float m = fminf(fmaxf(mu[base + i], 0.f), kMuMax);
    gs[i] = m;
    cs[i] = c[base + i];
    v[i] = (float)log1p((double)(-__fmul_rn(m, z[base + i])));
  }
  __syncwarp();
  float total = 0.f;
  if (lane == 0)
    for (int i = 0; i < k; ++i) total = __fadd_rn(total, v[i]);
  total = __shfl_sync(0xffffffffu, total, 0);
  for (int i = lane; i < k; i += kWarp) {
    const float g = __fmul_rn(
        gs[i], (float)exp((double)__fsub_rn(total, v[i])));
    gs[i] = g;
    g_out[base + i] = g;
  }
  __syncwarp();

  const int nr = n[row];
  for (int p = 0; p < g_pts; ++p) {
    const float lam = lams[row * g_pts + p];
    for (int i = lane; i < k; i += kWarp) {
      const float gi = gs[i];
      const float ci = cs[i];
      int rank = 0;
      for (int j = 0; j < k; ++j) {
        const float dw = __fsub_rn(gs[j], gi);
        const float lhs = __fmul_rn(lam, __fsub_rn(cs[j], ci));
        rank += (dw > lhs) || (dw == lhs && j < i);
      }
      const bool sel = rank < nr && gi > __fmul_rn(lam, ci);
      v[i] = __fmul_rn(sel ? 1.f : 0.f, ci);
    }
    __syncwarp();
    if (lane == 0) {
      float acc = 0.f;
      for (int i = 0; i < k; ++i) acc = __fadd_rn(acc, v[i]);
      costs[row * g_pts + p] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int awc_fw_launch(const void* z, const void* mu, const void* c,
                             const void* lams, const void* n, void* g_out,
                             void* costs, long long rows, int k, int g_pts,
                             void* stream) {
  if (rows <= 0 || k <= 0 || g_pts <= 0) return (int)cudaErrorInvalidValue;
  const size_t per_warp = 3 * sizeof(float) * (size_t)k;
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        awc_fw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + warps - 1) / warps;
  awc_fw_kernel<<<(unsigned)blocks, warps * kWarp, smem,
                  (cudaStream_t)stream>>>(
      (const float*)z, (const float*)mu, (const float*)c,
      (const float*)lams, (const int*)n, (float*)g_out, (float*)costs,
      rows, k, g_pts);
  return (int)cudaGetLastError();
}
