// awc_fw: fused AWC Frank-Wolfe gradient + lambda-probe costs (sm_90a).
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
// Bound on the H100: operations, and in practice the launch. At the main
// path's shape (1,365 rows, K = 9, G = 25) a call moves ~0.5 MB (~0.14 us
// at 3.35 TB/s) and does ~12 M operations (~0.18 us at 67 TFLOP/s fp32),
// far below the cost of a launch; the FW loop issues 8 of them per round.
//
// Design, K <= 32 (the main path): a block takes R rows, R*G threads close
// to 256 (R = 10 at G = 25) and R*K <= 4,096. Phase 1, a thread per
// (row, arm): the clipped mu, c and the log term go to shared memory; each
// thread sums its row's log terms in arm-index order (K adds, as the plain
// version's sum_in_order) and writes g to shared memory and, coalesced, to
// g_out. Phase 2, a thread per (row, lambda): the row's g and c in
// registers, the K^2 crossing compares fully unrolled over the template's
// K cap (with j < i known at compile time, "dw > lhs or dw == lhs and
// j < i" is dw >= lhs for j < i and dw > lhs for j > i), the masked costs
// summed in arm-index order, costs[row, p] written coalesced.
//
// K > 32: one warp per row, 8 rows to a block while they fit in 48 KB of
// shared memory; lanes rank their arms over a loop on j for each lambda in
// turn, lane 0 sums each row in arm-index order.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kThreads = 256;        // threads a block, K <= 32
constexpr int kSpan = 4096;          // most R*K floats a block stages
constexpr float kMuMax = 0.999999f;  // 1 - 1e-6 rounded to float

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
awc_fw_rows_kernel(const float* __restrict__ z, const float* __restrict__ mu,
                   const float* __restrict__ c,
                   const float* __restrict__ lams,
                   const int* __restrict__ n, float* __restrict__ g_out,
                   float* __restrict__ costs, long long rows, int k,
                   int g_pts, int rows_per_block) {
  extern __shared__ float smem[];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = rows - row0;
  const int nrows = left < rows_per_block ? (int)left : rows_per_block;
  const int span = nrows * k;
  float* gs = smem;                     // clipped mu, then g
  float* cs = gs + rows_per_block * k;  // c
  float* vs = cs + rows_per_block * k;  // log1p(-muc z)
  const long long base = row0 * k;

  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const float m = fminf(fmaxf(mu[base + e], 0.f), kMuMax);
    gs[e] = m;
    cs[e] = c[base + e];
    vs[e] = (float)log1p((double)(-__fmul_rn(m, z[base + e])));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const float* v = vs + (e / k) * k;
    float total = 0.f;
    for (int j = 0; j < k; ++j) total = __fadd_rn(total, v[j]);
    const float g = __fmul_rn(gs[e], (float)exp((double)__fsub_rn(total,
                                                                  vs[e])));
    gs[e] = g;
    g_out[base + e] = g;
  }
  __syncthreads();

  const int probes = nrows * g_pts;
  for (int e = threadIdx.x; e < probes; e += blockDim.x) {
    const int r = e / g_pts;
    const float lam = lams[row0 * g_pts + e];
    const float* grow = gs + r * k;
    const float* crow = cs + r * k;
    float gr[KCAP], cr[KCAP];
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      gr[j] = j < k ? grow[j] : 0.f;
      cr[j] = j < k ? crow[j] : 0.f;
    }
    const int nr = n[row0 + r];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KCAP; ++i) {
      if (i >= k) break;
      int rank = 0;
#pragma unroll
      for (int j = 0; j < KCAP; ++j) {
        if (j >= k) break;
        if (j == i) continue;
        const float dw = __fsub_rn(gr[j], gr[i]);
        const float lhs = __fmul_rn(lam, __fsub_rn(cr[j], cr[i]));
        rank += j < i ? (dw >= lhs) : (dw > lhs);
      }
      const bool sel = rank < nr && gr[i] > __fmul_rn(lam, cr[i]);
      acc = __fadd_rn(acc, __fmul_rn(sel ? 1.f : 0.f, cr[i]));
    }
    costs[row0 * g_pts + e] = acc;
  }
}

__global__ void awc_fw_warp_kernel(const float* __restrict__ z,
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

template <int KCAP>
cudaError_t launch_rows(const float* z, const float* mu, const float* c,
                        const float* lams, const int* n, float* g_out,
                        float* costs, long long rows, int k, int g_pts,
                        cudaStream_t stream) {
  int per = kThreads / g_pts;
  per = per < kSpan / k ? per : kSpan / k;
  per = per < 1 ? 1 : per;
  const size_t smem = 3 * sizeof(float) * (size_t)per * k;  // <= 48 KB
  const long long blocks = (rows + per - 1) / per;
  awc_fw_rows_kernel<KCAP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      z, mu, c, lams, n, g_out, costs, rows, k, g_pts, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" int awc_fw_launch(const void* z, const void* mu, const void* c,
                             const void* lams, const void* n, void* g_out,
                             void* costs, long long rows, int k, int g_pts,
                             void* stream) {
  if (rows <= 0 || k <= 0 || g_pts <= 0) return (int)cudaErrorInvalidValue;
  const float* zz = (const float*)z;
  const float* mm = (const float*)mu;
  const float* cc = (const float*)c;
  const float* ll = (const float*)lams;
  const int* nn = (const int*)n;
  float* go = (float*)g_out;
  float* co = (float*)costs;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return (int)launch_rows<16>(zz, mm, cc, ll, nn, go, co, rows, k, g_pts,
                                st);
  if (k <= 32)
    return (int)launch_rows<32>(zz, mm, cc, ll, nn, go, co, rows, k, g_pts,
                                st);
  const size_t per_warp = 3 * sizeof(float) * (size_t)k;
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        awc_fw_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + warps - 1) / warps;
  awc_fw_warp_kernel<<<(unsigned)blocks, warps * kWarp, smem, st>>>(
      zz, mm, cc, ll, nn, go, co, rows, k, g_pts);
  return (int)cudaGetLastError();
}
