// topn_lp: top-n-by-score cost reduction, one warp per row (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topn_lp.py:topn_lp.
// For each row b of (B, K) score/cost and a per-row cardinality n_b:
//
//   out_b = sum_k cost_bk * [rank_bk < n_b] (* [score_bk > 0] if !equality)
//   rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i}   (lower index wins)
//
// Bound on the H100: bytes and launches. A row is K score and K cost
// floats and one int in, one float out, against ~K^2 compares, so at the
// main path's K = 9 the kernel is far below the compute roof; one call at
// 174,784 rows moves ~12.6 MB (~3.8 us at 3.35 TB/s), and a call of a few
// thousand rows is bounded by the launch itself.
//
// Design: one warp per row, 8 warps (rows) per block while they fit in
// 48 KB of shared memory. The warp stages its score row in shared memory
// with coalesced loads; each lane counts the stable rank of arms lane,
// lane+32, ... with a loop over j, writes its masked cost back to shared
// memory, and lane 0 sums the row in arm-index order, so the result is the
// plain PyTorch version's to the bit. The ragged K edge is handled by the
// loop bounds; no padding is read. Any K whose row fits in shared memory
// (K <= 29,056) is taken.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void topn_lp_kernel(const float* __restrict__ score,
                               const float* __restrict__ cost,
                               const int* __restrict__ n,
                               float* __restrict__ out,
                               long long rows, int k, int equality) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // uniform across the warp
  float* s = smem + (size_t)warp * 2 * k;
  float* v = s + k;
  const float* srow = score + row * k;
  const float* crow = cost + row * k;
  for (int i = lane; i < k; i += kWarp) s[i] = srow[i];
  __syncwarp();
  const int nr = n[row];
  for (int i = lane; i < k; i += kWarp) {
    const float si = s[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const float sj = s[j];
      rank += (sj > si) || (sj == si && j < i);
    }
    bool sel = rank < nr;
    if (!equality) sel = sel && (si > 0.f);
    v[i] = __fmul_rn(sel ? 1.f : 0.f, crow[i]);
  }
  __syncwarp();
  if (lane == 0) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) acc = __fadd_rn(acc, v[i]);
    out[row] = acc;
  }
}

}  // namespace

extern "C" int topn_lp_launch(const void* score, const void* cost,
                              const void* n, void* out, long long rows,
                              int k, int equality, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t per_warp = 2 * sizeof(float) * (size_t)k;
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        topn_lp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + warps - 1) / warps;
  topn_lp_kernel<<<(unsigned)blocks, warps * kWarp, smem,
                   (cudaStream_t)stream>>>(
      (const float*)score, (const float*)cost, (const int*)n, (float*)out,
      rows, k, equality);
  return (int)cudaGetLastError();
}
