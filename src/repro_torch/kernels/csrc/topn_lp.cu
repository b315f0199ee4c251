// topn_lp: top-n-by-score cost reduction (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topn_lp.py:topn_lp.
// For each row b of (B, K) score/cost and a per-row cardinality n_b:
//
//   out_b = sum_k cost_bk * [rank_bk < n_b] (* [score_bk > 0] if !equality)
//   rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i}   (lower index wins)
//
// Bound on the H100: bytes. A row is K score and K cost floats and one int
// in, one float out, against ~K^2 compares, so at the main path's K = 9
// the kernel is far below the compute roof; one call at 174,784 rows moves
// ~14 MB (~4.2 us at 3.35 TB/s).
//
// Design, K <= 32 (the main path): a thread per row, the row in registers.
// A block of R rows (256 at K <= 16, 128 at K <= 32) stages its rows'
// score and cost, two contiguous spans of R*K floats, in shared memory
// with coalesced 16-byte loads; each thread then pulls its row into
// registers and counts the K^2 compares fully unrolled over the template's
// K cap, stopping at the row's K. With i and j known at compile time the
// stable rank rule "s_j > s_i, or s_j == s_i and j < i" is one compare a
// pair: s_j >= s_i for j < i and s_j > s_i for j > i (both false on a NaN,
// as the rule is). The masked costs are summed in arm-index order with
// __fmul_rn / __fadd_rn, the order and roundings of the plain PyTorch
// version, so the two agree to the bit; the result is written coalesced.
//
// K > 32: one warp per row, 8 rows to a block while they fit in 48 KB of
// shared memory; each lane counts the ranks of arms lane, lane + 32, ...
// over a loop on j, and lane 0 sums the masked costs in arm-index order.
// Any K whose row fits in shared memory (K <= 29,056) is taken.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;

// Copy count floats from global src to shared dst with the whole block:
// scalar loads up to src's first 16-byte boundary, float4 loads after it.
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int count) {
  int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  head = head < count ? head : count;
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = src[e];
  const int quads = (count - head) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 v = __ldg(src4 + q);
    float* d = dst + head + 4 * q;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int e = head + 4 * quads + threadIdx.x; e < count; e += blockDim.x)
    dst[e] = src[e];
}

template <int KCAP>
__global__ void __launch_bounds__(4096 / KCAP)
topn_lp_rows_kernel(const float* __restrict__ score,
                    const float* __restrict__ cost,
                    const int* __restrict__ n, float* __restrict__ out,
                    long long rows, int k, int equality) {
  constexpr int kRows = 4096 / KCAP;  // rows (threads) a block
  extern __shared__ float smem[];
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long left = rows - row0;
  const int nrows = left < kRows ? (int)left : kRows;
  float* ss = smem;
  float* cs = smem + kRows * k;
  stage(ss, score + row0 * k, nrows * k);
  stage(cs, cost + row0 * k, nrows * k);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= nrows) return;
  const float* srow = ss + t * k;
  const float* crow = cs + t * k;
  float s[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) s[j] = j < k ? srow[j] : 0.f;
  const int nr = n[row0 + t];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i >= k) break;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (j >= k) break;
      if (j < i) rank += s[j] >= s[i];
      if (j > i) rank += s[j] > s[i];
    }
    const bool sel = rank < nr && (equality || s[i] > 0.f);
    acc = __fadd_rn(acc, __fmul_rn(sel ? 1.f : 0.f, crow[i]));
  }
  out[row0 + t] = acc;
}

__global__ void topn_lp_warp_kernel(const float* __restrict__ score,
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

template <int KCAP>
cudaError_t launch_rows(const float* score, const float* cost, const int* n,
                        float* out, long long rows, int k, int equality,
                        cudaStream_t stream) {
  constexpr int kRows = 4096 / KCAP;
  const size_t smem = 2 * sizeof(float) * (size_t)kRows * k;  // <= 32 KB
  const long long blocks = (rows + kRows - 1) / kRows;
  topn_lp_rows_kernel<KCAP><<<(unsigned)blocks, kRows, smem, stream>>>(
      score, cost, n, out, rows, k, equality);
  return cudaGetLastError();
}

}  // namespace

extern "C" int topn_lp_launch(const void* score, const void* cost,
                              const void* n, void* out, long long rows,
                              int k, int equality, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* s = (const float*)score;
  const float* c = (const float*)cost;
  const int* nn = (const int*)n;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return (int)launch_rows<16>(s, c, nn, o, rows, k, equality, st);
  if (k <= 32) return (int)launch_rows<32>(s, c, nn, o, rows, k, equality, st);
  const size_t per_warp = 2 * sizeof(float) * (size_t)k;
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        topn_lp_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + warps - 1) / warps;
  topn_lp_warp_kernel<<<(unsigned)blocks, warps * kWarp, smem, st>>>(
      s, c, nn, o, rows, k, equality);
  return (int)cudaGetLastError();
}
