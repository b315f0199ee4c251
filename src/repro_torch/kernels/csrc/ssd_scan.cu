// ssd_chunk: the Mamba2 SSD intra-chunk dual form in fp32 (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:ssd_chunk.
// Per (batch row b, chunk c) of xd (B,NC,L,H,P), acum (B,NC,L,H) and
// bm/cm (B,NC,L,N):
//
//   y[i,h,:]   = sum_{j<=i} (C_i . B_j) * exp(acum[i,h] - acum[j,h]) * xd[j,h,:]
//   st[h,p,n]  = sum_l exp(acum[L-1,h] - acum[l,h]) * xd[l,h,p] * B[l,n]
//
// Bound on the H100: operations. At the serving prefill (B 4, NC 8, L 256,
// H 48, P 64, N 128) the work is ~13.2 GFLOP (C B^T once per chunk, the two
// L x L products over their causal half), ~0.20 ms at 67 TFLOP/s fp32,
// against ~0.26 GB of traffic (~0.08 ms). All products are fp32 FMAs on the
// CUDA cores (no TF32), so the kernel keeps parity with the plain version.
//
// Design. ssd_y_kernel: one block of 256 threads per (64-row tile of the
// chunk, 8 heads, chunk). It first forms the tile's rows of C B^T for every
// column up to the diagonal (register-blocked 4x4 per thread, N staged 32
// at a time) and keeps them transposed in shared memory, (j, i); then, for
// each of its heads and each 64-column tile up to the diagonal, it builds
// the scores C B^T * exp(acum_i - acum_j), selected to 0 above the diagonal
// (exp of a positive difference can be inf; inf * 0 would be NaN), and
// multiplies them into the head's xd tile, P/16 rows x 4 columns of y per
// thread in registers. C B^T does not depend on the head, so one block
// computes it once for 8 heads instead of once per head. ssd_state_kernel:
// one block per (64 state columns, head, chunk) runs the (P x L) x (L x 64)
// product with the decayed xd rows, 32 rows of the chunk at a time.
//
// Layout: xd, acum, y and st are contiguous and read in place (the heads
// stay inside the rows, no transposed copy); bm/cm are read through their
// strides, in their own dtype (bf16 or fp32), widened to fp32 on load.
// Ragged L (a prompt shorter than the chunk) is bounded: rows and columns
// past L read as zero and are never written. L <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows i and columns j of a score tile
constexpr int kMaxL = 256;
constexpr int kHeads = 8;       // heads per block of ssd_y_kernel
constexpr int kNK = 32;         // N columns staged per step of C B^T
constexpr int kStage = 68;      // padded row of a staged C/B slice
constexpr int kLT = 32;         // chunk rows per step of ssd_state_kernel

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared floats ssd_y_kernel takes for a chunk of `tiles` 64-row tiles.
constexpr size_t y_smem_floats(int tiles, int p) {
  return (size_t)tiles * kTile * kTile   // C B^T rows, (j, i)
         + kTile * kTile                 // scores, (j, i)
         + kTile * p                     // xd tile, (j, p)
         + 2 * kTile;                    // acum of the i and j rows
}

template <typename TB, int P>
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ xd, const float* __restrict__ acum,
             const TB* __restrict__ bm, const TB* __restrict__ cm,
             float* __restrict__ y, int nc, int L, int H, int N,
             long long bsb, long long bsc, long long bsl,
             long long csb, long long csc, long long csl) {
  constexpr int TM = P / 16;            // rows of y per thread
  constexpr int PV = P / 4;             // float4 columns of a head row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles = (L + kTile - 1) / kTile;
  const int it = tiles - 1 - (int)blockIdx.x;   // the longest rows first
  const int i0 = it * kTile;
  const int h0 = blockIdx.y * kHeads;
  const int bc = blockIdx.z;
  const int b = bc / nc, c = bc % nc;
  const int tid = threadIdx.x;

  float* sCB = smem;                               // [(it+1)*64][64] (j, i)
  float* sS = sCB + (size_t)(it + 1) * kTile * kTile;   // [64][64] (j, i)
  float* sX = sS + kTile * kTile;                  // [64][P]
  float* sAi = sX + kTile * P;                     // [64]
  float* sAj = sAi + kTile;                        // [64]
  float* sC = sS;                                  // staging, [kNK][kStage]
  float* sB = sS + kNK * kStage;                   // aliases sS and sX

  const TB* crow = cm + b * csb + c * csc;
  const TB* brow = bm + b * bsb + c * bsc;
  const long long row0 = (long long)bc * L;       // first row of the chunk

  // ---- C B^T for rows i0..i0+63 and columns 0..i0+63
  {
    const int cx = tid % 16, cy = tid / 16;        // j = 4cx.., i = 4cy..
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      float acc[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += kNK) {
        for (int e = tid; e < kNK * kTile; e += kThreads) {
          const int r = e / kNK, k = e % kNK, n = n0 + k;
          const int gi = i0 + r, gj = j0 + r;
          sC[k * kStage + r] =
              (gi < L && n < N) ? widen(crow[gi * csl + n]) : 0.f;
          sB[k * kStage + r] =
              (gj < L && n < N) ? widen(brow[gj * bsl + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kNK; ++k) {
          const float4 cv = *reinterpret_cast<const float4*>(
              &sC[k * kStage + 4 * cy]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &sB[k * kStage + 4 * cx]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(cr[r], br[q], acc[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(&sCB[(j0 + 4 * cx + q) * kTile + 4 * cy]) =
            make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
    }
    __syncthreads();
  }

  // ---- per head: scores tile by tile, times the head's xd tile
  const int tx = tid % PV, ty = tid / PV;          // p = 4tx.., i = TM*ty..
  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;                             // uniform in the block
    float acc[TM][4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      for (int e = tid; e < kTile * PV; e += kThreads) {
        const int j = e / PV, pv = e % PV, gj = j0 + j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gj < L)
          v = *reinterpret_cast<const float4*>(
              &xd[((row0 + gj) * H + h) * P + 4 * pv]);
        *reinterpret_cast<float4*>(&sX[j * P + 4 * pv]) = v;
      }
      if (tid < kTile) {
        const int gi = i0 + tid, gj = j0 + tid;
        sAi[tid] = gi < L ? acum[(row0 + gi) * H + h] : 0.f;
        sAj[tid] = gj < L ? acum[(row0 + gj) * H + h] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int j = e / kTile, i = e % kTile;
        const int gi = i0 + i, gj = j0 + j;
        // select, never multiply, the masked part: its exp may be inf
        sS[e] = (gj <= gi && gi < L)
                    ? sCB[gj * kTile + i] * expf(sAi[i] - sAj[j])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float sr[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) sr[r] = sS[j * kTile + TM * ty + r];
        const float4 xv =
            *reinterpret_cast<const float4*>(&sX[j * P + 4 * tx]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(sr[r], xr[q], acc[r][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gi = i0 + TM * ty + r;
      if (gi < L)
        *reinterpret_cast<float4*>(&y[((row0 + gi) * H + h) * P + 4 * tx]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <typename TB, int P>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ xd,
                 const float* __restrict__ acum, const TB* __restrict__ bm,
                 float* __restrict__ st, int nc, int L, int H, int N,
                 long long bsb, long long bsc, long long bsl) {
  constexpr int TM = P / 16;            // state rows (p) per thread
  constexpr int PV = P / 4;
  __shared__ __align__(16) float sXw[kLT * P];   // decayed xd rows, (l, p)
  __shared__ __align__(16) float sBt[kLT * kTile];   // B rows, (l, n)
  const int n0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int b = bc / nc, c = bc % nc;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;          // n = 4tx.., p = TM*ty..
  const long long row0 = (long long)bc * L;
  const TB* brow = bm + b * bsb + c * bsc;
  const float alast = acum[(row0 + L - 1) * H + h];

  float acc[TM][4] = {};
  for (int l0 = 0; l0 < L; l0 += kLT) {
    for (int e = tid; e < kLT * PV; e += kThreads) {
      const int l = e / PV, pv = e % PV, gl = l0 + l;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gl < L) {
        v = *reinterpret_cast<const float4*>(
            &xd[((row0 + gl) * H + h) * P + 4 * pv]);
        const float w = expf(alast - acum[(row0 + gl) * H + h]);
        v.x *= w; v.y *= w; v.z *= w; v.w *= w;
      }
      *reinterpret_cast<float4*>(&sXw[l * P + 4 * pv]) = v;
    }
    for (int e = tid; e < kLT * kTile; e += kThreads) {
      const int l = e / kTile, n = e % kTile, gl = l0 + l;
      sBt[e] = (gl < L && n0 + n < N) ? widen(brow[gl * bsl + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kLT; ++l) {
      float xr[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) xr[r] = sXw[l * P + TM * ty + r];
      const float4 bv =
          *reinterpret_cast<const float4*>(&sBt[l * kTile + 4 * tx]);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xr[r], br[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float* out = st + (((long long)bc * H + h) * P + TM * ty + r) * N;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + 4 * tx + q;
      if (n < N) out[n] = acc[r][q];
    }
  }
}

template <typename TB, int P>
int launch(const float* xd, const float* acum, const TB* bm, const TB* cm,
           float* y, float* st, int batch, int nc, int L, int H, int N,
           long long bsb, long long bsc, long long bsl, long long csb,
           long long csc, long long csl, cudaStream_t stream) {
  const int tiles = (L + kTile - 1) / kTile;
  const size_t smem = y_smem_floats(tiles, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel<TB, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 ygrid(tiles, (H + kHeads - 1) / kHeads, batch * nc);
  ssd_y_kernel<TB, P><<<ygrid, kThreads, smem, stream>>>(
      xd, acum, bm, cm, y, nc, L, H, N, bsb, bsc, bsl, csb, csc, csl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 sgrid((N + kTile - 1) / kTile, H, batch * nc);
  ssd_state_kernel<TB, P><<<sgrid, kThreads, 0, stream>>>(
      xd, acum, bm, st, nc, L, H, N, bsb, bsc, bsl);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_p(const void* xd, const void* acum, const void* bm,
             const void* cm, void* y, void* st, int batch, int nc, int L,
             int H, int P, int N, long long bsb, long long bsc,
             long long bsl, long long csb, long long csc, long long csl,
             cudaStream_t stream) {
#define SSD_LAUNCH(PP)                                                     \
  return launch<TB, PP>((const float*)xd, (const float*)acum,             \
                        (const TB*)bm, (const TB*)cm, (float*)y,          \
                        (float*)st, batch, nc, L, H, N, bsb, bsc, bsl,    \
                        csb, csc, csl, stream)
  switch (P) {
    case 16: SSD_LAUNCH(16);
    case 32: SSD_LAUNCH(32);
    case 64: SSD_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_LAUNCH
}

}  // namespace

// bc_dtype: 0 float32, 1 bfloat16 (bm and cm). Strides are in elements.
extern "C" int ssd_chunk_launch(const void* xd, const void* acum,
                                const void* bm, const void* cm, void* y,
                                void* st, int bc_dtype, int batch, int nc,
                                int L, int H, int P, int N, long long bsb,
                                long long bsc, long long bsl, long long csb,
                                long long csc, long long csl, void* stream) {
  if (batch <= 0 || nc <= 0 || L <= 0 || L > kMaxL || H <= 0 || N <= 0 ||
      (long long)batch * nc > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bc_dtype == 0)
    return launch_p<float>(xd, acum, bm, cm, y, st, batch, nc, L, H, P, N,
                           bsb, bsc, bsl, csb, csc, csl, s);
  if (bc_dtype == 1)
    return launch_p<__nv_bfloat16>(xd, acum, bm, cm, y, st, batch, nc, L, H,
                                   P, N, bsb, bsc, bsl, csb, csc, csl, s);
  return (int)cudaErrorInvalidValue;
}
