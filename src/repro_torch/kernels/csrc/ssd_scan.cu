// ssd_chunk: the Mamba2 SSD intra-chunk dual form on the tensor cores
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:ssd_chunk
// and computes what it computes, C B^T in fp32 included. Per (batch row b,
// chunk c) of xd (B,NC,L,H,P), acum (B,NC,L,H) and bm/cm (B,NC,L,N):
//
//   y[i,h,:]   = sum_{j<=i} (C_i . B_j) * exp(acum[i,h] - acum[j,h]) * xd[j,h,:]
//   st[h,p,n]  = sum_l exp(acum[L-1,h] - acum[l,h]) * xd[l,h,p] * B[l,n]
//
// Bound on the H100. At the serving prefill (B 4, NC 8, L 256, H 48, P 64,
// N 128, B/C bf16) the call moves ~0.257 GB (xd read, y written, the
// states written: ~0.077 ms at 3.35 TB/s) and does ~13.2 GFLOP (C B^T over
// the causal half, the two other products). On fp32 CUDA cores that work
// alone takes 0.19 ms; on the tensor cores, as this kernel splits it, about
// 0.065 ms, so the kernel is bound by bytes there.
//
// Accuracy: every product runs on the tensor cores (mma.sync) and keeps the
// fp32 result of the plain version up to summation order.
//  - C B^T with bf16 B/C: one m16n8k16 bf16 mma, fp32 accumulate. A product
//    of two bf16 values has at most 16 significant bits, so it is exact in
//    fp32: the same products the fp32 version sums.
//  - The scores product (C B^T * decay) @ xd has fp32 operands on both
//    sides: 3xTF32. Each operand is split a = a_hi + a_lo with a_hi rounded
//    to TF32 (10 mantissa bits) and a_lo the rest, rounded to TF32 as well,
//    and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, m16n8k8 TF32 with fp32
//    accumulate; the dropped a_lo.b_lo and the rounding of the low parts are
//    ~2^-21 of each product. TF32 alone would keep ~2^-11 (about 1e-3 of a
//    sum of mixed signs after 256 terms), far outside the 1e-4 gate.
//  - The state product (B)^T @ (w * xd), w = exp(acum[L-1] - acum): w * xd
//    is formed in fp32, as in the plain version, and split in two; bf16 B
//    is exact in TF32 (its low part is zero), so two TF32 mmas suffice.
//  - fp32 B/C (the reduced configurations) take the same design with C and
//    B split too: three TF32 mmas for C B^T and for the state.
//  - The decay exp(acum_i - acum_j) is selected, never multiplied, to zero
//    above the diagonal and past L: exp of a positive difference can be
//    inf, and inf * 0 would be NaN. It and the state weights w are the
//    SFU's ex2.approx of x log2 e (__expf's approximation, 2 + 1.2|x| ulp,
//    with results below 2^-126 flushed to zero): where a term matters (|x|
//    of a few units) that is ~1e-7 of it.
//
// Design. One block of 8 warps per (chunk, group of heads), one block an
// SM (~206 KB of shared memory at the main shape), as many heads a block
// as keeps the waves of blocks times the heads a block least (12 heads, 128
// blocks at the main shape). The block copies the chunk's B rows
// (L x N, in their own dtype) into shared memory once, and each warp loads
// the C rows of its two 16-row tiles into registers once, as mma A
// fragments: C and B do not depend on the head. Then, head by head, the
// head's xd (L x P fp32) and acum rows arrive by cp.async in a double
// buffer (the next head's copy runs under this head's products; one block
// barrier a head), and both products read that one copy:
//  - y: warp w takes row tiles w and 15 - w (17 of the 136 causal 16 x 16
//    tiles each). Per 16-column tile up to the diagonal it forms C B^T with
//    the C fragments in registers and B through ldmatrix, scales it by the
//    decay in registers, and uses the accumulator fragment directly as the
//    A operand of the TF32 product with xd: the k index of the m16n8k8 A
//    fragment is permuted (column t holds j = 2t, column t + 4 holds
//    2t + 1), and xd's rows are read in the same order, so the scores never
//    go through shared memory. C B^T is recomputed per head (at bf16's rate,
//    ~1/4 of a tile's tensor-core time) instead of being kept: a chunk's
//    C B^T in fp32 is 256 KB.
//  - states: warp w takes one 16-row tile of P and a share of N's 8-column
//    tiles, and runs over the chunk 8 rows at a time, with the same k
//    permutation; it forms the weights exp(acum[L-1] - acum[l]) it needs in
//    registers, and bf16 B comes through ldmatrix.trans in that k order.
// Shared rows are padded so that every fragment read is free of bank
// conflicts and 16-byte aligned for cp.async and ldmatrix: xd rows P + 4
// floats, B rows NP + 16 bytes. Ragged L (a prompt shorter than the chunk)
// is bounded: rows past L are copied as zeros (cp.async with a source size
// of 0) and never written. L <= 256, N <= 128, P in {16, 32, 64}.
//
// Layout: xd, acum, y and st are contiguous and read in place; bm/cm are
// read through their strides, which must be multiples of 16 bytes, from a
// 16-byte aligned base (the wrapper checks): the model's B/C are views into
// the conv output (row stride 3,328 bf16 at Mamba2-780M's width).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;
constexpr int kMaxN = 128;
constexpr int kRowTiles = kMaxL / 16;   // a warp takes tiles w and 15 - w
constexpr int kSmemLimit = 232448;      // a block's shared memory, sm_90

struct Params {
  const float* xd;
  const float* acum;
  const void* bm;
  const void* cm;
  float* y;
  float* st;
  int nc, L, H, N;
  int heads;              // heads a block takes, in order from h0
  int nbuf;               // xd buffers: 2 (double-buffered) or 1
  long long bsb, bsc, bsl, csb, csc, csl;   // strides in elements
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; bytes past
// src_bytes are written as zeros and not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// NUM 8x8 b16 matrices, transposed: lane i gets rows 2(i%4), 2(i%4) + 1
// of column i/4, the first in the low half; lanes 8m..8m+7 address the
// rows of matrix m
template <int NUM>
__device__ __forceinline__ void ldsm_trans(uint32_t addr,
                                           uint32_t (&r)[NUM]) {
  if constexpr (NUM == 4) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  } else if constexpr (NUM == 2) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr)
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
        : "=r"(r[0])
        : "r"(addr)
        : "memory");
  }
}

// d += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, as
// cvt.rna), lo the exact remainder, truncated to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// exp(x) as ex2.approx(x log2 e), results below 2^-126 flushed to zero:
// the SFU's approximation __expf uses, without its denormal fix-up
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

template <typename TB>
constexpr int kStep = std::is_same<TB, float>::value ? 8 : 16;   // mma k

// One k step of a warp's C A-fragment for rows i0 .. i0+15, in the order
// mma's A operand takes it, zero past L and N. bf16: m16n8k16, each word a
// pair of columns (the lower column in the low half); fp32: m16n8k8, each
// word one value, split at use.
template <typename TB>
__device__ __forceinline__ void load_cfrag(const TB* crow, long long csl,
                                           int L, int N, int i0, int ks,
                                           int g, int t, uint32_t (&f)[4]) {
  const int r0 = i0 + g, r1 = r0 + 8;
  if constexpr (std::is_same<TB, float>::value) {
    const int n0 = ks * 8 + t, n1 = n0 + 4;
    auto at = [&](int r, int n) -> uint32_t {
      return (r < L && n < N) ? __float_as_uint(crow[r * csl + n]) : 0u;
    };
    f[0] = at(r0, n0);
    f[1] = at(r1, n0);
    f[2] = at(r0, n1);
    f[3] = at(r1, n1);
  } else {
    const int n0 = ks * 16 + 2 * t, n1 = n0 + 8;
    auto pair = [&](int r, int n) -> uint32_t {
      if (r >= L || n >= N) return 0u;
      const TB* p = crow + r * csl + n;
      if (n + 1 < N) return *reinterpret_cast<const uint32_t*>(p);
      return static_cast<uint32_t>(__bfloat16_as_ushort(p[0]));
    };
    f[0] = pair(r0, n0);
    f[1] = pair(r1, n0);
    f[2] = pair(r0, n1);
    f[3] = pair(r1, n1);
  }
}

// cb = C B^T for the warp's 16 rows (fragments cf) and chunk columns
// j0 .. j0+15 (two n8 tiles), B rows from shared memory (row stride SB).
// Two partial sums per tile keep the mma chains short.
template <typename TB, int NP, int SB>
__device__ __forceinline__ void cb_tile(float (&cb)[2][4],
                                        const uint32_t (&cf)[NP / kStep<TB>][4],
                                        const TB* bs, int j0, int lane) {
  constexpr int KS = NP / kStep<TB>;
  const int g = lane >> 2, t = lane & 3;
  float part[2][2][4] = {};
  if constexpr (std::is_same<TB, float>::value) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(cf[ks][e]), ah[e], al[e]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* br = bs + (j0 + 8 * nt + g) * SB + ks * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split(br[0], bh0, bl0);
        split(br[4], bh1, bl1);
        float(&d)[4] = part[ks & 1][nt];
        mma_tf32(d, al, bh0, bh1);
        mma_tf32(d, ah, bl0, bl1);
        mma_tf32(d, ah, bh0, bh1);
      }
    }
  } else {
    // ldmatrix x4: matrices (rows j0.., cols k..), (j0.., k+8..),
    // (j0+8.., k..), (j0+8.., k+8..): b0/b1 of the two n8 tiles
    const int mat = lane >> 3, r = lane & 7;
    const uint32_t base =
        smem_addr(bs + (j0 + (mat >> 1) * 8 + r) * SB + (mat & 1) * 8);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      ldsm_x4(base + ks * 32, b);
      mma_bf16(part[ks & 1][0], cf[ks], b[0], b[1]);
      mma_bf16(part[ks & 1][1], cf[ks], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[nt][e] = part[0][nt][e] + part[1][nt][e];
}

template <typename TB, int P, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const Params a) {
  constexpr int SX = P + 4;                       // xd row stride, floats
  constexpr int SB = NP + 16 / (int)sizeof(TB);   // B row stride, elements
  constexpr int KS = NP / kStep<TB>;              // C B^T k steps
  constexpr int PN = P / 8;                       // n8 tiles of a y row
  constexpr int MT = P / 16;                      // m16 tiles of a state
  constexpr int NT = NP / 8;                      // n8 tiles of a state
  constexpr int kGroups = kWarps / MT;            // warps on one m16 tile
  constexpr int NTW = NT / kGroups;                // n8 tiles a warp
  static_assert(P % 16 == 0 && kWarps % MT == 0 && NT % kGroups == 0,
                "head dim and state width");

  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, N = a.N;
  const int T = (L + 15) / 16, Lp = T * 16;
  float* xs = reinterpret_cast<float*>(smem);                // [nbuf][Lp][SX]
  TB* bs = reinterpret_cast<TB*>(xs + a.nbuf * Lp * SX);    // [Lp][SB]
  float* as = reinterpret_cast<float*>(bs + Lp * SB);        // [nbuf][Lp]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bc = blockIdx.y, b = bc / a.nc, c = bc % a.nc;
  const int h0 = blockIdx.x * a.heads;
  const int nh = min(a.heads, H - h0);
  const long long row0 = (long long)bc * L;       // first row of the chunk
  const TB* brow = static_cast<const TB*>(a.bm) + b * a.bsb + c * a.bsc;
  const TB* crow = static_cast<const TB*>(a.cm) + b * a.csb + c * a.csc;

  // ---- B rows 0..Lp-1, columns 0..NP-1, zeros past L and N
  {
    constexpr int kVec = 16 / (int)sizeof(TB);
    constexpr int kRow = NP / kVec;
    for (int e = tid; e < Lp * kRow; e += kThreads) {
      const int l = e / kRow, n = (e % kRow) * kVec;
      const int bytes =
          (l < L && n < N) ? min(N - n, kVec) * (int)sizeof(TB) : 0;
      cp_async16(smem_addr(bs + l * SB + n),
                 bytes ? brow + l * a.bsl + n : brow, bytes);
    }
  }
  // ---- the k-th head's xd rows and acum into buffer buf
  auto stage = [&](int k, int buf) {
    const int h = h0 + k;
    float* xb = xs + buf * Lp * SX;
    float* ab = as + buf * Lp;
    constexpr int kRow = P / 4;
    for (int e = tid; e < Lp * kRow; e += kThreads) {
      const int l = e / kRow, q = e % kRow;
      const bool in = l < L;
      cp_async16(smem_addr(xb + l * SX + 4 * q),
                 in ? a.xd + ((row0 + l) * H + h) * P + 4 * q : a.xd,
                 in ? 16 : 0);
    }
    for (int l = tid; l < Lp; l += kThreads) {
      const bool in = l < L;
      cp_async4(smem_addr(ab + l), in ? a.acum + (row0 + l) * H + h : a.acum,
                in ? 4 : 0);
    }
  };
  stage(0, 0);
  cp_async_commit();

  // ---- C fragments of the warp's two row tiles, kept for every head
  uint32_t cf[2][KS][4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int rt = q == 0 ? warp : kRowTiles - 1 - warp;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      load_cfrag<TB>(crow, a.csl, L, N, rt * 16, ks, g, t, cf[q][ks]);
  }

  for (int k = 0; k < nh; ++k) {
    const int buf = a.nbuf == 2 ? (k & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();    // head k's xd and acum are in; head k - 1 is done
    if (a.nbuf == 2 && k + 1 < nh) {
      stage(k + 1, (k + 1) & 1);      // into head k - 1's buffer
      cp_async_commit();
    }
    const int h = h0 + k;
    const float* xb = xs + buf * Lp * SX;
    const float* ab = as + buf * Lp;

    // ---- y: row tiles warp and 15 - warp
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int rt = q == 0 ? warp : kRowTiles - 1 - warp;
      if (rt >= T) continue;
      const int ig = rt * 16 + g, ig8 = ig + 8;
      const float ai = ab[ig], ai8 = ab[ig8];
      const bool rows_in = rt * 16 + 16 <= L;     // no row of the tile past L
      float acc[PN][4] = {};
#pragma unroll 1
      for (int jt = 0; jt <= rt; ++jt) {
        const int j0 = jt * 16;
        float cb[2][4];
        cb_tile<TB, NP, SB>(cb, cf[q], bs, j0, lane);
        // scores, in the A-fragment order of the k-permuted product:
        // (g, j), (g+8, j), (g, j+1), (g+8, j+1) with j = j0 + 8nt + 2t
        // (the masks bite only on the diagonal tile and past L)
        uint32_t sh[2][4], sl[2][4];
        const bool inner = jt < rt && rows_in;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = j0 + 8 * nt + 2 * t;
          const float2 aj = *reinterpret_cast<const float2*>(ab + j);
          float s[4];
          if (inner) {
            s[0] = cb[nt][0] * exp_ftz(ai - aj.x);
            s[1] = cb[nt][2] * exp_ftz(ai8 - aj.x);
            s[2] = cb[nt][1] * exp_ftz(ai - aj.y);
            s[3] = cb[nt][3] * exp_ftz(ai8 - aj.y);
          } else {
            s[0] = (j <= ig && ig < L) ? cb[nt][0] * exp_ftz(ai - aj.x) : 0.f;
            s[1] =
                (j <= ig8 && ig8 < L) ? cb[nt][2] * exp_ftz(ai8 - aj.x) : 0.f;
            s[2] =
                (j + 1 <= ig && ig < L) ? cb[nt][1] * exp_ftz(ai - aj.y) : 0.f;
            s[3] = (j + 1 <= ig8 && ig8 < L) ? cb[nt][3] * exp_ftz(ai8 - aj.y)
                                             : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split(s[e], sh[nt][e], sl[nt][e]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // xd rows j, j + 1 of the k order, column 8 pn + g
          const float* xr = xb + (j0 + 8 * nt + 2 * t) * SX + g;
#pragma unroll
          for (int pn = 0; pn < PN; ++pn) {
            uint32_t xh0, xl0, xh1, xl1;
            split(xr[8 * pn], xh0, xl0);
            split(xr[SX + 8 * pn], xh1, xl1);
            mma_tf32(acc[pn], sl[nt], xh0, xh1);
            mma_tf32(acc[pn], sh[nt], xl0, xl1);
            mma_tf32(acc[pn], sh[nt], xh0, xh1);
          }
        }
      }
      float* yr = a.y + ((row0 + ig) * H + h) * P + 2 * t;
#pragma unroll
      for (int pn = 0; pn < PN; ++pn) {
        if (ig < L)
          *reinterpret_cast<float2*>(yr + 8 * pn) =
              make_float2(acc[pn][0], acc[pn][1]);
        if (ig8 < L)
          *reinterpret_cast<float2*>(yr + 8 * (long long)H * P + 8 * pn) =
              make_float2(acc[pn][2], acc[pn][3]);
      }
    }

    // ---- states: p rows 16mt.., n8 tiles grp*NTW.., 8 chunk rows a step
    {
      const int mt = warp % MT, grp = warp / MT;
      float acc[NTW][4] = {};
      const float* xc = xb + mt * 16 + g;
      const float alast = ab[L - 1];
      // bf16 B through ldmatrix.trans: matrix m of a load is n8 tile
      // grp*NTW + q0 + m over chunk rows l0..l0+7, so each lane gets the
      // pair (B[l0+2t][n], B[l0+2t+1][n]) of the permuted k order
      constexpr int kMats = NTW < 4 ? NTW : 4;
      const TB* bt =
          bs + (lane & 7) * SB + 8 * (grp * NTW + (lane >> 3) % kMats);
#pragma unroll 2
      for (int l0 = 0; l0 < Lp; l0 += 8) {
        const int l = l0 + 2 * t;                  // k order: l, l + 1
        const float2 am = *reinterpret_cast<const float2*>(ab + l);
        const float2 w = make_float2(l < L ? exp_ftz(alast - am.x) : 0.f,
                                     l + 1 < L ? exp_ftz(alast - am.y) : 0.f);
        const float* xr = xc + l * SX;
        uint32_t ah[4], al[4];
        split(xr[0] * w.x, ah[0], al[0]);
        split(xr[8] * w.x, ah[1], al[1]);
        split(xr[SX] * w.y, ah[2], al[2]);
        split(xr[SX + 8] * w.y, ah[3], al[3]);
        if constexpr (std::is_same<TB, float>::value) {
#pragma unroll
          for (int q = 0; q < NTW; ++q) {
            const float* br = bs + l * SB + 8 * (grp * NTW + q) + g;
            uint32_t bh0, bl0, bh1, bl1;
            split(br[0], bh0, bl0);
            split(br[SB], bh1, bl1);
            mma_tf32(acc[q], al, bh0, bh1);
            mma_tf32(acc[q], ah, bl0, bl1);
            mma_tf32(acc[q], ah, bh0, bh1);
          }
        } else {
          // a bf16 value is exact in TF32: its bits in the high half
#pragma unroll
          for (int q0 = 0; q0 < NTW; q0 += kMats) {
            uint32_t r[kMats];
            ldsm_trans<kMats>(smem_addr(bt + l0 * SB + 8 * q0), r);
#pragma unroll
            for (int m = 0; m < kMats; ++m) {
              const uint32_t b0 = r[m] << 16, b1 = r[m] & 0xffff0000u;
              mma_tf32(acc[q0 + m], al, b0, b1);
              mma_tf32(acc[q0 + m], ah, b0, b1);
            }
          }
        }
      }
      float* sr = a.st + (((long long)bc * H + h) * P + mt * 16 + g) * N;
#pragma unroll
      for (int q = 0; q < NTW; ++q) {
        const int n = (grp * NTW + q) * 8 + 2 * t;
        if (n < N) {
          sr[n] = acc[q][0];
          sr[8 * N + n] = acc[q][2];
        }
        if (n + 1 < N) {
          sr[n + 1] = acc[q][1];
          sr[8 * N + n + 1] = acc[q][3];
        }
      }
    }
    if (a.nbuf == 1 && k + 1 < nh) {
      __syncthreads();                // the one buffer is free again
      stage(k + 1, 0);
      cp_async_commit();
    }
  }
}

size_t smem_bytes(int lp, int p, int np, int esize, int nbuf) {
  return (size_t)nbuf * lp * (p + 4) * 4      // xd rows
         + (size_t)lp * (np * esize + 16)      // B rows
         + (size_t)nbuf * lp * 4;              // acum
}

template <typename TB, int P, int NP>
int launch(Params prm, int chunks, cudaStream_t stream) {
  const int lp = (prm.L + 15) / 16 * 16;
  // heads a block: one block runs on an SM at a time, so the call takes
  // (waves of blocks) x (heads a block) head-times; take the fewest, and
  // of those the most heads a block (fewer prologues)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long best = -1;
  int groups = 1;
  for (int hb = prm.H; hb >= 1; --hb) {
    const int gr = (prm.H + hb - 1) / hb;
    const long long cost = ((long long)chunks * gr + sms - 1) / sms * hb;
    if (best < 0 || cost < best) {
      best = cost;
      prm.heads = hb;
      groups = gr;
    }
  }
  size_t smem = smem_bytes(lp, P, NP, sizeof(TB), 2);
  prm.nbuf = 2;
  if (prm.heads == 1 || smem > (size_t)kSmemLimit) {
    prm.nbuf = 1;
    smem = smem_bytes(lp, P, NP, sizeof(TB), 1);
  }
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TB, P, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(groups, chunks);
  ssd_chunk_kernel<TB, P, NP><<<grid, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_p(const Params& prm, int P, int chunks, cudaStream_t stream) {
  const bool wide = prm.N > 64;       // N padded to 64 or 128 columns
  switch (P) {
    case 16: return wide ? launch<TB, 16, 128>(prm, chunks, stream)
                         : launch<TB, 16, 64>(prm, chunks, stream);
    case 32: return wide ? launch<TB, 32, 128>(prm, chunks, stream)
                         : launch<TB, 32, 64>(prm, chunks, stream);
    case 64: return wide ? launch<TB, 64, 128>(prm, chunks, stream)
                         : launch<TB, 64, 64>(prm, chunks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
      N > kMaxN || (long long)batch * nc > 65535)
    return (int)cudaErrorInvalidValue;
  Params prm{static_cast<const float*>(xd), static_cast<const float*>(acum),
             bm, cm, static_cast<float*>(y), static_cast<float*>(st),
             nc, L, H, N, 1, 1, bsb, bsc, bsl, csb, csc, csl};
  cudaStream_t s = (cudaStream_t)stream;
  if (bc_dtype == 0) return launch_p<float>(prm, P, batch * nc, s);
  if (bc_dtype == 1) return launch_p<__nv_bfloat16>(prm, P, batch * nc, s);
  return (int)cudaErrorInvalidValue;
}
