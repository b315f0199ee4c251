// flash_attention: tiled GQA attention with an fp32 online softmax (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention. For q (B, S, H, hd)
// and k/v (B, T, KV, hd), query head h reads KV head h / n_rep, and
//
//   o[b, s, h] = softmax_t(mask(q[b, s, h] . k[b, t, h/n_rep] / sqrt(hd)))
//                . v[b, t, h/n_rep]
//
// with the reference's masks (src/repro/kernels/ref.py:32-36): causal
// keeps kpos <= qpos, a window keeps kpos > qpos - window, and a masked
// score is -1e30 (not -inf). The output is written in q's dtype.
//
// Bound on the H100: operations. A causal call does 2 S^2 hd H B FLOPs
// (QK^T and PV over the visible half of the square); at the serving path's
// prefill (B 4, S 2,048, H 36, hd 128) that is 155 GFLOP against ~38 MB of
// q/k/v/o, so the tensor cores' 989 TFLOP/s bound it near 0.16 ms. The bf16
// kernel (the serving path's) runs both products on the tensor cores with
// mma.sync; the fp32 kernel runs on the CUDA cores (67 TFLOP/s peak) to
// keep fp32 inputs exact to fp32. wgmma and TMA are later work.
//
// Both kernels: one block of 128 threads per (q tile of 64 rows, head,
// batch row), looping over k/v tiles of 64 keys with m, l and the fp32
// accumulator in registers for the whole loop, which is what the Pallas
// kernel's sequential kv grid axis carried in VMEM. Tiles that the causal
// or window band excludes are skipped whole. Ragged S and T edges are
// handled by bounds: q rows past S are computed and not written, keys past
// T score -inf (they do not exist), so no shape needs padding.
//
// The fp32 kernel stages its q tile in shared memory once (transposed), then
// loops over k/v tiles of 64 keys: it stages K (transposed) and V, each
// thread computes a 4 x 8 register tile of scores (float4 shared loads), the
// row max and row sum are reduced across the 8 threads of a row group with
// warp shuffles, and the thread's 4 x hd/8 slice of the fp32 accumulator is
// rescaled and updated from P (through shared memory) and V.
//
// A row with no visible key at all is not reached on the serving path
// (causal, queries at positions 0..S-1 against keys 0..T-1 with S <= T);
// the kernel does not try to match the reference there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // fp32: 16 x 8 row/column groups; bf16: 4 warps
constexpr int kPad = 4;         // keeps float4 rows aligned
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, t, h, kv, n_rep;
  long long qb, qs, qh;   // strides in elements; the last dim is contiguous
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, os, oh;
  float scale;
  int causal, has_window, window;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)HD * (kBQ + kPad)      // Qt [hd][bq]
                          + (size_t)HD * (kBK + kPad)    // Kt [hd][bk]
                          + (size_t)kBK * HD             // V  [bk][hd]
                          + (size_t)kBK * (kBQ + kPad)); // Pt [bk][bq]
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  constexpr int kG = HD / 32;   // float4 column groups of the output
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + HD * (kBQ + kPad);
  float* vs = kt + HD * (kBK + kPad);
  float* pt = vs + kBK * HD;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  const int tid = threadIdx.x;
  const int ty = tid / 8;       // rows ty*4 .. ty*4+3
  const int tx = tid % 8;       // score columns tx*4+{0..3}, 32+tx*4+{0..3}
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / a.n_rep;

  const float* qbase = q + b * a.qb + head * a.qh;
  const float* kbase = k + b * a.kb + kvh * a.kh;
  const float* vbase = v + b * a.vb + kvh * a.vh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    qt[d * (kBQ + kPad) + r] =
        row < a.s ? qbase[(long long)row * a.qs + d] : 0.f;
  }

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, a.s) - 1;
  const int n_tiles = (a.t + kBK - 1) / kBK;
  const int end = a.causal ? min(n_tiles, q_last / kBK + 1) : n_tiles;
  for (int tile = 0; tile < end; ++tile) {
    const int k0 = tile * kBK;
    // the band excludes the whole tile: its last key is out of every row's
    // window (the first row's window starts latest)
    if (a.has_window && k0 + kBK - 1 <= q0 - a.window) continue;
    __syncthreads();   // the previous tile's P and V are consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < a.t) {
        kx = kbase[(long long)key * a.ks + d];
        vx = vbase[(long long)key * a.vs + d];
      }
      kt[d * (kBK + kPad) + j] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          qt + d * (kBQ + kPad) + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(
          kt + d * (kBK + kPad) + tx * 4);
      const float4 kb = *reinterpret_cast<const float4*>(
          kt + d * (kBK + kPad) + 32 + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
        float x;
        if (kpos >= a.t) {
          x = -INFINITY;            // no such key
        } else {
          bool keep = true;
          if (a.causal) keep = keep && kpos <= qpos;
          if (a.has_window) keep = keep && kpos > qpos - a.window;
          x = keep ? s[i][j] * a.scale : kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4;
      *reinterpret_cast<float4*>(pt + c * (kBQ + kPad) + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= alpha[i];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(
          pt + j * (kBQ + kPad) + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(
            vs + j * HD + 32 * g + tx * 4);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

  float* obase = o + b * a.ob + head * a.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        obase[(long long)row * a.os + 32 * g + tx * 4 + e] =
            acc[i][g * 4 + e] * inv;
  }
}

// ---------------------------------------------------------------- bf16
// The bf16 path runs both products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). Each of the block's 4 warps owns 16
// of the 64 query rows: its q fragments stay in registers for the whole
// loop, S = q k^T comes out in the accumulator layout, the online softmax
// runs on it in registers (row max and sum across the 4 lanes of a row),
// and P is repacked to A fragments for O += P v without a trip through
// shared memory. P goes in as two bf16 parts, its rounding and the rounding
// of the remainder (two products instead of one), so it keeps ~16 bits
// where one bf16 would keep 8 and move outputs by a bf16 ulp. K is
// staged row-major and V transposed, both bf16 with padded rows so the
// fragment loads hit 32 distinct banks.
constexpr int kKPad = 8;        // bf16 pad of a staged K row / V^T row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as two bf16 pairs whose sum carries ~16 bits: the rounding, and
// the rounding of what it left over
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)kBK * (HD + kKPad)      // K
                                  + (size_t)HD * (kBK + kKPad));  // V^T
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(Args a) {
  constexpr int kKS = HD / 16;        // k-steps of q k^T
  constexpr int kNT = kBK / 8;        // 8-key column tiles of S
  constexpr int kOT = HD / 8;         // 8-dim column tiles of O
  constexpr int kKr = HD + kKPad;     // staged K row, in bf16
  constexpr int kVr = kBK + kKPad;    // staged V^T row, in bf16
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* vt = ks + kBK * kKr;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / a.n_rep;
  const int r0 = q0 + warp * 16 + g;      // this lane's two rows
  const int r1 = r0 + 8;

  const __nv_bfloat16* qbase = q + b * a.qb + head * a.qh;
  const __nv_bfloat16* kbase = k + b * a.kb + kvh * a.kh;
  const __nv_bfloat16* vbase = v + b * a.vb + kvh * a.vh;

  uint32_t qf[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    const int c = s * 16 + 2 * t;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
        qbase + (long long)r0 * a.qs + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
        qbase + (long long)r1 * a.qs + c);
    qf[s][0] = r0 < a.s ? p0[0] : 0u;
    qf[s][1] = r1 < a.s ? p1[0] : 0u;
    qf[s][2] = r0 < a.s ? p0[4] : 0u;   // columns c + 8, c + 9
    qf[s][3] = r1 < a.s ? p1[4] : 0u;
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + kBQ, a.s) - 1;
  const int n_tiles = (a.t + kBK - 1) / kBK;
  const int end = a.causal ? min(n_tiles, q_last / kBK + 1) : n_tiles;
  for (int tile = 0; tile < end; ++tile) {
    const int k0 = tile * kBK;
    if (a.has_window && k0 + kBK - 1 <= q0 - a.window) continue;
    __syncthreads();   // the previous tile's K and V are consumed
    constexpr int kChunks = kBK * HD / 8;     // 16-byte chunks per matrix
    for (int c = tid; c < kChunks; c += kThreads) {
      // K row-major: a key's row is HD/8 consecutive chunks
      const int jk = c / (HD / 8), dk = (c % (HD / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0);
      if (k0 + jk < a.t)
        kx = *reinterpret_cast<const uint4*>(
            kbase + (long long)(k0 + jk) * a.ks + dk);
      *reinterpret_cast<uint4*>(ks + jk * kKr + dk) = kx;
      // V transposed: a warp covers 32 keys of one 8-dim chunk, so its
      // 2-byte stores fall on consecutive addresses
      const int jv = c % kBK, dv = (c / kBK) * 8;
      uint4 vx = make_uint4(0, 0, 0, 0);
      if (k0 + jv < a.t)
        vx = *reinterpret_cast<const uint4*>(
            vbase + (long long)(k0 + jv) * a.vs + dv);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(dv + e) * kVr + jv] = ve[e];
    }
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * kKr + 2 * t;
#pragma unroll
      for (int st = 0; st < kKS; ++st) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + st * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + st * 16 + 8);
        mma_bf16(s[n], qf[st][0], qf[st][1], qf[st][2], qf[st][3], b0, b1);
      }
    }

    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {        // h = 0: row r0, h = 1: row r1
      const int qpos = h ? r1 : r0;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + e;
          float x;
          if (kpos >= a.t) {
            x = -INFINITY;               // no such key
          } else {
            bool keep = true;
            if (a.causal) keep = keep && kpos <= qpos;
            if (a.has_window) keep = keep && kpos > qpos - a.window;
            x = keep ? s[n][2 * h + e] * a.scale : kMasked;
          }
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * h + e] - m_new);
          s[n][2 * h + e] = p;
          sum += p;
        }
      alpha[h] = expf(m[h] - m_new);
      l[h] = l[h] * alpha[h] + sum;      // this lane's share of the row
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < kOT; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * kVr + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma_bf16(acc[n], hi[0], hi[1], hi[2], hi[3], b0, b1);
        mma_bf16(acc[n], lo[0], lo[1], lo[2], lo[3], b0, b1);
      }
    }
  }

  __nv_bfloat16* obase = o + b * a.ob + head * a.oh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = h ? r1 : r0;
    if (row >= a.s) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int n = 0; n < kOT; ++n)
      *reinterpret_cast<uint32_t*>(obase + (long long)row * a.os + n * 8 +
                                   2 * t) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, int b,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements, for (B, S, H, hd)
// q/o and (B, T, KV, hd) k/v whose last dim is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int s, int t, int h, int kv, int hd, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int has_window, int window, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || h > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, s, t, h, kv, h / kv, qb, qs, qh, kb, ks, kh, vb, vs, vh,
         ob, os, oh, 1.0f / sqrtf((float)hd), causal, has_window, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch(flash_attention_kernel<64>, smem_bytes<64>(), a, b, st);
  if (dtype == 0 && hd == 128)
    return launch(flash_attention_kernel<128>, smem_bytes<128>(), a, b, st);
  if (dtype == 1 && hd == 64)
    return launch(flash_attention_mma_kernel<64>, mma_smem_bytes<64>(), a,
                  b, st);
  if (dtype == 1 && hd == 128)
    return launch(flash_attention_mma_kernel<128>, mma_smem_bytes<128>(), a,
                  b, st);
  return (int)cudaErrorInvalidValue;
}
