// decode_attention: one query token per row against a KV cache (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:decode_attention. For q (B, 1, H,
// hd), a cache k/v (B, T, KV, hd) and a per-row position pos (B,),
//
//   o[b, 0, h] = softmax_t(mask(q[b, 0, h] . k[b, t, h/n_rep] / sqrt(hd)))
//                . v[b, t, h/n_rep],      mask: t <= pos[b], else -1e30
//
// with an fp32 online softmax; the output is written in q's dtype.
//
// Bound on the H100: bytes. A row must read its K and V up to pos: at the
// serving path's decode (B 8, KV 4, hd 128, bf16, pos up to ~3,050) that is
// ~2 KiB per cached token per row, ~35 MB per call, about 10 us at
// 3.35 TB/s, against ~0.1 GFLOP of work. A decode step makes 32 such calls
// (one per layer) beside its 14.8 GB weight read (~4.4 ms).
//
// Design: one block of 128 threads per (KV head, row, split of T). The
// block serves the KV head's n_rep query heads, so each cache row is read
// from device memory once (a block per query head, as the Pallas grid has
// it, would read it n_rep = 9 times). A split covers up to kSplitTiles
// tiles of 64 slots and stops at min(pos, T-1): slots past pos are never
// read, which is the Pallas kernel's block skip. Splitting T gives the
// serving shape 256 blocks instead of 32, enough to keep the card's memory
// busy. Per tile the block stages K and V in shared memory (fp32) with
// 16-byte loads, all of a thread's loads in flight together, computes the
// n_rep x 64 scores (one dot product per thread and pair), runs the online
// softmax per head with one warp per head, and updates fp32 accumulators,
// each thread owning fixed (head, dim) outputs. With one split the block
// writes the output; with several it writes (m, l, acc) to a scratch
// buffer and a second kernel merges the splits per (head, row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;         // slots per tile
constexpr int kSplitTiles = 8;  // tiles per split of T
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 16;     // outputs per thread: n_rep * hd <= 2,048
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;
  float* part;            // (B, KV, splits, n_rep, hd + 2) when splits > 1
  int t, kv, n_rep;
  long long qb, qh;       // strides in elements; the last dim is contiguous
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, oh;
  float scale;
};

size_t smem_floats(int hd, int n_rep) {
  return (size_t)n_rep * hd          // q   [n_rep][hd]
         + (size_t)kBK * (hd + 1)    // K   [bk][hd+1]
         + (size_t)kBK * hd          // V   [bk][hd]
         + (size_t)n_rep * kBK       // S/P [n_rep][bk]
         + 3 * (size_t)n_rep;        // m, l, alpha
}

// Stage slots k0 .. k0+kBK-1 (zeros past `last`) of one KV head's K and V
// into shared memory as fp32, 16 bytes per load.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(const T* kbase, const T* vbase,
                                           long long ks, long long vs,
                                           int k0, int last, float* kt,
                                           float* vt) {
  constexpr int kVec = 16 / sizeof(T);            // elements per load
  constexpr int kRowChunks = HD / kVec;
  constexpr int kPer = kBK * kRowChunks / kThreads;
  constexpr int kGroup = kPer < 8 ? kPer : 8;     // loads in flight
  static_assert(kPer % kGroup == 0, "tile chunks per thread");
  for (int g0 = 0; g0 < kPer; g0 += kGroup) {
    uint4 kx[kGroup], vx[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int c = threadIdx.x + (g0 + g) * kThreads;
      const int slot = k0 + c / kRowChunks;
      const int d = (c % kRowChunks) * kVec;
      if (slot <= last) {
        kx[g] = *reinterpret_cast<const uint4*>(kbase + slot * ks + d);
        vx[g] = *reinterpret_cast<const uint4*>(vbase + slot * vs + d);
      } else {
        kx[g] = make_uint4(0, 0, 0, 0);
        vx[g] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int c = threadIdx.x + (g0 + g) * kThreads;
      const int j = c / kRowChunks;
      const int d = (c % kRowChunks) * kVec;
      const T* ke = reinterpret_cast<const T*>(&kx[g]);
      const T* ve = reinterpret_cast<const T*>(&vx[g]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kt[j * (HD + 1) + d + e] = to_f32(ke[e]);
        vt[j * HD + d + e] = to_f32(ve[e]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int n_rep = a.n_rep;
  float* qs = smem;
  float* kt = qs + n_rep * HD;
  float* vt = kt + kBK * (HD + 1);
  float* ss = vt + kBK * HD;
  float* ms = ss + n_rep * kBK;
  float* ls = ms + n_rep;
  float* alphas = ls + n_rep;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int pos = a.pos[b];
  const int last = min(pos, a.t - 1);
  const int row_tiles = last < 0 ? 0 : last / kBK + 1;
  const int tile0 = split * kSplitTiles;
  const int tile1 = min(row_tiles, tile0 + kSplitTiles);

  const T* qbase = q + b * a.qb + (long long)kvh * n_rep * a.qh;
  for (int i = tid; i < n_rep * HD; i += kThreads)
    qs[i] = to_f32(qbase[(i / HD) * a.qh + i % HD]);
  for (int i = tid; i < n_rep; i += kThreads) {
    ms[i] = kMasked;
    ls[i] = 0.f;
  }
  const int n_out = n_rep * HD;
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;

  const T* kbase = k + b * a.kb + kvh * a.kh;
  const T* vbase = v + b * a.vb + kvh * a.vh;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();   // q staged; the previous tile's P and V consumed
    stage_tile<T, HD>(kbase, vbase, a.ks, a.vs, k0, last, kt, vt);
    __syncthreads();
    for (int i = tid; i < n_rep * kBK; i += kThreads) {
      const int hh = i / kBK, j = i % kBK;
      const float* qr = qs + hh * HD;
      const float* kr = kt + j * (HD + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int slot = k0 + j;
      ss[i] = slot >= a.t ? -INFINITY
                          : (slot <= pos ? dot * a.scale : kMasked);
    }
    __syncthreads();
    for (int hh = warp; hh < n_rep; hh += kWarps) {
      float* sr = ss + hh * kBK;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[hh];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alphas[hh] = alpha;
        ls[hh] = ls[hh] * alpha + sum;
        ms[hh] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int i = tid + r * kThreads;
      if (i < n_out) {
        const int hh = i / HD, d = i % HD;
        const float* pr = ss + hh * kBK;
        float x = acc[r] * alphas[hh];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) x = fmaf(pr[j], vt[j * HD + d], x);
        acc[r] = x;
      }
    }
  }
  __syncthreads();

  if (n_split == 1) {
    T* obase = static_cast<T*>(a.o) + b * a.ob +
               (long long)kvh * n_rep * a.oh;
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int i = tid + r * kThreads;
      if (i < n_out) {
        const int hh = i / HD, d = i % HD;
        store(obase + hh * a.oh + d, acc[r] / fmaxf(ls[hh], 1e-30f));
      }
    }
    return;
  }
  // partials of this split; an empty split (past the row's pos) has
  // m = -inf and weighs nothing in the merge
  float* part = a.part + (((long long)b * a.kv + kvh) * n_split + split) *
                             n_rep * (HD + 2);
  const bool empty = tile0 >= tile1;
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int i = tid + r * kThreads;
    if (i < n_out) part[(i / HD) * (HD + 2) + i % HD] = acc[r];
  }
  for (int hh = tid; hh < n_rep; hh += kThreads) {
    part[hh * (HD + 2) + HD] = empty ? -INFINITY : ms[hh];
    part[hh * (HD + 2) + HD + 1] = ls[hh];
  }
}

// Merge the splits of one (query head, row): hd threads, one per dim.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_merge_kernel(Args a,
                                                          int n_split) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = head / a.n_rep, hh = head % a.n_rep;
  const float* part = a.part +
                      ((long long)b * a.kv + kvh) * n_split * a.n_rep *
                          (HD + 2) +
                      hh * (HD + 2);
  const long long step = (long long)a.n_rep * (HD + 2);
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part[s * step + HD]);
  if (m == -INFINITY) m = 0.f;   // no slot at all (pos < 0): output 0
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(part[s * step + HD] - m);
    l = fmaf(part[s * step + HD + 1], w, l);
    o = fmaf(part[s * step + d], w, o);
  }
  T* out = static_cast<T*>(a.o) + b * a.ob + head * a.oh;
  store(out + d, o / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const Args& a, int b, int n_split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(HD, a.n_rep);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, HD>
      <<<dim3(a.kv, b, n_split), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<T, HD>
      <<<dim3(a.kv * a.n_rep, b), HD, 0, stream>>>(a, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits of T the launch uses for a cache of t slots (the scratch buffer
// holds b * kv * splits * n_rep * (hd + 2) floats when it is above 1).
extern "C" int decode_attention_splits(int t) {
  const int tiles = (t + kBK - 1) / kBK;
  return (tiles + kSplitTiles - 1) / kSplitTiles;
}

// dtype: 0 float32, 1 bfloat16. Strides are in elements, for (B, 1, H, hd)
// q/o and (B, T, KV, hd) k/v whose last dim is contiguous and 16-byte
// aligned rows; pos is (B,) int32.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part, int dtype, int b, int t, int h, int kv, int hd,
    long long qb, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long oh,
    void* stream) {
  if (b <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || b > 65535 ||
      (long long)(h / kv) * hd > (long long)kMaxOut * kThreads)
    return (int)cudaErrorInvalidValue;
  const int n_split = decode_attention_splits(t);
  if (n_split > 65535 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, (const int*)pos, o, (float*)part, t, kv, h / kv, qb, qh,
         kb, ks, kh, vb, vs, vh, ob, oh, 1.0f / sqrtf((float)hd)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64) return launch<float, 64>(a, b, n_split, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(a, b, n_split, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(a, b, n_split, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(a, b, n_split, st);
  return (int)cudaErrorInvalidValue;
}
