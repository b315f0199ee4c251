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
// Both kernels take one block of 128 threads per (KV head, row, split of T)
// and serve the KV head's n_rep query heads, so each cache row is read from
// device memory once (a block per query head, as the Pallas grid has it,
// would read it n_rep = 9 times). A split covers `split_tiles` tiles of 64
// slots, chosen by the wrapper, and stops at min(pos, T-1): slots past pos
// are never read, which is the Pallas kernel's block skip, and a block
// whose split starts past pos exits before any load. A row whose slots lie
// in one split gets its output from that block; otherwise each split
// writes (m, l, acc) to a scratch buffer, merged per (head, row) by the
// last of the row's blocks to finish (bf16: an atomic count per row and KV
// head, in the call's scratch, zeroed by the launch) or by
// `decode_merge_kernel` (fp32).
//
// When the caller passes an `lse` buffer (B, H) fp32, each (row, head) also
// gets the log-sum-exp of its scaled scores over the slots it read, m + log
// l in the natural base, or -inf for a row with no slot at all. The output
// is computed as without it: the buffer only adds stores. A caller that
// splits T over devices runs the kernel on each block with a local pos and
// combines the blocks' outputs by their lse.
//
// bf16 (`decode_attention_mma_kernel`): the two products run on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate). The KV head's
// n_rep query heads are the M rows (rows n_rep..15 are zero; two M tiles
// when n_rep > 16). wgmma would need M = 64, 55 of whose rows would be
// padding at the serving shape's n_rep 9, and the kernel is bound by bytes,
// so the smaller unit is the right one. Each of the 4 warps owns 16 slots
// of every tile and runs on its own: it copies its slots' K and V rows,
// bf16 as stored, into its part of a 3-stage shared-memory ring with
// cp.async (16 bytes a copy, zeros past `last`), so the next two tiles are
// in flight while one computes; rows are XOR-swizzled in 16-byte chunks so
// that ldmatrix reads them without bank conflicts. S = Q K^T takes Q from
// registers (loaded once) and K through ldmatrix; the warp's online
// softmax (fp32, base 2) reduces rows over quads with shuffles; O += P V
// takes V through ldmatrix.trans, with P as two bf16 parts (hi + lo), so
// the error stays at the output's own rounding. Inside the loop a warp
// waits only on its own copies; the 4 warps merge their (m, l, O) through
// shared memory at the end.
//
// fp32 (`decode_attention_kernel`): tiles are staged in shared memory as
// fp32 with 16-byte loads and reduced with an fp32 online softmax on the
// CUDA cores, one warp per head for the softmax and fixed (head, dim)
// outputs per thread for the products.
//
// head_dim 64, 80, 120 and 128 are built, as instances of both kernels,
// each reading its rows in place (no padded copy of the cache). In the
// bf16 kernel a staged row is hd rounded up to 64 columns (128 at 80 and
// 120), so the XOR swizzle of its 16-byte chunks stays inside the row; Q
// K^T steps k by 16, so at 120 its last step reads one chunk past hd,
// which the copy zero-fills in shared memory (as Q's columns past hd are
// zeros in registers); P V's n tiles are hd / 8, 15 at 120, the last one
// read with an x2 ldmatrix. A ring cache (sliding window) needs no mask
// of its own: with pos past its end every slot is valid, which is what
// min(pos, T-1) gives, and the softmax does not depend on slot order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;         // slots per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 16;     // fp32 kernel: outputs per thread
constexpr float kMasked = -1e30f;
constexpr int kStages = 3;      // bf16 kernel: tiles in the ring
constexpr int kWarpSlots = kBK / kWarps;   // a warp's slots of a tile
constexpr int kMaxSplits = 64;  // bf16: splits of T the last block merges
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
  int split_tiles;        // tiles of 64 slots per split of T
  int* count;             // bf16: (B, KV) splits finished, zeroed per launch
  float* lse;             // (B, H) log-sum-exp of the scores, or null
};

// log-sum-exp of (row b, KV head kvh, query head hh of its group): m + log
// l, m in base 2 when `base2`; -inf when no slot was read (l == 0)
__device__ __forceinline__ void store_lse(const Args& a, int b, int kvh,
                                          int hh, float m, float l,
                                          bool base2) {
  if (a.lse == nullptr) return;
  a.lse[((long long)b * a.kv + kvh) * a.n_rep + hh] =
      l > 0.f ? (base2 ? m * kLn2 : m) + logf(l) : -INFINITY;
}

size_t smem_floats(int hd, int n_rep) {
  return (size_t)n_rep * hd          // q   [n_rep][hd]
         + (size_t)kBK * (hd + 1)    // K   [bk][hd+1]
         + (size_t)kBK * hd          // V   [bk][hd]
         + (size_t)n_rep * kBK       // S/P [n_rep][bk]
         + 3 * (size_t)n_rep;        // m, l, alpha
}

// Loads a thread keeps in flight while staging a tile: the largest divisor
// of its `per` loads up to 8 (8 at hd 64 and 128, 5 at hd 80 and 120)
__host__ __device__ constexpr int load_group(int per) {
  int g = per < 8 ? per : 8;
  while (per % g) --g;
  return g;
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
  constexpr int kGroup = load_group(kPer);        // loads in flight
  static_assert(kBK * kRowChunks % kThreads == 0, "tile chunks per thread");
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
  const int tile0 = split * a.split_tiles;
  const int tile1 = min(row_tiles, tile0 + a.split_tiles);

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
    for (int hh = tid; hh < n_rep; hh += kThreads)
      store_lse(a, b, kvh, hh, ms[hh], ls[hh], false);
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

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
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

// (x, y) as bf16 pairs hi + lo with x in the low half, the first column
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      x - __bfloat162float(h.x), y - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Columns of a staged K or V row: hd rounded up to whole groups of 8
// 16-byte chunks (64 columns), so that the XOR swizzle below stays inside
// the row: 64 at hd 64, 128 at hd 80, 120 and 128.
template <int HD>
__host__ __device__ constexpr int row_cols() {
  return (HD + 63) / 64 * 64;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [16][row_cols]
// bf16 buffer whose chunks are XOR-swizzled by the row: the 8 rows an
// ldmatrix phase reads fall in 8 different bank groups.
template <int HD>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * (row_cols<HD>() * 2) + ((chunk ^ (row & 7)) << 4);
}

// Shared memory of the bf16 kernel: per warp, kStages stages of its 16
// slots' K and V, [16][row_cols] bf16 each; after the loop the same bytes
// hold the warp's (O, m, l) for the merge.
template <int HD>
constexpr int mma_smem_bytes() {
  return kWarps * kStages * 2 * kWarpSlots * row_cols<HD>() * 2;
}

template <int HD, int MT>
__global__ void __launch_bounds__(kThreads)
decode_attention_mma_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  static_assert(HD % 16 == 0 || HD % 16 == 8, "whole 16-byte chunks");
  constexpr int kChunks = HD / 8;               // 16-byte chunks of hd
  constexpr int kKSteps = (HD + 15) / 16;       // k steps of Q K^T
  constexpr int kCopies = 2 * kKSteps;          // chunks staged a row; one
  //                                               past hd (hd 120) is zeros
  constexpr int kNTiles = HD / 8;               // n tiles of P V (odd at 120)
  constexpr int kRows = MT * 16;                // M rows (query heads)
  constexpr int kOStride = HD + 4;              // floats in a merged O row
  constexpr int kBuf = kWarpSlots * row_cols<HD>() * 2;  // bytes a stage
  constexpr int kWarpBytes = kStages * 2 * kBuf;
  static_assert(kCopies <= row_cols<HD>() / 8, "staged chunks fit a row");
  static_assert((kRows * kOStride + 2 * kRows) * 4 <= kWarpBytes,
                "a warp's (O, m, l) fits its part of the ring");
  static_assert(kWarpSlots * kCopies % 32 == 0, "copies per lane");
  static_assert((2 * kMaxSplits + 1) * 32 * 4 <= kWarps * kWarpBytes,
                "the merge's (m, l) fit the ring");

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;       // mma fragment row, column
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int n_rep = a.n_rep;
  const int last = min(a.pos[b], a.t - 1);
  const int tile0 = split * a.split_tiles;
  const int tile1 =
      last < 0 ? 0 : min(last / kBK + 1, tile0 + a.split_tiles);
  const int n_tiles = tile1 - tile0;
  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(a.o) + b * a.ob +
                         (long long)kvh * n_rep * a.oh;
  if (n_tiles <= 0) {
    // past the row's pos: nothing to merge from this split; a row with no
    // slot at all gets zeros from its first split
    if (last < 0 && split == 0) {
      for (int i = threadIdx.x; i < n_rep * HD; i += kThreads)
        obase[(i / HD) * a.oh + i % HD] = __float2bfloat16(0.f);
      for (int i = threadIdx.x; i < n_rep; i += kThreads)
        store_lse(a, b, kvh, i, 0.f, 0.f, true);
    }
    return;
  }

  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.kb + kvh * a.kh;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vb + kvh * a.vh;
  unsigned char* ring = smem_raw + warp * kWarpBytes;
  const uint32_t ring_s = smem_addr(ring);

  // this warp's 16 slots of `tile` into stage `st`; zeros past `last` and
  // in a chunk past hd, which Q K^T's last k step reads at hd 120
  auto load = [&](int tile, int st) {
    const int slot0 = tile * kBK + warp * kWarpSlots;
    const uint32_t kd = ring_s + st * 2 * kBuf, vd = kd + kBuf;
#pragma unroll
    for (int i = 0; i < kWarpSlots * kCopies / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c / kCopies, ch = c % kCopies;
      const int slot = slot0 + r;
      const bool in = slot <= last && ch < kChunks;
      const long long ko = in ? (long long)slot * a.ks + ch * 8 : 0;
      const long long vo = in ? (long long)slot * a.vs + ch * 8 : 0;
      cp_async16(kd + swz<HD>(r, ch), kbase + ko, in ? 16 : 0);
      cp_async16(vd + swz<HD>(r, ch), vbase + vo, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load(tile0 + st, st);
    cp_async_commit();
  }

  // Q as A fragments, once: rows n_rep..kRows-1 are zero, and so are
  // columns past hd (the second half of the last k step at hd 120)
  const __nv_bfloat16* qbase = static_cast<const __nv_bfloat16*>(a.q) +
                               b * a.qb + (long long)kvh * n_rep * a.qh;
  uint32_t qa[MT][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      const bool ok = row < n_rep;
      const __nv_bfloat16* qr = qbase + (long long)(ok ? row : 0) * a.qh;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int col = ks * 16 + 2 * cq;
        qa[mt][ks][h] =
            ok ? *reinterpret_cast<const uint32_t*>(qr + col) : 0u;
        qa[mt][ks][2 + h] =
            ok && ks * 16 + 8 < HD
                ? *reinterpret_cast<const uint32_t*>(qr + col + 8)
                : 0u;
      }
    }
  }

  float o[MT][kNTiles][4];
  float m[MT][2], l[MT][2];   // per fragment row g (h 0) and g + 8 (h 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float scale2 = a.scale * kLog2e;        // softmax in base 2

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles)
      load(tile0 + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this warp's copies of tile i landed
    __syncwarp();
    const uint32_t kd = ring_s + (i % kStages) * 2 * kBuf, vd = kd + kBuf;

    // S = Q K^T over the warp's 16 slots, two n tiles of 8 slots
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      // matrices: (slots 0-7, chunk 2ks), (0-7, 2ks+1), (8-15, 2ks),
      // (8-15, 2ks+1): B fragments of n tiles 0 and 1
      uint32_t kf[4];
      ldsm_x4(kd + swz<HD>((lane & 7) + ((lane >> 4) << 3),
                           2 * ks + ((lane >> 3) & 1)),
              kf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][0], qa[mt][ks], kf[0], kf[1]);
        mma_bf16(s[mt][1], qa[mt][ks], kf[2], kf[3]);
      }
    }

    // mask past `last`, online softmax per row, P as A fragments
    const int slot0 = (tile0 + i) * kBK + warp * kWarpSlots + 2 * cq;
    uint32_t phi[MT][4], plo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[4];                 // x[2j + e]: n tile j, column e
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            x[2 * j + e] = slot0 + 8 * j + e <= last
                               ? s[mt][j][2 * h + e] * scale2
                               : -INFINITY;
        float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[mt][h] - m_use);
        m[mt][h] = m_new;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = exp2f(x[e] - m_use);
        l[mt][h] = fmaf(l[mt][h], alpha, (p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          o[mt][n][2 * h] *= alpha;
          o[mt][n][2 * h + 1] *= alpha;
        }
        // A fragment: a0/a1 rows g/g+8 of slots 0-7, a2/a3 of slots 8-15
        split_pair(p[0], p[1], phi[mt][h], plo[mt][h]);
        split_pair(p[2], p[3], phi[mt][2 + h], plo[mt][2 + h]);
      }
    }

    // O += P V: V's rows are k, read transposed into B fragments
#pragma unroll
    for (int np = 0; np < kNTiles / 2; ++np) {
      // matrices: (slots 0-7, chunk 2np), (8-15, 2np), (0-7, 2np+1),
      // (8-15, 2np+1): B fragments of n tiles 2np and 2np+1
      uint32_t vf[4];
      ldsm_x4_trans(vd + swz<HD>((lane & 7) + (((lane >> 3) & 1) << 3),
                                 2 * np + (lane >> 4)),
                    vf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * np], phi[mt], vf[0], vf[1]);
        mma_bf16(o[mt][2 * np], plo[mt], vf[0], vf[1]);
        mma_bf16(o[mt][2 * np + 1], phi[mt], vf[2], vf[3]);
        mma_bf16(o[mt][2 * np + 1], plo[mt], vf[2], vf[3]);
      }
    }
    if constexpr (kNTiles % 2 == 1) {
      // the last n tile alone (hd 120): (slots 0-7, 8-15) of its chunk
      uint32_t vf[2];
      ldsm_x2_trans(vd + swz<HD>((lane & 7) + (((lane >> 3) & 1) << 3),
                                 kNTiles - 1),
                    vf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][kNTiles - 1], phi[mt], vf[0], vf[1]);
        mma_bf16(o[mt][kNTiles - 1], plo[mt], vf[0], vf[1]);
      }
    }
    __syncwarp();   // stage i % kStages is refilled next iteration
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's (O, m, l) into its own part of shared memory
  float* wo = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      float lsum = l[mt][h];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (cq == 0) {
        wo[kRows * kOStride + row] = m[mt][h];
        wo[kRows * kOStride + kRows + row] = lsum;
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
        *reinterpret_cast<float2*>(wo + row * kOStride + n * 8 + 2 * cq) =
            make_float2(o[mt][n][2 * h], o[mt][n][2 * h + 1]);
    }
  }
  __syncthreads();

  // merge the 4 warps; write the output when this is the row's only split
  // with work, else this split's partials: acc [split][row][HD] for every
  // (row, KV head) first, then (m in base 2, l) [split][row][2]
  const int used = min(n_split, last / (a.split_tiles * kBK) + 1);
  const long long pair = (long long)b * a.kv + kvh;
  float* acc_row = a.part + pair * n_split * n_rep * HD;
  float* ml_row = a.part + (long long)gridDim.y * a.kv * n_split * n_rep * HD +
                  pair * n_split * n_rep * 2;
  for (int i = threadIdx.x; i < n_rep * HD; i += kThreads) {
    const int row = i / HD, d = i % HD;
    float mw[kWarps], mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ww =
          reinterpret_cast<const float*>(smem_raw + w * kWarpBytes);
      mw[w] = ww[kRows * kOStride + row];
      mx = fmaxf(mx, mw[w]);
    }
    const float mu = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ww =
          reinterpret_cast<const float*>(smem_raw + w * kWarpBytes);
      const float e = exp2f(mw[w] - mu);
      acc = fmaf(e, ww[row * kOStride + d], acc);
      lsum = fmaf(e, ww[kRows * kOStride + kRows + row], lsum);
    }
    if (used == 1) {
      obase[row * a.oh + d] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
      if (d == 0) store_lse(a, b, kvh, row, mx, lsum, true);
    } else {
      acc_row[((long long)split * n_rep + row) * HD + d] = acc;
      if (d == 0)
        *reinterpret_cast<float2*>(ml_row + (split * n_rep + row) * 2) =
            make_float2(mx, lsum);
    }
  }
  if (used == 1) return;

  // the last of the row's `used` splits to finish merges them all (the
  // launch zeroes the counters in stream order before the kernel runs)
  __shared__ int merges;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    merges = atomicAdd(a.count + (long long)b * a.kv + kvh, 1) == used - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  // (m, l) of every (split, row) into shared memory, m turned into each
  // split's weight per row; then every thread's 4-float groups of outputs
  // summed over the splits, with all of its loads of a split in flight
  float* wgt = reinterpret_cast<float*>(smem_raw);    // [used][n_rep]
  float* lsp = wgt + kMaxSplits * 32;                 // [used][n_rep]
  float* inv_l = lsp + kMaxSplits * 32;               // [n_rep]
  for (int i = threadIdx.x; i < used * n_rep; i += kThreads) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(ml_row) + i);
    wgt[i] = ml.x;
    lsp[i] = ml.y;
  }
  __syncthreads();
  for (int row = threadIdx.x; row < n_rep; row += kThreads) {
    float mx = -INFINITY;
    for (int sp = 0; sp < used; ++sp) mx = fmaxf(mx, wgt[sp * n_rep + row]);
    float lsum = 0.f;
    for (int sp = 0; sp < used; ++sp) {
      const float e = exp2f(wgt[sp * n_rep + row] - mx);
      wgt[sp * n_rep + row] = e;
      lsum = fmaf(e, lsp[sp * n_rep + row], lsum);
    }
    inv_l[row] = 1.f / fmaxf(lsum, 1e-30f);
    store_lse(a, b, kvh, row, mx, lsum, true);
  }
  __syncthreads();
  constexpr int kQuads = HD / 4;                  // 4-float groups in a row
  constexpr int kPer =                            // groups a thread merges
      (kRows * kQuads + kThreads - 1) / kThreads;
  const int n_quads = n_rep * kQuads;
  float4 acc4[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc4[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int sp = 0; sp < used; ++sp) {
    const float4* ps = reinterpret_cast<const float4*>(
        acc_row + (long long)sp * n_rep * HD);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = threadIdx.x + r * kThreads;
      if (j < n_quads) {
        const float w = wgt[sp * n_rep + j / kQuads];
        const float4 x = __ldcg(ps + j);
        acc4[r].x = fmaf(w, x.x, acc4[r].x);
        acc4[r].y = fmaf(w, x.y, acc4[r].y);
        acc4[r].z = fmaf(w, x.z, acc4[r].z);
        acc4[r].w = fmaf(w, x.w, acc4[r].w);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (j < n_quads) {
      const int row = j / kQuads;
      const float il = inv_l[row];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          obase + row * a.oh + (j % kQuads) * 4);
      dst[0] = __floats2bfloat162_rn(acc4[r].x * il, acc4[r].y * il);
      dst[1] = __floats2bfloat162_rn(acc4[r].z * il, acc4[r].w * il);
    }
  }
}

// fp32: merge the splits of one (query head, row), hd threads, one per
// dim. Only the splits that start at or before the row's last slot hold
// partials.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_merge_kernel(Args a,
                                                          int n_split) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = head / a.n_rep, hh = head % a.n_rep;
  const int last = min(a.pos[b], a.t - 1);
  const int used =
      last < 0 ? 0 : min(n_split, last / (a.split_tiles * kBK) + 1);
  const float* part = a.part +
                      ((long long)b * a.kv + kvh) * n_split * a.n_rep *
                          (HD + 2) +
                      hh * (HD + 2);
  const long long step = (long long)a.n_rep * (HD + 2);
  float m = -INFINITY;
  for (int s = 0; s < used; ++s) m = fmaxf(m, part[s * step + HD]);
  if (m == -INFINITY) m = 0.f;   // no slot at all (pos < 0): output 0
  float l = 0.f, o = 0.f;
  for (int s = 0; s < used; ++s) {
    const float w = expf(part[s * step + HD] - m);
    l = fmaf(part[s * step + HD + 1], w, l);
    o = fmaf(part[s * step + d], w, o);
  }
  T* out = static_cast<T*>(a.o) + b * a.ob + head * a.oh;
  store(out + d, o / fmaxf(l, 1e-30f));
  if (d == 0) store_lse(a, b, kvh, hh, m, l, false);
}

template <int HD>
int launch_fp32(const Args& a, int b, int n_split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(HD, a.n_rep);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<float, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<float, HD>
      <<<dim3(a.kv, b, n_split), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<float, HD>
      <<<dim3(a.kv * a.n_rep, b), HD, 0, stream>>>(a, n_split);
  return (int)cudaGetLastError();
}

template <int HD, int MT>
int launch_mma(const Args& a, int b, int n_split, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HD>();
  if (n_split > 1) {
    const cudaError_t e = cudaMemsetAsync(
        a.count, 0, sizeof(int) * (size_t)b * a.kv, stream);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_mma_kernel<HD, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_mma_kernel<HD, MT>
      <<<dim3(a.kv, b, n_split), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements, for (B, 1, H, hd)
// q/o and (B, T, KV, hd) k/v whose last dim is contiguous and 16-byte
// aligned rows; pos is (B,) int32. T is cut into n_split splits of
// split_tiles tiles of 64 slots (the wrapper's choice); with more than one,
// `part` holds b * kv * n_split * n_rep * (hd + 2) floats, and for bf16
// `count` b * kv ints of scratch, zeroed here with cudaMemsetAsync on
// `stream` (so a launch owns its counters, on any stream and under CUDA
// graph capture). The
// output's rows must be 8-byte aligned (oh a multiple of 4). `lse`, when not
// null, is a contiguous (B, H) fp32 buffer for each (row, head)'s
// log-sum-exp.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part, void* count, void* lse, int dtype, int b, int t, int h,
    int kv, int hd, int split_tiles, int n_split, long long qb, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, long long ob, long long oh, void* stream) {
  if (b <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || b > 65535 ||
      (long long)(h / kv) * hd > (long long)kMaxOut * kThreads)
    return (int)cudaErrorInvalidValue;
  const int tiles = (t + kBK - 1) / kBK;
  if (split_tiles <= 0 ||
      n_split != (tiles + split_tiles - 1) / split_tiles ||
      n_split > 65535 ||
      (n_split > 1 && part == nullptr) ||
      (dtype == 1 && (n_split > kMaxSplits ||
                      (n_split > 1 && count == nullptr))))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, (const int*)pos, o, (float*)part, t, kv, h / kv, qb, qh,
         kb, ks, kh, vb, vs, vh, ob, oh, 1.0f / sqrtf((float)hd),
         split_tiles, (int*)count, (float*)lse};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (hd) {
      case 64: return launch_fp32<64>(a, b, n_split, st);
      case 80: return launch_fp32<80>(a, b, n_split, st);
      case 120: return launch_fp32<120>(a, b, n_split, st);
      case 128: return launch_fp32<128>(a, b, n_split, st);
    }
  } else if (dtype == 1) {
    // n_rep * hd <= 2,048: up to 32 M rows at hd 64, 25 at 80, 17 at 120,
    // 16 at 128
    const bool one = a.n_rep <= 16;
    switch (hd) {
      case 64: return one ? launch_mma<64, 1>(a, b, n_split, st)
                          : launch_mma<64, 2>(a, b, n_split, st);
      case 80: return one ? launch_mma<80, 1>(a, b, n_split, st)
                          : launch_mma<80, 2>(a, b, n_split, st);
      case 120: return one ? launch_mma<120, 1>(a, b, n_split, st)
                           : launch_mma<120, 2>(a, b, n_split, st);
      case 128: return launch_mma<128, 1>(a, b, n_split, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
