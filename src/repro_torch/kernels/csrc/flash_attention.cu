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
// q/k/v/o, so the tensor cores' 989 TFLOP/s bound it near 0.16 ms.
//
// Two kernels. The bf16 kernel (the serving path's) is built for Hopper:
// TMA copies, wgmma products and a producer warpgroup (its design is at
// flash_attention_wgmma_kernel below). The fp32 kernel runs on the CUDA
// cores (67 TFLOP/s peak) to keep fp32 inputs exact to fp32.
//
// Both kernels: one block per (q tile, head, batch row), looping over k/v
// tiles with m, l and the fp32 accumulator in registers for the whole loop,
// which is what the Pallas kernel's sequential kv grid axis carried in VMEM.
// Tiles that the causal or window band excludes are not visited. Ragged S
// and T edges are handled by bounds: q rows past S are computed and not
// written, keys past T score -inf (they do not exist), so no shape needs
// padding.
//
// The fp32 kernel (128 threads, 64 q rows, 64-key tiles) stages its q tile
// in shared memory once (transposed), then loops over k/v tiles: it stages
// K (transposed) and V, each thread computes a 4 x 8 register tile of
// scores (float4 shared loads), the row max and row sum are reduced across
// the 8 threads of a row group with warp shuffles, and the thread's
// 4 x hd/8 slice of the fp32 accumulator is rescaled and updated from P
// (through shared memory) and V.
//
// A row with no visible key at all is not reached on the serving path
// (causal, queries at positions 0..S-1 against keys 0..T-1 with S <= T);
// the kernels do not try to match the reference there.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // fp32: query rows per block
constexpr int kBK = 64;         // fp32: keys per tile
constexpr int kThreads = 128;   // fp32: 16 x 8 row/column groups
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
// flash_attention_wgmma_kernel: FlashAttention-3's structure on Hopper.
//
// - A block of 384 threads takes 128 query rows of one (head, batch row):
//   warpgroup 0 is the producer, warpgroups 1 and 2 are consumers of 64 rows
//   each (wgmma's M). `setmaxnreg` moves registers from the producer (24) to
//   the consumers (240).
// - One thread of the producer copies Q once, and K and V 128 keys at a time
//   into a 3-stage ring, with TMA (cp.async.bulk.tensor) over 4-d tensor maps
//   (hd, heads, rows, batch) built on the host with the caller's strides, so
//   the (B, S, H, hd) layout is read in place. Each box is 128 rows x 64
//   columns (128 bytes) with the 128-byte swizzle; rows past S or T arrive
//   as zeros. Each stage has a "full" mbarrier (TMA's byte count) and an
//   "empty" one (all 256 consumer threads arrive once the stage is read).
// - A consumer computes S = Q K^T with wgmma m64n128k16 from shared memory
//   (both operands K-major), the online softmax in registers (row max and
//   sum across the 4 lanes that share a row; scores in the log2 domain,
//   ex2.approx), and O += P V with P from registers as the A operand and V
//   straight from its row-major tile as an N-major B operand (wgmma's
//   transpose flag), so V is never transposed. P enters as two bf16 parts,
//   its rounding and the rounding of the remainder, so it keeps ~16 bits
//   where one bf16 would keep 8 and move outputs by a bf16 ulp.
// - Overlap: each tile's Q K^T is issued together with the previous tile's
//   P V (two wgmma groups), so the softmax of a tile runs while the previous
//   tile's P V is on the tensor cores; and the two consumers take turns to
//   issue (named barriers), so one's softmax runs beside the other's
//   products.
// - Masks are applied only on tiles that cross the causal diagonal, the
//   window's edge or T; tiles outside the band are not loaded at all.
// - The grid is (heads, batch, q tiles) with the q tile reversed, so the
//   causal triangle's heaviest tiles start first and the last wave is short.
// Shared memory at hd 128: Q 32 KB + 3 x (K 32 KB + V 32 KB) = 224 KB, one
// block per SM. A stage is released only once the P V that reads its V has
// completed, late in the next tile's step, so a third stage keeps the next
// tile's copy in flight for a whole step.
constexpr int kTile = 128;                  // q rows per block, keys per tile
constexpr int kStages = 3;                  // depth of the k/v ring
constexpr int kWg = 128;                    // threads of a warpgroup
constexpr int kWgThreads = 3 * kWg;         // producer + two consumers
constexpr int kBox = kTile * 128;           // one 128-row x 64-column box
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in the block's 1024-aligned dynamic shared memory.
template <int HD>
struct Layout {
  static constexpr int kCB = HD / 64;               // 64-column boxes per row
  static constexpr int kMat = kCB * kBox;           // one 128-row tile
  static constexpr int kK = kMat;                   // K of stage s: + 2 s kMat
  static constexpr int kV = 2 * kMat;               // V of stage s: + 2 s kMat
  static constexpr int kBar = (1 + 2 * kStages) * kMat;
  // mbarriers: q, full[kStages], empty[kStages]; + slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at coordinates (c0, c1, c2, c3) into shared `dst`;
// its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler the registers are read and written here, so it neither
// reads a wgmma's result before the wait nor reuses its operands early.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void keep_p(uint32_t (&p_hi)[8][4],
                                       uint32_t (&p_lo)[8][4]) {
  keep(p_hi);
  keep(p_lo);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// D (64 x 128, fp32) (+)= A (64 x 16) . B (16 x 128): A and B bf16 in shared
// memory, both K-major (tnspA = tnspB = 0); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16
// in shared memory, N-major: tnspB = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16
// in shared memory, N-major: tnspB = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, 256 threads each), so one warpgroup's softmax runs
// while the other's products occupy the tensor cores.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(2 * kWg) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(2 * kWg) : "memory");
}

// Issue S = Q K^T (one wgmma group): 16 columns of hd a step, 32 bytes into
// a swizzled row, the 64-column boxes kBox apart.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_base,
                                         uint32_t ks) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const uint32_t off = (k / 4) * kBox + (k % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q_base + off, 16, 1024),
                  sw128_desc(ks + off, 16, 1024), k > 0);
  }
  wgmma_commit();
}

// Issue O += P V (one wgmma group): 16 keys a step (2,048 bytes of V's
// tile); V is the N-major B operand, its 64-column boxes kBox apart.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p_hi)[8][4],
                                         const uint32_t (&p_lo)[8][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = sw128_desc(vs + kk * 16 * 128, kBox, 1024);
    wgmma_pv<HD>(o, p_hi[kk], dv);
    wgmma_pv<HD>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

// P as wgmma A fragments: keys 16kk..16kk+15 are S's column tiles 2kk and
// 2kk + 1, laid out as mma's m16k16 A fragment.
__device__ __forceinline__ void to_fragments(const float (&s)[64],
                                             uint32_t (&p_hi)[8][4],
                                             uint32_t (&p_lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], p_hi[kk][j],
                 p_lo[kk][j]);
}

// Online softmax of the tile whose first key is k0, on the warpgroup's
// scores s, in the log2 domain (x = s * mul); s[4i + e] is row (e < 2 ? r0 :
// r1), key k0 + 8i + col + (e & 1). Leaves P in s, updates each row's max m
// and this lane's share of its sum l, and returns the rescale of O in alpha.
// A tile that crosses a mask's edge or T is scaled first and masked in the
// log2 domain, so -1e30 never meets an fma with the scale (whose exact
// product would leave a residual that ex2 turns into inf).
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Args& a, float scale_log2,
                                               int k0, int row_lo, int row_hi,
                                               int r0, int r1, int col) {
  const bool edge = (a.causal && k0 + kTile - 1 > row_lo) ||
                    (a.has_window && k0 <= row_hi - a.window) ||
                    k0 + kTile > a.t;
  float mul = scale_log2;
  if (edge) {
    mul = 1.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float& x = s[4 * i + e];
        x *= scale_log2;
        if (key >= a.t)
          x = -INFINITY;                     // no such key
        else if ((a.causal && key > row) ||
                 (a.has_window && key <= row - a.window))
          x = kMasked;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * mul);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * i + 2 * h + e], mul, -m_new));
        s[4 * i + 2 * h + e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha[h] + sum;            // this lane's share of the row
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Args a) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the base to it
  const uint32_t base = (shared_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + kStages + st); };

  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * kTile;
  const int kvh = head / a.n_rep;
  // the k/v tiles the band reaches: [n_begin, n_end)
  const int q_last = min(q0 + kTile, a.s) - 1;
  const int n_tiles = (a.t + kTile - 1) / kTile;
  const int n_end = a.causal ? min(n_tiles, q_last / kTile + 1) : n_tiles;
  int n_begin = 0;
  if (a.has_window) {
    const int first_key = q0 - a.window + 1;   // row q0's first visible key
    n_begin = first_key > 0 ? min(first_key / kTile, n_end) : 0;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 2 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kMat);
      for (int cb = 0; cb < L::kCB; ++cb)
        tma_load(base + cb * kBox, &tq, bar_q, cb * 64, head, q0, b);
      for (int n = n_begin, it = 0; n < n_end; ++n, ++it) {
        const int st = it % kStages;
        mbar_wait(bar_empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(st), 2 * L::kMat);
        const uint32_t ks = base + L::kK + st * 2 * L::kMat;
        const uint32_t vs = base + L::kV + st * 2 * L::kMat;
        for (int cb = 0; cb < L::kCB; ++cb) {
          tma_load(ks + cb * kBox, &tk, bar_full(st), cb * 64, kvh, n * kTile,
                   b);
          tma_load(vs + cb * kBox, &tv, bar_full(st), cb * 64, kvh, n * kTile,
                   b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    constexpr int kO = HD / 2;                  // O accumulator per thread
    const int c = threadIdx.x / kWg - 1;        // rows q0 + 64c .. + 63
    const int tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32;
    const int row_lo = q0 + 64 * c, row_hi = row_lo + 63;
    const int r0 = row_lo + 16 * warp + lane / 4, r1 = r0 + 8;
    const int col = 2 * (lane % 4);
    // this warpgroup's 64 rows of Q, box by box
    const uint32_t q_base = base + c * 64 * 128;
    const float scale_log2 = a.scale * kLog2e;

    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    float s[64];
    uint32_t p_hi[8][4], p_lo[8][4];

    // Tile it's S = Q K^T is issued together with tile it-1's O += P V, in
    // this warpgroup's turn; the softmax of tile it then runs while P V is
    // in flight. A stage is released once the P V that reads it completes.
    const int n_iter = n_end - n_begin;
    mbar_wait(bar_q, 0);
    if (n_iter > 0) {
      if (c == 1) turn_pass(c);                 // warpgroup 1 goes first
      float alpha[2];
      mbar_wait(bar_full(0), 0);
      turn_wait(c);
      wgmma_fence();
      issue_qk<HD>(s, q_base, base + L::kK);
      turn_pass(c);
      wgmma_wait<0>();
      keep(s);
      online_softmax(s, m, l, alpha, a, scale_log2, n_begin * kTile, row_lo,
                     row_hi, r0, r1, col);
      to_fragments(s, p_hi, p_lo);
      for (int it = 1; it < n_iter; ++it) {
        const int st = it % kStages, prev = (it - 1) % kStages;
        mbar_wait(bar_full(st), (it / kStages) & 1);
        keep_p(p_hi, p_lo);
        keep(o);
        turn_wait(c);
        wgmma_fence();
        issue_qk<HD>(s, q_base, base + L::kK + st * 2 * L::kMat);
        issue_pv<HD>(o, p_hi, p_lo, base + L::kV + prev * 2 * L::kMat);
        turn_pass(c);
        wgmma_wait<1>();
        keep(s);
        online_softmax(s, m, l, alpha, a, scale_log2, (n_begin + it) * kTile,
                       row_lo, row_hi, r0, r1, col);
        wgmma_wait<0>();
        keep(o);
        keep_p(p_hi, p_lo);
        mbar_arrive(bar_empty(prev));
#pragma unroll
        for (int i = 0; i < kO / 4; ++i) {
          o[4 * i] *= alpha[0];
          o[4 * i + 1] *= alpha[0];
          o[4 * i + 2] *= alpha[1];
          o[4 * i + 3] *= alpha[1];
        }
        to_fragments(s, p_hi, p_lo);
      }
      const int last = (n_iter - 1) % kStages;
      keep_p(p_hi, p_lo);
      keep(o);
      turn_wait(c);
      wgmma_fence();
      issue_pv<HD>(o, p_hi, p_lo, base + L::kV + last * 2 * L::kMat);
      if (c == 0) turn_pass(c);   // warpgroup 1's last pass would go unmatched
      wgmma_wait<0>();
      keep(o);
      keep_p(p_hi, p_lo);
      mbar_arrive(bar_empty(last));
    }

    __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(a.o) + b * a.ob +
                           head * a.oh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = h ? r1 : r0;
      if (row >= a.s) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = obase + (long long)row * a.os + col;
#pragma unroll
      for (int i = 0; i < kO / 4; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
    }
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

// cuTensorMapEncodeTiled, taken from the driver at run time so that nothing
// but the CUDA runtime is linked
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, rows, heads, HD) tensor read through its strides (in elements;
// the last dim is contiguous) in boxes of 128 rows x 64 columns of one head
// and batch row, 128-byte swizzled; rows past `rows` read as zeros.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int hd, int heads, int rows, int batch, long long sb,
                long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const Args& a, int b, int hd, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, a.q, hd, a.h, a.s, b, a.qb, a.qs, a.qh) ||
      !tensor_map(encode, &tk, a.k, hd, a.kv, a.t, b, a.kb, a.ks, a.kh) ||
      !tensor_map(encode, &tv, a.v, hd, a.kv, a.t, b, a.vb, a.vs, a.vh))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (a.s + kTile - 1) / kTile;
  if (n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  const int smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.h, b, n_qtiles);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements, for (B, S, H, hd)
// q/o and (B, T, KV, hd) k/v whose last dim is contiguous. Scores are
// scaled by `scale`: 1/sqrt(hd), or that of a smaller head_dim whose
// inputs were zero-padded to hd.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int s, int t, int h, int kv, int hd, float scale, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, int causal, int has_window, int window, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || h > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, s, t, h, kv, h / kv, qb, qs, qh, kb, ks, kh, vb, vs, vh,
         ob, os, oh, scale, causal, has_window, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch(flash_attention_kernel<64>, smem_bytes<64>(), a, b, st);
  if (dtype == 0 && hd == 128)
    return launch(flash_attention_kernel<128>, smem_bytes<128>(), a, b, st);
  if (dtype == 1 && hd == 64) return launch_wgmma<64>(a, b, hd, st);
  if (dtype == 1 && hd == 128) return launch_wgmma<128>(a, b, hd, st);
  return (int)cudaErrorInvalidValue;
}
