// Causal / sliding-window / non-causal GQA attention with an online softmax,
// for float32 or bfloat16 q, k, v, with a float32 running max, denominator
// and accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pl.pallas_call at :87).  Contract (that kernel's and
// repro_torch/kernels/ref.py::attention_ref's): q (b, sq, h, hd), k and v
// (b, sk, kvh, hd), all contiguous and of one dtype; query head kv*g + gi
// (g = h / kvh) reads kv head kv; positions are 0..s-1 on both sides, so the
// causal mask is top-left aligned when sq != sk, or the int32 arrays pos_q
// (b, sq) and pos_k (b, sk) (flash_attention_pos_launch); key j is visible
// to query i when (!causal || pos_q[i] >= pos_k[j]) && (window <= 0 ||
// pos_q[i] - pos_k[j] < window), the mask of the reference's
// models/attention.py::full_attention; scores are scaled by hd^-0.5; the
// output (b, sq, h, hd) has q's dtype.  A row that
// sees no key gets the reference's answer for that case (its softmax over
// all-masked scores is uniform): the mean of v over all sk keys.  One launch
// per call, no atomics: two calls give the same bits.
//
// Two kernels, chosen by dtype (flash_attention_launch at the end):
//
// bfloat16: flash_attention_mma_kernel, on the tensor cores.  One CTA of
// WARPS = 4 or 8 warps (16 rows each) per (batch, kv head, tile of BM = 16
// WARPS rows).  A row is a (query position, query head) pair of the kv
// head, numbered position * g + head, so a tile holds BM / g positions of
// all g heads (or, for g > BM, part of one position's heads): every K/V
// tile is read once per kv head and serves all g heads, and causality and
// the window are masked per row by its position.  Q, K and V stay bf16 in
// shared memory; K/V tiles of BN keys go through a ring of STAGES cp.async
// buffers, so the next tiles load while this one computes.  S = Q K^T and
// O += P V take bf16 operands and float32 accumulators, by one of two
// products (MmaTile<hd>::STEP, chosen per head dim on the card by
// tools/kernel_variants.py):
//   STEP 1, mma.sync.m16n8k16 (HMMA) per warp (hd 16, 32 and 112): rows
//     padded by 16 bytes so that ldmatrix (ldmatrix.trans for V, the B
//     operand of P V) reads eight rows from eight distinct bank groups (at
//     hd=112 a 240-byte row is 15 such groups, odd, so eight rows still
//     land in eight); up to hd=128 a warp keeps its Q fragments in
//     registers, above it reads them again per key tile;
//   STEP 2, wgmma.m64nNk16 (HGMMA) per warpgroup of four warps (hd 64,
//     128, 192 and 256: whole 128-byte rows, which hd=112's 224-byte rows
//     are not): Q, K and V in wgmma's 128-byte-swizzled layout; Q K^T with
//     both operands from shared memory (K-major), P V with P from
//     registers and V from shared memory (MN-major, the transpose bit); at
//     hd=256 the 64 x 256 float32 accumulator is 128 registers per thread,
//     at hd=192 96.
// After the online-softmax update (the row max and sum joined across the
// four lanes of a quad by shuffles; p = 2^(s * scale * log2 e - max) by one
// fma and one ex2; the accumulator's rescale skipped when no row of the warp
// moved its max) each warp repacks its S accumulator into bf16 A fragments
// of P in registers, as FlashAttention-2 does: P is rounded to bf16 before
// the P V product (the denominator sums the float32 p).  Tiles wholly past
// the causal diagonal of the tile's last row, and wholly before the window
// of its first row, are never loaded; the CTAs with the most key tiles are
// launched first.  The output is staged through shared memory and written
// in 16-byte rows.
//
// Explicit positions (decode over a ring-buffer cache, packed or offset
// prompts): a position array says nothing about which key tiles a row can
// see, so both kernels then visit every key tile and mask every score by
// the two positions; pos_k is read through the read-only cache.  A decode
// step (sq = 1) fills only g rows of a tile's BM; the rest are padding,
// whose position is read clamped to the last row and which are never
// written.
//
// float32: flash_attention_kernel, on the CUDA cores (TF32 tensor cores
// cannot hold the float32 tolerance of 2e-5), for the CPU-size float32
// cross-checks only.  One CTA per (batch, kv head, q tile) packed as above;
// up to hd=128 a query row belongs to one thread (ROWS = 128 threads); at
// hd 192 and 256 SPLIT = 4 threads of one warp share a row, 48 or 64 dims
// each, joining their partial dot products with __shfl_xor_sync (a
// butterfly, so all four hold the same sum bitwise); K/V tiles of BK keys
// are staged in shared memory and read back as broadcasts.  All products are fmaf(); the build's
// -fmad=false leaves the other arithmetic uncontracted.
//
// Bound: for TinyLlama-1.1B's prefill shape (b=4, sq=sk=1024, h=32, kvh=4,
// hd=64, bf16) the causal half of QK^T and PV is 2*b*h*sq*sk*hd = 17.2 GFLOP
// and the function must move 37.7 MB (q, k, v read once, o written once), so
// at 989 TFLOP/s bf16 (tensor cores, with wgmma) and 3.35 TB/s it is
// compute-bound at ~0.017 ms; at recurrentgemma-9b's (b=4, s=1024, h=16,
// kvh=1, hd=256) it is 34.4 GFLOP, ~0.035 ms.  Each K/V tile waits for its
// products and each product for the softmax (no warp specialisation, no
// TMA), so the kernel reaches a part of that rate; the times on an NVIDIA
// H100 are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// FLASH_PART: kernels/build.py compiles this file as two objects in
// parallel, the forward's kernels and entry points (0) and the backward's
// (1), and links them into one library; unset, one object holds both.
#if !defined(FLASH_PART) || FLASH_PART == 0
#define FLASH_FORWARD 1
#else
#define FLASH_FORWARD 0
#endif
#if !defined(FLASH_PART) || FLASH_PART == 1
#define FLASH_BACKWARD 1
#else
#define FLASH_BACKWARD 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- float32

constexpr int BK = 32;  // keys per K/V tile

// Threads per query row, threads per CTA and query rows per CTA of a head dim.
template <int HD>
struct Tile {
  static constexpr int SPLIT = HD > 128 ? 4 : 1;
  static constexpr int THREADS = HD > 128 ? 256 : 128;
  static constexpr int ROWS = THREADS / SPLIT;
  static constexpr int DH = HD / SPLIT;  // dims per thread
  static_assert(DH % 4 == 0, "a thread's dims are whole float4 chunks");
};

template <int HD>
constexpr int smem_bytes() {
  return (Tile<HD>::ROWS * (HD + 1) + 2 * BK * HD) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse,
                           const int* __restrict__ pos_q,
                           const int* __restrict__ pos_k, int sq, int sk,
                           int h, int kvh, int bq, int causal, int window,
                           float scale) {
  constexpr int THREADS = Tile<HD>::THREADS;
  constexpr int SPLIT = Tile<HD>::SPLIT;
  constexpr int ROWS = Tile<HD>::ROWS;
  constexpr int DH = Tile<HD>::DH;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [ROWS][HD + 1]
  float* ks = qs + ROWS * (HD + 1);             // [BK][HD]
  float* vs = ks + BK * HD;                     // [BK][HD]
  __shared__ int kps[BK];                       // the K/V tile's positions

  const int g = h / kvh;
  const int kv = blockIdx.y;
  const int bi = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, sq - q0);  // query positions in this tile
  const int tid = threadIdx.x;

  // q tile: for each position the g heads of this kv head are contiguous
  const int row_elems = g * HD;
  for (int e = tid; e < nq * row_elems; e += THREADS) {
    const int qi = e / row_elems;
    const int rest = e - qi * row_elems;  // gi * HD + d
    const size_t src = (((size_t)bi * sq + q0 + qi) * h + kv * g) * HD + rest;
    qs[(qi * g + rest / HD) * (HD + 1) + rest % HD] = q[src];
  }
  __syncthreads();

  // the SPLIT threads of a row sit 32 / SPLIT lanes apart in one warp
  constexpr int WROWS = 32 / SPLIT;  // rows per warp
  const int lane = tid & 31;
  const int row = (tid >> 5) * WROWS + lane % WROWS;
  const int part = lane / WROWS;  // which float4 chunks of the row
  const int qi = row / g;
  const int gi = row - qi * g;
  const bool active = qi < nq;
  const int qpos = pos_q == nullptr ? q0 + qi
                   : active ? pos_q[(size_t)bi * sq + q0 + qi]
                            : 0;

  // dims 4*(c*SPLIT + part) .. +3 of the row are this thread's chunk c
  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * SPLIT + part) + i;
      qr[4 * c + i] = active ? qs[row * (HD + 1) + d] : 0.f;
      acc[4 * c + i] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys any row of this tile can see (every key with explicit positions)
  const int q_last = q0 + nq - 1;
  int lo = window > 0 && pos_k == nullptr ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;
  const int hi = causal && pos_k == nullptr ? min(sk, q_last + 1) : sk;

  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int nk = min(BK, hi - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const size_t src =
            (((size_t)bi * sk + k0 + j) * kvh + kv) * HD + (e - j * HD);
        kx = k[src];
        vx = v[src];
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    for (int j = tid; j < BK; j += THREADS)
      kps[j] = j >= nk ? 0 : pos_k == nullptr ? k0 + j
                                              : pos_k[(size_t)bi * sk + k0 + j];
    __syncthreads();
    // with SPLIT > 1 every lane of the warp takes part in the shuffles, so
    // rows past the tile compute (and discard) their scores too
    if (SPLIT == 1 && !active) continue;

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = ks4[j * (HD / 4) + c * SPLIT + part];
        dot = fmaf(qr[4 * c + 0], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        dot = dot + __shfl_xor_sync(0xffffffffu, dot, off * WROWS);
      const int kpos = kps[j];
      const bool ok = j < nk && (!causal || qpos >= kpos) &&
                      (window <= 0 || qpos - kpos < window);
      s[j] = ok ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (!active || tmax == -INFINITY) continue;  // nothing visible here

    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 vv = vs4[j * (HD / 4) + c * SPLIT + part];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  if (lse != nullptr && part == 0)
    lse[((size_t)bi * h + kv * g + gi) * sq + q0 + qi] =
        l > 0.f ? m + logf(l) : INFINITY;
  float* dst = o + (((size_t)bi * sq + q0 + qi) * h + kv * g + gi) * HD;
  if (l > 0.f) {
#pragma unroll
    for (int c = 0; c < DH / 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[4 * (c * SPLIT + part) + i] = acc[4 * c + i] / l;
    return;
  }
  // no visible key: uniform weights over all sk keys, as the reference
  for (int c = 0; c < DH / 4; ++c) {
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * SPLIT + part) + i;
      float sum = 0.f;
      for (int j = 0; j < sk; ++j)
        sum += v[(((size_t)bi * sk + j) * kvh + kv) * HD + d];
      dst[d] = sk > 0 ? sum / (float)sk : 0.f;
    }
  }
}

// --------------------------------------------------------------- bfloat16

// Warps per CTA (16 rows each; a warpgroup of four runs a wgmma over its
// 64 rows), keys per K/V tile, cp.async ring depth, and the products of a
// head dim: STEP 1 is mma.sync, STEP 2 wgmma (head dims that are whole
// 128-byte rows).  The values are the fastest of tools/kernel_variants.py's
// sweeps at the serving shapes on an H100 (hd 64/128/256: `flash`; hd 112
// and 192, kimi-k2's and nemotron-4's heads: `all wide`, PERF.md).
template <int HD>
struct MmaTile;
template <>
struct MmaTile<16> {
  static constexpr int WARPS = 4, BN = 64, STAGES = 2, STEP = 1;
};
template <>
struct MmaTile<32> {
  static constexpr int WARPS = 4, BN = 64, STAGES = 2, STEP = 1;
};
template <>
struct MmaTile<64> {
  static constexpr int WARPS = 4, BN = 64, STAGES = 2, STEP = 2;
};
template <>
struct MmaTile<112> {
  static constexpr int WARPS = 4, BN = 32, STAGES = 2, STEP = 1;
};
template <>
struct MmaTile<128> {
  static constexpr int WARPS = 8, BN = 128, STAGES = 2, STEP = 2;
};
template <>
struct MmaTile<192> {
  static constexpr int WARPS = 8, BN = 64, STAGES = 3, STEP = 2;
};
template <>
struct MmaTile<256> {
  static constexpr int WARPS = 8, BN = 64, STAGES = 2, STEP = 2;
};

// Shared-memory layout of a [ROWS x HD] bf16 operand, in elements.
// STEP 1: rows padded by 16 bytes, so the eight rows an ldmatrix reads at
// one column sit in eight distinct 16-byte bank groups.  STEP 2: wgmma's
// 128-byte-swizzled canonical layout: the operand is cut into HD / 64
// column blocks of ROWS rows of 128 bytes, and the 16-byte chunk c of row r
// is stored at chunk c ^ (r % 8) of its row.
template <int HD, int STEP>
struct Layout {
  template <int ROWS>
  __host__ __device__ static constexpr int size() {
    return STEP == 1 ? ROWS * (HD + 8) : ROWS * HD;
  }
  // element offset of the 16-byte chunk c (elements 8c .. 8c+7) of row r
  template <int ROWS>
  static __device__ __forceinline__ int chunk(int r, int c) {
    if constexpr (STEP == 1)
      return r * (HD + 8) + c * 8;
    else
      return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
  }
};

template <int HD>
constexpr int mma_smem_bytes() {
  constexpr int STEP = MmaTile<HD>::STEP;
  constexpr int ROWS =
      16 * MmaTile<HD>::WARPS + 2 * MmaTile<HD>::STAGES * MmaTile<HD>::BN;
  // STEP 2 aligns the base to a 1024-byte swizzle atom itself
  return (STEP == 1 ? ROWS * (HD + 8) : ROWS * HD + 512) * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
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

// Orders the compiler's later uses of wgmma accumulators after the
// wait_group that completes them (the wgmma writes them asynchronously)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// makes this thread's completed cp.async writes to shared memory visible to
// wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (>> 4), layout type 1 (128B)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

// wgmma.m64nNk16, bf16 in, f32 accumulators d[N / 8][4] in the layout of
// mma.m16n8's C per warp (warp w holds rows 16w .. 16w+15).  wgmma_ss:
// A and B from shared memory, both K-major; D = A B, or D += A B when
// accumulate.  wgmma_rs: A from registers (mma.m16n8k16's A fragment per
// warp), B from shared memory MN-major (transposed); D += A B.

__device__ __forceinline__ void wgmma_ss(float (&d)[4][4],
                                         uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4],
                                         uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4],
                                         uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
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
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * grp + t:
//   A a0 (row grp, cols 2t..2t+1), a1 (row grp+8, same cols), a2 (row grp,
//     cols 2t+8..), a3 (row grp+8, cols 2t+8..);
//   B b0 (k 2t..2t+1, col grp), b1 (k 2t+8.., col grp);
//   C c0 c1 (row grp, cols 2t, 2t+1), c2 c3 (row grp+8, same cols).
// So the thread holds rows grp and grp+8 of its warp's 16, and the score
// of S's n-block nb at keys 8 nb + 2t (+1) is s[nb][0..1] (row grp) and
// s[nb][2..3] (row grp+8); the A fragment of P for keys 16 kb.. 16 kb+15
// is {s[2kb][0..1], s[2kb][2..3], s[2kb+1][0..1], s[2kb+1][2..3]}.  wgmma's
// accumulators and register A operand have the same layout per warp.
template <int HD>
__global__ void __launch_bounds__(32 * MmaTile<HD>::WARPS)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o,
                               float* __restrict__ lse,
                               const int* __restrict__ pos_q,
                               const int* __restrict__ pos_k, int sq, int sk,
                               int h, int kvh, int causal, int window,
                               float scale_log2) {
  constexpr int BM = 16 * MmaTile<HD>::WARPS;  // rows per CTA
  constexpr int THREADS = 32 * MmaTile<HD>::WARPS;
  constexpr int BN = MmaTile<HD>::BN;
  constexpr int STAGES = MmaTile<HD>::STAGES;
  constexpr int STEP = MmaTile<HD>::STEP;
  using L = Layout<HD, STEP>;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr bool Q_IN_REGS = STEP == 1 && HD <= 128;
  static_assert(BN % 16 == 0 && HD % 16 == 0, "whole mma tiles");
  static_assert(STEP == 1 || (HD % 64 == 0 && BN % 32 == 0 && BM % 64 == 0),
                "wgmma operands are whole 128-byte rows and warpgroups");
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  if constexpr (STEP == 2)  // swizzle atoms start at 1024-byte boundaries
    qs += ((1024 - (smem_u32(qs) & 1023)) & 1023) / sizeof(bf16);
  bf16* ks = qs + L::template size<BM>();            // [STAGES] K tiles
  bf16* vs = ks + STAGES * L::template size<BN>();   // [STAGES] V tiles

  const int g = h / kvh;
  // one CTA per (row tile, batch, kv head), the row tile slowest and
  // counted down, so the CTAs with the most key tiles start first
  const int rows = sq * g;  // (position, head) rows of this kv head
  const int tiles = (rows + BM - 1) / BM;
  const int per_tile = gridDim.x / tiles;  // b * kvh
  const int kv = blockIdx.x % kvh;
  const int bi = (blockIdx.x % per_tile) / kvh;
  const int r0 = (tiles - 1 - (int)(blockIdx.x / per_tile)) * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Q tile, row r0 + r = position * g + head
  for (int c = tid; c < BM * CH; c += THREADS) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int R = r0 + r;
    const bool ok = R < rows;
    const int pos = ok ? R / g : 0;
    const int gi = ok ? R - pos * g : 0;
    cp_async16(smem_u32(qs + L::template chunk<BM>(r, ch)),
               q + (((size_t)bi * sq + pos) * h + kv * g + gi) * HD + ch * 8,
               ok);
  }

  // keys any row of this tile can see (every key with explicit positions)
  const bool explicit_pos = pos_k != nullptr;
  const int pos_first = r0 / g;
  const int pos_last = (min(r0 + BM, rows) - 1) / g;
  int lo = window > 0 && !explicit_pos ? max(0, pos_first - window + 1) : 0;
  lo = lo / BN * BN;
  const int hi = causal && !explicit_pos ? min(sk, pos_last + 1) : sk;
  const int ntiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  auto load_kv = [&](int t) {
    const int k0 = lo + t * BN;
    bf16* kd = ks + (t % STAGES) * L::template size<BN>();
    bf16* vd = vs + (t % STAGES) * L::template size<BN>();
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int j = c / CH;
      const int ch = c - j * CH;
      const bool ok = k0 + j < sk;  // zeros past the end: P V stays finite
      const size_t off =
          (((size_t)bi * sk + (ok ? k0 + j : 0)) * kvh + kv) * HD + ch * 8;
      const int at = L::template chunk<BN>(j, ch);
      cp_async16(smem_u32(kd + at), k + off, ok);
      cp_async16(smem_u32(vd + at), v + off, ok);
    }
  };

  // group 0 holds Q and K/V tile 0; group t holds tile t
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  const int grp = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  int pos_row[2];            // positions of the thread's rows grp, grp + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = r0 + wr + grp + 8 * i;
    pos_row[i] = explicit_pos
                     ? __ldg(pos_q + (size_t)bi * sq + min(R, rows - 1) / g)
                     : R / g;
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int db = 0; db < HD / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[db][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // mask tile t's scores, online softmax: m is the row max of the raw
  // scores, and p = 2^(s * scale_log2 - m * scale_log2) is one fma and one
  // ex2; leaves p in s and rescales l and O
  auto softmax = [&](float (&s)[BN / 8][4], int t) {
    const int k0 = lo + t * BN;
    if (explicit_pos || !(k0 + BN <= sk &&
                          (!causal || k0 + BN - 1 <= pos_first) &&
                          (window <= 0 || pos_last - k0 < window))) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        int kpos[2];  // positions of keys 2 t4 and 2 t4 + 1 of n-block nb
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + nb * 8 + 2 * t4 + c;
          kpos[c] = !explicit_pos || key >= sk
                        ? key
                        : __ldg(pos_k + (size_t)bi * sk + key);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nb * 8 + 2 * t4 + (e & 1);
          const int kp = kpos[e & 1];
          const int pos = pos_row[e >> 1];
          if (!(key < sk && (!causal || kp <= pos) &&
                (window <= 0 || pos - kp < window)))
            s[nb][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    float corr[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // nothing seen yet: base 0, so masked p and corr are 2^-inf = 0
      base[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      corr[i] = ex2(__fmaf_rn(m[i], scale_log2, -base[i]));
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(__fmaf_rn(s[nb][e], scale_log2, -base[e >> 1]));
        s[nb][e] = p;
        l[e >> 1] += p;
      }
    }
    // the row max rarely moves once many keys are seen: skip the rescale
    // when it moved in no row of the warp
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int db = 0; db < HD / 8; ++db) {
        oacc[db][0] *= corr[0];
        oacc[db][1] *= corr[0];
        oacc[db][2] *= corr[1];
        oacc[db][3] *= corr[1];
      }
    }
  };

  // P in bf16 from the S accumulator: the A fragments of P V
  auto pack_p = [](const float (&s)[BN / 8][4], uint32_t (&pf)[BN / 16][4]) {
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      pf[kb][0] = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
      pf[kb][1] = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
      pf[kb][2] = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
      pf[kb][3] = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
    }
  };

  if constexpr (STEP == 1) {
    // ldmatrix row addresses: A of Q (rows lane & 15, cols (lane >> 4) * 8);
    // B of K^T (keys (lane & 7) + (lane >> 4) * 8, dims ((lane >> 3) & 1) *
    // 8), two n-blocks per x4; B of V with .trans (keys (lane & 7) +
    // ((lane >> 3) & 1) * 8, dims (lane >> 4) * 8), two d-blocks per x4
    const uint32_t q_addr =
        smem_u32(qs + (wr + (lane & 15)) * (HD + 8) + (lane >> 4) * 8);
    const int k_off =
        ((lane & 7) + ((lane >> 4) << 3)) * (HD + 8) + ((lane >> 3) & 1) * 8;
    const int v_off =
        ((lane & 7) + (((lane >> 3) & 1) << 3)) * (HD + 8) + (lane >> 4) * 8;
    uint32_t qf[Q_IN_REGS ? HD / 16 : 1][4];
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile t is in; every warp is done with tile t - 1
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      cp_async_commit();
      if (Q_IN_REGS && t == 0) {
#pragma unroll
        for (int kk = 0; kk < (Q_IN_REGS ? HD / 16 : 1); ++kk)
          ldsm_x4(qf[kk], q_addr + kk * 32);
      }
      const int slot = t % STAGES;
      const uint32_t k_base = smem_u32(ks + slot * L::template size<BN>() +
                                       k_off);
      const uint32_t v_base = smem_u32(vs + slot * L::template size<BN>() +
                                       v_off);

      // S = Q K^T
      float s[BN / 8][4];
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        if (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[Q_IN_REGS ? kk : 0][e];
        } else {
          ldsm_x4(a, q_addr + kk * 32);
        }
#pragma unroll
        for (int nb = 0; nb < BN / 8; nb += 2) {
          uint32_t b[4];
          ldsm_x4(b, k_base + (nb * 8 * (HD + 8) + kk * 16) * 2);
          mma_bf16(s[nb], a, b[0], b[1]);
          mma_bf16(s[nb + 1], a, b[2], b[3]);
        }
      }
      softmax(s, t);

      // O += P V
      uint32_t pf[BN / 16][4];
      pack_p(s, pf);
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
#pragma unroll
        for (int db = 0; db < HD / 8; db += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_base + (kb * 16 * (HD + 8) + db * 8) * 2);
          mma_bf16(oacc[db], pf[kb], b[0], b[1]);
          mma_bf16(oacc[db + 1], pf[kb], b[2], b[3]);
        }
      }
    }
  } else {
    // the warpgroup's 64 rows of Q (BM x HD) and K (BN x HD), K-major: a
    // k-step of 16 dims is 32 bytes into a 128-byte row, 8-row groups 1024
    // bytes apart; V (BN x HD) MN-major: 16 keys are 2048 bytes, 8-key
    // groups 1024 bytes apart, 64-dim column blocks BN * 128 bytes apart
    const uint32_t qa = smem_u32(qs) + (warp >> 2) * 64 * 128;
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();  // tile t is in; every warp is done with tile t - 1
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      cp_async_commit();
      const uint32_t ka = smem_u32(ks + (t % STAGES) * L::template size<BN>());
      const uint32_t va = smem_u32(vs + (t % STAGES) * L::template size<BN>());

      float s[BN / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s, wgmma_desc(qa + (kk >> 2) * BM * 128 + (kk & 3) * 32,
                               16, 1024),
                 wgmma_desc(ka + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16,
                            1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      softmax(s, t);

      uint32_t pf[BN / 16][4];
      pack_p(s, pf);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb)
        wgmma_rs(oacc, pf[kb], wgmma_desc(va + kb * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(oacc);
    }
  }
  cp_async_wait<0>();

  // epilogue: O / l in bf16 into the warp's own rows of the Q buffer, then
  // 16-byte rows to device memory
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wr + grp + 8 * i;
    const int R = r0 + r;
    if (lse != nullptr && t4 == 0 && R < rows)
      lse[((size_t)bi * h + kv * g + R % g) * sq + R / g] =
          l[i] > 0.f ? m[i] * (scale_log2 * 0.6931471805599453f) + logf(l[i])
                     : INFINITY;
    if (l[i] > 0.f) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int db = 0; db < HD / 8; ++db)
        *reinterpret_cast<uint32_t*>(qs + L::template chunk<BM>(r, db) +
                                     2 * t4) =
            pack_bf16(oacc[db][2 * i] * inv, oacc[db][2 * i + 1] * inv);
    } else if (R < rows) {
      // no visible key: uniform weights over all sk keys, as the reference
      for (int db = 0; db < HD / 8; ++db) {
        float sum0 = 0.f, sum1 = 0.f;
        for (int j = 0; j < sk; ++j) {
          const bf16* vr =
              v + (((size_t)bi * sk + j) * kvh + kv) * HD + db * 8 + 2 * t4;
          sum0 += __bfloat162float(vr[0]);
          sum1 += __bfloat162float(vr[1]);
        }
        const float inv = sk > 0 ? 1.f / (float)sk : 0.f;
        *reinterpret_cast<uint32_t*>(qs + L::template chunk<BM>(r, db) +
                                     2 * t4) =
            pack_bf16(sum0 * inv, sum1 * inv);
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = wr + c / CH;
    const int ch = c % CH;
    const int R = r0 + r;
    if (R >= rows) continue;
    const int pos = R / g;
    const int gi = R - pos * g;
    *reinterpret_cast<uint4*>(
        o + (((size_t)bi * sq + pos) * h + kv * g + gi) * HD + ch * 8) =
        *reinterpret_cast<const uint4*>(qs + L::template chunk<BM>(r, ch));
  }
}

// --------------------------------------------------------------- backward
//
// The gradient of the function above: with P = exp(S * scale - lse)
// recomputed from the forward's logsumexp and D = rowsum(dO o), dV = P^T
// dO, dP = dO V^T, dS = P (dP - D), dQ = scale dS K and dK = scale dS^T Q,
// where a masked score has P = 0 and a row that sees no key (lse = +inf)
// has P = 1 / sk on every key and dS = 0, the gradient of the reference's
// uniform softmax over its all-masked row.  Two launches, no atomics, so
// two calls give the same bits; the first writes D into dsum, the second
// reads it.  Rows are numbered position * g + head, as in the forward.
//
// bfloat16: two tiled kernels on the tensor cores (mma.sync.m16n8k16 with
// ldmatrix from 16-byte-padded shared memory, the forward's STEP 1), bf16
// operands and float32 accumulators.  P and dS are rounded to bf16 as the
// operands of their products, as FlashAttention-2 does.  S and dP are
// formed in both kernels: seven products against the minimal five, the
// price of dQ without atomics.
//   1. flash_bwd_dq_mma_kernel: one CTA of QWARPS warps (16 rows each) per
//      (batch, kv head, tile of rows), the tiles with the most keys first.
//      Q and dO stay in shared memory; K/V tiles of QN keys go through a
//      two-stage cp.async ring, as in the forward, over the keys the rows
//      can see.  Per tile each warp forms S = Q K^T and dP = dO V^T, then
//      dS in registers, repacked into bf16 A fragments, and dQ += dS K
//      (K read with ldmatrix.trans).
//   2. flash_bwd_dkv_mma_kernel: one CTA of KWARPS warps per (batch, kv
//      head, tile of BN keys), key tile 0 (the most rows, when causal)
//      first.  K and V stay in shared memory; the rows that can see a key
//      of the tile go through a two-stage ring of BM-row tiles (Q, dO and
//      each row's lse, D and position), in order, so dK and dV sum the g
//      heads of the kv head in one fixed order.  Warp w takes keys 16 (w %
//      KW) .. +15 (KW = BN / 16); for each row tile it forms S^T = K Q^T and
//      dP^T = V dO^T over its share of the rows, writes P^T and dS^T in bf16
//      to shared memory, and after a barrier adds P^T dO and dS^T Q into
//      its share of the head dim's dV and dK accumulators (dims split over
//      the warps of a key group, so hd=256 fits in registers).
// Tiles wholly outside the causal diagonal or the window are skipped (the
// forward's lo / hi bounds for the keys, rlo / rhi for the rows); with
// explicit positions every tile is visited and every score masked.
// Bound: the five products over the visible pairs at the bf16 tensor-core
// rate, or q, k, v, o, dO and lse read and dq, dk, dv written once; at
// TinyLlama-1.1B's training shape (b=8, s=256, 32/4 heads, hd=64) the
// bytes, 0.0114 ms on an H100.  No warp specialisation, TMA or wgmma yet;
// the times are in PERF.md.
//
// float32: flash_bwd_dq_kernel and flash_bwd_dkv_kernel, on the CUDA cores,
// for the CPU-size float32 cross-checks (the float32 forward's reasons): a
// row or key is SPLIT threads of DH dims each, whose partial dot products
// join by an xor butterfly (every lane ends with the same bits); K/V or
// Q/dO tiles staged in shared memory; the same launches and order.

// the largest power of two not above x
constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }

template <int HD>
struct BwdTile {
  // lanes per row: a power of two (row_sum's butterfly), 16 dims each at
  // hd 16/32/64/128/256, 28 at hd=112 (4 lanes), 24 at hd=192 (8 lanes)
  static constexpr int SPLIT = pow2_floor(HD / 16);
  static constexpr int DH = HD / SPLIT;  // dims per thread
  static constexpr int THREADS = HD >= 128 ? 256 : 128;
  static constexpr int ROWS = THREADS / SPLIT;  // rows or keys per CTA
  static constexpr int BT = 4096 / HD;  // keys or rows per staged tile
  static_assert(HD % SPLIT == 0 && DH % 4 == 0 && SPLIT <= 32,
                "a row is whole lanes of a warp, each whole float4 chunks");
};

template <int HD>
constexpr int bwd_smem_bytes() {
  return 2 * BwdTile<HD>::BT * HD * (int)sizeof(float);
}

// the sum over the SPLIT lanes of a row (consecutive lanes), in every lane
template <int SPLIT>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1)
    x = x + __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

template <int HD>
__global__ void __launch_bounds__(BwdTile<HD>::THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum, float* __restrict__ dq,
                        const int* __restrict__ pos_q,
                        const int* __restrict__ pos_k, int sq, int sk, int h,
                        int kvh, int causal, int window, float scale) {
  constexpr int DH = BwdTile<HD>::DH;
  constexpr int SPLIT = BwdTile<HD>::SPLIT;
  constexpr int ROWS = BwdTile<HD>::ROWS;
  constexpr int THREADS = BwdTile<HD>::THREADS;
  constexpr int BK = BwdTile<HD>::BT;
  extern __shared__ float4 bwd_smem4[];
  float* ks = reinterpret_cast<float*>(bwd_smem4);  // [BK][HD]
  float* vs = ks + BK * HD;                         // [BK][HD]
  __shared__ int kps[BK];

  const int g = h / kvh;
  const int kv = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = sq * g;
  const int R0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int R = R0 + tid / SPLIT;
  const int part = tid % SPLIT;
  const bool active = R < rows;
  const int pos = active ? R / g : 0;
  const int head = kv * g + (active ? R % g : 0);
  const int qpos = pos_q == nullptr ? pos : pos_q[(size_t)bi * sq + pos];
  const size_t qoff = (((size_t)bi * sq + pos) * h + head) * HD + part * DH;

  float qr[DH], dor[DH], acc[DH];
  float dpart = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? q[qoff + d] : 0.f;
    dor[d] = active ? dout[qoff + d] : 0.f;
    dpart = __fmaf_rn(dor[d], active ? o[qoff + d] : 0.f, dpart);
    acc[d] = 0.f;
  }
  const float D = row_sum<SPLIT>(dpart);
  const size_t lidx = ((size_t)bi * h + head) * sq + pos;
  const float L = active ? lse[lidx] : INFINITY;
  const bool live = active && L != INFINITY;
  if (active && part == 0) dsum[lidx] = D;

  // keys any row of this tile can see (every key with explicit positions)
  const int pos_first = R0 / g;
  const int pos_last = (min(R0 + ROWS, rows) - 1) / g;
  int lo = window > 0 && pos_k == nullptr ? max(0, pos_first - window + 1) : 0;
  lo = lo / BK * BK;
  const int hi = causal && pos_k == nullptr ? min(sk, pos_last + 1) : sk;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int nk = min(BK, hi - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < nk * HD; e += THREADS) {
      const int j = e / HD;
      const size_t src =
          (((size_t)bi * sk + k0 + j) * kvh + kv) * HD + (e - j * HD);
      ks[e] = k[src];
      vs[e] = v[src];
    }
    for (int j = tid; j < nk; j += THREADS)
      kps[j] = pos_k == nullptr ? k0 + j : pos_k[(size_t)bi * sk + k0 + j];
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kr = ks + j * HD + part * DH;
      const float* vr = vs + j * HD + part * DH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = __fmaf_rn(qr[d], kr[d], s);
        dp = __fmaf_rn(dor[d], vr[d], dp);
      }
      s = row_sum<SPLIT>(s);
      dp = row_sum<SPLIT>(dp);
      if (!live || !visible(qpos, kps[j], causal, window)) continue;
      const float p = expf(s * scale - L);
      const float ds = p * (dp - D);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = __fmaf_rn(ds, kr[d], acc[d]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[qoff + d] = acc[d] * scale;
}

template <int HD>
__global__ void __launch_bounds__(BwdTile<HD>::THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ pos_q,
                         const int* __restrict__ pos_k, int sq, int sk,
                         int h, int kvh, int causal, int window,
                         float scale) {
  constexpr int DH = BwdTile<HD>::DH;
  constexpr int SPLIT = BwdTile<HD>::SPLIT;
  constexpr int ROWS = BwdTile<HD>::ROWS;
  constexpr int THREADS = BwdTile<HD>::THREADS;
  constexpr int BQ = BwdTile<HD>::BT;
  extern __shared__ float4 bwd_smem4[];
  float* qs = reinterpret_cast<float*>(bwd_smem4);  // [BQ][HD]
  float* dos = qs + BQ * HD;                        // [BQ][HD]
  __shared__ float ls[BQ], ds_[BQ];
  __shared__ int qps[BQ];

  const int g = h / kvh;
  const int kv = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = sq * g;
  const int k0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int key = k0 + tid / SPLIT;
  const int part = tid % SPLIT;
  const bool active = key < sk;
  const int kpos = !active ? 0 : pos_k == nullptr
                                     ? key
                                     : pos_k[(size_t)bi * sk + key];
  const size_t koff = (((size_t)bi * sk + (active ? key : 0)) * kvh + kv) *
                          HD + part * DH;
  const float inv_sk = 1.f / (float)sk;

  float kr[DH], vr[DH], dka[DH], dva[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = active ? k[koff + d] : 0.f;
    vr[d] = active ? v[koff + d] : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // rows that can see a key of this tile (every row with explicit
  // positions); rows past sk + window - 1 see no key at all and still give
  // every key its uniform share of dV
  const int key_last = min(k0 + ROWS, sk) - 1;
  int rlo = 0, rhi = rows;
  if (pos_k == nullptr) {
    if (causal) rlo = min(rows, k0 * g);
    if (window > 0 && sq - 1 < sk + window - 1)
      rhi = min(rows, (key_last + window) * g);
  }

  for (int r0 = rlo; r0 < rhi; r0 += BQ) {
    const int nr = min(BQ, rhi - r0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < nr * HD; e += THREADS) {
      const int r = e / HD;
      const int R = r0 + r;
      const int pos = R / g;
      const size_t src =
          (((size_t)bi * sq + pos) * h + kv * g + (R - pos * g)) * HD +
          (e - r * HD);
      qs[e] = q[src];
      dos[e] = dout[src];
    }
    for (int r = tid; r < nr; r += THREADS) {
      const int R = r0 + r;
      const int pos = R / g;
      const size_t lidx = ((size_t)bi * h + kv * g + (R - pos * g)) * sq + pos;
      ls[r] = lse[lidx];
      ds_[r] = dsum[lidx];
      qps[r] = pos_q == nullptr ? pos : pos_q[(size_t)bi * sq + pos];
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* qrow = qs + r * HD + part * DH;
      const float* drow = dos + r * HD + part * DH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = __fmaf_rn(qrow[d], kr[d], s);
        dp = __fmaf_rn(drow[d], vr[d], dp);
      }
      s = row_sum<SPLIT>(s);
      dp = row_sum<SPLIT>(dp);
      if (!active) continue;
      const float L = ls[r];
      if (L == INFINITY) {  // a row that sees no key: uniform, dS = 0
#pragma unroll
        for (int d = 0; d < DH; ++d)
          dva[d] = __fmaf_rn(inv_sk, drow[d], dva[d]);
        continue;
      }
      if (!visible(qps[r], kpos, causal, window)) continue;
      const float p = expf(s * scale - L);
      const float dsc = p * (dp - ds_[r]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dva[d] = __fmaf_rn(p, drow[d], dva[d]);
        dka[d] = __fmaf_rn(dsc, qrow[d], dka[d]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[koff + d] = dka[d] * scale;
    dv[koff + d] = dva[d];
  }
}

// The bfloat16 kernels' tiles per head dim: QWARPS warps of 16 rows per dQ
// CTA over K/V tiles of QN keys; KWARPS warps per dK/dV CTA of BN keys over
// row tiles of BM rows.  At hd 64, 112, 128 and 192 the fastest of a sweep
// of text variants at the training shapes on an H100 (hd=128's dK/dV
// kernel spills a few bytes and is still the fastest).  hd=112's dK/dV
// keeps the whole head dim in one warp (112 / 16 = 7 d-blocks of 16 admit
// no split into warps), 254 registers; hd=192's splits it over two.
template <int HD>
struct BwdMma;
template <>
struct BwdMma<16> {
  static constexpr int QWARPS = 4, QN = 64, KWARPS = 4, BN = 64, BM = 64;
};
template <>
struct BwdMma<32> {
  static constexpr int QWARPS = 4, QN = 64, KWARPS = 4, BN = 64, BM = 64;
};
template <>
struct BwdMma<64> {
  static constexpr int QWARPS = 4, QN = 32, KWARPS = 8, BN = 64, BM = 64;
};
template <>
struct BwdMma<112> {
  static constexpr int QWARPS = 4, QN = 32, KWARPS = 4, BN = 64, BM = 64;
};
template <>
struct BwdMma<128> {
  static constexpr int QWARPS = 4, QN = 32, KWARPS = 16, BN = 128, BM = 64;
};
template <>
struct BwdMma<192> {
  static constexpr int QWARPS = 8, QN = 32, KWARPS = 8, BN = 64, BM = 64;
};
template <>
struct BwdMma<256> {
  static constexpr int QWARPS = 4, QN = 32, KWARPS = 8, BN = 32, BM = 64;
};

template <int HD>
constexpr int bwd_dq_smem_bytes() {
  return (2 * 16 * BwdMma<HD>::QWARPS + 4 * BwdMma<HD>::QN) * (HD + 8) *
         (int)sizeof(bf16);
}

template <int HD>
constexpr int bwd_dkv_smem_bytes() {
  constexpr int BN = BwdMma<HD>::BN, BM = BwdMma<HD>::BM;
  return (2 * BN + 4 * BM) * (HD + 8) * (int)sizeof(bf16) +
         2 * BN * (BM + 8) * (int)sizeof(bf16) + 2 * 3 * BM * 4;
}

// ldmatrix addresses in a row-major bf16 matrix of LD elements per row:
// the A fragment (16 x 16) at (row0, k0); the B fragments of the two n8
// blocks n0 .. n0+15 at k0 from a matrix stored [n][k] (ldmatrix, as K in
// the forward's S = Q K^T) or from one stored [k][n] (ldmatrix.trans, as V
// in its P V): x4 registers 0, 1 are the first block's b0, b1, 2, 3 the
// second's.
template <int LD>
__device__ __forceinline__ uint32_t a_frag(const bf16* m, int row0, int k0,
                                           int lane) {
  return smem_u32(m + (row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t b_frag(const bf16* m, int n0, int k0,
                                           int lane) {
  return smem_u32(m + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                  ((lane >> 3) & 1) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bt_frag(const bf16* m, int k0, int n0,
                                            int lane) {
  return smem_u32(m + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                  n0 + (lane >> 4) * 8);
}

constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__global__ void __launch_bounds__(32 * BwdMma<HD>::QWARPS)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum, bf16* __restrict__ dq,
                            const int* __restrict__ pos_q,
                            const int* __restrict__ pos_k, int sq, int sk,
                            int h, int kvh, int causal, int window,
                            float scale_log2, float scale) {
  constexpr int BM = 16 * BwdMma<HD>::QWARPS;
  constexpr int THREADS = 32 * BwdMma<HD>::QWARPS;
  constexpr int BN = BwdMma<HD>::QN;
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  static_assert(BN % 16 == 0 && HD % 16 == 0, "whole mma tiles");
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* dos = qs + BM * LD;                       // [BM][LD]
  bf16* ks = dos + BM * LD;                       // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;                    // [2][BN][LD]

  const int g = h / kvh;
  const int rows = sq * g;
  const int tiles = (rows + BM - 1) / BM;
  const int per_tile = gridDim.x / tiles;  // b * kvh
  const int kv = blockIdx.x % kvh;
  const int bi = (blockIdx.x % per_tile) / kvh;
  const int r0 = (tiles - 1 - (int)(blockIdx.x / per_tile)) * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;

  for (int c = tid; c < BM * CH; c += THREADS) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int R = r0 + r;
    const bool ok = R < rows;
    const int pos = ok ? R / g : 0;
    const int gi = ok ? R - pos * g : 0;
    const size_t off = (((size_t)bi * sq + pos) * h + kv * g + gi) * HD +
                       ch * 8;
    cp_async16(smem_u32(qs + r * LD + ch * 8), q + off, ok);
    cp_async16(smem_u32(dos + r * LD + ch * 8), dout + off, ok);
  }

  // keys any row of this tile can see (every key with explicit positions)
  const bool explicit_pos = pos_k != nullptr;
  const int pos_first = r0 / g;
  const int pos_last = (min(r0 + BM, rows) - 1) / g;
  int lo = window > 0 && !explicit_pos ? max(0, pos_first - window + 1) : 0;
  lo = lo / BN * BN;
  const int hi = causal && !explicit_pos ? min(sk, pos_last + 1) : sk;
  const int ntiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  auto load_kv = [&](int t) {
    const int k0 = lo + t * BN;
    bf16* kd = ks + (t & 1) * BN * LD;
    bf16* vd = vs + (t & 1) * BN * LD;
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int j = c / CH;
      const int ch = c - j * CH;
      const bool ok = k0 + j < sk;  // zeros past the end
      const size_t off =
          (((size_t)bi * sk + (ok ? k0 + j : 0)) * kvh + kv) * HD + ch * 8;
      cp_async16(smem_u32(kd + j * LD + ch * 8), k + off, ok);
      cp_async16(smem_u32(vd + j * LD + ch * 8), v + off, ok);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();  // group 0: Q, dO and K/V tile 0

  // D = rowsum(dO o) of the warp's 16 rows, from device memory: lanes l
  // and l + 16 take the two halves of row wr + (l & 15); every lane then
  // holds D of its mma rows grp and grp + 8
  float Drow[2], L2[2];
  int pos_row[2];
  {
    const int r = wr + (lane & 15);
    const int R = r0 + r;
    const bool ok = R < rows;
    const int pos = ok ? R / g : 0;
    const int gi = ok ? R - pos * g : 0;
    const size_t off = (((size_t)bi * sq + pos) * h + kv * g + gi) * HD;
    const int c0 = (lane >> 4) * (CH / 2);
    float part = 0.f;
    if (ok) {
#pragma unroll
      for (int c = c0; c < c0 + CH / 2; ++c) {
        const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c * 8);
        const uint4 b = *reinterpret_cast<const uint4*>(o + off + c * 8);
        const bf16* ea = reinterpret_cast<const bf16*>(&a);
        const bf16* eb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part = __fmaf_rn(__bfloat162float(ea[e]), __bfloat162float(eb[e]),
                           part);
      }
    }
    const float D = part + __shfl_xor_sync(0xffffffffu, part, 16);
    if (ok && lane < 16) dsum[((size_t)bi * h + kv * g + gi) * sq + pos] = D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Drow[i] = __shfl_sync(0xffffffffu, D, grp + 8 * i);
      const int Ri = r0 + wr + grp + 8 * i;
      const bool oki = Ri < rows;
      const int pi = oki ? Ri / g : 0;
      // a row that sees no key, or a padding row: L2 = +inf gives P = 0
      // and dS = 0
      L2[i] = oki ? lse[((size_t)bi * h + kv * g + Ri - pi * g) * sq + pi] *
                        LOG2E
                  : INFINITY;
      pos_row[i] = explicit_pos ? __ldg(pos_q + (size_t)bi * sq + pi) : pi;
    }
  }

  float dqa[HD / 8][4];
#pragma unroll
  for (int db = 0; db < HD / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[db][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_kv(t + 1);
    cp_async_commit();
    const int k0 = lo + t * BN;
    const bf16* kt = ks + (t & 1) * BN * LD;
    const bf16* vt = vs + (t & 1) * BN * LD;

    // S = Q K^T and dP = dO V^T
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, a_frag<LD>(qs, wr, kk * 16, lane));
      ldsm_x4(ad, a_frag<LD>(dos, wr, kk * 16, lane));
#pragma unroll
      for (int nb = 0; nb < BN / 8; nb += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_frag<LD>(kt, nb * 8, kk * 16, lane));
        mma_bf16(s[nb], aq, b[0], b[1]);
        mma_bf16(s[nb + 1], aq, b[2], b[3]);
        ldsm_x4(b, b_frag<LD>(vt, nb * 8, kk * 16, lane));
        mma_bf16(dp[nb], ad, b[0], b[1]);
        mma_bf16(dp[nb + 1], ad, b[2], b[3]);
      }
    }

    // dS = P (dP - D), P = 2^(S scale log2 e - lse log2 e), 0 where masked
    const bool masked = explicit_pos ||
                        !(k0 + BN <= sk &&
                          (!causal || k0 + BN - 1 <= pos_first) &&
                          (window <= 0 || pos_last - k0 < window));
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      int kpos[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + nb * 8 + 2 * t4 + c;
        kpos[c] = !explicit_pos || key >= sk
                      ? key
                      : __ldg(pos_k + (size_t)bi * sk + key);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t4 + (e & 1);
        const int i = e >> 1;
        const bool ok = !masked || (key < sk && visible(pos_row[i],
                                                        kpos[e & 1], causal,
                                                        window));
        const float p =
            ok ? ex2(__fmaf_rn(s[nb][e], scale_log2, -L2[i])) : 0.f;
        s[nb][e] = p * (dp[nb][e] - Drow[i]);
      }
    }

    // dQ += dS K: dS in bf16 A fragments, K through ldmatrix.trans
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
      a[1] = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
      a[2] = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
      a[3] = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
#pragma unroll
      for (int db = 0; db < HD / 8; db += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_frag<LD>(kt, kb * 16, db * 8, lane));
        mma_bf16(dqa[db], a, b[0], b[1]);
        mma_bf16(dqa[db + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies into the Q buffer are in

  // epilogue: scale dQ into the warp's own rows of the Q buffer (no other
  // warp reads them), then 16-byte rows to device memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + grp + 8 * i;
#pragma unroll
    for (int db = 0; db < HD / 8; ++db)
      *reinterpret_cast<uint32_t*>(qs + r * LD + db * 8 + 2 * t4) =
          pack_bf16(dqa[db][2 * i] * scale, dqa[db][2 * i + 1] * scale);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = wr + c / CH;
    const int ch = c % CH;
    const int R = r0 + r;
    if (R >= rows) continue;
    const int pos = R / g;
    const int gi = R - pos * g;
    *reinterpret_cast<uint4*>(
        dq + (((size_t)bi * sq + pos) * h + kv * g + gi) * HD + ch * 8) =
        *reinterpret_cast<const uint4*>(qs + r * LD + ch * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * BwdMma<HD>::KWARPS)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             const int* __restrict__ pos_q,
                             const int* __restrict__ pos_k, int sq, int sk,
                             int h, int kvh, int causal, int window,
                             float scale_log2, float scale) {
  constexpr int WARPS = BwdMma<HD>::KWARPS;
  constexpr int THREADS = 32 * WARPS;
  constexpr int BN = BwdMma<HD>::BN;
  constexpr int BM = BwdMma<HD>::BM;
  constexpr int LD = HD + 8;
  constexpr int LDP = BM + 8;
  constexpr int CH = HD / 8;
  constexpr int KW = BN / 16;      // key groups of 16
  constexpr int DW = WARPS / KW;   // warps per key group
  constexpr int RN = BM / DW;      // a warp's rows of S^T and dP^T
  constexpr int DN = HD / DW;      // a warp's dims of dK and dV
  static_assert(KW * DW == WARPS && RN % 16 == 0 && DN % 16 == 0,
                "whole mma tiles per warp");
  extern __shared__ uint4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BN][LD]
  bf16* vs = ks + BN * LD;                        // [BN][LD]
  bf16* qs = vs + BN * LD;                        // [2][BM][LD]
  bf16* dos = qs + 2 * BM * LD;                   // [2][BM][LD]
  bf16* pt = dos + 2 * BM * LD;                   // P^T [BN][LDP]
  bf16* dst = pt + BN * LDP;                      // dS^T [BN][LDP]
  float* l2s = reinterpret_cast<float*>(dst + BN * LDP);  // [2][BM]
  float* dds = l2s + 2 * BM;                               // [2][BM]
  int* rps = reinterpret_cast<int*>(dds + 2 * BM);         // [2][BM]

  const int g = h / kvh;
  const int rows = sq * g;
  const int ktiles = (sk + BN - 1) / BN;
  const int per_tile = gridDim.x / ktiles;  // b * kvh
  const int kv = blockIdx.x % kvh;
  const int bi = (blockIdx.x % per_tile) / kvh;
  const int k0 = (int)(blockIdx.x / per_tile) * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int t4 = lane & 3;
  const int kw = warp % KW;
  const int dw = warp / KW;
  const bool explicit_pos = pos_k != nullptr;

  for (int c = tid; c < BN * CH; c += THREADS) {
    const int j = c / CH;
    const int ch = c - j * CH;
    const bool ok = k0 + j < sk;
    const size_t off =
        (((size_t)bi * sk + (ok ? k0 + j : 0)) * kvh + kv) * HD + ch * 8;
    cp_async16(smem_u32(ks + j * LD + ch * 8), k + off, ok);
    cp_async16(smem_u32(vs + j * LD + ch * 8), v + off, ok);
  }

  // rows that can see a key of this tile (every row with explicit
  // positions); rows past sk + window - 1 see no key at all and still give
  // every key its uniform share of dV
  const int key_last = min(k0 + BN, sk) - 1;
  int rlo = 0, rhi = rows;
  if (!explicit_pos) {
    if (causal) rlo = min(rows, k0 * g);
    if (window > 0 && sq - 1 < sk + window - 1)
      rhi = min(rows, (key_last + window) * g);
  }
  const int ntiles = rhi > rlo ? (rhi - rlo + BM - 1) / BM : 0;

  // row tile t into stage t & 1: Q and dO by cp.async, and per row lse
  // log2 e (+inf for a row that sees no key, and for padding rows, whose
  // Q and dO are zeros), D and the position
  auto load_rows = [&](int t) {
    const int r0 = rlo + t * BM;
    bf16* qd = qs + (t & 1) * BM * LD;
    bf16* dd = dos + (t & 1) * BM * LD;
    for (int c = tid; c < BM * CH; c += THREADS) {
      const int r = c / CH;
      const int ch = c - r * CH;
      const int R = r0 + r;
      const bool ok = R < rhi;
      const int pos = ok ? R / g : 0;
      const int gi = ok ? R - pos * g : 0;
      const size_t off = (((size_t)bi * sq + pos) * h + kv * g + gi) * HD +
                         ch * 8;
      cp_async16(smem_u32(qd + r * LD + ch * 8), q + off, ok);
      cp_async16(smem_u32(dd + r * LD + ch * 8), dout + off, ok);
    }
    for (int r = tid; r < BM; r += THREADS) {
      const int R = r0 + r;
      const bool ok = R < rhi;
      const int pos = ok ? R / g : 0;
      const size_t lidx = ((size_t)bi * h + kv * g + R - pos * g) * sq + pos;
      l2s[(t & 1) * BM + r] = ok ? lse[lidx] * LOG2E : INFINITY;
      dds[(t & 1) * BM + r] = ok ? dsum[lidx] : 0.f;
      rps[(t & 1) * BM + r] =
          explicit_pos && ok ? __ldg(pos_q + (size_t)bi * sq + pos) : pos;
    }
  };
  if (ntiles > 0) load_rows(0);
  cp_async_commit();  // group 0: K, V and row tile 0

  // the positions of the thread's keys grp and grp + 8 of its group
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * kw + grp + 8 * i;
    kpos[i] = explicit_pos && key < sk ? __ldg(pos_k + (size_t)bi * sk + key)
                                       : key;
  }
  const float inv_sk = 1.f / (float)sk;

  float dka[DN / 8][4], dva[DN / 8][4];
#pragma unroll
  for (int db = 0; db < DN / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_rows(t + 1);
    cp_async_commit();
    const int r0 = rlo + t * BM;
    const bf16* qt = qs + (t & 1) * BM * LD;
    const bf16* dt = dos + (t & 1) * BM * LD;
    const float* l2 = l2s + (t & 1) * BM;
    const float* dd = dds + (t & 1) * BM;
    const int* rp = rps + (t & 1) * BM;

    // S^T = K Q^T and dP^T = V dO^T: keys 16 kw.., rows dw RN..
    float s[RN / 8][4], dp[RN / 8][4];
#pragma unroll
    for (int nb = 0; nb < RN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_frag<LD>(ks, 16 * kw, kk * 16, lane));
      ldsm_x4(av, a_frag<LD>(vs, 16 * kw, kk * 16, lane));
#pragma unroll
      for (int nb = 0; nb < RN / 8; nb += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_frag<LD>(qt, dw * RN + nb * 8, kk * 16, lane));
        mma_bf16(s[nb], ak, b[0], b[1]);
        mma_bf16(s[nb + 1], ak, b[2], b[3]);
        ldsm_x4(b, b_frag<LD>(dt, dw * RN + nb * 8, kk * 16, lane));
        mma_bf16(dp[nb], av, b[0], b[1]);
        mma_bf16(dp[nb + 1], av, b[2], b[3]);
      }
    }

    // P^T and dS^T in bf16 to shared memory
    const int pos_first = r0 / g;
    const int pos_last = (min(r0 + BM, rhi) - 1) / g;
    const bool masked = explicit_pos ||
                        !(k0 + BN <= sk &&
                          (!causal || k0 + BN - 1 <= pos_first) &&
                          (window <= 0 || pos_last - k0 < window));
#pragma unroll
    for (int nb = 0; nb < RN / 8; ++nb) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = dw * RN + nb * 8 + 2 * t4 + (e & 1);
        const float L2 = l2[r];
        const bool ok = !masked || (k0 + 16 * kw + grp + 8 * i < sk &&
                                    visible(rp[r], kpos[i], causal, window));
        if (L2 == INFINITY) {  // uniform row (or padding: dO is zero)
          p[e] = inv_sk;
          ds[e] = 0.f;
        } else {
          p[e] = ok ? ex2(__fmaf_rn(s[nb][e], scale_log2, -L2)) : 0.f;
          ds[e] = p[e] * (dp[nb][e] - dd[r]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (16 * kw + grp + 8 * i) * LDP + dw * RN + nb * 8 +
                       2 * t4;
        *reinterpret_cast<uint32_t*>(pt + at) =
            pack_bf16(p[2 * i], p[2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dst + at) =
            pack_bf16(ds[2 * i], ds[2 * i + 1]);
      }
    }
    __syncthreads();  // every warp's P^T and dS^T are in

    // dV += P^T dO and dK += dS^T Q: keys 16 kw.., dims dw DN..
#pragma unroll
    for (int kb = 0; kb < BM / 16; ++kb) {
      uint32_t ap[4], ads[4];
      ldsm_x4(ap, a_frag<LDP>(pt, 16 * kw, kb * 16, lane));
      ldsm_x4(ads, a_frag<LDP>(dst, 16 * kw, kb * 16, lane));
#pragma unroll
      for (int db = 0; db < DN / 8; db += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_frag<LD>(dt, kb * 16, dw * DN + db * 8, lane));
        mma_bf16(dva[db], ap, b[0], b[1]);
        mma_bf16(dva[db + 1], ap, b[2], b[3]);
        ldsm_x4_trans(b, bt_frag<LD>(qt, kb * 16, dw * DN + db * 8, lane));
        mma_bf16(dka[db], ads, b[0], b[1]);
        mma_bf16(dka[db + 1], ads, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V

  // epilogue: scale dK; dK and dV in bf16 into the K and V buffers, then
  // 16-byte rows to device memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = 16 * kw + grp + 8 * i;
#pragma unroll
    for (int db = 0; db < DN / 8; ++db) {
      const int at = j * LD + dw * DN + db * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(ks + at) =
          pack_bf16(dka[db][2 * i] * scale, dka[db][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(vs + at) =
          pack_bf16(dva[db][2 * i], dva[db][2 * i + 1]);
    }
  }
  __syncthreads();
  for (int c = tid; c < BN * CH; c += THREADS) {
    const int j = c / CH;
    const int ch = c - j * CH;
    if (k0 + j >= sk) continue;
    const size_t off = (((size_t)bi * sk + k0 + j) * kvh + kv) * HD + ch * 8;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(ks + j * LD + ch * 8);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(vs + j * LD + ch * 8);
  }
}

// ------------------------------------------------------------ launchers

constexpr int MAX_DEVICES = 64;

// Raises a kernel's dynamic shared-memory limit past the 48 KB default,
// once per kernel and device (the attribute is per device).
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* pos_q, const int* pos_k, int b, int sq, int sk,
               int h, int kvh, int causal, int window, cudaStream_t stream) {
  const int g = h / kvh;
  if (g > Tile<HD>::ROWS) return (int)cudaErrorInvalidValue;
  const int bq = Tile<HD>::ROWS / g;
  const int bytes = smem_bytes<HD>();
  const cudaError_t err = allow_smem<flash_attention_kernel<HD>>(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + bq - 1) / bq, kvh, b);
  flash_attention_kernel<HD><<<grid, Tile<HD>::THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      pos_q, pos_k, sq, sk, h, kvh, bq, causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* pos_q, const int* pos_k, int b, int sq, int sk,
                int h, int kvh, int causal, int window, cudaStream_t stream) {
  constexpr int BM = 16 * MmaTile<HD>::WARPS;
  const long long rows = (long long)sq * (h / kvh);
  if (rows > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  const int bytes = mma_smem_bytes<HD>();
  const cudaError_t err = allow_smem<flash_attention_mma_kernel<HD>>(bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (rows + BM - 1) / BM * b * kvh;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas);
  flash_attention_mma_kernel<HD><<<grid, 32 * MmaTile<HD>::WARPS, bytes,
                                   stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, pos_q,
      pos_k, sq, sk, h, kvh, causal, window, 1.4426950408889634f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

#if FLASH_FORWARD
typedef int (*Launcher)(const void*, const void*, const void*, void*,
                        float*, const int*, const int*, int, int, int, int, int, int,
                        int, cudaStream_t);

// the launcher of head dim hd for one dtype, or null
Launcher f32_launcher(int hd) {
  switch (hd) {
    case 16: return launch_f32<16>;
    case 32: return launch_f32<32>;
    case 64: return launch_f32<64>;
    case 112: return launch_f32<112>;
    case 128: return launch_f32<128>;
    case 192: return launch_f32<192>;
    case 256: return launch_f32<256>;
    default: return nullptr;
  }
}

Launcher bf16_launcher(int hd) {
  switch (hd) {
    case 16: return launch_bf16<16>;
    case 32: return launch_bf16<32>;
    case 64: return launch_bf16<64>;
    case 112: return launch_bf16<112>;
    case 128: return launch_bf16<128>;
    case 192: return launch_bf16<192>;
    case 256: return launch_bf16<256>;
    default: return nullptr;
  }
}
#endif  // FLASH_FORWARD


template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* dsum, void* dq,
                   void* dk, void* dv, const int* pos_q, const int* pos_k,
                   int b, int sq, int sk, int h, int kvh, int causal,
                   int window, cudaStream_t stream) {
  constexpr int ROWS = BwdTile<HD>::ROWS;
  constexpr int THREADS = BwdTile<HD>::THREADS;
  const int bytes = bwd_smem_bytes<HD>();
  cudaError_t err = allow_smem<flash_bwd_dq_kernel<HD>>(bytes);
  if (err == cudaSuccess) err = allow_smem<flash_bwd_dkv_kernel<HD>>(bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)sq * (h / kvh);
  if (rows > 0x7fffffffLL - ROWS) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  const dim3 grid_q((unsigned)((rows + ROWS - 1) / ROWS), kvh, b);
  flash_bwd_dq_kernel<HD><<<grid_q, THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, lse, dsum, (float*)dq, pos_q, pos_k, sq, sk, h,
      kvh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || sk == 0) return (int)err;
  const dim3 grid_k((sk + ROWS - 1) / ROWS, kvh, b);
  flash_bwd_dkv_kernel<HD><<<grid_k, THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, dsum, (float*)dk, (float*)dv, pos_q, pos_k, sq, sk, h, kvh,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* dsum, void* dq, void* dk, void* dv,
                    const int* pos_q, const int* pos_k, int b, int sq, int sk,
                    int h, int kvh, int causal, int window,
                    cudaStream_t stream) {
  constexpr int BM = 16 * BwdMma<HD>::QWARPS;
  constexpr int BN = BwdMma<HD>::BN;
  const int qbytes = bwd_dq_smem_bytes<HD>();
  const int kbytes = bwd_dkv_smem_bytes<HD>();
  cudaError_t err = allow_smem<flash_bwd_dq_mma_kernel<HD>>(qbytes);
  if (err == cudaSuccess)
    err = allow_smem<flash_bwd_dkv_mma_kernel<HD>>(kbytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)sq * (h / kvh);
  if (rows > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  const long long q_ctas = (rows + BM - 1) / BM * b * kvh;
  const long long k_ctas = (long long)((sk + BN - 1) / BN) * b * kvh;
  if (q_ctas > 0x7fffffffLL || k_ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  flash_bwd_dq_mma_kernel<HD><<<(unsigned)q_ctas, 32 * BwdMma<HD>::QWARPS,
                                qbytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, dsum, (bf16*)dq, pos_q, pos_k, sq, sk, h, kvh,
      causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || sk == 0) return (int)err;
  flash_bwd_dkv_mma_kernel<HD><<<(unsigned)k_ctas, 32 * BwdMma<HD>::KWARPS,
                                 kbytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      dsum, (bf16*)dk, (bf16*)dv, pos_q, pos_k, sq, sk, h, kvh, causal,
      window, scale_log2, scale);
  return (int)cudaGetLastError();
}

#if FLASH_BACKWARD
typedef int (*BwdLauncher)(const void*, const void*, const void*,
                           const void*, const void*, const float*, float*,
                           void*, void*, void*, const int*, const int*, int,
                           int, int, int, int, int, int, cudaStream_t);

BwdLauncher bwd_launcher(int hd, int dtype) {
  const bool bf = dtype == 1;
  switch (hd) {
    case 16: return bf ? launch_bwd_bf16<16> : launch_bwd_f32<16>;
    case 32: return bf ? launch_bwd_bf16<32> : launch_bwd_f32<32>;
    case 64: return bf ? launch_bwd_bf16<64> : launch_bwd_f32<64>;
    case 112: return bf ? launch_bwd_bf16<112> : launch_bwd_f32<112>;
    case 128: return bf ? launch_bwd_bf16<128> : launch_bwd_f32<128>;
    case 192: return bf ? launch_bwd_bf16<192> : launch_bwd_f32<192>;
    case 256: return bf ? launch_bwd_bf16<256> : launch_bwd_f32<256>;
    default: return nullptr;
  }
}
#endif  // FLASH_BACKWARD

}  // namespace

#if FLASH_FORWARD
// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel); pos_q (b, sq) and pos_k (b, sk) int32 positions, both or neither
// (null: 0..s-1).  Returns the launch's CUDA error code.
// lse (b, h, sq) float32, or null: the natural-log logsumexp of each row's
// scaled visible scores, +inf for a row that sees no key (the backward's
// flag for the uniform row); the training forward asks for it.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          const int* pos_q, const int* pos_k,
                                          int b, int sq, int sk, int h,
                                          int kvh, int hd, int causal,
                                          int window, int dtype,
                                          void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kvh < 1 || h % kvh != 0 ||
      b > 65535 || kvh > 65535 || (pos_q == nullptr) != (pos_k == nullptr))
    return (int)cudaErrorInvalidValue;
  Launcher fn = dtype == 0 ? f32_launcher(hd)
                : dtype == 1 ? bf16_launcher(hd)
                             : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, o, lse, pos_q, pos_k, b, sq, sk, h, kvh, causal, window,
            (cudaStream_t)stream);
}

extern "C" int flash_attention_pos_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          const int* pos_q, const int* pos_k,
                                          int b, int sq, int sk, int h,
                                          int kvh, int hd, int causal,
                                          int window, int dtype,
                                          void* stream) {
  return flash_attention_lse_launch(q, k, v, o, nullptr, pos_q, pos_k, b, sq,
                                    sk, h, kvh, hd, causal, window, dtype,
                                    stream);
}

// The implicit positions 0..s-1 (tools/kernel_variants.py binds this one).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int sk, int h, int kvh, int hd,
                                      int causal, int window, int dtype,
                                      void* stream) {
  return flash_attention_pos_launch(q, k, v, o, nullptr, nullptr, b, sq, sk,
                                    h, kvh, hd, causal, window, dtype,
                                    stream);
}

// Which tensor-core products serve bfloat16 at head dim hd: 1 = mma.sync,
// 2 = wgmma; 0 for a head dim the kernel lacks.
extern "C" int flash_attention_bf16_step(int hd) {
  switch (hd) {
    case 16: return MmaTile<16>::STEP;
    case 32: return MmaTile<32>::STEP;
    case 64: return MmaTile<64>::STEP;
    case 112: return MmaTile<112>::STEP;
    case 128: return MmaTile<128>::STEP;
    case 192: return MmaTile<192>::STEP;
    case 256: return MmaTile<256>::STEP;
    default: return 0;
  }
}

#endif  // FLASH_FORWARD

#if FLASH_BACKWARD
// The backward: dq (b, sq, h, hd), dk and dv (b, sk, kvh, hd) in the
// dtype of q, k, v, o and dout (0 float32, 1 bfloat16), from the forward's
// lse (b, h, sq); dsum (b, h, sq) float32 is scratch (D = rowsum(dO o)).
// Two launches on the stream.  Returns the first CUDA error code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dsum, void* dq, void* dk,
    void* dv, const int* pos_q, const int* pos_k, int b, int sq, int sk,
    int h, int kvh, int hd, int causal, int window, int dtype,
    void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kvh < 1 || h % kvh != 0 ||
      b > 65535 || kvh > 65535 || (pos_q == nullptr) != (pos_k == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdLauncher fn = dtype == 0 || dtype == 1 ? bwd_launcher(hd, dtype)
                                             : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, o, dout, lse, dsum, dq, dk, dv, pos_q, pos_k, b, sq, sk,
            h, kvh, causal, window, (cudaStream_t)stream);
}
#endif  // FLASH_BACKWARD
