// W8A16 matrix product for int8-quantized weights: y = (x @ q) * s.
//
// Replaces the TPU kernel container_engine_accelerators_tpu/ops/
// quant.py::int8_matmul (_int8_matmul_kernel, pl.pallas_call at line
// 214). Same function:
//   x [T, D] bf16 or f32, q [D, F] int8 (row-major), s [F] f32
//   y [T, F] in x's dtype, y = (sum_d x[t, d] * q[d, f]) * s[f]
// with the sum in f32 and the per-column scale applied once at the end.
//
// What bounds it on an H100. Decode (T <= 16): bytes. Each weight byte
// serves at most 16 multiply-adds, so the D*F int8 bytes are the cost
// (w_gate at T 8: 0.0176 ms at 3.35 TB/s; a llama3_8b step's 225 calls
// 2.24 ms), half the bf16 weight stream. Prefill (T of 128 to 1024):
// operations, on the tensor cores (w_gate at T 1024: 120 GFLOP, 0.122 ms
// at 989 TFLOP/s bf16).
//
// Both bodies compute y^T = q^T x^T on the tensor cores: the weight is
// the A operand, converted from int8 to bf16 in registers (int8 values
// are exact in bf16), and x^T the B operand; sums in f32, the scale and
// the cast once per output. ops/quant.plan picks the body and its grid
// from the shapes, the SM count and the weight rows' alignment only, so
// one call is one launch that reads nothing on the host and a CUDA
// graph can hold it.
//   - The weight stays in its [D, F] layout, so a thread reads 4 or 8
//     neighbouring columns of 4 D rows, one word each, and both orders
//     are bent to fit the fragments instead of moving data: its rows are
//     its four k slots and its column bytes 2j, 2j + 1 are rows g, g + 8
//     of m-tile j (the epilogue stores each row to its column). A pair of
//     bytes from two D rows becomes one bf16x2 register in 4
//     instructions (a byte permute, two masks under the exponent of 128,
//     one bf16x2 fma: v = (128 + (v & 127)) - (128 or 256 by its sign
//     bit), exact). Each output column ends in one thread, so y is
//     written 4 or 8 neighbouring columns at a time. Shared-memory tiles
//     are XOR-swizzled in 16-byte chunks so that a warp's fragment reads
//     hit 32 distinct banks.
//   - int8_mma_kernel (decode; f32 x; rows not 16-byte aligned):
//     mma.sync m16n8k16, 4 warps on 128 output columns by a token tile
//     NT of 8, 16, 32, 64 or 128, so each weight byte is read from HBM
//     once per NT tokens; a ring of cp.async stages (4 at decode, 2-3
//     at NT 128), each 64 rows of the weight and of x, 16 bytes a thread
//     (8 or 4 where F's rows are not 16-byte aligned), zero-filled past
//     D, F and T. f32 x (the lm_head) is split as its fragment is read
//     into hi = bf16(x) and lo = bf16(x - hi), two products on the same
//     converted weight into one f32 sum: ~2e-6 of max|y|, where TF32 or
//     bf16 alone give 2e-4 or 1.4e-3.
//   - int8_wgmma_kernel (bf16 x past 64 rows, 16-byte rows): 128 tokens
//     by 256 columns a CTA. A producer warp loads x and the weight by TMA
//     (128-byte swizzle, zeros past the edges) into a 3-stage ring of
//     128 rows of D; two consumer warpgroups each convert their 128
//     columns' fragments in registers and issue wgmma m64n128k16 with A
//     from registers and x, K-major in shared memory, as B, converting
//     the next step while the last runs. A slab's products retire before
//     its stage is released (products in flight across slabs made ptxas
//     serialize them).
//   - Too few output tiles to fill 132 SMs (decode, small F) split D
//     across CTAs (grid z): each writes its f32 sums to a workspace, and
//     the last CTA of an output tile to take a ticket adds the splits in
//     split order, scales, casts and writes y, then resets the ticket.
//     No atomics touch y, so the bits repeat from call to call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;                 // 4 warps
constexpr int kCols = 128;                    // output columns a CTA
constexpr int kDepth = 64;                    // rows of D a stage
constexpr int kWBytes = kDepth * kCols;       // a stage's weight slab

// The warps' layout over a CTA's 128 columns x NT tokens.
template <int NT>
struct Geom {
  static constexpr int kWarpsF = NT <= 16 ? 4 : 2;   // warps along F
  static constexpr int kWarpsT = 4 / kWarpsF;        // warps along T
  static constexpr int kMW = kCols / kWarpsF;        // columns a warp
  static constexpr int kNW = NT / kWarpsT;           // tokens a warp
  static constexpr int kM = kMW / 16;                // m16 tiles a warp
  static constexpr int kN = kNW / 8;                 // n8 tiles a warp
  static constexpr int kRowBytes = kMW / 8;          // bytes a thread a row
};

template <int NT, class XT>
struct Ring {
  static constexpr int kStage = kWBytes + NT * kDepth * (int)sizeof(XT);
  static constexpr int kStages = NT <= 16 ? 4 : (kStage <= 24576 ? 3 : 2);
  static constexpr int kSmem = kStages * kStage;
};
static_assert(Ring<128, float>::kSmem <= 232448, "ring too large");

// cp.async of `bytes` (4, 8 or 16) from global to shared memory; with
// `ok` false nothing is read and the destination is zero-filled.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;
  if constexpr (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(bytes), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Byte offset of 16-byte chunk `chunk` of weight row `row` (128 bytes a
// row): the chunk is XORed with 2 * ((row / 4) % 4), so the 4 rows x 8
// column groups of a warp's fragment read fall in distinct banks.
__device__ __forceinline__ int w_off(int row, int chunk) {
  return row * kCols + ((chunk ^ (((row >> 2) & 3) << 1)) << 4);
}

// Byte offset of chunk `chunk` of token row `row` of the x slab: 64
// values, 128 bytes in bf16 (8 chunks, XOR 2 * (row % 4)) or 256 in f32
// (16 chunks, XOR 4 * (row % 2)), so a warp's 8- or 16-byte fragment
// reads are conflict-free.
template <class XT>
__device__ __forceinline__ int x_off(int row, int chunk) {
  if constexpr (sizeof(XT) == 2)
    return row * 128 + ((chunk ^ ((row & 3) << 1)) << 4);
  else
    return row * 256 + ((chunk ^ ((row & 1) << 2)) << 4);
}

// One stage: weight rows [d0, d0 + 64) x columns [f0, f0 + 128), and x
// tokens [t0, t0 + NT) x the same 64 columns of D.
template <int NT, class XT>
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* w,
                                           const XT* x, int T, int D, int F,
                                           int t0, int f0, int d0, int vec) {
  for (int c = threadIdx.x; c < kDepth * 8; c += kThreads) {
    const int row = c >> 3, ch = c & 7;
    const int d = d0 + row, f = f0 + ch * 16;
    uint8_t* dst = st + w_off(row, ch);
    const int8_t* src = w + (size_t)d * F + f;
    const bool in_d = d < D;
    if (vec == 16) {
      cp_async<16>(dst, in_d && f < F ? src : w, in_d && f < F);
    } else if (vec == 8) {
#pragma unroll
      for (int p = 0; p < 16; p += 8) {
        const bool ok = in_d && f + p < F;
        cp_async<8>(dst + p, ok ? src + p : w, ok);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 16; p += 4) {
        const bool ok = in_d && f + p < F;
        cp_async<4>(dst + p, ok ? src + p : w, ok);
      }
    }
  }
  constexpr int kXChunks = kDepth * (int)sizeof(XT) / 16;   // a token row
  constexpr int kPer = 16 / (int)sizeof(XT);                // values a chunk
  uint8_t* xs = st + kWBytes;
  for (int c = threadIdx.x; c < NT * kXChunks; c += kThreads) {
    const int row = c / kXChunks, ch = c % kXChunks;
    const int t = t0 + row, d = d0 + ch * kPer;
    const bool ok = t < T && d < D;
    cp_async<16>(xs + x_off<XT>(row, ch), ok ? x + (size_t)t * D + d : x,
                 ok);
  }
}

// Bytes b of w0 and w1 (two D rows, one output column) as one bf16x2
// register, w0's in the low half: with the byte's low 7 bits under the
// exponent of 128 (128 + (v & 127)) and its sign bit under the same
// exponent (128, or 256 when set), v = lo - hi exactly.
template <int b>
__device__ __forceinline__ uint32_t i8_pair(uint32_t w0, uint32_t w1) {
  constexpr uint32_t sel = b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12);
  const uint32_t p = __byte_perm(w0, w1, sel);
  const uint32_t lo = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (p & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(hi), "r"(0xBF80BF80u), "r"(lo));   // lo + hi * -1
  return r;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of a warp's kM m-tiles for k step kk, from its four D
// rows 16 kk + 4 tq + r: word j / 2 of row r holds columns 2j, 2j + 1.
template <int NT>
__device__ __forceinline__ void a_frags(const uint8_t* ws, int kk, int wf,
                                        int g, int tq,
                                        uint32_t (&a)[Geom<NT>::kM][4]) {
  using G = Geom<NT>;
  const int byte = wf * G::kMW + g * G::kRowBytes;
  const int ch = byte >> 4, off = byte & 15;
  uint32_t wr[4][G::kRowBytes / 4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint8_t* p = ws + w_off(16 * kk + 4 * tq + r, ch) + off;
    if constexpr (G::kRowBytes == 4) {
      wr[r][0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      wr[r][0] = v.x;
      wr[r][1] = v.y;
    }
  }
#pragma unroll
  for (int j = 0; j < G::kM; ++j) {
    const int wd = j / 2;
    if (j % 2 == 0) {
      a[j][0] = i8_pair<0>(wr[0][wd], wr[1][wd]);   // row g, k 2t, 2t+1
      a[j][1] = i8_pair<1>(wr[0][wd], wr[1][wd]);   // row g+8
      a[j][2] = i8_pair<0>(wr[2][wd], wr[3][wd]);   // row g, k 2t+8, 2t+9
      a[j][3] = i8_pair<1>(wr[2][wd], wr[3][wd]);   // row g+8
    } else {
      a[j][0] = i8_pair<2>(wr[0][wd], wr[1][wd]);
      a[j][1] = i8_pair<3>(wr[0][wd], wr[1][wd]);
      a[j][2] = i8_pair<2>(wr[2][wd], wr[3][wd]);
      a[j][3] = i8_pair<3>(wr[2][wd], wr[3][wd]);
    }
  }
}

template <int NT, class XT>
__device__ __forceinline__ void compute_stage(
    const uint8_t* st, int wf, int wt, int g, int tq,
    float (&acc)[Geom<NT>::kM][Geom<NT>::kN][4]) {
  using G = Geom<NT>;
  const uint8_t* xs = st + kWBytes;
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    uint32_t a[G::kM][4];
    a_frags<NT>(st, kk, wf, g, tq, a);
#pragma unroll
    for (int ni = 0; ni < G::kN; ++ni) {
      const int row = wt * G::kNW + ni * 8 + g;   // token in the tile
      if constexpr (sizeof(XT) == 2) {
        // D 16kk + 4tq .. +3: k 2t, 2t+1 | 2t+8, 2t+9.
        const int byte = 32 * kk + 8 * tq;
        const uint2 v = *reinterpret_cast<const uint2*>(
            xs + x_off<XT>(row, byte >> 4) + (byte & 15));
#pragma unroll
        for (int j = 0; j < G::kM; ++j) mma(acc[j][ni], a[j], v.x, v.y);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + x_off<XT>(row, 4 * kk + tq));
        const uint32_t h0 = bf16x2(v.x, v.y), h1 = bf16x2(v.z, v.w);
        const uint32_t l0 = bf16x2(v.x - __uint_as_float(h0 << 16),
                                   v.y - __uint_as_float(h0 & 0xFFFF0000u));
        const uint32_t l1 = bf16x2(v.z - __uint_as_float(h1 << 16),
                                   v.w - __uint_as_float(h1 & 0xFFFF0000u));
#pragma unroll
        for (int j = 0; j < G::kM; ++j) {
          mma(acc[j][ni], a[j], h0, h1);
          mma(acc[j][ni], a[j], l0, l1);
        }
      }
    }
  }
}

__device__ __forceinline__ void store4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}
__device__ __forceinline__ void store4(bf16* y, float4 v) {
  uint2 u;
  u.x = bf16x2(v.x, v.y);
  u.y = bf16x2(v.z, v.w);
  *reinterpret_cast<uint2*>(y) = u;
}

__device__ __forceinline__ float4 scaled(float4 v, const float* s) {
  return make_float4(v.x * __ldg(s), v.y * __ldg(s + 1), v.z * __ldg(s + 2),
                     v.w * __ldg(s + 3));
}

// Columns f .. f + 3 of token t: y, scaled and cast, or with splits > 1
// the split's raw sums in part [splits, T, F].
template <class XT>
__device__ __forceinline__ void put4(XT* y, float* part, const float* scales,
                                     int T, int F, int split, int splits,
                                     int t, int f, float4 v) {
  if (t >= T || f >= F) return;   // F % 4 == 0: a group is all in or out
  if (splits == 1)
    store4(y + (size_t)t * F + f, scaled(v, scales + f));
  else
    store4(part + ((size_t)split * T + t) * F + f, v);
}

// Named barrier 1 over the `n` threads that store a tile (barrier 0 is
// __syncthreads, which a finished producer warp would never reach).
__device__ __forceinline__ void tile_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// After the put4s of the `n` threads from `first` on: the last CTA of
// output tile `tile` (rows [t0, t0 + rows), columns [f0, f0 + cols)) to
// take its ticket adds the splits' sums in split order, scales, casts
// and writes y, and resets the ticket for the next call.
template <class XT>
__device__ __forceinline__ void merge_splits(XT* y, const float* part,
                                             const float* scales,
                                             int* tickets, int tile, int T,
                                             int F, int splits, int t0,
                                             int rows, int f0, int cols,
                                             int first, int n) {
  __shared__ int is_last;
  const int me = threadIdx.x - first;
  __threadfence();
  tile_sync(n);
  if (me == 0) is_last = atomicAdd(tickets + tile, 1) == splits - 1;
  tile_sync(n);
  if (!is_last) return;
  __threadfence();
  for (int i = me; i < rows * (cols / 4); i += n) {
    const int t = t0 + i / (cols / 4), f = f0 + (i % (cols / 4)) * 4;
    if (f >= F) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 p = __ldcg(
          reinterpret_cast<const float4*>(part + ((size_t)s * T + t) * F + f));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    store4(y + (size_t)t * F + f, scaled(sum, scales + f));
  }
  if (me == 0) tickets[tile] = 0;
}

// Grid: (token tiles, column tiles, splits of D). part [splits, T, F] f32
// and tickets [token tiles x column tiles] (zero before and after a
// call) are used only with splits > 1.
template <int NT, class XT>
__global__ void __launch_bounds__(kThreads, NT >= 64 ? 2 : 4)
    int8_mma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales, XT* __restrict__ y,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int T, int D, int F, int d_per_split, int vec) {
  using G = Geom<NT>;
  using R = Ring<NT, XT>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int t0 = blockIdx.x * NT, f0 = blockIdx.y * kCols;
  const int split = blockIdx.z, splits = gridDim.z;
  const int d_begin = split * d_per_split;
  const int d_end = min(D, d_begin + d_per_split);
  const int n_k = (d_end - d_begin + kDepth - 1) / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wf = warp % G::kWarpsF, wt = warp / G::kWarpsF;

  float acc[G::kM][G::kN][4];
#pragma unroll
  for (int j = 0; j < G::kM; ++j)
#pragma unroll
    for (int n = 0; n < G::kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < n_k)
      load_stage<NT, XT>(smem + s * R::kStage, w, x, T, D, F, t0, f0,
                         d_begin + s * kDepth, vec);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<R::kStages - 2>();   // this thread's loads of slab kt
    __syncthreads();                   // everyone's; slab kt - 1 is free
    const int nxt = kt + R::kStages - 1;
    if (nxt < n_k)
      load_stage<NT, XT>(smem + (nxt % R::kStages) * R::kStage, w, x, T, D,
                         F, t0, f0, d_begin + nxt * kDepth, vec);
    cp_async_commit();
    compute_stage<NT, XT>(smem + (kt % R::kStages) * R::kStage, wf, wt, g,
                          tq, acc);
  }
  cp_async_wait<0>();

  // Thread (g, tq) holds columns fc .. fc + kRowBytes - 1 (column 2j + i
  // is m-tile j's row g + 8i) for tokens 2tq, 2tq + 1 of each n-tile.
  const int fc = f0 + wf * G::kMW + g * G::kRowBytes;
#pragma unroll
  for (int n = 0; n < G::kN; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q0 = 0; q0 < G::kRowBytes; q0 += 4)
        put4(y, part, scales, T, F, split, splits,
             t0 + wt * G::kNW + n * 8 + 2 * tq + e, fc + q0,
             make_float4(acc[q0 / 2][n][e], acc[q0 / 2][n][2 + e],
                         acc[q0 / 2 + 1][n][e], acc[q0 / 2 + 1][n][2 + e]));
  if (splits > 1)
    merge_splits(y, part, scales, tickets, blockIdx.y * gridDim.x + blockIdx.x,
                 T, F, splits, t0, min(NT, T - t0), f0, kCols, 0, kThreads);
}

// ------------------------------------------------- the prefill body, wgmma

// bf16 x at 128 tokens a CTA: 256 output columns. Two consumer
// warpgroups of 128 columns each, both on the same x tile, and a
// producer warpgroup whose first warp keeps the ring full with TMA; 128
// rows of D a stage, 3 stages (192 KiB). Registers a thread after
// setmaxnreg: 128 x 40 + 256 x 232 (flash_attention.cu's split; at 168
// each ptxas serializes the products for want of registers).
constexpr int kWgThreads = 3 * 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWgCols = 256;
constexpr int kWgTokens = 128;
constexpr int kWgDepth = 128;
constexpr int kWgStages = 3;
constexpr int kBox = 8192;   // a TMA box: 64 rows of 128 bytes
constexpr int kWgXBytes = kWgTokens * kWgDepth * 2;   // 4 boxes
constexpr int kWgWBytes = kWgDepth * kWgCols;         // 4 boxes
constexpr int kWgStage = kWgXBytes + kWgWBytes;
constexpr int kWgBarOff = kWgStages * kWgStage;
constexpr int kWgSmem = kWgBarOff + 64 + 1024;   // + the 1024 alignment
static_assert(kWgSmem <= 232448, "wgmma ring too large");

// One TMA box of a 2-D tensor map at (c0 innermost, c1); completion bytes
// go to `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A stage is 8 TMA boxes, all with the 128-byte swizzle (16-byte chunk c
// of a box's row r at chunk c ^ (r % 8)): x as 2 boxes of 128 tokens x
// 64 of D (the K-major B operand the descriptors read), then the weight
// as (half of D, warpgroup) boxes of 64 rows x 128 columns. Rows past T
// or D and columns past F come in as zeros.
__device__ __forceinline__ uint32_t wg_wbox(uint32_t st, int dh, int wg) {
  return st + kWgXBytes + (2 * dh + wg) * kBox;
}

// The producer warp: every slab of the split through the ring.
__device__ __forceinline__ void wg_producer(const CUtensorMap* tm_x,
                                            const CUtensorMap* tm_w,
                                            uint32_t base, uint32_t bar,
                                            int t0, int f0, int d_begin,
                                            int n_k) {
  if ((threadIdx.x & 31) != 0) return;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kWgStages;
    const uint32_t phase = (kt / kWgStages) & 1;
    mbar_wait(bar + 8 * (kWgStages + s), phase ^ 1);   // empty
    const uint32_t full = bar + 8 * s, st = base + s * kWgStage;
    const int d0 = d_begin + kt * kWgDepth;
    mbar_expect_tx(full, kWgStage);
    for (int dh = 0; dh < 2; ++dh) {
      tma_box(st + dh * 2 * kBox, tm_x, full, d0 + 64 * dh, t0);
      for (int wg = 0; wg < 2; ++wg)
        tma_box(wg_wbox(st, dh, wg), tm_w, full, f0 + 128 * wg,
                d0 + 64 * dh);
    }
  }
}

// A fragments of step kk for both 64-column halves of the warpgroup:
// the thread's word (columns 4g .. 4g + 3 of warp w's 32) of D rows
// 16kk + {2t, 2t + 1, 2t + 8, 2t + 9}; half h takes bytes 2h (row g) and
// 2h + 1 (row g + 8). In the swizzled box those rows' chunks fall in
// distinct banks.
__device__ __forceinline__ void wg_a_frags(const uint8_t* box, int kk4,
                                           int w, int g, int tq,
                                           uint32_t (&a)[2][4]) {
  const int ch = 2 * w + (g >> 2), off = 4 * (g & 3);
  uint32_t wr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 16 * kk4 + 2 * tq + (r & 1) + 8 * (r >> 1);
    wr[r] = *reinterpret_cast<const uint32_t*>(
        box + row * 128 + ((ch ^ (row & 7)) << 4) + off);
  }
  a[0][0] = i8_pair<0>(wr[0], wr[1]);
  a[0][1] = i8_pair<1>(wr[0], wr[1]);
  a[0][2] = i8_pair<0>(wr[2], wr[3]);
  a[0][3] = i8_pair<1>(wr[2], wr[3]);
  a[1][0] = i8_pair<2>(wr[0], wr[1]);
  a[1][1] = i8_pair<3>(wr[0], wr[1]);
  a[1][2] = i8_pair<2>(wr[2], wr[3]);
  a[1][3] = i8_pair<3>(wr[2], wr[3]);
}

// Grid: (token tiles of 128, column tiles of 256, splits of D);
// warpgroup 0 is the producer, warpgroups 1 and 2 the consumers (on
// columns [0, 128) and [128, 256) of the tile).
__global__ void __launch_bounds__(kWgThreads, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const float* __restrict__ scales, bf16* __restrict__ y,
                      float* __restrict__ part, int* __restrict__ tickets,
                      int T, int D, int F, int d_per_split) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the boxes so
  // that TMA and the descriptors agree on its phase.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bar = base + kWgBarOff;
  const int t0 = blockIdx.x * kWgTokens, f0 = blockIdx.y * kWgCols;
  const int split = blockIdx.z, splits = gridDim.z;
  const int d_begin = split * d_per_split;
  const int d_end = min(D, d_begin + d_per_split);
  const int n_k = (d_end - d_begin + kWgDepth - 1) / kWgDepth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bar + 8 * s, 1);                // full: the producer
      mbar_init(bar + 8 * (kWgStages + s), 8);  // empty: the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never reconverging, so that ptxas
  // can honour setmaxnreg.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32)
      wg_producer(&tm_x, &tm_w, base, bar, t0, f0, d_begin, n_k);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = (threadIdx.x >> 7) - 1, w = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    uint32_t a[2][2][4];   // two steps' fragments: one converts, one runs
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(bar + 8 * s, (kt / kWgStages) & 1);   // full
      const uint32_t st = base + s * kWgStage;
      // Each step converts its fragments while the step before runs; the
      // slab's products are retired before its stage is released.
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        uint32_t (&ak)[2][4] = a[kk & 1];
        if (kk >= 2) {
          wgmma_wait<1>();   // step kk - 2, which read these registers
          fence_regs(ak[0]);
          fence_regs(ak[1]);
        }
        wg_a_frags(smem + (wg_wbox(st, kk / 4, wg) - base), kk % 4, w, g,
                   tq, ak);
        const uint64_t b = kmajor_desc<kWgTokens>(st, kk);
        wgmma_fence();
        wgmma_rs<0>(acc[0], ak[0], b);
        wgmma_rs<0>(acc[1], ak[1], b);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(a[0][0]);
      fence_regs(a[0][1]);
      fence_regs(a[1][0]);
      fence_regs(a[1][1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (kWgStages + s));   // empty
    }

    // acc[h][4j + e]: column 2h + e / 2 of the thread's 4, token
    // 8j + 2tq + e % 2.
    const int fc = f0 + wg * 128 + w * 32 + 4 * g;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        put4(y, part, scales, T, F, split, splits, t0 + 8 * j + 2 * tq + e,
             fc, make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                             acc[1][4 * j + e], acc[1][4 * j + 2 + e]));
    if (splits > 1)
      merge_splits(y, part, scales, tickets,
                   blockIdx.y * gridDim.x + blockIdx.x, T, F, splits, t0,
                   min(kWgTokens, T - t0), f0, kWgCols, 128, 256);
  }
}

// A row-major [rows, cols] tensor of `elem`-byte values read in boxes of
// `box_rows` rows x 128 bytes with the 128-byte swizzle; out-of-bounds
// reads are zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int elem, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <class K>
cudaError_t allow_smem(K kernel, int bytes, unsigned& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (ready >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) ready |= 1u << dev;
  return err;
}

template <int NT, class XT>
int launch(const void* x, const void* w, const void* scales, void* y,
           void* part, void* tickets, int T, int D, int F, int d_per_split,
           int splits, int vec, cudaStream_t stream) {
  auto kernel = int8_mma_kernel<NT, XT>;
  const int smem = Ring<NT, XT>::kSmem;
  static unsigned ready = 0;   // devices whose limit is raised, by bit
  const cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + NT - 1) / NT, (F + kCols - 1) / kCols, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<XT*>(y),
      static_cast<float*>(part), static_cast<int*>(tickets), T, D, F,
      d_per_split, vec);
  return static_cast<int>(cudaGetLastError());
}

template <class XT>
int dispatch(int nt, const void* x, const void* w, const void* scales,
             void* y, void* part, void* tickets, int T, int D, int F,
             int d_per_split, int splits, int vec, cudaStream_t stream) {
  switch (nt) {
    case 8:
      return launch<8, XT>(x, w, scales, y, part, tickets, T, D, F,
                           d_per_split, splits, vec, stream);
    case 16:
      return launch<16, XT>(x, w, scales, y, part, tickets, T, D, F,
                            d_per_split, splits, vec, stream);
    case 32:
      return launch<32, XT>(x, w, scales, y, part, tickets, T, D, F,
                            d_per_split, splits, vec, stream);
    case 64:
      return launch<64, XT>(x, w, scales, y, part, tickets, T, D, F,
                            d_per_split, splits, vec, stream);
    case 128:
      return launch<128, XT>(x, w, scales, y, part, tickets, T, D, F,
                             d_per_split, splits, vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_wgmma(const void* x, const void* w, const void* scales, void* y,
                 void* part, void* tickets, int T, int D, int F,
                 int d_per_split, int splits, cudaStream_t stream) {
  // The tensor maps of this call's x and weight, built on the host and
  // passed by value; an encoding that CUDA refuses is not launched.
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, T, D,
                  kWgTokens) ||
      !tensor_map(&tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, F, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned ready = 0;
  const cudaError_t err = allow_smem(int8_wgmma_kernel, kWgSmem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kWgTokens - 1) / kWgTokens, (F + kWgCols - 1) / kWgCols,
                  splits);
  int8_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      tm_x, tm_w, static_cast<const float*>(scales), static_cast<bf16*>(y),
      static_cast<float*>(part), static_cast<int*>(tickets), T, D, F,
      d_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch. The plan (body, nt, d_per_split, splits) comes from
// ops/quant.plan: body 0 is int8_mma_kernel at token tile nt, body 1
// int8_wgmma_kernel (bf16 x, nt 128, vec 16, d_per_split a multiple of
// 128). vec (16, 8 or 4) is the widest copy that F's rows and the
// weight's address allow. Needs T > 0, D % 8 == 0, F % 4 == 0, x and y
// 16-byte aligned, d_per_split a multiple of 64 and splits =
// ceil(D / d_per_split); part and tickets when splits > 1. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           void* y, void* part, void* tickets, int x_is_bf16,
                           int T, int D, int F, int body, int nt,
                           int d_per_split, int splits, int vec,
                           void* stream) {
  if (T < 1 || D < 1 || D % 8 || F < 4 || F % 4 || d_per_split < 1 ||
      d_per_split % kDepth || splits < 1 ||
      (D + d_per_split - 1) / d_per_split != splits ||
      (splits > 1 && (!part || !tickets)) ||
      (vec != 16 && vec != 8 && vec != 4) || (F + kCols - 1) / kCols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!x_is_bf16 || nt != kWgTokens || vec != 16 ||
        d_per_split % kWgDepth)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(x, w, scales, y, part, tickets, T, D, F, d_per_split,
                        splits, s);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_bf16)
    return dispatch<bf16>(nt, x, w, scales, y, part, tickets, T, D, F,
                          d_per_split, splits, vec, s);
  return dispatch<float>(nt, x, w, scales, y, part, tickets, T, D, F,
                         d_per_split, splits, vec, s);
}
