// Flash attention for training: the forward (K4) and the two backward
// kernels (K5: dq, K6: dk and dv), bf16 in, f32 accumulators.
//
// K4 replaces the TPU kernel container_engine_accelerators_tpu/ops/
// flash_attention.py::_fwd (_fwd_kernel, pl.pallas_call at line 231),
// K5 ...::_flash_bwd_rule's dq call (_bwd_dq_kernel, line 475) and K6 its
// dk/dv call (_bwd_dkv_kernel, line 523). Same functions, in the JAX
// layout, with no repeated KV copy:
//   q      [B, S, Hq, D] bf16, pre-scaled by D^-0.5 and rounded to bf16
//          by the caller (the Pallas wrapper does the same)
//   k, v   [B, S, Hkv, D] bf16; q head h reads KV head h / (Hq / Hkv)
//   seg    [B, S] f32 segment ids, or null: a key is visible only from
//          a query of the same segment
//   out    [B, S, Hq, D] bf16; lse [B, Hq, S] f32
//   do     [B, S, Hq, D] bf16; delta = sum(do * out) [B, Hq, S] f32
//   dq     [B, S, Hq, D] bf16, w.r.t. the scaled q (the caller multiplies
//          by D^-0.5); dk, dv [B, S, Hkv, D] bf16
// Masked scores are NEG_INF = -1e30 (not -inf), updated in the Pallas
// body's order, so a tile that is fully masked before the row's first
// live key adds garbage that the next live tile's alpha = 0 wipes, as on
// the TPU. p is rounded to bf16 before P.V and P^T.dO, ds before
// ds.K and ds^T.q; m, l and every accumulator are f32; l is clamped to
// 1e-30 before lse = m + log(l).
//
// What bounds them on an H100: operations. At B 4, S 2048, 32 q heads,
// D 128, causal, K4 does 137 GFLOP (0.139 ms at 989 TFLOP/s bf16), K5
// 206 and K6 275, against ~0.05 ms of bytes each. So the products run on
// the tensor cores and the softmax runs on the accumulators in registers
// (FlashAttention-2's scheme). No blocks above the diagonal are visited,
// so the TPU's 'rect' and 'tri' causal grids are one schedule here.
//
// K4 is built for Hopper (sm_90a): TMA, mbarriers, warp specialisation
// and wgmma, the tensor-core path that reaches the full bf16 rate.
//   - One CTA per (q tile of 128 rows, q head, batch row), heavy (late)
//     q tiles first; 3 warpgroups. WG0 is the producer: setmaxnreg gives
//     its registers away, and one warp walks the key tiles, one lane
//     issuing the TMA loads. WG1 and WG2 consume, 64 query rows each.
//   - Shared memory (dynamic, ~227 KiB): the Q tile, loaded once, and a
//     ring of 3 stages of K and V tiles of 128 keys x 128 dims, each
//     stage with a full barrier for K, one for V and an empty barrier.
//     Every tile is two TMA boxes of 128 rows x 64 dims (a 128-byte
//     row), stored with the 128-byte swizzle that wgmma reads. Three
//     stages, because a consumer holds two (tile j's V, tile j + 1's K)
//     while the third fills.
//   - S = Q.K^T: wgmma m64n128k16, A (Q) and B (K) from shared memory,
//     both K-major, 8 steps over D. The online softmax runs on the
//     accumulator in registers; a thread holds rows g and g + 8 of its
//     warp's 16, as with mma.sync, so a row's max and sum are quad
//     shuffles. It uses ex2.approx with log2(e) folded in, p =
//     2^(s log2e - m log2e) in one FMA; lse stays natural, m + log(l).
//     A row whose keys are all masked so far takes scale 0, so its
//     garbage p and alpha are 0 where Pallas has exp(0) = 1: the first
//     live tile's alpha = 0 wipes either alike. Causal masking touches
//     the diagonal tile only.
//   - O += P.V: wgmma m64n128k16 with A = P packed to bf16 in registers
//     (the accumulator layout is the A fragment layout) and B = V from
//     shared memory as an MN-major (transposed) operand. A consumer
//     warp releases a stage only after wgmma.wait_group has retired
//     every product that read it.
//   - Softmax beside the tensor cores: a consumer issues tile j + 1's
//     Q.K^T and tile j's P.V together and runs tile j + 1's softmax
//     while P.V is in flight; and the two consumers take turns on named
//     barriers, so one issues its products while the other does its
//     softmax (FlashAttention-3's intra-warpgroup overlap and ping-pong).
//   - Segment ids: the producer warp reads a key tile's 128 ids, and a
//     tile whose [min, max] does not meet the q tile's is never loaded.
//     That is exact for any ids: disjoint ranges have no equal pair,
//     every row sees its own key, and a fully masked tile changes no
//     bit (before a row's first live key its garbage is wiped by
//     alpha = 0, after it p = 0). A live tile's ids go to shared memory
//     beside it, and a tile of one segment equal to the q tile's one is
//     not masked at all.
// K4 takes S a multiple of 128 (the JAX kernel's own gate).
//
// K5 and K6 use mma.sync m16n8k16 (bf16 in, f32 out) from 4 warps:
//   - K5: one CTA per (q tile of 64, q head, batch row), a warp per 16
//     query rows, looping over 64-key tiles up to the diagonal; Q and dO
//     stay in shared memory, K/V tiles stream;
//   - K6: one CTA per (k tile of 64, KV head, batch row), a warp per 16
//     keys, looping over the Hq/Hkv q heads of its group and over 32-row
//     q tiles from the diagonal on. dk and dv sum the whole group in f32
//     and round once; no KV head is repeated in memory and no atomics
//     are used, so every kernel is deterministic.
// Their tiles come in with 16-byte loads and sit in shared memory with
// rows padded by 16 bytes, so fragment reads are free of bank conflicts.
#include <cuda.h>           // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;              // head_dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;            // q rows (K5) or keys (K6) a CTA
constexpr int kKeyTile = 64;         // keys per step of K5
constexpr int kQTile = 32;           // q rows per step of K6
constexpr int kStride = kD + 8;      // smem row, in bf16: 272 bytes
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragments of mma.m16n8k16, lane = 4 * g + t. A is 16x16 (rows r0.., k
// k0..) of a row-major smem tile X.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* X, int r0,
                                       int k0, int g, int t) {
  a[0] = word(X + (r0 + g) * kStride + k0 + 2 * t);
  a[1] = word(X + (r0 + g + 8) * kStride + k0 + 2 * t);
  a[2] = word(X + (r0 + g) * kStride + k0 + 8 + 2 * t);
  a[3] = word(X + (r0 + g + 8) * kStride + k0 + 8 + 2 * t);
}

// B is 16x8 (k x n). load_b: the tile holds X[n][k] (B^T row-major, as K
// for Q.K^T); load_b_t: it holds X[k][n] (as V for P.V).
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* X, int n0,
                                       int k0, int g, int t) {
  b[0] = word(X + (n0 + g) * kStride + k0 + 2 * t);
  b[1] = word(X + (n0 + g) * kStride + k0 + 8 + 2 * t);
}

__device__ __forceinline__ void load_b_t(uint32_t b[2], const bf16* X,
                                         int k0, int n0, int g, int t) {
  const bf16* p = X + (k0 + 2 * t) * kStride + n0 + g;
  b[0] = pack(p[0], p[kStride]);
  b[1] = pack(p[8 * kStride], p[9 * kStride]);
}

// `rows` rows of D bf16 from global (row pitch `pitch` elements) into a
// padded smem tile, 16 bytes per thread per step.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, size_t pitch) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * pitch + c * 8);
  }
}

// The accumulator of an m16n8 product: c[0], c[1] are row g, columns
// 2t, 2t+1; c[2], c[3] row g+8. Scores of a tile are masked in place.
template <int NT>
__device__ __forceinline__ void mask_scores(float (*s)[4], int row0,
                                            int col0, bool causal_tile,
                                            const float* seg_row,
                                            const float* seg_col, int g,
                                            int t, bool rows_are_q) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + (e >= 2 ? 8 : 0);
      const int col = col0 + 8 * j + 2 * t + (e & 1);
      const int qi = rows_are_q ? row : col, ki = rows_are_q ? col : row;
      if (causal_tile && qi < ki) s[j][e] = kNegInf;
      if (seg_row != nullptr && seg_row[row] != seg_col[col])
        s[j][e] = kNegInf;
    }
}

// ------------------------------------------------------------------ K4

constexpr int kFwdRows = 128;                // q rows a CTA
constexpr int kFwdKeys = 128;                // keys a tile
constexpr int kFwdStages = 3;                // depth of the K/V ring
constexpr int kFwdThreads = 3 * 128;         // producer WG + 2 consumer WGs
constexpr int kBoxBytes = kFwdKeys * 64 * 2; // one TMA box: 128 rows x 64 dims
constexpr int kTileBytes = 2 * kBoxBytes;    // 128 rows x 128 dims
constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
constexpr int kKvOff = kTileBytes;           // the ring, after Q
constexpr int kBarOff = kKvOff + kFwdStages * kStageBytes;
constexpr int kMetaOff = kBarOff + 128;      // per stage: key tile, masked
constexpr int kSegOff = kBarOff + 256;       // per stage: 128 key ids
constexpr int kFwdSmem = kSegOff + kFwdStages * kFwdKeys * 4 +
                         1024;               // + the 1024-byte alignment
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(8 * (1 + 3 * kFwdStages) <= kMetaOff - kBarOff &&
                  8 * kFwdStages <= kSegOff - kMetaOff,
              "barriers and stage records overlap");
static_assert(kFwdSmem <= 232448, "more shared memory than a block has");
static_assert(kFwdRows == kFwdKeys, "causal: q tile i's diagonal is key tile i");
constexpr float kLog2e = 1.4426950408889634f;

// The mbarriers, at kBarOff: Q, then per stage K full, V full, empty.
__device__ __forceinline__ uint32_t q_full(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t k_full(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t v_full(uint32_t bar, int s) {
  return bar + 8 * (1 + kFwdStages + s);
}
__device__ __forceinline__ uint32_t stage_empty(uint32_t bar, int s) {
  return bar + 8 * (1 + 2 * kFwdStages + s);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase `parity` has completed. The loop stays
// inside the asm, so the compiler sees no divergent branch around the
// wgmma products that are in flight across a wait.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A value that every lane of the warp read from the same shared-memory
// word, broadcast from lane 0 so that ptxas knows it is warp-uniform.
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// One TMA box of a [B, S, H, 128] tensor: 64 dims from d0, one head,
// 128 rows from row0, one batch row; completion bytes go to `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int d0, int head,
                                        int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head),
      "r"(row0), "r"(b)
      : "memory");
}

// A 128 x 128 tile: the two boxes, dims 0-63 then 64-127.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int b) {
  tma_box(dst, map, bar, 0, head, row0, b);
  tma_box(dst + kBoxBytes, map, bar, 64, head, row0, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1);
// the address and both offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q as A, K as B), step kk of 16 dims: box kk / 4, then
// 32 bytes a step inside the 128-byte row (the hardware applies the
// swizzle to the computed address); 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (V as B, N = dims), step kk of 16 keys: 16 rows of
// 128 bytes; the two 64-dim boxes are LBO apart, 8-key groups SBO.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kBoxBytes, 1024);
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

// Keep the compiler from touching registers that an asynchronous wgmma
// reads or writes across the wait that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D64                                                        \
  WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),     \
      WG_D8(48), WG_D8(56)
#define WG_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; accumulate = 0 overwrites d. The accumulator of thread
// (warp w, lane 4g + t): d[4j + e] is row 16w + g + 8(e / 2), column
// 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the mma.sync
// A fragment of each warp's 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Named barriers 1 and 2 take turns between the consumer warpgroups
// (barrier 0 is __syncthreads): a warpgroup issues its products only
// between bar.sync on its own barrier and bar.arrive on the other's,
// so one warpgroup's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Warp 0 of WG0: Q once, then every live key tile through the ring, then
// a sentinel stage (key tile -1). Lane l reads ids 4l..4l+3 of a tile.
__device__ __forceinline__ void fwd_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    uint32_t base, uint32_t bar, int* meta, float* seg_s, const float* segb,
    int q0, int h, int kvh, int b, int n_tiles) {
  const int lane = threadIdx.x;
  float qmin = 0.f, qmax = 0.f;
  if (segb != nullptr) {
    const float4 x = reinterpret_cast<const float4*>(segb + q0)[lane];
    qmin = warp_min(fminf(fminf(x.x, x.y), fminf(x.z, x.w)));
    qmax = warp_max(fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
  if (lane == 0) {
    mbar_expect_tx(q_full(bar), kTileBytes);
    tma_tile(base, tm_q, q_full(bar), h, q0, b);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    float4 ids = make_float4(0.f, 0.f, 0.f, 0.f);
    int masked = 0;
    if (segb != nullptr) {
      ids = reinterpret_cast<const float4*>(segb + kt * kFwdKeys)[lane];
      const float kmin = warp_min(fminf(fminf(ids.x, ids.y),
                                        fminf(ids.z, ids.w)));
      const float kmax = warp_max(fmaxf(fmaxf(ids.x, ids.y),
                                        fmaxf(ids.z, ids.w)));
      if (kmax < qmin || kmin > qmax) continue;   // no equal pair: skip
      masked = !(kmin == kmax && qmin == qmax && kmin == qmin);
    }
    mbar_wait(stage_empty(bar, stage), phase ^ 1);
    reinterpret_cast<float4*>(seg_s + stage * kFwdKeys)[lane] = ids;
    if (lane == 0) {
      meta[2 * stage] = kt;
      meta[2 * stage + 1] = masked;
      const uint32_t kv = base + kKvOff + stage * kStageBytes;
      mbar_expect_tx(k_full(bar, stage), kTileBytes);
      tma_tile(kv, tm_k, k_full(bar, stage), kvh, kt * kFwdKeys, b);
      mbar_expect_tx(v_full(bar, stage), kTileBytes);
      tma_tile(kv + kTileBytes, tm_v, v_full(bar, stage), kvh,
               kt * kFwdKeys, b);
    } else {
      mbar_arrive(k_full(bar, stage));   // releases this lane's ids
    }
    if (++stage == kFwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(stage_empty(bar, stage), phase ^ 1);
  if (lane == 0) meta[2 * stage] = -1;
  mbar_arrive(k_full(bar, stage));
}

// 2^x in one MUFU instruction; a subnormal result flushes to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Masks a key tile's scores (the diagonal tile; ids where the tile is
// not one segment equal to the q tile's), then takes the online
// softmax's step on rows g (r = 0) and g + 8 (r = 1), whose four lanes
// form a quad: s becomes p in f32, m and l move on, and alpha is what
// the output accumulator must be scaled by. The accumulator itself is
// left alone: a product may still be adding into it.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool diag, bool masked, const float* ids, const float (&qseg)[2],
    int row, int t) {
  if (diag || masked) {
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 kid = masked
          ? *reinterpret_cast<const float2*>(ids + col)
          : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        if (diag && col + (e & 1) > row + 8 * r) s[4 * j + e] = kNegInf;
        if (masked && qseg[r] != ((e & 1) ? kid.y : kid.x))
          s[4 * j + e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    // A row whose keys are all masked so far takes scale 0, so its p
    // and alpha are 0 where Pallas has exp(0) = 1: finite either way,
    // and the first live tile's alpha = 0 wipes both alike.
    const float ml = m_new == kNegInf ? 0.f : m_new * kLog2e;
    alpha[r] = ex2(fmaf(m[r], kLog2e, -ml));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, -ml));
        sum += s[4 * j + e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_new;
  }
}

// p (f32 in s) to bf16: n8 blocks 2kk and 2kk + 1 of the accumulator
// are the A fragment of keys 16kk..16kk+15.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack(s[2 * i], s[2 * i + 1]);
}

// o *= alpha, per row.
__device__ __forceinline__ void rescale(float (&o)[64],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i / 2) % 2];
}

// WG1 or WG2: 64 query rows, over the key tiles the producer delivers.
// Tile j + 1's Q.K^T is issued before tile j's P.V, and its softmax runs
// while P.V is on the tensor cores.
__device__ __forceinline__ void fwd_consumer(
    uint32_t base, uint32_t bar, const int* meta, const float* seg_s,
    const float* segb, bf16* __restrict__ out, float* __restrict__ lse,
    int S, int Hq, int h, int b, int q_tile, int causal) {
  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = cw * 64 + warp * 16 + g;   // in the q tile; and row + 8
  const int q0 = q_tile * kFwdRows;
  float qseg[2] = {0.f, 0.f};
  if (segb != nullptr) {
    qseg[0] = segb[q0 + row];
    qseg[1] = segb[q0 + row + 8];
  }
  float o[64], s[64], alpha[2];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = base + cw * 64 * 128;   // row 64 cw of each box
  auto k_addr = [&](int stage) { return base + kKvOff + stage * kStageBytes; };

  // The first tile: there always is one (every row sees its own key).
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(q_full(bar), 0);
  mbar_wait(k_full(bar, 0), 0);
  const int kt = uniform(meta[0]);
  // Turns: WG1 goes first; each warpgroup passes the turn after each of
  // its issues, WG2 not after its last, so every bar.arrive is matched.
  if (cw == 1) turn_pass(cw);
  turn_wait(cw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(s, kmajor_desc(q_addr, kk), kmajor_desc(k_addr(0), kk), kk);
  wgmma_commit();
  turn_pass(cw);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m, l, alpha, causal && kt == q_tile, uniform(meta[1]),
               seg_s, qseg, row, t);
  // Every pass issues the same products in the same order, with no
  // branch between a product and the wait that retires it, so ptxas
  // keeps them asynchronous; the last tile's P.V follows the loop.
  for (;;) {
    pack_p(s, p);
    const int next = stage + 1 == kFwdStages ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    mbar_wait(k_full(bar, next), next_phase);
    const int kt_next = uniform(meta[2 * next]);
    if (kt_next < 0) break;   // the sentinel: no more tiles
    mbar_wait(v_full(bar, stage), phase);
    turn_wait(cw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(s, kmajor_desc(q_addr, kk), kmajor_desc(k_addr(next), kk),
               kk);
    wgmma_commit();
    rescale(o, alpha);   // while Q.K^T runs
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
      wgmma_rs(o, p + 4 * kk,
               mnmajor_desc(k_addr(stage) + kTileBytes, kk));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<1>();   // Q.K^T of the next tile; P.V still running
    fence_regs(s);
    softmax_tile(s, m, l, alpha, causal && kt_next == q_tile,
                 uniform(meta[2 * next + 1]), seg_s + next * kFwdKeys, qseg,
                 row, t);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(stage_empty(bar, stage));
    stage = next;
    phase = next_phase;
  }
  rescale(o, alpha);
  mbar_wait(v_full(bar, stage), phase);
  turn_wait(cw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk)
    wgmma_rs(o, p + 4 * kk, mnmajor_desc(k_addr(stage) + kTileBytes, kk));
  wgmma_commit();
  if (cw == 0) turn_pass(cw);
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_row = q0 + row + 8 * r;
    const float lr = fmaxf(l[r], 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * S + q_row) * Hq * kD + (size_t)h * kD);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[j * 4 + t] = __floats2bfloat162_rn(o[4 * j + 2 * r] / lr,
                                             o[4 * j + 2 * r + 1] / lr);
    if (t == 0) lse[((size_t)b * Hq + h) * S + q_row] = m[r] + logf(lr);
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ seg, bf16* __restrict__ out,
                 float* __restrict__ lse, int S, int Hq, int Hkv,
                 int causal) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles so
  // that TMA and the wgmma descriptors agree on its phase.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bar = base + kBarOff;
  int* meta = reinterpret_cast<int*>(smem + kMetaOff);
  float* seg_s = reinterpret_cast<float*>(smem + kSegOff);
  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full(bar), 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(k_full(bar, s), 32);   // the producer warp's lanes
      mbar_init(v_full(bar, s), 1);
      mbar_init(stage_empty(bar, s), 8);     // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never reconverging, so that ptxas
  // can honour setmaxnreg.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32)
      fwd_producer(&tm_q, &tm_k, &tm_v, base, bar, meta, seg_s, segb,
                   q_tile * kFwdRows, h, h / (Hq / Hkv), b,
                   causal ? q_tile + 1 : S / kFwdKeys);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    fwd_consumer(base, bar, meta, seg_s, segb, out, lse, S, Hq, h, b, q_tile,
                 causal);
  }
}

#undef WG_D8
#undef WG_D64
#undef WG_REGS

// ------------------------------------------------------------------ K5

constexpr int kDqSmem = 4 * kTile * kStride * sizeof(bf16);

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ seg,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int Hq, int Hkv, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTile * kStride;
  bf16* k_s = do_s + kTile * kStride;
  bf16* v_s = k_s + kKeyTile * kStride;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = q_tile * kTile;
  const int r0 = q0 + warp * 16;
  const size_t q_pitch = (size_t)Hq * kD, kv_pitch = (size_t)Hkv * kD;
  const size_t head = (size_t)b * S * Hq + h;
  const bf16* kb = k + ((size_t)b * S * Hkv + kvh) * kD;
  const bf16* vb = v + ((size_t)b * S * Hkv + kvh) * kD;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;
  const float* lse_h = lse + ((size_t)b * Hq + h) * S;
  const float* delta_h = delta + ((size_t)b * Hq + h) * S;

  load_tile(q_s, q + head * kD + q0 * q_pitch, kTile, q_pitch);
  load_tile(do_s, dout + head * kD + q0 * q_pitch, kTile, q_pitch);
  const float row_lse[2] = {lse_h[r0 + g], lse_h[r0 + g + 8]};
  const float row_delta[2] = {delta_h[r0 + g], delta_h[r0 + g + 8]};

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = causal ? (q0 + kTile) / kKeyTile : S / kKeyTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeyTile;
    __syncthreads();
    load_tile(k_s, kb + k0 * kv_pitch, kKeyTile, kv_pitch);
    load_tile(v_s, vb + k0 * kv_pitch, kKeyTile, kv_pitch);
    __syncthreads();

    float s[kKeyTile / 8][4], dp[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, q_s, warp * 16, kk * 16, g, t);
      load_a(ado, do_s, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        uint32_t bk[2], bv[2];
        load_b(bk, k_s, j * 8, kk * 16, g, t);
        load_b(bv, v_s, j * 8, kk * 16, g, t);
        mma(s[j], aq, bk);
        mma(dp[j], ado, bv);
      }
    }
    mask_scores<kKeyTile / 8>(s, r0, k0,
                              causal && k0 + kKeyTile - 1 > q0, segb, segb,
                              g, t, true);
    // ds = p * (dp - delta), p = exp(s - lse); kept in s.
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = expf(s[j][e] - row_lse[r]) * (dp[j][e] - row_delta[r]);
      }
    // acc += ds.bf16 @ K
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        uint32_t bf[2];
        load_b_t(bf, k_s, kk * 16, j * 8, g, t);
        mma(acc[j], a, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        dq + head * kD + (size_t)(r0 + g + 8 * r) * q_pitch);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[j * 4 + t] = __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ K6

constexpr int kDkvSmem = (2 * kTile + 2 * kQTile) * kStride * sizeof(bf16) +
                         2 * kQTile * sizeof(float);

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ seg,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Hq, int Hkv,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTile * kStride;
  bf16* q_s = v_s + kTile * kStride;
  bf16* do_s = q_s + kQTile * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kQTile * kStride);
  float* delta_s = lse_s + kQTile;
  const int k_tile = blockIdx.x;      // early key tiles see the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = k_tile * kTile;
  const int r0 = k0 + warp * 16;       // this warp's first key
  const size_t q_pitch = (size_t)Hq * kD, kv_pitch = (size_t)Hkv * kD;
  const size_t kv_head = (size_t)b * S * Hkv + kvh;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;

  load_tile(k_s, k + kv_head * kD + k0 * kv_pitch, kTile, kv_pitch);
  load_tile(v_s, v + kv_head * kD + k0 * kv_pitch, kTile, kv_pitch);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Causal: q tiles before k0 see none of these keys.
  const int q_first = causal ? k0 / kQTile : 0;
  for (int h = kvh * n_rep; h < (kvh + 1) * n_rep; ++h) {
    const size_t head = (size_t)b * S * Hq + h;
    const float* lse_h = lse + ((size_t)b * Hq + h) * S;
    const float* delta_h = delta + ((size_t)b * Hq + h) * S;
    for (int qt = q_first; qt < S / kQTile; ++qt) {
      const int q0 = qt * kQTile;
      __syncthreads();
      load_tile(q_s, q + head * kD + q0 * q_pitch, kQTile, q_pitch);
      load_tile(do_s, dout + head * kD + q0 * q_pitch, kQTile, q_pitch);
      if (threadIdx.x < kQTile) {
        lse_s[threadIdx.x] = lse_h[q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta_h[q0 + threadIdx.x];
      }
      __syncthreads();

      // s^T = K.q^T and dp^T = V.dO^T: rows are keys, columns queries.
      float s[kQTile / 8][4], dp[kQTile / 8][4];
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, k_s, warp * 16, kk * 16, g, t);
        load_a(av, v_s, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < kQTile / 8; ++j) {
          uint32_t bq[2], bdo[2];
          load_b(bq, q_s, j * 8, kk * 16, g, t);
          load_b(bdo, do_s, j * 8, kk * 16, g, t);
          mma(s[j], ak, bq);
          mma(dp[j], av, bdo);
        }
      }
      mask_scores<kQTile / 8>(s, r0, q0, causal && k0 + kTile - 1 > q0,
                              segb, segb, g, t, false);
      // p = exp(s - lse[q]) in s; ds = p * (dp - delta[q]) in dp.
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          s[j][e] = expf(s[j][e] - lse_s[c]);
          dp[j][e] = s[j][e] * (dp[j][e] - delta_s[c]);
        }
      // dv += p^T.bf16 @ dO and dk += ds^T.bf16 @ q.
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        const uint32_t ap[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                                pack(s[2 * kk][2], s[2 * kk][3]),
                                pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t ads[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                                 pack(dp[2 * kk][2], dp[2 * kk][3]),
                                 pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                 pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          uint32_t bdo[2], bq[2];
          load_b_t(bdo, do_s, kk * 16, j * 8, g, t);
          load_b_t(bq, q_s, kk * 16, j * 8, g, t);
          mma(dv_acc[j], ap, bdo);
          mma(dk_acc[j], ads, bq);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = kv_head * kD + (size_t)(r0 + g + 8 * r) * kv_pitch;
    __nv_bfloat162* dk2 = reinterpret_cast<__nv_bfloat162*>(dk + off);
    __nv_bfloat162* dv2 = reinterpret_cast<__nv_bfloat162*>(dv + off);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      dk2[j * 4 + t] =
          __floats2bfloat162_rn(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      dv2[j * 4 + t] =
          __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// The shapes every entry point takes: D 128, S a multiple of 64 (of 128
// for K4), Hq a multiple of Hkv. Anything else returns
// cudaErrorInvalidValue unlaunched (the Python wrappers check first).
bool bad_shape(int B, int S, int Hq, int Hkv, int D) {
  return D != kD || B < 1 || S < kTile || S % kTile || Hkv < 1 ||
         Hq % Hkv;
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, S, H, 128] bf16 tensor as 4-D (innermost first: D, H, S, B),
// read in boxes of 64 dims x 1 head x 128 rows x 1 batch row with the
// 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {kD * sizeof(bf16),
                                 (cuuint64_t)H * kD * sizeof(bf16),
                                 (cuuint64_t)S * H * kD * sizeof(bf16)};
  const cuuint32_t box[4] = {64, 1, kFwdKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* seg, void* out, void* lse, int B,
                              int S, int Hq, int Hkv, int D, int causal,
                              void* stream) {
  if (bad_shape(B, S, Hq, Hkv, D) || S % kFwdRows)
    return static_cast<int>(cudaErrorInvalidValue);
  // The tensor maps of this call's q, k and v, built on the host and
  // passed by value; an encoding the driver refuses is not launched.
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, B, S, Hq) || !tensor_map(&tm_k, k, B, S, Hkv) ||
      !tensor_map(&tm_v, v, B, S, Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kFwdRows, Hq, B);
  flash_fwd_kernel<<<grid, kFwdThreads, kFwdSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(seg),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, Hq, Hkv, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* seg, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int S, int Hq, int Hkv, int D,
                                 int causal, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kTile, Hq, B);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(seg),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, Hq, Hkv,
      causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* seg, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int Hq,
                                  int Hkv, int D, int causal, void* stream) {
  if (bad_shape(B, S, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kTile, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(seg),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, Hq, Hkv, causal);
  return static_cast<int>(cudaGetLastError());
}
