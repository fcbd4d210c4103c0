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
// 206 (three products) and K6 275 (four), against ~0.05 ms of bytes
// each. So the products run on the tensor cores and the softmax runs on
// the accumulators in registers (FlashAttention-2's scheme). No blocks
// above the diagonal are visited, so the TPU's 'rect' and 'tri' causal
// grids are one schedule here. The backward stays two kernels, as on
// the TPU: a fused one (five products, not seven) would sum dq across
// CTAs by atomics, whose order changes from run to run, or through a
// per-key-tile f32 buffer of ~4 GB at these shapes; the two extra
// products are the price of a deterministic dq.
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
//
// K5 and K6 run on K4's machinery: TMA boxes into a ring of mbarrier
// stages, a producer warp, two consumer warpgroups on wgmma taking turns
// on named barriers, ex2.approx with log2(e) folded into one FMA, and
// segment-tile skipping. Each is deterministic: no atomics, every sum in
// a fixed order inside one CTA.
//   - K5 (dq): one CTA per (q tile of 128 rows, q head, batch row),
//     heavy (late) q tiles first. Q and dO of the 128 rows come in once;
//     64-key K and V tiles stream through a 4-stage ring. A consumer
//     warpgroup takes 64 rows: S = Q.K^T and dP = dO.V^T are wgmma
//     m64n64k16 with both operands K-major in shared memory (V is read
//     K-major here), ds = p (dp - delta) with p = 2^(s log2e - lse log2e)
//     runs on the accumulators, and dQ += dS.K takes dS packed to bf16
//     from the accumulator as its A operand and the same K tile, read
//     MN-major, as B (m64n128k16). dq is rounded to bf16 once.
//   - K6 (dk, dv): one CTA per (key tile of 128, KV head, batch row),
//     early key tiles first; K and V stay resident. The producer walks
//     the group's q heads in order and each head's 64-row q tiles from
//     the causal diagonal on, bringing Q, dO, the tile's lse and delta
//     (bulk copies) and its ids through a 4-stage ring. A consumer
//     warpgroup takes 64 keys: S^T = K.Q^T and dP^T = V.dO^T (m64n64k16),
//     then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from the
//     accumulators as A and dO, Q read MN-major as B. The GQA group sums
//     in the same f32 accumulators, head by head, and rounds once.
//   - Softmax beside the tensor cores: the two consumer warpgroups take
//     turns on named barriers, so one computes ds while the other's
//     products run. A warpgroup issues its two steps of a tile (scores,
//     then gradients) one after the other: in K6, dK and dV hold 128
//     registers a thread and leave no room for the next tile's scores
//     in flight; in K5 that overlap measured slower than none.
//   - A tile that the causal rule or the segment ids mask whole is
//     never loaded (the producer reads both tiles' id ranges, as in K4):
//     its p would be exp(-1e30 - lse) = 0, so it adds exactly nothing;
//     the backward needs no alpha. ops/flash_attention.py writes the two
//     walks out (dq_key_tiles, dkv_q_tiles).
// All three take S a multiple of 128 (the JAX kernel's own gate).
#include <cuda.h>           // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;              // head_dim
constexpr int kSeqTile = 128;        // S is a multiple of it
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
// Registers a thread after setmaxnreg, in all three kernels: 128 x 40 +
// 256 x 232 = 64512. K6's producer spilled at 24, and 32 + 240, the whole
// file of 65536, was never granted (the kernel hung).
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
// the map's box of rows from row0, one batch row; completion bytes go to
// `bar`.
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

// A tile of Rows x 128: the two boxes, dims 0-63 then 64-127 (the map's
// box has Rows rows).
template <int Rows = 128>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int b) {
  tma_box(dst, map, bar, 0, head, row0, b);
  tma_box(dst + Rows * 128, map, bar, 64, head, row0, b);
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
// swizzle to the computed address); 8-row groups 1024 bytes apart. Rows:
// the rows of the tile's boxes, Rows x 128 bytes each.
template <int Rows = 128>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * Rows * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (V as B, N = dims), step kk of 16 keys: 16 rows of
// 128 bytes; the two 64-dim boxes are LBO apart, 8-key groups SBO.
template <int Rows = 128>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, Rows * 128, 1024);
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
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_REGS32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
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

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory;
// d[4j + e] is row 16w + g + 8(e / 2), column 8j + 2t + e % 2 as above.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
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

// [min, max] over the warp of the segment ids each lane holds.
__device__ __forceinline__ float2 warp_range(float2 x) {
  return make_float2(warp_min(fminf(x.x, x.y)), warp_max(fmaxf(x.x, x.y)));
}
__device__ __forceinline__ float2 warp_range(float4 x) {
  return warp_range(make_float2(fminf(fminf(x.x, x.y), fminf(x.z, x.w)),
                                fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w))));
}

// A streamed tile of ids against the CTA's own: skip it when the two
// [min, max] ranges are disjoint (no pair is equal); mask it unless both
// are one segment, the same.
__device__ __forceinline__ bool disjoint(float2 a, float2 b) {
  return a.y < b.x || a.x > b.y;
}
__device__ __forceinline__ int needs_mask(float2 a, float2 b) {
  return !(a.x == a.y && b.x == b.y && a.x == b.x);
}

// Warp 0 of WG0: Q once, then every live key tile through the ring, then
// a sentinel stage (key tile -1). Lane l reads ids 4l..4l+3 of a tile.
__device__ __forceinline__ void fwd_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    uint32_t base, uint32_t bar, int* meta, float* seg_s, const float* segb,
    int q0, int h, int kvh, int b, int n_tiles) {
  const int lane = threadIdx.x;
  const float2 qr =
      segb != nullptr
          ? warp_range(reinterpret_cast<const float4*>(segb + q0)[lane])
          : make_float2(0.f, 0.f);
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
      const float2 kr = warp_range(ids);
      if (disjoint(kr, qr)) continue;
      masked = needs_mask(kr, qr);
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


// ---------------------------------------------------------------- K5, K6

constexpr int kBwdStages = 4;                 // depth of each ring
constexpr int kHalfBytes = 64 * 128 * 2;      // a tile of 64 rows x 128 dims
constexpr int kBwdStageBytes = 2 * kHalfBytes;   // K and V, or Q and dO
constexpr int kBwdRingOff = 2 * kTileBytes;   // after the two 128-row tiles
constexpr int kBwdBarOff = kBwdRingOff + kBwdStages * kBwdStageBytes;
constexpr int kBwdMetaOff = kBwdBarOff + 128; // per stage: tile, masked
constexpr int kBwdAuxOff = kBwdBarOff + 256;  // per stage: 64-value records
constexpr int kDqSmem = kBwdAuxOff + kBwdStages * 64 * 4 + 1024;
constexpr int kDkvSmem = kBwdAuxOff + kBwdStages * 3 * 64 * 4 + 1024;
static_assert(8 * (1 + 2 * kBwdStages) <= kBwdMetaOff - kBwdBarOff &&
                  8 * kBwdStages <= kBwdAuxOff - kBwdMetaOff,
              "barriers and stage records overlap");
static_assert(kDkvSmem <= 232448, "more shared memory than a block has");

// The mbarriers, at kBwdBarOff: the CTA's resident tiles (K5: Q and dO;
// K6: K and V), then per stage full and empty.
__device__ __forceinline__ uint32_t bwd_full(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bwd_empty(uint32_t bar, int s) {
  return bar + 8 * (1 + kBwdStages + s);
}

__device__ __forceinline__ void bwd_init(uint32_t bar) {
  mbar_init(bar, 1);
  for (int s = 0; s < kBwdStages; ++s) {
    mbar_init(bwd_full(bar, s), 32);   // the producer warp's lanes
    mbar_init(bwd_empty(bar, s), 8);   // the consumer warps
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global to shared memory; completion
// bytes go to `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// p (f32 in s) and ds (f32 in dp) to bf16 A fragments, as pack_p.
__device__ __forceinline__ void pack32(const float (&x)[32],
                                       uint32_t (&p)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack(x[2 * i], x[2 * i + 1]);
}

// K5's producer, warp 0 of WG0: Q and dO once, then every live 64-key
// tile (K, V and its ids) through the ring, then a sentinel (tile -1).
__device__ __forceinline__ void dq_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do,
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, uint32_t base,
    uint32_t bar, int* meta, float* ids_s, const float* segb, int q0, int h,
    int kvh, int b, int n_tiles) {
  const int lane = threadIdx.x;
  const float2 qr =
      segb != nullptr
          ? warp_range(reinterpret_cast<const float4*>(segb + q0)[lane])
          : make_float2(0.f, 0.f);
  if (lane == 0) {
    mbar_expect_tx(bar, 2 * kTileBytes);
    tma_tile(base, tm_q, bar, h, q0, b);
    tma_tile(base + kTileBytes, tm_do, bar, h, q0, b);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    float2 ids = make_float2(0.f, 0.f);
    int masked = 0;
    if (segb != nullptr) {
      ids = reinterpret_cast<const float2*>(segb + kt * 64)[lane];
      const float2 kr = warp_range(ids);
      if (disjoint(kr, qr)) continue;
      masked = needs_mask(kr, qr);
    }
    mbar_wait(bwd_empty(bar, stage), phase ^ 1);
    reinterpret_cast<float2*>(ids_s + stage * 64)[lane] = ids;
    if (lane == 0) {
      meta[2 * stage] = kt;
      meta[2 * stage + 1] = masked;
      const uint32_t kv = base + kBwdRingOff + stage * kBwdStageBytes;
      mbar_expect_tx(bwd_full(bar, stage), kBwdStageBytes);
      tma_tile<64>(kv, tm_k, bwd_full(bar, stage), kvh, kt * 64, b);
      tma_tile<64>(kv + kHalfBytes, tm_v, bwd_full(bar, stage), kvh,
                   kt * 64, b);
    } else {
      mbar_arrive(bwd_full(bar, stage));   // releases this lane's ids
    }
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(bwd_empty(bar, stage), phase ^ 1);
  if (lane == 0) meta[2 * stage] = -1;
  mbar_arrive(bwd_full(bar, stage));
}

// K5's scores: s = Q.K^T and dp = dO.V^T of a 64-key tile on rows g
// (r = 0) and g + 8 (r = 1) become ds = p (dp - delta) in s, p = 2^(s
// log2e - lse log2e). A masked score is NEG_INF, whose p is exactly 0.
// `off` is the thread's query row minus the tile's first key.
__device__ __forceinline__ void dq_scores(float (&s)[32], const float (&dp)[32],
                                          bool diag, bool masked,
                                          const float* ids,
                                          const float (&qseg)[2], int off,
                                          const float (&lse2)[2],
                                          const float (&delta)[2], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 kid = masked ? *reinterpret_cast<const float2*>(ids + col)
                              : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      float x = s[4 * j + e];
      if (diag && col + (e & 1) > off + 8 * r) x = kNegInf;
      if (masked && qseg[r] != ((e & 1) ? kid.y : kid.x)) x = kNegInf;
      const float p = ex2(fmaf(x, kLog2e, -lse2[r]));
      s[4 * j + e] = p * (dp[4 * j + e] - delta[r]);
    }
  }
}

// S = Q.K^T and dP = dO.V^T of the tile in `kv` for one warpgroup's 64
// rows (q and dO at row 64 cw of the CTA's tiles).
__device__ __forceinline__ void dq_score_products(float (&s)[32],
                                                  float (&dp)[32],
                                                  uint32_t q, uint32_t d_o,
                                                  uint32_t kv) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss64(s, kmajor_desc(q, kk), kmajor_desc<64>(kv, kk), kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss64(dp, kmajor_desc(d_o, kk),
               kmajor_desc<64>(kv + kHalfBytes, kk), kk);
}

// dQ += dS.K, K of the tile in `kv` read MN-major.
__device__ __forceinline__ void dq_product(float (&acc)[64],
                                           const uint32_t (&ds)[16],
                                           uint32_t kv) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(acc, ds + 4 * kk, mnmajor_desc<64>(kv, kk));
}

// K5's WG1 or WG2: 64 query rows over the key tiles the producer
// delivers: S and dP, then ds, then dQ += dS.K, in turn with the other
// warpgroup, so one computes ds while the other's products run.
__device__ __forceinline__ void dq_consumer(
    uint32_t base, uint32_t bar, const int* meta, const float* ids_s,
    const float* segb, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int Hq,
    int h, int b, int q0, int causal) {
  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = cw * 64 + warp * 16 + g;   // in the q tile; and row + 8
  const float* lse_h = lse + ((size_t)b * Hq + h) * S + q0;
  const float* delta_h = delta + ((size_t)b * Hq + h) * S + q0;
  const float lse2[2] = {lse_h[row] * kLog2e, lse_h[row + 8] * kLog2e};
  const float dl[2] = {delta_h[row], delta_h[row + 8]};
  float qseg[2] = {0.f, 0.f};
  if (segb != nullptr) {
    qseg[0] = segb[q0 + row];
    qseg[1] = segb[q0 + row + 8];
  }
  float acc[64], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t q_addr = base + cw * 64 * 128;   // row 64 cw of each box
  const uint32_t do_addr = q_addr + kTileBytes;
  auto kv_addr = [&](int stage) {
    return base + kBwdRingOff + stage * kBwdStageBytes;
  };
  // The warpgroup's rows meet a key tile's diagonal from its first key
  // q0 + 64 cw on.
  auto diag = [&](int kt) { return causal && kt * 64 >= q0 + cw * 64; };

  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(bar, 0);
  // Turns as in fwd_consumer, two a tile; WG1 takes WG2's last pass
  // after the loop, so every bar.arrive is matched.
  if (cw == 1) turn_pass(cw);
  for (;;) {
    mbar_wait(bwd_full(bar, stage), phase);
    const int kt = uniform(meta[2 * stage]);
    if (kt < 0) break;   // the sentinel: no more tiles
    turn_wait(cw);
    wgmma_fence();
    dq_score_products(s, dp, q_addr, do_addr, kv_addr(stage));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dq_scores(s, dp, diag(kt), uniform(meta[2 * stage + 1]),
              ids_s + stage * 64, qseg, q0 + row - kt * 64, lse2, dl, t);
    pack32(s, ds);
    turn_wait(cw);
    wgmma_fence();
    dq_product(acc, ds, kv_addr(stage));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(bwd_empty(bar, stage));
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (cw == 0) turn_wait(cw);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        dq + ((size_t)b * S + q0 + row + 8 * r) * Hq * kD + (size_t)h * kD);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[j * 4 + t] = __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                             acc[4 * j + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ seg,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int Hq, int Hkv, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bar = base + kBwdBarOff;
  int* meta = reinterpret_cast<int*>(smem + kBwdMetaOff);
  float* ids_s = reinterpret_cast<float*>(smem + kBwdAuxOff);
  // Heavy (late) q tiles first, every head and batch row of a q tile
  // together.
  const int q_tile = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;

  if (threadIdx.x == 0) bwd_init(bar);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32)
      dq_producer(&tm_q, &tm_do, &tm_k, &tm_v, base, bar, meta, ids_s, segb,
                  q_tile * kSeqTile, h, h / (Hq / Hkv), b,
                  causal ? 2 * q_tile + 2 : S / 64);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    dq_consumer(base, bar, meta, ids_s, segb, lse, delta, dq, S, Hq, h, b,
                q_tile * kSeqTile, causal);
  }
}

// K6's producer, warp 0 of WG0: K and V once, then for each q head of
// the group in order, every live 64-row q tile from the diagonal on (Q,
// dO, its lse, delta and ids) through the ring, then a sentinel.
__device__ __forceinline__ void dkv_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do,
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, uint32_t base,
    uint32_t bar, int* meta, float* aux, const float* segb,
    const float* __restrict__ lse, const float* __restrict__ delta, int k0,
    int kvh, int b, int S, int Hq, int n_rep, int causal) {
  const int lane = threadIdx.x;
  const float2 kr =
      segb != nullptr
          ? warp_range(reinterpret_cast<const float4*>(segb + k0)[lane])
          : make_float2(0.f, 0.f);
  if (lane == 0) {
    mbar_expect_tx(bar, 2 * kTileBytes);
    tma_tile(base, tm_k, bar, kvh, k0, b);
    tma_tile(base + kTileBytes, tm_v, bar, kvh, k0, b);
  }
  const int q_first = causal ? k0 / 64 : 0;   // earlier rows see no key
  int stage = 0;
  uint32_t phase = 0;
  for (int h = kvh * n_rep; h < (kvh + 1) * n_rep; ++h) {
    const size_t stats = ((size_t)b * Hq + h) * S;
    for (int qt = q_first; qt < S / 64; ++qt) {
      float2 ids = make_float2(0.f, 0.f);
      int masked = 0;
      if (segb != nullptr) {
        ids = reinterpret_cast<const float2*>(segb + qt * 64)[lane];
        const float2 qr = warp_range(ids);
        if (disjoint(qr, kr)) continue;
        masked = needs_mask(qr, kr);
      }
      mbar_wait(bwd_empty(bar, stage), phase ^ 1);
      float* rec = aux + stage * 3 * 64;   // lse, delta, ids
      reinterpret_cast<float2*>(rec + 128)[lane] = ids;
      if (lane == 0) {
        meta[2 * stage] = qt;
        meta[2 * stage + 1] = masked;
        const uint32_t full = bwd_full(bar, stage);
        const uint32_t qd = base + kBwdRingOff + stage * kBwdStageBytes;
        mbar_expect_tx(full, kBwdStageBytes + 2 * 64 * 4);
        tma_tile<64>(qd, tm_q, full, h, qt * 64, b);
        tma_tile<64>(qd + kHalfBytes, tm_do, full, h, qt * 64, b);
        bulk_copy(smem_u32(rec), lse + stats + qt * 64, 64 * 4, full);
        bulk_copy(smem_u32(rec + 64), delta + stats + qt * 64, 64 * 4, full);
      } else {
        mbar_arrive(bwd_full(bar, stage));   // releases this lane's ids
      }
      if (++stage == kBwdStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(bwd_empty(bar, stage), phase ^ 1);
  if (lane == 0) meta[2 * stage] = -1;
  mbar_arrive(bwd_full(bar, stage));
}

// K6's scores: s = K.Q^T and dp = V.dO^T of a 64-row q tile, rows keys g
// (r = 0) and g + 8 (r = 1), columns queries: p goes to s, ds = p (dp -
// delta) to dp, with each column's lse and delta from the stage's
// record. `off` is the thread's key minus the tile's first query; the
// key's id is read only where the tile is masked (`kseg`: at the key).
__device__ __forceinline__ void dkv_scores(float (&s)[32], float (&dp)[32],
                                           bool diag, bool masked,
                                           const float* rec,
                                           const float* kseg, int off,
                                           int t) {
  float kid[2] = {0.f, 0.f};
  if (masked) {
    kid[0] = kseg[0];
    kid[1] = kseg[8];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(rec + col);
    const float2 dl = *reinterpret_cast<const float2*>(rec + 64 + col);
    const float2 qid = masked
        ? *reinterpret_cast<const float2*>(rec + 128 + col)
        : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2, c = e & 1;
      float x = s[4 * j + e];
      if (diag && col + c < off + 8 * r) x = kNegInf;
      if (masked && kid[r] != (c ? qid.y : qid.x)) x = kNegInf;
      const float p = ex2(fmaf(x, kLog2e, -(c ? l.y : l.x) * kLog2e));
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - (c ? dl.y : dl.x));
    }
  }
}

// S^T = K.Q^T and dP^T = V.dO^T for one warpgroup's 64 keys (k and v at
// row 64 cw of the CTA's tiles) against the q tile in `qd`.
__device__ __forceinline__ void dkv_score_products(float (&s)[32],
                                                   float (&dp)[32],
                                                   uint32_t k, uint32_t v,
                                                   uint32_t qd) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss64(s, kmajor_desc(k, kk), kmajor_desc<64>(qd, kk), kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss64(dp, kmajor_desc(v, kk),
               kmajor_desc<64>(qd + kHalfBytes, kk), kk);
}

// dV += P^T.dO and dK += dS^T.Q, dO and Q of the tile in `qd` MN-major.
__device__ __forceinline__ void dkv_products(float (&dk)[64], float (&dv)[64],
                                             const uint32_t (&p)[16],
                                             const uint32_t (&ds)[16],
                                             uint32_t qd) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(dv, p + 4 * kk, mnmajor_desc<64>(qd + kHalfBytes, kk));
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(dk, ds + 4 * kk, mnmajor_desc<64>(qd, kk));
}

// K6's WG1 or WG2: 64 keys over the q tiles the producer delivers. dK
// and dV (128 registers a thread) leave no room for the next tile's
// scores beside this tile's products, so a warpgroup issues its two
// products of a tile one after the other, and the two warpgroups take
// turns: one computes p and ds while the other's products run.
__device__ __forceinline__ void dkv_consumer(
    uint32_t base, uint32_t bar, const int* meta, const float* aux,
    const float* segb, bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
    int S, int Hkv, int kvh, int b, int k0, int causal) {
  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + cw * 64 + warp * 16 + g;   // and key + 8
  float dk[64], dv[64], s[32], dp[32];
  uint32_t p[16], ds[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_addr = base + cw * 64 * 128;   // row 64 cw of each box

  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(bar, 0);
  // Turns as in fwd_consumer, two a tile; WG1 takes WG2's last pass
  // after the loop, so every bar.arrive is matched.
  if (cw == 1) turn_pass(cw);
  for (;;) {
    mbar_wait(bwd_full(bar, stage), phase);
    const int qt = uniform(meta[2 * stage]);
    if (qt < 0) break;   // the sentinel: no more tiles
    const uint32_t qd = base + kBwdRingOff + stage * kBwdStageBytes;
    turn_wait(cw);
    wgmma_fence();
    dkv_score_products(s, dp, k_addr, k_addr + kTileBytes, qd);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // Some query of the tile comes before a key of the warpgroup's.
    dkv_scores(s, dp, causal && qt * 64 < k0 + cw * 64 + 64,
               uniform(meta[2 * stage + 1]), aux + stage * 3 * 64,
               segb == nullptr ? nullptr : segb + key, key - qt * 64, t);
    pack32(s, p);
    pack32(dp, ds);
    turn_wait(cw);
    wgmma_fence();
    dkv_products(dk, dv, p, ds, qd);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(p);
    fence_regs(ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(bwd_empty(bar, stage));
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (cw == 0) turn_wait(cw);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = ((size_t)b * S + key + 8 * r) * Hkv * kD +
                       (size_t)kvh * kD;
    __nv_bfloat162* dk2 = reinterpret_cast<__nv_bfloat162*>(dk_out + off);
    __nv_bfloat162* dv2 = reinterpret_cast<__nv_bfloat162*>(dv_out + off);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      dk2[j * 4 + t] =
          __floats2bfloat162_rn(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      dv2[j * 4 + t] =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ seg,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Hq, int Hkv,
                     int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bar = base + kBwdBarOff;
  int* meta = reinterpret_cast<int*>(smem + kBwdMetaOff);
  float* aux = reinterpret_cast<float*>(smem + kBwdAuxOff);
  // Early key tiles, which see the most rows under causal masking,
  // first: every KV head and batch row of a key tile together.
  const int k_tile = blockIdx.z;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;

  if (threadIdx.x == 0) bwd_init(bar);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32)
      dkv_producer(&tm_q, &tm_do, &tm_k, &tm_v, base, bar, meta, aux, segb,
                   lse, delta, k_tile * kSeqTile, kvh, b, S, Hq, Hq / Hkv,
                   causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    dkv_consumer(base, bar, meta, aux, segb, dk, dv, S, Hkv, kvh, b,
                 k_tile * kSeqTile, causal);
  }
}

#undef WG_D8
#undef WG_D32
#undef WG_D64
#undef WG_REGS32
#undef WG_REGS

// The shapes every entry point takes: D 128, S a multiple of 128, Hq a
// multiple of Hkv. Anything else returns cudaErrorInvalidValue
// unlaunched (the Python wrappers check first).
bool bad_shape(int B, int S, int Hq, int Hkv, int D) {
  return D != kD || B < 1 || S < kSeqTile || S % kSeqTile || Hkv < 1 ||
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
// read in boxes of 64 dims x 1 head x `rows` rows x 1 batch row with the
// 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int rows = kSeqTile) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {kD * sizeof(bf16),
                                 (cuuint64_t)H * kD * sizeof(bf16),
                                 (cuuint64_t)S * H * kD * sizeof(bf16)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
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
  if (bad_shape(B, S, Hq, Hkv, D))
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

// The four tensor maps of a backward call: q and do (Hq heads) in boxes
// of `q_rows` rows, k and v (Hkv heads) in boxes of `kv_rows`.
bool bwd_maps(CUtensorMap (&tm)[4], const void* q, const void* dout,
              const void* k, const void* v, int B, int S, int Hq, int Hkv,
              int q_rows, int kv_rows) {
  return tensor_map(&tm[0], q, B, S, Hq, q_rows) &&
         tensor_map(&tm[1], dout, B, S, Hq, q_rows) &&
         tensor_map(&tm[2], k, B, S, Hkv, kv_rows) &&
         tensor_map(&tm[3], v, B, S, Hkv, kv_rows);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* seg, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int S, int Hq, int Hkv, int D,
                                 int causal, void* stream) {
  CUtensorMap tm[4];
  if (bad_shape(B, S, Hq, Hkv, D) ||
      !bwd_maps(tm, q, dout, k, v, B, S, Hq, Hkv, kSeqTile, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, S / kSeqTile);
  flash_bwd_dq_kernel<<<grid, kFwdThreads, kDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(seg),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, Hq, Hkv, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* seg, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int Hq,
                                  int Hkv, int D, int causal, void* stream) {
  CUtensorMap tm[4];
  if (bad_shape(B, S, Hq, Hkv, D) ||
      !bwd_maps(tm, q, dout, k, v, B, S, Hq, Hkv, 64, kSeqTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B, S / kSeqTile);
  flash_bwd_dkv_kernel<<<grid, kFwdThreads, kDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(seg),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hkv, causal);
  return static_cast<int>(cudaGetLastError());
}
