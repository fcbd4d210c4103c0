// GQA attention of T new queries over a KV cache, for every prefill and
// decode step of the serving path: K1 over a contiguous cache, K3 over a
// paged one, each with a bf16, int8 or int4 cache.
//
// K1 replaces the TPU kernel container_engine_accelerators_tpu/ops/
// decode_attention.py::decode_attention (_decode_kernel, pl.pallas_call
// at line 282). Same function:
//   q     [B, T, Hq, D] bf16, queries at absolute positions
//         [cache_len, cache_len + T)
//   k, v  [B, max_len, Hkv, D] bf16, the new tokens already written
//   lens  [B] int32 cache_len per batch row
//   out   [B, T, Hq, D] bf16
// Query t of head h sees key positions p with p < live = cache_len + T
// and p <= cache_len + t. Online softmax with m, l and the accumulator
// in f32; p.v in f32, as the Pallas body does.
//
// The Pallas body's two quantized modes (its `quant` and `int4` flags):
//   int8  k, v [B, max_len, Hkv, D] int8 and scales [B, Hkv, max_len] f32,
//         one per (token, KV head): key p of head h is
//         float(k[b, p, h, :]) * k_scales[b, h, p], and v alike;
//   int4  k, v [B, max_len, Hkv, D/2] int8, two nibbles a byte in the
//         split-half layout of ops/quant.pack_int4 (byte j: element j in
//         the low nibble, element j + D/2 in the high one), same scales.
// The scales stay f32, as in the Pallas body, and never fold into a
// bf16 tile: the integers become bf16 exactly (|x| <= 127 fits bf16's 8
// significant bits), and the kernels compute
// s = scale * k_scale[j] * sum_d q_d * k_int[j, d] and
// acc += (p_j * v_scale[j]) * v_int[j, :], the same function up to f32
// reassociation and p's split into two bf16 terms (see P.V below).
//
// K3 replaces ...::paged_decode_attention (paged_kernel, pl.pallas_call
// at line 391), in all three modes. It computes K1's function in logical
// positions; only a key's address differs. The cache is a page pool
//   k, v    [n_pages, page, Hkv, D or D/2]
//   scales  [n_pages, Hkv, page] f32 (int8, int4)
//   tables  [B, max_pages] int32, the pool row of each logical page
// and key `pos` of row b lives at pool row
// r = clamp(tables[b, pos / page], 0, n_pages - 1), offset pos % page, its
// scale at [r, h, pos % page], with max_len = max_pages * page. As in the
// Pallas version, the body is K1's: the kernels are templates over how a
// key's row and scale are addressed and how its row is stored. Any page
// size works.
//
// What bounds it on an H100: at decode, bytes. Every step streams the
// live part of the cache once (HBM, 3.35 TB/s on the SXM part); the
// arithmetic is ~2 flops per cache element per query row. At decode (B 8,
// 8 KV heads, lengths up to 2047) that is ~16 MB, 5 us at the byte bound,
// so what costs is latency and how few SMs a walk over one row's keys can
// use. At prefill each key serves T x G query rows, and the tensor cores'
// operations bound it. Two kernels share the payloads, the addressing,
// the tile loader and the products' fragment layouts:
//
// Decode (T*G <= 4 query rows per GQA group), decode_split_kernel:
//   - the key range of a (KV head, batch row) is split across CTAs: the
//     grid is (split, KV head, batch row), the split count a function of
//     the shapes and the SM count only (ops/decode_attention.split_plan),
//     never of the lengths, so one call is one launch that reads no
//     length on the host and a CUDA graph can hold it. A CTA takes chunk
//     `split` of [0, live), ceil(live / splits) keys rounded up to a
//     tile, so short rows spread over several SMs too; a CTA past the
//     row's last chunk leaves at once;
//   - each CTA writes its partial (m, l and the f32 accumulator of its
//     rows) to a workspace, takes a ticket with one atomic per (KV head,
//     batch row), and the last of the row's busy CTAs to arrive merges
//     their partials in split order, writes the output and resets the
//     ticket. The order is fixed, so the output is the same bits from run
//     to run, and K3 the same bits as K1 on the same keys. A row whose
//     keys fit one chunk is written by its CTA directly;
//   - tiles of 64 keys stream through a ring of 3 shared-memory stages
//     filled with cp.async (16 bytes a thread, zero-filled past the
//     chunk), so two tiles are in flight while one is computed. TMA buys
//     nothing at these tile sizes: cp.async costs each thread a few
//     instructions a tile, and a paged tile needs no tensor map;
//   - the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 out), where CUDA cores need ~900 instructions a warp a tile
//     and leave the body latency-bound: each warp takes 16 keys of every
//     tile and keeps its own online softmax over them. S = Q.K^T puts
//     the group's rows (at most 4) in rows 0-3 of the 16-row A operand,
//     so each K value read from shared memory feeds every row. O += P.V
//     takes P (times V's scales) as two bf16 terms, its bf16 and the
//     bf16 of what that left out, so p keeps 16 significant bits, with
//     f32 sums; the row sum l adds the f32 p. Scores are in log2 units
//     and exponentials are ex2.approx. Quantized K and V integers become
//     bf16 exactly as their fragments are read. Rows in shared memory sit
//     16 bytes apart beyond their length, so a fragment's 8 rows use
//     distinct banks; bf16 V comes in by ldmatrix.trans. Warps merge
//     through shared memory once per CTA;
//   - paged (K3), a tile's pool row is read from the table one tile
//     ahead of its loads, once per tile, where a tile lies in one page
//     (page a multiple of 64, as in every engine); smaller pages resolve
//     each key's row.
// Prefill (more rows), prefill_mma_kernel:
//   - one CTA per (KV head, batch row, block of 64 query rows), the row
//     block the grid's slowest dimension and taken from the last, so the
//     blocks with the most keys start first and the causal tail fills in
//     behind them. Each of the 4 warps holds 16 rows, one m16 A operand
//     (16 tokens x 4 heads at Llama-3's G of 4), with its Q fragments in
//     registers for the whole walk;
//   - the decode body's loader streams 64-key tiles through a ring of
//     kPrefillStages, the table entry one tile ahead;
//   - S = Q.K^T and O += P.V on mma.sync, S kept in registers: the m16n8
//     accumulator layout of two adjacent key columns is the m16n8k16 A
//     layout of one 16-key step, so P's A fragments are S's registers
//     and P never goes through shared memory. P (times V's scales) enters
//     as two bf16 terms, l adds the f32 p, scores are in log2 units, and
//     a thread's two rows reduce their max across its quad;
//   - int8 and int4 tiles are unpacked once a tile, by the whole CTA,
//     into a bf16 staging tile, so every payload takes the same fragment
//     path (ldmatrix for K, ldmatrix.trans for V) and no query row
//     repeats the unpack;
//   - a tile wholly at or below a warp's first query position and before
//     the block's last visible key runs unmasked; only the tiles that
//     cross the diagonal or `live` mask each element, and a warp skips
//     the tiles past its last query. One CTA walks all of a row block's
//     keys: no atomics, so the output repeats its bits, and K3 gives K1's
//     bits on the same keys.
// Both stop at `live`: positions at or past it are never read (nor their
// scales, nor, paged, their table entries), so a reused cache holding
// NaN or stale scales there, or a stale table entry, cannot reach the
// accumulator. No wgmma: decode has at most 4 rows a KV head, and
// prefill shares one body across three payloads and two addressings,
// where wgmma would need every tile in a swizzled layout that matches
// its descriptors bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;          // keys per shared-memory tile
constexpr int kDecodeRows = 4;       // query rows (T*G) of a decode CTA
constexpr int kStages = 3;           // decode: tiles in the ring
constexpr int kPrefillRows = 16 * kWarps;   // query rows of a prefill CTA
constexpr int kPrefillStages = 2;    // prefill: tiles in the ring
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// cp.async of `bytes` (4 or 16) from global to shared memory; with `ok`
// false nothing is read and the destination is zero-filled.
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
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Bits [lo, lo + n) of w as a signed integer, in f32.
template <int lo, int n>
__device__ __forceinline__ float sbits(uint32_t w) {
  return static_cast<float>(static_cast<int>(w << (32 - lo - n)) >> (32 - n));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The four 8x8 b16 matrices whose rows lanes 8m .. 8m + 7 address, into
// r[m]: as stored (lane 4i + j holds row i, columns 2j, 2j + 1), or
// transposed (column i, rows 2j, 2j + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// How a cache row of D values is stored: `words`, its 32-bit words.
// Decode, on the tensor cores: `qk_b`, the B fragment of S = Q.K^T for
// the key row `row` in shared memory at k-step ks (dims 16 ks + 2t, +1
// and 16 ks + 2t + 8, +9); `pv_b`, the B fragments of P.V for the warp's
// 16 value rows at `v` (row stride S) and dims 16 np .. 16 np + 15: b[0..1]
// dims 16 np + g, b[2..3] dims 16 np + 8 + g, each holding keys 2t, 2t+1
// and 2t + 8, 2t + 9. Prefill reads bf16 rows only: the quantized
// payloads' `unpack` writes chunk c of a row (8 elements) there as bf16.
struct Bf16Payload {
  static constexpr bool kQuant = false;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 2; }
  template <int D>
  __device__ static void qk_b(const uint8_t* row, int ks, int t,
                              uint32_t (&b)[2]) {
    b[0] = *reinterpret_cast<const uint32_t*>(row + 32 * ks + 4 * t);
    b[1] = *reinterpret_cast<const uint32_t*>(row + 32 * ks + 16 + 4 * t);
  }
  template <int D, int S>
  __device__ static void pv_b(const uint8_t* v, int np, int lane,
                              uint32_t (&b)[4]) {
    // ldmatrix.trans: lanes 8m .. 8m + 7 address matrix m's rows (keys
    // 8 (m & 1) .., dims 16 np + 8 (m >> 1) ..).
    const int mtx = lane / 8, r = lane % 8;
    ldmatrix_x4_trans(
        b, v + (8 * (mtx & 1) + r) * S + (16 * np + 8 * (mtx >> 1)) * 2);
  }
};

// The quantized payloads' decode fragments (see Bf16Payload), element by
// element from the integers staged in shared memory.
template <class P, int D>
__device__ __forceinline__ void quant_qk_b(const uint8_t* row, int ks, int t,
                                           uint32_t (&b)[2]) {
  const int d = 16 * ks + 2 * t;
  b[0] = bf16_pair(P::template elem<D>(row, d),
                   P::template elem<D>(row, d + 1));
  b[1] = bf16_pair(P::template elem<D>(row, d + 8),
                   P::template elem<D>(row, d + 9));
}

template <class P, int D, int S>
__device__ __forceinline__ void quant_pv_b(const uint8_t* v, int np,
                                           int lane, uint32_t (&b)[4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 16 * np + 8 * h + g;
    b[2 * h] = bf16_pair(P::template elem<D>(v + 2 * t * S, d),
                         P::template elem<D>(v + (2 * t + 1) * S, d));
    b[2 * h + 1] = bf16_pair(P::template elem<D>(v + (2 * t + 8) * S, d),
                             P::template elem<D>(v + (2 * t + 9) * S, d));
  }
}

// One signed byte an element: element d is byte d.
struct Int8Payload {
  static constexpr bool kQuant = true;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 4; }
  // Decode: as Bf16Payload's, each integer made a bf16 (exact).
  template <int D>
  __device__ static float elem(const uint8_t* row, int d) {
    return static_cast<float>(static_cast<int8_t>(row[d]));
  }
  template <int D>
  __device__ static void qk_b(const uint8_t* row, int ks, int t,
                              uint32_t (&b)[2]) {
    quant_qk_b<Int8Payload, D>(row, ks, t, b);
  }
  template <int D, int S>
  __device__ static void pv_b(const uint8_t* v, int np, int lane,
                              uint32_t (&b)[4]) {
    quant_pv_b<Int8Payload, D, S>(v, np, lane, b);
  }
  // Prefill: bytes 8c .. 8c + 7 of `src`, as bf16 at `dst`.
  template <int D>
  __device__ static void unpack(const uint8_t* src, uint8_t* dst, int c) {
    const uint2 w = *reinterpret_cast<const uint2*>(src + 8 * c);
    uint4 o;
    o.x = bf16_pair(sbits<0, 8>(w.x), sbits<8, 8>(w.x));
    o.y = bf16_pair(sbits<16, 8>(w.x), sbits<24, 8>(w.x));
    o.z = bf16_pair(sbits<0, 8>(w.y), sbits<8, 8>(w.y));
    o.w = bf16_pair(sbits<16, 8>(w.y), sbits<24, 8>(w.y));
    *reinterpret_cast<uint4*>(dst + 16 * c) = o;
  }
};

// Split-half nibbles: byte j holds element j (low) and j + D/2 (high).
struct Int4Payload {
  static constexpr bool kQuant = true;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 8; }
  // Decode: as Int8Payload's; element d is the low nibble of byte d
  // for d < D/2, else the high nibble of byte d - D/2.
  template <int D>
  __device__ static float elem(const uint8_t* row, int d) {
    return d < D / 2 ? sbits<0, 4>(row[d]) : sbits<4, 4>(row[d - D / 2]);
  }
  template <int D>
  __device__ static void qk_b(const uint8_t* row, int ks, int t,
                              uint32_t (&b)[2]) {
    quant_qk_b<Int4Payload, D>(row, ks, t, b);
  }
  template <int D, int S>
  __device__ static void pv_b(const uint8_t* v, int np, int lane,
                              uint32_t (&b)[4]) {
    quant_pv_b<Int4Payload, D, S>(v, np, lane, b);
  }
  // Prefill: bytes 4c .. 4c + 3 of `src`, elements 4c .. 4c + 3 (low
  // nibbles) and D/2 + 4c .. D/2 + 4c + 3 (high), as bf16 at `dst`.
  template <int D>
  __device__ static void unpack(const uint8_t* src, uint8_t* dst, int c) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src + 4 * c);
    const uint2 lo = make_uint2(bf16_pair(sbits<0, 4>(w), sbits<8, 4>(w)),
                                bf16_pair(sbits<16, 4>(w), sbits<24, 4>(w)));
    const uint2 hi = make_uint2(bf16_pair(sbits<4, 4>(w), sbits<12, 4>(w)),
                                bf16_pair(sbits<20, 4>(w), sbits<28, 4>(w)));
    *reinterpret_cast<uint2*>(dst + 8 * c) = lo;
    *reinterpret_cast<uint2*>(dst + D + 8 * c) = hi;
  }
};
// Row of key `pos` of batch row b, in units of Hkv rows of one token, and
// the index of its scale for KV head h. Decode resolves a tile's rows at
// once: `tile` gives the row and scale index of the tile's first key,
// and key k0 + j sits j after them, unless `per_key` (a page smaller
// than a tile, or not a multiple of it).
struct Tile {
  size_t row0, scale0;
};

struct ContiguousKeys {
  int max_len;
  __device__ __forceinline__ size_t row(int b, int pos) const {
    return (size_t)b * max_len + pos;
  }
  __device__ __forceinline__ size_t scale(int b, int h, int Hkv,
                                          int pos) const {
    return ((size_t)b * Hkv + h) * max_len + pos;
  }
  __device__ __forceinline__ bool per_key() const { return false; }
  __device__ __forceinline__ Tile tile(int b, int h, int Hkv, int k0) const {
    return {row(b, k0), scale(b, h, Hkv, k0)};
  }
};

struct PagedKeys {
  const int* tables;   // [B, max_pages]
  int page, max_pages, n_pages;
  __device__ __forceinline__ int pool_row(int b, int pos) const {
    const int r = tables[(size_t)b * max_pages + pos / page];
    return min(max(r, 0), n_pages - 1);
  }
  __device__ __forceinline__ size_t row(int b, int pos) const {
    return (size_t)pool_row(b, pos) * page + pos % page;
  }
  __device__ __forceinline__ size_t scale(int b, int h, int Hkv,
                                          int pos) const {
    return ((size_t)pool_row(b, pos) * Hkv + h) * page + pos % page;
  }
  __device__ __forceinline__ bool per_key() const {
    return page % kBlockK != 0;
  }
  // One table entry for the whole tile (k0 is a multiple of kBlockK).
  __device__ __forceinline__ Tile tile(int b, int h, int Hkv, int k0) const {
    const size_t r = pool_row(b, k0);
    const int off = k0 % page;
    return {r * page + off, (r * Hkv + h) * page + off};
  }
};


// 2^x in one MUFU instruction (decode keeps its scores in log2 units).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Decode: the shapes of one instantiation. K/V rows sit in shared memory
// 16 bytes apart more than their length, so the 8 rows that one
// fragment load touches fall in different banks.
template <class P, int D>
struct DecodeLayout {
  static constexpr int kRowBytes = 4 * P::template words<D>();
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;        // 16-B loads a row
  static constexpr int kPayloadBytes = kBlockK * kStride;
  static constexpr int kStageBytes =
      2 * kPayloadBytes + (P::kQuant ? 2 * kBlockK * 4 : 0);
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kMergeBytes = kWarps * kDecodeRows * (D + 2) * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static_assert(kBlockK == 16 * kWarps && kThreads == 2 * kBlockK, "");
};

// Partial of split s for (KV head, batch row) bh and query row r, in the
// workspace `part`: D accumulator values, then m and l (f32).
__device__ __forceinline__ size_t part_index(int bh, int splits, int s,
                                             int r, int D) {
  return (((size_t)bh * splits + s) * kDecodeRows + r) * (D + 2);
}

// c += A B on the tensor cores (m16n8k16, bf16 in, f32 out), with A's
// rows 8-15 zero: a0 holds A[g][2t, 2t+1], a2 A[g][2t+8, 2t+9].
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Loads of the tiles of keys [begin, end), tile n into the ring stage
// `st` it is given: K and V rows, 16 bytes a thread, zero-filled at or
// past `end` (never read at or past `live`); the quantized modes'
// scales, 4 bytes a thread (threads below kBlockK K's, the rest V's).
// Paged, tile n + 1's table entry is read before tile n's loads go out,
// so its latency hides behind a tile of compute.
template <class P, int D, class Keys>
struct TileLoader {
  using L = DecodeLayout<P, D>;
  const uint8_t *kg, *vg;
  const float *k_scales, *v_scales;
  Keys keys;
  int b, kvh, Hkv, begin, end, n_tiles;
  Tile next;

  __device__ __forceinline__ TileLoader(const void* k, const void* v,
                                        const float* ks, const float* vs,
                                        Keys keys_, int b_, int kvh_,
                                        int Hkv_, int begin_, int end_)
      : kg(static_cast<const uint8_t*>(k)),
        vg(static_cast<const uint8_t*>(v)), k_scales(ks), v_scales(vs),
        keys(keys_), b(b_), kvh(kvh_), Hkv(Hkv_), begin(begin_), end(end_),
        n_tiles((end_ - begin_ + kBlockK - 1) / kBlockK), next{} {
    if (!keys.per_key()) next = keys.tile(b, kvh, Hkv, begin);
  }

  __device__ __forceinline__ void load(uint8_t* st, int n) {
    const Tile tile = next;
    if (n + 1 < n_tiles && !keys.per_key())
      next = keys.tile(b, kvh, Hkv, begin + (n + 1) * kBlockK);
    const int k0 = begin + n * kBlockK;
    for (int id = threadIdx.x; id < kBlockK * L::kChunks; id += kThreads) {
      const int j = id / L::kChunks, c = id % L::kChunks;
      const bool ok = k0 + j < end;   // never read at or past `live`
      size_t off = 0;
      if (ok) {
        const size_t row = keys.per_key() ? keys.row(b, k0 + j)
                                          : tile.row0 + j;
        off = (row * Hkv + kvh) * L::kRowBytes + c * 16;
      }
      const int dst = j * L::kStride + c * 16;
      cp_async<16>(st + dst, kg + off, ok);
      cp_async<16>(st + L::kPayloadBytes + dst, vg + off, ok);
    }
    if constexpr (P::kQuant) {
      const int j = threadIdx.x % kBlockK;
      const bool ok = k0 + j < end;   // nor a scale
      size_t si = 0;
      if (ok)
        si = keys.per_key() ? keys.scale(b, kvh, Hkv, k0 + j)
                            : tile.scale0 + j;
      const bool is_k = threadIdx.x < kBlockK;
      float* dst = reinterpret_cast<float*>(st + 2 * L::kPayloadBytes) +
                   (is_k ? 0 : kBlockK) + j;
      cp_async<4>(dst, (is_k ? k_scales : v_scales) + si, ok);
    }
  }
};

// c += A B on the tensor cores (m16n8k16, bf16 in, f32 out): a[0] holds
// A[g][2t, 2t+1], a[1] A[g + 8][2t, 2t+1], a[2] A[g][2t+8, 2t+9], a[3]
// A[g + 8][2t+8, 2t+9]; b0 B[2t, 2t+1][g], b1 B[2t+8, 2t+9][g]; c[0..1]
// C[g][2t, 2t+1], c[2..3] C[g + 8][2t, 2t+1].
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Prefill: the shapes of one instantiation. The ring's stages are
// decode's (payload rows padded 16 bytes, the scales after them); the
// products read bf16 rows of D values, 16 bytes apart beyond their
// length: bf16 K and V in the ring itself, quantized ones unpacked into
// two staging tiles after the ring. Q is staged once, before the walk,
// where nothing lies yet: in the staging tiles, or in the ring's last
// stage, which the prologue leaves empty.
template <class P, int D>
struct PrefillLayout {
  using L = DecodeLayout<P, D>;
  static constexpr int kStride = 2 * D + 16;
  static constexpr int kTileBytes = kBlockK * kStride;
  static constexpr int kRingBytes = kPrefillStages * L::kStageBytes;
  static constexpr int kSmemBytes =
      kRingBytes + (P::kQuant ? 2 * kTileBytes : 0);
  static constexpr int kQOffset =
      P::kQuant ? kRingBytes : (kPrefillStages - 1) * L::kStageBytes;
  static_assert(P::kQuant || L::kStride == kStride, "");
  static_assert(kQOffset + kPrefillRows * kStride <= kSmemBytes, "");
  static_assert(kPrefillStages >= 2 && D % 32 == 0, "");
};

// Prefill: the integers of ring stage `st` as bf16 in the staging tiles,
// K's then V's, by the whole CTA; a row is D / 8 chunks of 8 elements.
template <class P, int D>
__device__ __forceinline__ void unpack_tile(const uint8_t* st,
                                            uint8_t* staging) {
  using L = DecodeLayout<P, D>;
  using PL = PrefillLayout<P, D>;
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int id = threadIdx.x; id < 2 * kBlockK * kChunks; id += kThreads) {
    const int kv = id / (kBlockK * kChunks);
    const int j = id / kChunks % kBlockK, c = id % kChunks;
    P::template unpack<D>(st + kv * L::kPayloadBytes + j * L::kStride,
                          staging + kv * PL::kTileBytes + j * PL::kStride,
                          c);
  }
}

template <class P, int D, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k, const void* __restrict__ v,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets, int T, int Hq, int Hkv,
                    int max_len, int splits, float scale, Keys keys) {
  using L = DecodeLayout<P, D>;
  constexpr int R = kDecodeRows;
  constexpr int S = L::kStride;
  constexpr int kSteps = D / 16;    // k-steps of Q.K^T, dim pairs of P.V
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) __nv_bfloat16 q_s[R][D];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int bh = b * Hkv + kvh;
  const int G = Hq / Hkv;
  const int n_rows = T * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
  const int cache_len = lens[b];
  // Scores, and every m below, in log2 units: exp(x) = 2^(x log2 e).
  const float scale2 = scale * 1.4426950408889634f;
  // Every row's last visible key is below live = cache_len + T.
  const int k_end = min(cache_len + T, max_len);
  const int per_split = (k_end + splits - 1) / splits;
  const int chunk = (per_split + kBlockK - 1) / kBlockK * kBlockK;
  // Splits past the row's last key have nothing to do: they leave at
  // once, and the row's `active` splits alone take tickets.
  const int active = (k_end + chunk - 1) / chunk;
  if (split >= active) return;
  const int begin = split * chunk;
  const int end = min(begin + chunk, k_end);
  const int n_tiles = (end - begin + kBlockK - 1) / kBlockK;

  // The group's query rows (rows past T*G are zero and see no key),
  // staged with 16-byte loads.
  for (int c = threadIdx.x; c < R * D / 8; c += kThreads) {
    const int r = c / (D / 8), off = c % (D / 8) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < n_rows) {
      const int tq = r / G, h = kvh * G + r % G;
      w = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * T + tq) * Hq + h) * D + off);
    }
    *reinterpret_cast<uint4*>(&q_s[r][off]) = w;
  }

  TileLoader<P, D, Keys> tiles(k, v, k_scales, v_scales, keys, b, kvh, Hkv,
                               begin, end);

#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < n_tiles) tiles.load(smem + n * L::kStageBytes, n);
    cp_async_commit();
  }

  // Q as the A operand of S = Q.K^T, rows 0-7 (rows g >= R are zero): a
  // lane holds row g, dims 16 ks + 2t, +1 and 16 ks + 2t + 8, +9.
  __syncthreads();
  uint32_t qa[kSteps][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (g < R) {
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(&q_s[g][16 * ks + 2 * t]);
      qa[ks][1] =
          *reinterpret_cast<const uint32_t*>(&q_s[g][16 * ks + 2 * t + 8]);
    }
  }
  const int qpos = g < n_rows ? cache_len + g / G : -1;   // row g's query

  // The warp's online softmax over its keys of every tile (16 of each:
  // keys 16 warp .. 16 warp + 15), for row g; o holds O[g][8 nt + 2t, +1]
  // in o[nt][0..1] (o[nt][2..3], rows g + 8, stay zero).
  float m = kNegInf, l = 0.f;
  float o[2 * kSteps][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<kStages - 2>();   // this thread's loads of tile n
    __syncthreads();                // everyone's; and tile n - 1 is done
    if (n + kStages - 1 < n_tiles)
      tiles.load(smem + (n + kStages - 1) % kStages * L::kStageBytes,
                 n + kStages - 1);
    cp_async_commit();

    const uint8_t* st = smem + (n % kStages) * L::kStageBytes;
    const uint8_t* kt = st + 16 * warp * S;               // the warp's keys
    const uint8_t* vt = st + L::kPayloadBytes + 16 * warp * S;
    const float* sc_s =
        reinterpret_cast<const float*>(st + 2 * L::kPayloadBytes);
    const int j0 = 16 * warp;                // first key of the warp, tile
    const int k0 = begin + n * kBlockK + j0;

    // S = Q.K^T for the warp's 16 keys: c[h] holds row g, keys
    // 8h + 2t, +1.
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t kb[2];
        P::template qk_b<D>(kt + (8 * h + g) * S, ks, t, kb);
        mma_rows8(c[h], qa[ks][0], qa[ks][1], kb[0], kb[1]);
      }

    float s[4], p[4];
    float m_tile = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jl = 8 * (i / 2) + 2 * t + i % 2;   // key within the warp's
      const int pos = k0 + jl;
      float sc = scale2;
      if constexpr (P::kQuant) sc *= sc_s[j0 + jl];
      const bool ok = pos < end && pos <= qpos;
      s[i] = ok ? c[i / 2][i % 2] * sc : kNegInf;
      m_tile = fmaxf(m_tile, s[i]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(kFull, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(kFull, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = exp2_approx(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = s[i] > kNegInf ? exp2_approx(s[i] - m_new) : 0.f;
      sum += p[i];
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l = l * alpha + sum;
    m = m_new;

    // O += P.V on the tensor cores, in f32 to 2^-16: P (times V's scales)
    // goes in as a bf16 term and the bf16 of what it left out.
    uint32_t a_hi[2], a_lo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pv[e] = p[2 * h + e];
        if constexpr (P::kQuant)
          pv[e] *= sc_s[kBlockK + j0 + 8 * h + 2 * t + e];
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
      const float2 hf = __bfloat1622float2(hi);
      a_hi[h] = *reinterpret_cast<const uint32_t*>(&hi);
      a_lo[h] = bf16_pair(pv[0] - hf.x, pv[1] - hf.y);
    }
#pragma unroll
    for (int np = 0; np < kSteps; ++np) {
      uint32_t vb[4];
      P::template pv_b<D, S>(vt, np, lane, vb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&on)[4] = o[2 * np + h];
        on[0] *= alpha;
        on[1] *= alpha;
        mma_rows8(on, a_hi[0], a_hi[1], vb[2 * h], vb[2 * h + 1]);
        mma_rows8(on, a_lo[0], a_lo[1], vb[2 * h], vb[2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the merge

  // The warps' states, in order, through shared memory: [warp][row][D + 2].
  float* red = reinterpret_cast<float*>(smem);
  if (g < R) {
    float* w = red + (warp * R + g) * (D + 2);
#pragma unroll
    for (int nt = 0; nt < 2 * kSteps; ++nt) {
      w[8 * nt + 2 * t] = o[nt][0];
      w[8 * nt + 2 * t + 1] = o[nt][1];
    }
    if (t == 0) {
      w[D] = m;
      w[D + 1] = l;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float m_cta = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_cta = fmaxf(m_cta, red[(w * R + r) * (D + 2) + D]);
    float l_cta = 0.f, a_cta = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* x = red + (w * R + r) * (D + 2);
      const float cw = exp2_approx(x[D] - m_cta);
      l_cta += x[D + 1] * cw;
      a_cta += x[d] * cw;
    }
    if (active == 1) {
      if (r < n_rows) {
        const int tq = r / G, h = kvh * G + r % G;
        out[((size_t)(b * T + tq) * Hq + h) * D + d] =
            __float2bfloat16_rn(a_cta * (1.f / fmaxf(l_cta, 1e-30f)));
      }
    } else {
      float* pp = part + part_index(bh, splits, split, r, D);
      pp[d] = a_cta;
      if (d == 0) {
        pp[D] = m_cta;
        pp[D + 1] = l_cta;
      }
    }
  }
  if (active == 1) return;

  // The last CTA of this (KV head, batch row) to arrive merges the
  // partials in split order, then resets the ticket for the next call.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(tickets + bh, 1) == active - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < min(n_rows, R) * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float m_all = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < active; ++sp)
      m_all = fmaxf(m_all,
                    __ldcg(part + part_index(bh, splits, sp, r, D) + D));
    float l_all = 0.f, a_all = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < active; ++sp) {
      const float* pp = part + part_index(bh, splits, sp, r, D);
      const float cw = exp2_approx(__ldcg(pp + D) - m_all);
      l_all += __ldcg(pp + D + 1) * cw;
      a_all += __ldcg(pp + d) * cw;
    }
    const int tq = r / G, h = kvh * G + r % G;
    out[((size_t)(b * T + tq) * Hq + h) * D + d] =
        __float2bfloat16_rn(a_all * (1.f / fmaxf(l_all, 1e-30f)));
  }
  if (threadIdx.x == 0) tickets[bh] = 0;
}

// Two CTAs a SM, the ring's target: without it ptxas caps the registers
// of the small head dims for more and spills.
template <class P, int D, class Keys>
__global__ void __launch_bounds__(kThreads, 2)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ k, const void* __restrict__ v,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ lens,
                   __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv,
                   int max_len, float scale, Keys keys) {
  using L = DecodeLayout<P, D>;
  using PL = PrefillLayout<P, D>;
  constexpr int S = PL::kStride;    // a bf16 row, as the products read it
  constexpr int kSteps = D / 16;    // k-steps of Q.K^T, dim pairs of P.V
  constexpr int kKeyTiles = kBlockK / 8;   // 8-key n-tiles of S
  extern __shared__ __align__(16) uint8_t smem[];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kPrefillRows;
  const int G = Hq / Hkv;
  const int n_rows = T * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
  const int cache_len = lens[b];
  // Scores, and every m below, in log2 units: exp(x) = 2^(x log2 e).
  const float scale2 = scale * 1.4426950408889634f;
  // The walk ends at the block's last visible key: below live =
  // cache_len + T, and at or below its last row's query.
  const int t_last = (min(row0 + kPrefillRows, n_rows) - 1) / G;
  const int k_end = min(min(cache_len + T, max_len), cache_len + t_last + 1);

  TileLoader<P, D, Keys> tiles(k, v, k_scales, v_scales, keys, b, kvh, Hkv,
                               0, k_end);
#pragma unroll
  for (int n = 0; n < kPrefillStages - 1; ++n) {
    if (n < tiles.n_tiles) tiles.load(smem + n * L::kStageBytes, n);
    cp_async_commit();
  }

  // The block's query rows (rows past T*G are zero and never written),
  // staged with 16-byte loads, then held as each warp's A operand for the
  // whole walk: qa[ks] holds its rows g and g + 8, dims 16 ks + 2t, +1
  // and 16 ks + 2t + 8, +9.
  uint8_t* q_s = smem + PL::kQOffset;
  for (int c = threadIdx.x; c < kPrefillRows * D / 8; c += kThreads) {
    const int r = c / (D / 8), off = c % (D / 8) * 8;
    const int row = row0 + r;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (row < n_rows)
      w = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * T + row / G) * Hq + kvh * G + row % G) * D + off);
    *reinterpret_cast<uint4*>(q_s + r * S + off * 2) = w;
  }
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    ldmatrix_x4(qa[ks],
                q_s + (16 * warp + lane % 16) * S + (16 * ks + 8 * (lane / 16)) * 2);

  const int wrow = row0 + 16 * warp;          // the warp's first row
  const bool busy = wrow < n_rows;
  const int wq_lo = cache_len + wrow / G;     // its first query position
  const int wq_hi = cache_len + (min(wrow + 15, n_rows - 1)) / G;
  const int qpos[2] = {cache_len + (wrow + g) / G,
                       cache_len + (wrow + g + 8) / G};
  // Rows g and g + 8's online softmax: m in log2 units, l this thread's
  // part of the row sum (its quad adds the parts at the end); o holds
  // O[g][8 nt + 2t, +1] in o[nt][0..1] and row g + 8's in o[nt][2..3].
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[2 * kSteps][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  const int mtx = lane / 8, r8 = lane % 8;    // ldmatrix addressing

  for (int n = 0; n < tiles.n_tiles; ++n) {
    cp_async_wait<kPrefillStages - 2>();   // this thread's loads of tile n
    __syncthreads();                       // everyone's; tile n - 1 is done
    if (n + kPrefillStages - 1 < tiles.n_tiles)
      tiles.load(smem + (n + kPrefillStages - 1) % kPrefillStages *
                            L::kStageBytes,
                 n + kPrefillStages - 1);
    cp_async_commit();

    const uint8_t* st = smem + (n % kPrefillStages) * L::kStageBytes;
    const uint8_t* kt = st;
    const uint8_t* vt = st + L::kPayloadBytes;
    if constexpr (P::kQuant) {
      unpack_tile<P, D>(st, smem + PL::kRingBytes);
      __syncthreads();
      kt = smem + PL::kRingBytes;
      vt = kt + PL::kTileBytes;
    }
    const float* sc_s =
        reinterpret_cast<const float*>(st + 2 * L::kPayloadBytes);
    const int k0 = n * kBlockK;
    if (!busy || k0 > wq_hi) continue;   // no row of the warp sees a key
    // Every key of the tile visible to every row of the warp?
    const bool full = k0 + kBlockK <= k_end && k0 + kBlockK - 1 <= wq_lo;

    // S = Q.K^T: s[nt] holds rows g, g + 8 and keys 8 nt + 2t, +1.
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kSteps / 2; ++kp)
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        // Keys 8 nt .., dims 32 kp + 8 mtx ..: B of k-steps 2 kp, 2 kp + 1.
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (8 * nt + r8) * S + (32 * kp + 8 * mtx) * 2);
        mma_16816(s[nt], qa[2 * kp], kb[0], kb[1]);
        mma_16816(s[nt], qa[2 * kp + 1], kb[2], kb[3]);
      }

    float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * nt + 2 * t + (e & 1);
        float sc = scale2;
        if constexpr (P::kQuant) sc *= sc_s[j];
        float x = s[nt][e] * sc;
        if (!full) {
          const int pos = k0 + j;
          x = pos < k_end && pos <= qpos[e / 2] ? x : kNegInf;
        }
        s[nt][e] = x;
        m_tile[e / 2] = fmaxf(m_tile[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(kFull, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(kFull, m_tile[r], 2));
      const float m_new = fmaxf(m[r], m_tile[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = full || x > kNegInf ? exp2_approx(x - m[e / 2]) : 0.f;
        s[nt][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int nt = 0; nt < 2 * kSteps; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P.V, 16 keys a step. S's n-tiles 2j and 2j + 1 are P's A
    // operand for keys 16j .. 16j + 15; P (times V's scales) goes in as
    // a bf16 term and the bf16 of what it left out.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0 = s[2 * j + h][2 * r], p1 = s[2 * j + h][2 * r + 1];
          if constexpr (P::kQuant) {
            const float* vsc = sc_s + kBlockK + 16 * j + 8 * h + 2 * t;
            p0 *= vsc[0];
            p1 *= vsc[1];
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          a_hi[2 * h + r] = *reinterpret_cast<const uint32_t*>(&hi);
          a_lo[2 * h + r] = bf16_pair(p0 - hf.x, p1 - hf.y);
        }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        // Keys 16j + 8 (mtx & 1) .., dims 16 np + 8 (mtx >> 1) ..,
        // transposed: b[0..1] dims 16 np + g, b[2..3] 16 np + 8 + g.
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * j + 8 * (mtx & 1) + r8) * S +
                                  (16 * np + 8 * (mtx >> 1)) * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_16816(o[2 * np + h], a_hi, vb[2 * h], vb[2 * h + 1]);
          mma_16816(o[2 * np + h], a_lo, vb[2 * h], vb[2 * h + 1]);
        }
      }
    }
  }

  if (!busy) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((size_t)(b * T + row / G) * Hq + kvh * G + row % G) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 2 * kSteps; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
          __floats2bfloat162_rn(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
  }
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *lens;
  void* out;
  int B, T, Hq, Hkv, max_len;   // max_len: logical (max_pages * page)
  float scale;
  int splits;                   // decode: key-range splits
  void *part, *tickets;         // decode workspace, when splits > 1
  cudaStream_t stream;
};

template <class P, int D, class Keys>
int launch_prefill(const Args& a, Keys keys) {
  constexpr int kSmem = PrefillLayout<P, D>::kSmemBytes;
  // Once per instantiation: the ring exceeds the 48 KiB default.
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mma_kernel<P, D, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_rows = a.T * (a.Hq / a.Hkv);
  const dim3 grid(a.Hkv, a.B, (n_rows + kPrefillRows - 1) / kPrefillRows);
  prefill_mma_kernel<P, D, Keys><<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.lens), static_cast<__nv_bfloat16*>(a.out),
      a.T, a.Hq, a.Hkv, a.max_len, a.scale, keys);
  return 0;
}

template <class P, int D, class Keys>
int launch_decode(const Args& a, Keys keys) {
  constexpr int kSmem = DecodeLayout<P, D>::kSmemBytes;
  // Once per instantiation: the ring may exceed the 48 KiB default.
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<P, D, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.splits < 1 || (a.splits > 1 && (!a.part || !a.tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.splits, a.Hkv, a.B);
  decode_split_kernel<P, D, Keys><<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.lens), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.part), static_cast<int*>(a.tickets), a.T, a.Hq,
      a.Hkv, a.max_len, a.splits, a.scale, keys);
  return 0;
}

// Decode (at most kDecodeRows query rows per GQA group) splits the keys
// across CTAs; prefill takes 64 rows a CTA.
template <class P, int D, class Keys>
int launch_rows(const Args& a, Keys keys) {
  if (a.T * (a.Hq / a.Hkv) <= kDecodeRows) return launch_decode<P, D>(a, keys);
  return launch_prefill<P, D>(a, keys);
}

// Returns cudaGetLastError() after the launch (0 = launched); a head dim
// or split count it does not take returns cudaErrorInvalidValue
// unlaunched.
template <class P, class Keys>
int launch_head_dim(const Args& a, int D, Keys keys) {
  int err;
  switch (D) {
    case 32: err = launch_rows<P, 32>(a, keys); break;
    case 64: err = launch_rows<P, 64>(a, keys); break;
    case 128: err = launch_rows<P, 128>(a, keys); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

template <class P>
int contiguous(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lens, void* out, int B, int T,
               int Hq, int Hkv, int D, int max_len, float scale, int splits,
               void* part, void* tickets, void* stream) {
  const Args a{q, k, v, ks, vs, lens, out, B, T, Hq, Hkv, max_len, scale,
               splits, part, tickets, static_cast<cudaStream_t>(stream)};
  return launch_head_dim<P>(a, D, ContiguousKeys{max_len});
}

template <class P>
int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* ks_pool, const void* vs_pool, const void* lens,
          const void* tables, void* out, int B, int T, int Hq, int Hkv,
          int D, int page, int max_pages, int n_pages, float scale,
          int splits, void* part, void* tickets, void* stream) {
  const Args a{q, k_pool, v_pool, ks_pool, vs_pool, lens, out, B, T, Hq, Hkv,
               max_pages * page, scale, splits, part, tickets,
               static_cast<cudaStream_t>(stream)};
  return launch_head_dim<P>(
      a, D, PagedKeys{static_cast<const int*>(tables), page, max_pages,
                      n_pages});
}

}  // namespace

// Every entry ends in (splits, part, tickets, stream): the decode kernel's
// key-range splits, its f32 workspace [B, Hkv, splits, 4, D + 2] and its
// int32 tickets [B * Hkv], zero before the call and zero after it (both
// unused with one split, and by prefill).

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     int splits, void* part, void* tickets,
                                     void* stream) {
  return contiguous<Bf16Payload>(q, k, v, nullptr, nullptr, lens, out, B, T,
                                 Hq, Hkv, D, max_len, scale, splits, part,
                                 tickets, stream);
}

extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scales,
                                     const void* v_scales, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     int splits, void* part, void* tickets,
                                     void* stream) {
  return contiguous<Int8Payload>(q, k, v, k_scales, v_scales, lens, out, B,
                                 T, Hq, Hkv, D, max_len, scale, splits, part,
                                 tickets, stream);
}

extern "C" int decode_attention_int4(const void* q, const void* k,
                                     const void* v, const void* k_scales,
                                     const void* v_scales, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     int splits, void* part, void* tickets,
                                     void* stream) {
  return contiguous<Int4Payload>(q, k, v, k_scales, v_scales, lens, out, B,
                                 T, Hq, Hkv, D, max_len, scale, splits, part,
                                 tickets, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, int splits,
    void* part, void* tickets, void* stream) {
  return paged<Bf16Payload>(q, k_pool, v_pool, nullptr, nullptr, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, splits, part, tickets, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, int splits,
    void* part, void* tickets, void* stream) {
  return paged<Int8Payload>(q, k_pool, v_pool, k_scales, v_scales, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, splits, part, tickets, stream);
}

extern "C" int paged_decode_attention_int4(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, int splits,
    void* part, void* tickets, void* stream) {
  return paged<Int4Payload>(q, k_pool, v_pool, k_scales, v_scales, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, splits, part, tickets, stream);
}
