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
// The dequantization is f32, as in the Pallas body, never a bf16 tile:
// the kernel stages the integer payload and the tile's scales in shared
// memory and computes s = scale * k_scale[j] * sum_d q_d * k_int[j, d]
// and acc += (p_j * v_scale[j]) * v_int[j, :], the same function up to
// f32 reassociation.
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
// Pallas version, the body is K1's: the kernel is a template over how a
// key's row and scale are addressed and how its row is stored. The page
// is looked up per key, not per tile, so a 64-key tile may straddle
// pages and any page size works.
//
// What bounds it on an H100: bytes. Every step streams the live part of
// the cache once (HBM, 3.35 TB/s on the SXM part); the arithmetic is
// ~2 flops per cache element per query row. The design, the simple first
// version:
//   - one CTA per (query block, KV head, batch row): its rows are queries
//     of one GQA group (G = Hq/Hkv), so the G heads sharing a KV head
//     read each K/V tile once. Each CTA walks its keys in order, as one
//     TPU core did. A decode step has only B*Hkv CTAs, too few for 132
//     SMs; splitting the key range across CTAs waits for a later version;
//   - the key loop stops at cache_len + (last query of the block) + 1:
//     positions at or past `live` are never read (nor their scales, nor,
//     paged, their table entries), so a reused cache holding NaN or stale
//     scales there, or a stale table entry, cannot reach the accumulator;
//   - K/V tiles of 64 keys come in with 16-byte loads and sit in shared
//     memory with an odd row stride in 32-bit words (D/2 + 1 for bf16,
//     D/4 + 1 for int8, D/8 + 1 for int4), so a lane per key reads its
//     row without bank conflicts; one warp reduction per tile gives the
//     tile max and sum;
//   - in p.v a lane owns output dims (2p, 2p+1) whatever the payload: a
//     bf16 word, an int8 halfword, or for int4 the low (p < D/4) or high
//     nibbles of halfword p mod D/4, each nibble sign-extended;
//   - decode (T*G <= 4 rows) runs one row per warp; prefill four, so a
//     CTA's 16 rows share each tile it loads.
// No TMA and no wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;          // keys per shared-memory tile
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float2 bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Bits [lo, lo + n) of w as a signed integer, in f32.
template <int lo, int n>
__device__ __forceinline__ float sbits(uint32_t w) {
  return static_cast<float>(static_cast<int>(w << (32 - lo - n)) >> (32 - n));
}

// How a cache row of D values is stored. `words`: 32-bit words a row;
// `dot`: q . k over word p of a key row (qr: the query row as bf16
// pairs); `v_pair`: output dims (2p, 2p+1) of a value row.
struct Bf16Payload {
  static constexpr bool kQuant = false;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 2; }
  template <int D>
  __device__ static float dot(const __nv_bfloat162* qr, int p, uint32_t w) {
    const float2 qq = __bfloat1622float2(qr[p]), kk = bf16x2(w);
    return qq.x * kk.x + qq.y * kk.y;
  }
  template <int D>
  __device__ static float2 v_pair(const uint32_t* row, int p) {
    return bf16x2(row[p]);
  }
};

// One signed byte an element: word p holds elements 4p .. 4p + 3.
struct Int8Payload {
  static constexpr bool kQuant = true;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 4; }
  template <int D>
  __device__ static float dot(const __nv_bfloat162* qr, int p, uint32_t w) {
    const float2 a = __bfloat1622float2(qr[2 * p]);
    const float2 b = __bfloat1622float2(qr[2 * p + 1]);
    return a.x * sbits<0, 8>(w) + a.y * sbits<8, 8>(w) +
           b.x * sbits<16, 8>(w) + b.y * sbits<24, 8>(w);
  }
  template <int D>
  __device__ static float2 v_pair(const uint32_t* row, int p) {
    const uint32_t h = reinterpret_cast<const uint16_t*>(row)[p];
    return make_float2(sbits<0, 8>(h), sbits<8, 8>(h));
  }
};

// Split-half nibbles: byte j holds element j (low) and j + D/2 (high), so
// word p holds elements 4p .. 4p + 3 and D/2 + 4p .. D/2 + 4p + 3.
struct Int4Payload {
  static constexpr bool kQuant = true;
  template <int D>
  __host__ __device__ static constexpr int words() { return D / 8; }
  template <int D>
  __device__ static float dot(const __nv_bfloat162* qr, int p, uint32_t w) {
    const float2 a = __bfloat1622float2(qr[2 * p]);
    const float2 b = __bfloat1622float2(qr[2 * p + 1]);
    const float2 c = __bfloat1622float2(qr[D / 4 + 2 * p]);
    const float2 d = __bfloat1622float2(qr[D / 4 + 2 * p + 1]);
    return a.x * sbits<0, 4>(w) + a.y * sbits<8, 4>(w) +
           b.x * sbits<16, 4>(w) + b.y * sbits<24, 4>(w) +
           c.x * sbits<4, 4>(w) + c.y * sbits<12, 4>(w) +
           d.x * sbits<20, 4>(w) + d.y * sbits<28, 4>(w);
  }
  // Dims (2p, 2p+1): the low nibbles of halfword p for p < D/4, else the
  // high nibbles of halfword p - D/4.
  template <int D>
  __device__ static float2 v_pair(const uint32_t* row, int p) {
    const bool high = p >= D / 4;
    uint32_t h = reinterpret_cast<const uint16_t*>(row)[high ? p - D / 4 : p];
    if (high) h >>= 4;
    return make_float2(sbits<0, 4>(h), sbits<8, 4>(h));
  }
};

// Row of key `pos` of batch row b, in units of Hkv rows of one token, and
// the index of its scale for KV head h.
struct ContiguousKeys {
  int max_len;
  __device__ __forceinline__ size_t row(int b, int pos) const {
    return (size_t)b * max_len + pos;
  }
  __device__ __forceinline__ size_t scale(int b, int h, int Hkv,
                                          int pos) const {
    return ((size_t)b * Hkv + h) * max_len + pos;
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
};

template <class P, int D, int RPW, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out, int T, int Hq,
                        int Hkv, int max_len, float scale, Keys keys) {
  constexpr int kPairs = D / 2;                    // output dims / 2
  constexpr int kWords = P::template words<D>();  // payload words per row
  constexpr int kStride = kWords + 1;              // odd: conflict-free
  constexpr int kPairsPerLane = (kPairs + 31) / 32;
  constexpr int kRows = kWarps * RPW;
  constexpr int kVec = 4;                          // words per 16-B load
  constexpr int kScaled = P::kQuant ? kBlockK : 1;

  __shared__ uint32_t k_w[kBlockK * kStride];
  __shared__ uint32_t v_w[kBlockK * kStride];
  __shared__ float ks_s[kScaled];
  __shared__ float vs_s[kScaled];
  __shared__ __nv_bfloat162 q_s[kRows][kPairs];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int n_rows = T * G;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cache_len = lens[b];
  const int live = min(cache_len + T, max_len);
  const int t_last = min(row0 + kRows - 1, n_rows - 1) / G;
  const int k_end = min(live, cache_len + t_last + 1);

  // Stage this block's query rows (rows past T*G stay zero); bf16 here,
  // f32 in the arithmetic, as the Pallas body casts q.
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(q);
  for (int i = threadIdx.x; i < kRows * kPairs; i += kThreads) {
    const int r = i / kPairs, p = i % kPairs;
    const int row = row0 + r;
    __nv_bfloat162 val = __float2bfloat162_rn(0.f);
    if (row < n_rows) {
      const int t = row / G, h = kvh * G + row % G;
      val = q2[((size_t)(b * T + t) * Hq + h) * kPairs + p];
    }
    q_s[r][p] = val;
  }

  float m[RPW], l[RPW];
  int qpos[RPW];   // absolute position of the row's query, -1 for padding
  float2 acc[RPW][kPairsPerLane];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + warp * RPW + rr;
    m[rr] = kNegInf;
    l[rr] = 0.f;
    qpos[rr] = row < n_rows ? cache_len + row / G : -1;
#pragma unroll
    for (int i = 0; i < kPairsPerLane; ++i) acc[rr][i] = make_float2(0.f, 0.f);
  }

  const uint4* k4 = static_cast<const uint4*>(k);
  const uint4* v4 = static_cast<const uint4*>(v);
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile is consumed; q_s is staged
    constexpr int kChunks = kWords / kVec;         // 16-B loads per row
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int pos = k0 + j;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = kw;
      if (pos < k_end) {   // never read at or past `live`
        const size_t off = (keys.row(b, pos) * Hkv + kvh) * kChunks + c;
        kw = k4[off];
        vw = v4[off];
      }
      uint32_t* kd = k_w + j * kStride + c * kVec;
      uint32_t* vd = v_w + j * kStride + c * kVec;
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
    }
    if constexpr (P::kQuant) {
      for (int j = threadIdx.x; j < kBlockK; j += kThreads) {
        const int pos = k0 + j;
        float ks = 0.f, vs = 0.f;
        if (pos < k_end) {   // nor a scale at or past `live`
          const size_t si = keys.scale(b, kvh, Hkv, pos);
          ks = k_scales[si];
          vs = v_scales[si];
        }
        ks_s[j] = ks;
        vs_s[j] = vs;
      }
    }
    __syncthreads();
    const int tile_keys = min(kBlockK, k_end - k0);

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      if (qpos[rr] < k0) continue;   // padding, or no visible key here;
                                     // uniform across the warp
      const __nv_bfloat162* qr = q_s[warp * RPW + rr];
      // Lane owns keys k0 + lane and k0 + lane + 32.
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int p = 0; p < kWords; ++p) {
        s0 += P::template dot<D>(qr, p, k_w[lane * kStride + p]);
        s1 += P::template dot<D>(qr, p, k_w[(lane + 32) * kStride + p]);
      }
      float scale0 = scale, scale1 = scale;
      if constexpr (P::kQuant) {
        scale0 *= ks_s[lane];
        scale1 *= ks_s[lane + 32];
      }
      const int pos0 = k0 + lane, pos1 = pos0 + 32;
      const bool ok0 = pos0 < k_end && pos0 <= qpos[rr];
      const bool ok1 = pos1 < k_end && pos1 <= qpos[rr];
      s0 = ok0 ? s0 * scale0 : kNegInf;
      s1 = ok1 ? s1 * scale1 : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[rr] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kPairsPerLane; ++i) {
        acc[rr][i].x *= alpha;
        acc[rr][i].y *= alpha;
      }
      const int keys = min(tile_keys, qpos[rr] - k0 + 1);
      for (int j = 0; j < keys; ++j) {
        float pj = __shfl_sync(kFull, j < 32 ? p0 : p1, j & 31);
        if constexpr (P::kQuant) pj *= vs_s[j];
#pragma unroll
        for (int i = 0; i < kPairsPerLane; ++i) {
          const int p = lane + 32 * i;
          if (p < kPairs) {
            const float2 vv = P::template v_pair<D>(v_w + j * kStride, p);
            acc[rr][i].x += pj * vv.x;
            acc[rr][i].y += pj * vv.y;
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + warp * RPW + rr;
    if (row >= n_rows) continue;
    const int t = row / G, h = kvh * G + row % G;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
    for (int i = 0; i < kPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      if (p < kPairs)
        out2[((size_t)(b * T + t) * Hq + h) * kPairs + p] =
            __floats2bfloat162_rn(acc[rr][i].x * inv, acc[rr][i].y * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *lens;
  void* out;
  int B, T, Hq, Hkv, max_len;   // max_len: logical (max_pages * page)
  float scale;
  cudaStream_t stream;
};

template <class P, int D, int RPW, class Keys>
void launch(const Args& a, Keys keys) {
  constexpr int kRows = kWarps * RPW;
  const int n_rows = a.T * (a.Hq / a.Hkv);
  const dim3 grid((n_rows + kRows - 1) / kRows, a.Hkv, a.B);
  decode_attention_kernel<P, D, RPW, Keys><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.lens), static_cast<__nv_bfloat16*>(a.out),
      a.T, a.Hq, a.Hkv, a.max_len, a.scale, keys);
}

// Decode (at most 4 query rows per GQA group) runs one row per warp,
// prefill four.
template <class P, int D, class Keys>
void launch_rows(const Args& a, Keys keys) {
  if (a.T * (a.Hq / a.Hkv) <= kWarps)
    launch<P, D, 1>(a, keys);
  else
    launch<P, D, 4>(a, keys);
}

// Returns cudaGetLastError() after the launch (0 = launched); a head dim
// it does not take returns cudaErrorInvalidValue unlaunched.
template <class P, class Keys>
int launch_head_dim(const Args& a, int D, Keys keys) {
  switch (D) {
    case 32: launch_rows<P, 32>(a, keys); break;
    case 64: launch_rows<P, 64>(a, keys); break;
    case 128: launch_rows<P, 128>(a, keys); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int contiguous(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* lens, void* out, int B, int T,
               int Hq, int Hkv, int D, int max_len, float scale,
               void* stream) {
  const Args a{q, k, v, ks, vs, lens, out, B, T, Hq, Hkv, max_len, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_head_dim<P>(a, D, ContiguousKeys{max_len});
}

template <class P>
int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* ks_pool, const void* vs_pool, const void* lens,
          const void* tables, void* out, int B, int T, int Hq, int Hkv,
          int D, int page, int max_pages, int n_pages, float scale,
          void* stream) {
  const Args a{q, k_pool, v_pool, ks_pool, vs_pool, lens, out, B, T, Hq, Hkv,
               max_pages * page, scale, static_cast<cudaStream_t>(stream)};
  return launch_head_dim<P>(
      a, D, PagedKeys{static_cast<const int*>(tables), page, max_pages,
                      n_pages});
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     void* stream) {
  return contiguous<Bf16Payload>(q, k, v, nullptr, nullptr, lens, out, B, T,
                                 Hq, Hkv, D, max_len, scale, stream);
}

extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scales,
                                     const void* v_scales, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     void* stream) {
  return contiguous<Int8Payload>(q, k, v, k_scales, v_scales, lens, out, B,
                                 T, Hq, Hkv, D, max_len, scale, stream);
}

extern "C" int decode_attention_int4(const void* q, const void* k,
                                     const void* v, const void* k_scales,
                                     const void* v_scales, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     void* stream) {
  return contiguous<Int4Payload>(q, k, v, k_scales, v_scales, lens, out, B,
                                 T, Hq, Hkv, D, max_len, scale, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, void* stream) {
  return paged<Bf16Payload>(q, k_pool, v_pool, nullptr, nullptr, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, void* stream) {
  return paged<Int8Payload>(q, k_pool, v_pool, k_scales, v_scales, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, stream);
}

extern "C" int paged_decode_attention_int4(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, void* stream) {
  return paged<Int4Payload>(q, k_pool, v_pool, k_scales, v_scales, lens,
                            tables, out, B, T, Hq, Hkv, D, page, max_pages,
                            n_pages, scale, stream);
}
