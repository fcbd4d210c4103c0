// GQA attention of T new queries over a bf16 KV cache, for every
// prefill and decode step of the serving path: K1 over a contiguous
// cache, K3 over a paged one.
//
// K1 replaces the TPU kernel container_engine_accelerators_tpu/ops/
// decode_attention.py::decode_attention (_decode_kernel, pl.pallas_call
// at line 282) in its bf16-cache mode. Same function:
//   q     [B, T, Hq, D] bf16, queries at absolute positions
//         [cache_len, cache_len + T)
//   k, v  [B, max_len, Hkv, D] bf16, the new tokens already written
//   lens  [B] int32 cache_len per batch row
//   out   [B, T, Hq, D] bf16
// Query t of head h sees key positions p with p < live = cache_len + T
// and p <= cache_len + t. Online softmax with m, l and the accumulator
// in f32; p.v in f32, as the Pallas body does.
//
// K3 replaces ...::paged_decode_attention (paged_kernel, pl.pallas_call
// at line 391) in its bf16 mode. It computes K1's function in logical
// positions; only a key's address differs. The cache is a page pool
//   k, v    [n_pages, page, Hkv, D] bf16
//   tables  [B, max_pages] int32, the pool row of each logical page
// and key `pos` of row b lives at pool row
// clamp(tables[b, pos / page], 0, n_pages - 1), offset pos % page, with
// max_len = max_pages * page. As in the Pallas version, the body is K1's:
// the kernel is a template over how a key's row is addressed. The page
// is looked up per key, not per tile, so a 64-key tile may straddle
// pages and any page size works.
//
// What bounds it on an H100: bytes. Every step streams the live part of
// the cache once (HBM, 3.35 TB/s on the SXM part); the arithmetic is
// ~2 flops per cache byte per query row. The design, the simple first
// version:
//   - one CTA per (query block, KV head, batch row): its rows are queries
//     of one GQA group (G = Hq/Hkv), so the G heads sharing a KV head
//     read each K/V tile once. Each CTA walks its keys in order, as one
//     TPU core did. A decode step has only B*Hkv CTAs, too few for 132
//     SMs; splitting the key range across CTAs waits for a later version;
//   - the key loop stops at cache_len + (last query of the block) + 1:
//     positions at or past `live` are never read (nor, paged, are their
//     table entries), so a reused cache holding NaN there, or a stale
//     table entry, cannot reach the accumulator;
//   - K/V tiles of 64 keys come in with 16-byte loads and sit in shared
//     memory with an odd row stride (in 32-bit words), so a lane per key
//     reads its row without bank conflicts; one warp reduction per tile
//     gives the tile max and sum;
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

// Row of key `pos` of batch row b, in units of Hkv * D elements.
struct ContiguousKeys {
  int max_len;
  __device__ __forceinline__ size_t row(int b, int pos) const {
    return (size_t)b * max_len + pos;
  }
};

struct PagedKeys {
  const int* tables;   // [B, max_pages]
  int page, max_pages, n_pages;
  __device__ __forceinline__ size_t row(int b, int pos) const {
    int r = tables[(size_t)b * max_pages + pos / page];
    r = min(max(r, 0), n_pages - 1);
    return (size_t)r * page + pos % page;
  }
};

template <int D, int RPW, class Keys>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out, int T, int Hq,
                        int Hkv, int max_len, float scale, Keys keys) {
  constexpr int kPairs = D / 2;                    // bf16x2 words per row
  constexpr int kStride = kPairs + 1;              // odd: conflict-free
  constexpr int kPairsPerLane = (kPairs + 31) / 32;
  constexpr int kRows = kWarps * RPW;
  constexpr int kVec = 4;                          // words per 16-B load

  __shared__ __nv_bfloat162 k_s[kBlockK * kStride];
  __shared__ __nv_bfloat162 v_s[kBlockK * kStride];
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

  const uint4* k4 = reinterpret_cast<const uint4*>(k);
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
  uint32_t* k_w = reinterpret_cast<uint32_t*>(k_s);
  uint32_t* v_w = reinterpret_cast<uint32_t*>(v_s);
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile is consumed; q_s is staged
    constexpr int kChunks = kPairs / kVec;         // 16-B loads per row
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
      for (int p = 0; p < kPairs; ++p) {
        const float2 qq = __bfloat1622float2(qr[p]);
        const float qa = qq.x, qb = qq.y;
        const float2 ka = __bfloat1622float2(k_s[lane * kStride + p]);
        const float2 kb = __bfloat1622float2(k_s[(lane + 32) * kStride + p]);
        s0 += qa * ka.x + qb * ka.y;
        s1 += qa * kb.x + qb * kb.y;
      }
      const int pos0 = k0 + lane, pos1 = pos0 + 32;
      const bool ok0 = pos0 < k_end && pos0 <= qpos[rr];
      const bool ok1 = pos1 < k_end && pos1 <= qpos[rr];
      s0 = ok0 ? s0 * scale : kNegInf;
      s1 = ok1 ? s1 * scale : kNegInf;
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
        const float pj = __shfl_sync(kFull, j < 32 ? p0 : p1, j & 31);
#pragma unroll
        for (int i = 0; i < kPairsPerLane; ++i) {
          const int p = lane + 32 * i;
          if (p < kPairs) {
            const float2 vv = __bfloat1622float2(v_s[j * kStride + p]);
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
  const void *q, *k, *v, *lens;
  void* out;
  int B, T, Hq, Hkv, max_len;   // max_len: logical (max_pages * page)
  float scale;
  cudaStream_t stream;
};

template <int D, int RPW, class Keys>
void launch(const Args& a, Keys keys) {
  constexpr int kRows = kWarps * RPW;
  const int n_rows = a.T * (a.Hq / a.Hkv);
  const dim3 grid((n_rows + kRows - 1) / kRows, a.Hkv, a.B);
  decode_attention_kernel<D, RPW, Keys><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const int*>(a.lens), static_cast<__nv_bfloat16*>(a.out),
      a.T, a.Hq, a.Hkv, a.max_len, a.scale, keys);
}

// Decode (at most 4 query rows per GQA group) runs one row per warp,
// prefill four.
template <int D, class Keys>
void launch_rows(const Args& a, Keys keys) {
  if (a.T * (a.Hq / a.Hkv) <= kWarps)
    launch<D, 1>(a, keys);
  else
    launch<D, 4>(a, keys);
}

// Returns cudaGetLastError() after the launch (0 = launched); a head dim
// it does not take returns cudaErrorInvalidValue unlaunched.
template <class Keys>
int launch_head_dim(const Args& a, int D, Keys keys) {
  switch (D) {
    case 32: launch_rows<32>(a, keys); break;
    case 64: launch_rows<64>(a, keys); break;
    case 128: launch_rows<128>(a, keys); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lens,
                                     void* out, int B, int T, int Hq,
                                     int Hkv, int D, int max_len, float scale,
                                     void* stream) {
  const Args a{q, k, v, lens, out, B, T, Hq, Hkv, max_len, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_head_dim(a, D, ContiguousKeys{max_len});
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* lens,
    const void* tables, void* out, int B, int T, int Hq, int Hkv, int D,
    int page, int max_pages, int n_pages, float scale, void* stream) {
  const Args a{q, k_pool, v_pool, lens, out, B, T, Hq, Hkv,
               max_pages * page, scale, static_cast<cudaStream_t>(stream)};
  return launch_head_dim(
      a, D, PagedKeys{static_cast<const int*>(tables), page, max_pages,
                      n_pages});
}
