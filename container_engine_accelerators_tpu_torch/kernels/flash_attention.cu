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
// live key adds exp(0) garbage that the next live tile's alpha = 0 wipes,
// as on the TPU. p is rounded to bf16 before P.V and P^T.dO, ds before
// ds.K and ds^T.q; m, l and every accumulator are f32; l is clamped to
// 1e-30 before lse = m + log(l).
//
// What bounds them on an H100: operations. At B 4, S 2048, 32 q heads,
// D 128, causal, K4 does 137 GFLOP (0.139 ms at 989 TFLOP/s bf16), K5
// 206 and K6 275, against ~0.05 ms of bytes each. So the products run on
// the tensor cores, through mma.sync m16n8k16 (bf16 in, f32 out), whose
// fragment layouts are fixed, so the softmax runs on the accumulators in
// registers (FlashAttention-2's scheme):
//   - K4: one CTA per (q tile of 64, q head, batch row), a warp per 16
//     query rows, looping over 64-key tiles up to the diagonal; heavy
//     (late) q tiles launch first;
//   - K5: the same grid; Q and dO stay in shared memory, K/V tiles stream;
//   - K6: one CTA per (k tile of 64, KV head, batch row), a warp per 16
//     keys, looping over the Hq/Hkv q heads of its group and over 32-row
//     q tiles from the diagonal on. dk and dv sum the whole group in f32
//     and round once; no KV head is repeated in memory and no atomics
//     are used, so every kernel is deterministic.
// No blocks above the diagonal are visited, so the TPU's 'rect' and 'tri'
// causal grids are one schedule here. Tiles come in with 16-byte loads
// and sit in shared memory with rows padded by 16 bytes, so fragment
// reads are free of bank conflicts. No cp.async pipeline, TMA or wgmma
// yet: those are the next steps toward the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;              // head_dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;            // q rows (K4, K5) or keys (K6) a CTA
constexpr int kKeyTile = 64;         // keys per step of K4 and K5
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

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ seg,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int Hq, int Hkv, int causal) {
  __shared__ __align__(16) bf16 k_s[kKeyTile * kStride];
  __shared__ __align__(16) bf16 v_s[kKeyTile * kStride];
  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = q_tile * kTile;
  const int r0 = q0 + warp * 16;        // this warp's first query row
  const size_t q_pitch = (size_t)Hq * kD, kv_pitch = (size_t)Hkv * kD;
  const bf16* qb = q + ((size_t)b * S * Hq + h) * kD;
  const bf16* kb = k + ((size_t)b * S * Hkv + kvh) * kD;
  const bf16* vb = v + ((size_t)b * S * Hkv + kvh) * kD;
  const float* segb = seg ? seg + (size_t)b * S : nullptr;

  // Q through shared memory into registers, once.
  load_tile(k_s, qb + q0 * q_pitch, kTile, q_pitch);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    load_a(qf[kk], k_s, warp * 16, kk * 16, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = causal ? (q0 + kTile) / kKeyTile : S / kKeyTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeyTile;
    __syncthreads();   // the previous tile (or Q) is consumed
    load_tile(k_s, kb + k0 * kv_pitch, kKeyTile, kv_pitch);
    load_tile(v_s, vb + k0 * kv_pitch, kKeyTile, kv_pitch);
    __syncthreads();

    float s[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        uint32_t bf[2];
        load_b(bf, k_s, j * 8, kk * 16, g, t);
        mma(s[j], qf[kk], bf);
      }
    mask_scores<kKeyTile / 8>(s, r0, k0,
                              causal && k0 + kKeyTile - 1 > q0, segb, segb,
                              g, t, true);

    // Online softmax over the tile, rows g (r = 0) and g + 8 (r = 1);
    // the four lanes of a quad hold one row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // o += p.bf16 @ V: the score accumulators are the A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        uint32_t bf[2];
        load_b_t(bf, v_s, kk * 16, j * 8, g, t);
        mma(o[j], a, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float lr = fmaxf(l[r], 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * S + row) * q_pitch + (size_t)h * kD);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      dst[j * 4 + t] = __floats2bfloat162_rn(o[j][2 * r] / lr,
                                             o[j][2 * r + 1] / lr);
    if (t == 0) lse[((size_t)b * Hq + h) * S + row] = m[r] + logf(lr);
  }
}

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

// The shapes every entry point takes: D 128, S a multiple of 64, Hq a
// multiple of Hkv. Anything else returns cudaErrorInvalidValue
// unlaunched (the Python wrappers check first).
bool bad_shape(int B, int S, int Hq, int Hkv, int D) {
  return D != kD || B < 1 || S < kTile || S % kTile || Hkv < 1 ||
         Hq % Hkv;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* seg, void* out, void* lse, int B,
                              int S, int Hq, int Hkv, int D, int causal,
                              void* stream) {
  if (bad_shape(B, S, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S / kTile, Hq, B);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(seg),
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
