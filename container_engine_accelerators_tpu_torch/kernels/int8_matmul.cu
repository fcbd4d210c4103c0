// W8A16 matrix product for int8-quantized weights: y = (x @ q) * s.
//
// Replaces the TPU kernel container_engine_accelerators_tpu/ops/
// quant.py::int8_matmul (_int8_matmul_kernel, pl.pallas_call at line
// 214). Same function:
//   x [T, D] bf16 or f32, q [D, F] int8 (row-major), s [F] f32
//   y [T, F] in x's dtype, y = (sum_d x[t, d] * q[d, f]) * s[f]
// with the sum in f32 and the per-column scale applied once at the end.
//
// What bounds it on an H100: bytes. At decode T is the batch (<= 8), so
// each weight byte is used for at most 8 multiply-adds and the D*F int8
// bytes are the whole cost; the point of int8 storage is that this is
// half the bf16 weight stream. The design:
//   - the weight tile goes from HBM straight into registers, 4 bytes (4
//     neighbouring output columns) per thread and 32 rows in flight at
//     a time, and is converted to f32 there; no shared-memory copy;
//   - x is staged in shared memory in f32, 8 rows by 256 columns at a
//     time, and read as a broadcast;
//   - a decode-sized product has too few column blocks to fill the
//     card's SMs (132 on an H100 SXM), so the contraction is split (`splits` blocks along D, chosen by the
//     caller) into an f32 scratch [splits, T, F]; a second small kernel
//     sums the splits in a fixed order, scales and casts. No atomics, so
//     the result is the same from run to run.
// This is the simple first version: no tensor cores, no TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;       // output columns per thread (one 4-B load)
constexpr int kTileT = 8;      // rows of x per block
constexpr int kChunkD = 256;   // columns of x staged per pass
constexpr int kBatch = 32;     // weight rows loaded before they are used

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// acc[r][j] += x_s[r][c] * w[j] for the 4 int8 weights in `q`.
__device__ __forceinline__ void fma_row(float (&acc)[kTileT][kCols],
                                        const float (&x_s)[kTileT][kChunkD],
                                        int c, char4 q) {
  const float w[kCols] = {static_cast<float>(q.x), static_cast<float>(q.y),
                          static_cast<float>(q.z), static_cast<float>(q.w)};
#pragma unroll
  for (int r = 0; r < kTileT; ++r) {
    const float xv = x_s[r][c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] += xv * w[j];
  }
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_partial(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ partial, int T, int D, int F,
                    int d_per_split) {
  __shared__ float x_s[kTileT][kChunkD];
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int t0 = blockIdx.z * kTileT;
  const int d_begin = split * d_per_split;
  const int d_end = min(D, d_begin + d_per_split);
  const int f4 = F / kCols;

  float acc[kTileT][kCols];
#pragma unroll
  for (int r = 0; r < kTileT; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int c0 = d_begin; c0 < d_end; c0 += kChunkD) {
    const int n = min(kChunkD, d_end - c0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < kTileT * kChunkD; i += kThreads) {
      const int r = i / kChunkD, c = i % kChunkD;
      const int t = t0 + r;
      x_s[r][c] = (t < T && c < n) ? to_f32(x[(size_t)t * D + c0 + c]) : 0.f;
    }
    __syncthreads();
    if (col < F) {
      const char4* wp = reinterpret_cast<const char4*>(w) +
                        (size_t)c0 * f4 + col / kCols;
      int c = 0;
      // Start kBatch independent loads, then use them: keeps enough
      // bytes in flight per thread to cover the memory latency.
      for (; c + kBatch <= n; c += kBatch) {
        char4 q[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) q[u] = wp[(size_t)(c + u) * f4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) fma_row(acc, x_s, c + u, q[u]);
      }
      for (; c < n; ++c) fma_row(acc, x_s, c, wp[(size_t)c * f4]);
    }
  }
  if (col >= F) return;
#pragma unroll
  for (int r = 0; r < kTileT; ++r) {
    const int t = t0 + r;
    if (t < T) {
      *reinterpret_cast<float4*>(partial + ((size_t)split * T + t) * F +
                                 col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <typename OT>
__global__ void int8_matmul_finish(const float* __restrict__ partial,
                                   const float* __restrict__ scales,
                                   OT* __restrict__ y, int T, int F,
                                   int splits) {
  const size_t n = (size_t)T * F;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[s * n + i];
  y[i] = from_f32<OT>(sum * scales[i % F]);
}

template <typename XT>
void launch(const void* x, const void* w, const void* scales, void* partial,
            void* y, int T, int D, int F, int d_per_split, int splits,
            cudaStream_t stream) {
  const int cols_per_block = kThreads * kCols;
  const dim3 grid((F + cols_per_block - 1) / cols_per_block, splits,
                  (T + kTileT - 1) / kTileT);
  int8_matmul_partial<XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(partial), T, D, F, d_per_split);
  const size_t n = (size_t)T * F;
  const int threads = 256;
  int8_matmul_finish<XT><<<(unsigned)((n + threads - 1) / threads), threads,
                           0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scales),
      static_cast<XT*>(y), T, F, splits);
}

}  // namespace

// F must be a multiple of 4 and every pointer 16-byte aligned (checked
// by the Python wrapper). Returns cudaGetLastError() after the launches.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           void* partial, void* y, int x_is_bf16, int T,
                           int D, int F, int d_per_split, int splits,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % kCols) return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_bf16)
    launch<__nv_bfloat16>(x, w, scales, partial, y, T, D, F, d_per_split,
                          splits, s);
  else
    launch<float>(x, w, scales, partial, y, T, D, F, d_per_split, splits, s);
  return static_cast<int>(cudaGetLastError());
}
