// K7, the real-fault demo kernel: out = x * 2, staged through shared
// memory one tile at a time.
//
// Replaces the TPU kernel demo/tpu-error/real-fault/provoke_vmem_oom.py
// (`kernel`, pl.pallas_call at line 24). There the whole [4096, 4096]
// f32 array is one 64 MiB block in VMEM, the TPU's on-chip scratch, and
// the compiler refuses it: that refusal is the real fault the health
// checker's VMEM_OOM rule is held against. Shared memory is the card's
// on-chip scratch, so the tile here lives in STATIC shared memory of
// K7_TILE_ROWS rows x 4096 columns:
//   - the kernel library builds it with 2 rows (32 KiB, under the 48 KiB
//     a block may hold statically): the healthy K7, held against
//     x * 2.0 (exact in f32);
//   - demo/real_fault/provoke_smem_oom.py compiles this same source with
//     -DK7_TILE_ROWS=4096, the whole array as one block as the Pallas
//     kernel asked, and the toolchain refuses it at compile time, as
//     Mosaic refused the TPU block.
//
// What bounds it on an H100: bytes (each element read once and written
// once, one multiply). The array is walked as flat tiles, so any shape
// works and the last tile is ragged; each thread moves 16 bytes at a
// time, neighbouring threads on neighbouring addresses. The simple first
// version: no TMA, no cp.async.
#include <cuda_runtime.h>

#ifndef K7_TILE_ROWS
#define K7_TILE_ROWS 2
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = static_cast<long long>(K7_TILE_ROWS) * 4096;

__global__ void __launch_bounds__(kThreads)
    scale_demo_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n) {
  __shared__ __align__(16) float tile[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int count = static_cast<int>(min(kTile, n - base));
  const int n4 = count >> 2;   // tiles start 16-byte aligned: kTile % 4 == 0
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < n4; i += kThreads) t4[i] = x4[i];
  for (int i = (n4 << 2) + threadIdx.x; i < count; i += kThreads)
    tile[i] = x[base + i];
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    float4 v = t4[i];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    o4[i] = v;
  }
  for (int i = (n4 << 2) + threadIdx.x; i < count; i += kThreads)
    out[base + i] = tile[i] * 2.0f;
}

}  // namespace

// x and out: n f32 values each, 16-byte aligned, n > 0.
extern "C" int scale_demo_f32(const void* x, void* out, long long n,
                              void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  scale_demo_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
