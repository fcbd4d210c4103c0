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
//   - the kernel library builds it with 1 row (16 KiB, under the 48 KiB
//     a block may hold statically): the healthy K7, held against
//     x * 2.0 (exact in f32);
//   - demo/real_fault/provoke_smem_oom.py compiles this same source with
//     -DK7_TILE_ROWS=4096, the whole array as one block as the Pallas
//     kernel asked, and the toolchain refuses it at compile time, as
//     Mosaic refused the TPU block.
//
// What bounds it on an H100: bytes (each element read once and written
// once, one multiply): 0.0401 ms for [4096, 4096] at 3.35 TB/s, where
// torch.mul's own kernel reaches 84%. The design, chosen by timing
// variants beside torch.mul in turns on the card (PERF.md):
//   - small tiles, many blocks: a 16 KiB tile a block, 4096 blocks for
//     the demo's array, up to 8 resident on an SM (256 threads each);
//     32 KiB tiles left a longer tail, and one block a resident slot
//     walking tiles through a cp.async or TMA ring, with the next tile's
//     loads issued before this tile's stores, ran slower still;
//   - each thread moves 16 bytes at a time, neighbouring threads on
//     neighbouring addresses, issues its 4 loads of a tile before it
//     writes any to the tile, and reads back only the slots it filled,
//     so the warps of a block never wait for each other.
// The array is walked as flat tiles, so any shape works and the last
// tile is ragged.
#include <cuda_runtime.h>

#ifndef K7_TILE_ROWS
#define K7_TILE_ROWS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = static_cast<long long>(K7_TILE_ROWS) * 4096;
constexpr int kBatch = 4;   // 16-byte loads a thread has in flight
constexpr long long kPer = kTile / 4 / kThreads;   // 16-byte slots a thread
static_assert(kPer % kBatch == 0, "a tile is whole batches");

__global__ void __launch_bounds__(kThreads)
    scale_demo_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n) {
  __shared__ __align__(16) float tile[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int count = static_cast<int>(min(kTile, n - base));
  const int n4 = count >> 2;   // tiles start 16-byte aligned: kTile % 4 == 0
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  float4* t4 = reinterpret_cast<float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (long long j0 = 0; j0 < kPer; j0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long i = (j0 + j) * kThreads + threadIdx.x;
      if (i < n4) v[j] = x4[i];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long i = (j0 + j) * kThreads + threadIdx.x;
      if (i < n4) t4[i] = v[j];
    }
  }
  for (int i = (n4 << 2) + threadIdx.x; i < count; i += kThreads)
    tile[i] = x[base + i];
  __syncwarp();   // the warp's tile writes before its reads
  for (long long j0 = 0; j0 < kPer; j0 += kBatch) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long i = (j0 + j) * kThreads + threadIdx.x;
      if (i < n4) {
        float4 v = t4[i];
        v.x *= 2.0f;
        v.y *= 2.0f;
        v.z *= 2.0f;
        v.w *= 2.0f;
        o4[i] = v;
      }
    }
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
