// Banked burst scatter (the paper's §II-C split dispatch) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `banked_copy` of the reference package
// (src/repro/kernels/banked_copy/kernel.py).  A request's fresh KV "burst"
// [B, nblk, bs, W] is cut into its blocks ("beats") and block (b, j) lands in
// the pool [NB, bs, W] at row block_table[b, j], in place.  An entry of -1
// skips its block; the Pallas kernel redirects it to a trash row instead.
//
// Design.  The Pallas grid (B, nblk) moves one [bs, W] tile per step through
// VMEM.  Here the grid is (chunk, j, b): each CUDA block reads its own table
// entry, returns at once for -1 (the whole tile is skipped), and otherwise
// copies one chunk of the tile with 16-byte vector loads and stores, consecutive
// threads on consecutive addresses.  The copy treats the data as bytes, so every
// dtype (bf16, f32, int32, ...) takes the same path; where the tile size or a
// pointer is not 16-byte aligned it copies 4-byte or 1-byte words instead.
// Entries outside [0, NB) other than -1 are skipped too, so no write can leave
// the pool; the allocator never produces them.
//
// Bound.  It must read each live tile once and write it once: 2 * bytes of the
// live tiles over 3.35 TB/s.  On the serving path (stablelm-1.6b, bf16, bs 16,
// W = 24 layers * 2 * 32 heads * 64) a 64-block burst is 201 MB each way,
// ~120 us.  With chunks of 32 KB there are ~96 CUDA blocks per tile, enough to
// keep every SM's loads in flight.
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks shapes,
// dtypes and devices; the function returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 8;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    banked_copy_kernel(V* __restrict__ pool, const V* __restrict__ burst,
                       const int32_t* __restrict__ table, int nblk, int NB, long long tile_vecs) {
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int dst = table[static_cast<long long>(b) * nblk + j];
  if (dst < 0 || dst >= NB) return;  // -1: the whole tile is skipped
  const long long chunk = static_cast<long long>(kThreads) * kVecsPerThread;
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = lo + chunk < tile_vecs ? lo + chunk : tile_vecs;
  const V* src = burst + (static_cast<long long>(b) * nblk + j) * tile_vecs;
  V* out = pool + static_cast<long long>(dst) * tile_vecs;
#pragma unroll
  for (int u = 0; u < kVecsPerThread; ++u) {
    const long long i = lo + u * kThreads + threadIdx.x;
    if (i < hi) out[i] = src[i];
  }
}

template <typename V>
int launch(void* pool, const void* burst, const void* table, int B, int nblk, int NB,
           long long tile_bytes, cudaStream_t stream) {
  const long long tile_vecs = tile_bytes / static_cast<long long>(sizeof(V));
  const long long chunk = static_cast<long long>(kThreads) * kVecsPerThread;
  const dim3 grid(static_cast<unsigned>((tile_vecs + chunk - 1) / chunk), nblk, B);
  banked_copy_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(pool), static_cast<const V*>(burst), static_cast<const int32_t*>(table),
      nblk, NB, tile_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int banked_copy(void* pool, const void* burst, const void* table, int B, int nblk,
                           int NB, long long tile_bytes, void* stream) {
  if (B == 0 || nblk == 0 || tile_bytes == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](unsigned a) {
    return tile_bytes % a == 0 && reinterpret_cast<uintptr_t>(pool) % a == 0 &&
           reinterpret_cast<uintptr_t>(burst) % a == 0;
  };
  if (aligned(16)) return launch<uint4>(pool, burst, table, B, nblk, NB, tile_bytes, s);
  if (aligned(4)) return launch<uint32_t>(pool, burst, table, B, nblk, NB, tile_bytes, s);
  return launch<uint8_t>(pool, burst, table, B, nblk, NB, tile_bytes, s);
}
