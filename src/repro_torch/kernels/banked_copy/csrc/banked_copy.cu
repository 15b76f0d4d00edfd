// Banked burst scatter (the paper's §II-C split dispatch) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `banked_copy` of the reference package
// (src/repro/kernels/banked_copy/kernel.py:29).  A request's fresh KV "burst"
// [B, nblk, bs, W] is cut into its blocks ("beats") and block (b, j) lands in
// the pool [NB, bs, W] at row block_table[b, j], in place.  An entry of -1
// skips its block; the Pallas kernel redirects it to a trash row instead.
// Entries outside [0, NB) other than -1 are skipped too, so no write can
// leave the pool; the allocator never produces them.  The copy treats the
// data as bytes, so every dtype (bf16, f32, int32, ...) takes the same path.
//
// Bound.  Each live byte is read once and written once: two bytes of traffic
// for each live byte, over 3.35 TB/s.  A 64-block burst of stablelm-1.6b
// (bf16, bs 16, W = 24 layers * 2 * 32 heads * 64) is 201 MB each way, 120 us;
// whisper-base's 14-block burst at W = 6144 is 2.75 MB each way, 1.64 us,
// under the ~1.9 us that an empty kernel of this launch shape takes queued.
//
// Design.  The wrapper plans the work (ops.py::copy_plan): the burst is
// B * nblk tiles of `tile_bytes`, cut into chunks of `chunk_bytes` that never
// cross a tile's end, the last chunk of a tile shorter.  A chunk is at most
// 16 KB (one round of 16-byte words for 128 threads), whole 128-byte lines
// where aligned (no two CTAs write one line), and its size comes from the
// burst's total bytes, about two chunks an SM, so that a burst of a few MB
// still gives every SM work.  CTA c copies chunk c: part c % per_tile of
// tile c / per_tile = b * nblk + j, at byte offset (c % per_tile) *
// chunk_bytes, per_tile = ceil(tile_bytes / chunk_bytes) (the first lines of
// banked_copy_kernel; the same formula as tests/test_torch_banked_copy.py::chunks).
//  - The earlier grid (chunk, j, b) was sized to the tile, 32 KB a CTA:
//    whisper's 14 tiles of 192 KB gave 84 CTAs for 132 SMs.  Here it is 266
//    CTAs of ~10 KB.
//  - Each CTA issues its table-entry load before its data loads and tests
//    the entry only before its stores, where the earlier kernel tested it
//    before loading.  (The compiler issues one load a thread ahead of the
//    test and sinks the rest past it; forcing all eight ahead, as volatile
//    loads, measured slower.)  A chunk whose entry is skipped is read and
//    not written.
//  - Words of 16 bytes where the tile and both base pointers are 16-byte
//    aligned, else 4-byte words, else bytes (a 60-byte tile, a
//    storage-offset view): the same kernel, its word picked by the plan.
// A TMA bulk-copy ring (persistent CTAs, one thread moving 16 KB chunks
// through 4 stages of shared memory with cp.async.bulk) was measured against
// this design in turns and lost on every row (PERF.md §6, banked_copy).
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks shapes,
// dtypes and devices and computes the plan, which is the only input: the
// function launches `grid` CTAs on words of `word` bytes as given, and
// returns the cudaError_t of the launch.  `banked_copy_floor` launches an empty kernel of
// the same grid and block: the floor under the kernel's time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;              // words in flight a thread
constexpr long long kMaxChunk = 16384;  // ops.py MAX_CHUNK: kThreads * kUnroll 16-byte words

// One round of the copy: kUnroll words a thread from word i0 on.
template <typename V>
__device__ __forceinline__ void load_round(V (&r)[kUnroll], const V* __restrict__ src, int i0,
                                           int words) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = i0 + u * kThreads + threadIdx.x;
    if (i < words) r[u] = src[i];
  }
}

template <typename V>
__device__ __forceinline__ void store_round(V* __restrict__ dst, const V (&r)[kUnroll], int i0,
                                            int words) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = i0 + u * kThreads + threadIdx.x;
    if (i < words) dst[i] = r[u];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    banked_copy_kernel(char* __restrict__ pool, const char* __restrict__ burst,
                       const int32_t* __restrict__ table, int NB, long long tile_bytes,
                       long long chunk_bytes, long long per_tile) {
  const long long tile = blockIdx.x / per_tile;  // b * nblk + j
  const long long off = (blockIdx.x - tile * per_tile) * chunk_bytes;
  const long long len = chunk_bytes < tile_bytes - off ? chunk_bytes : tile_bytes - off;
  const int words = static_cast<int>(len / static_cast<long long>(sizeof(V)));
  const int row = table[tile];  // waited on only before the stores
  const V* src = reinterpret_cast<const V*>(burst + tile * tile_bytes + off);
  V r[kUnroll];
  load_round(r, src, 0, words);
  if (row < 0 || row >= NB) return;  // -1: the chunk is read, not written
  V* dst = reinterpret_cast<V*>(pool + static_cast<long long>(row) * tile_bytes + off);
  store_round(dst, r, 0, words);
  if constexpr (sizeof(V) < 16) {  // a chunk of 16-byte words is one round
    for (int i0 = kThreads * kUnroll; i0 < words; i0 += kThreads * kUnroll) {
      load_round(r, src, i0, words);
      store_round(dst, r, i0, words);
    }
  }
}

__global__ void __launch_bounds__(kThreads) floor_kernel() {}

}  // namespace

extern "C" int banked_copy(void* pool, const void* burst, const void* table, int NB,
                           long long tile_bytes, long long chunk_bytes, long long grid, int word,
                           void* stream) {
  // a chunk of 16-byte words is one round: a longer one would lose bytes
  if (chunk_bytes <= 0 || chunk_bytes > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_tile = (tile_bytes + chunk_bytes - 1) / chunk_bytes;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<char*>(pool);
  const auto* src = static_cast<const char*>(burst);
  const auto* tbl = static_cast<const int32_t*>(table);
  const auto g = static_cast<unsigned>(grid);
  switch (word) {
    case 16:
      banked_copy_kernel<uint4><<<g, kThreads, 0, st>>>(dst, src, tbl, NB, tile_bytes,
                                                        chunk_bytes, per_tile);
      break;
    case 4:
      banked_copy_kernel<uint32_t><<<g, kThreads, 0, st>>>(dst, src, tbl, NB, tile_bytes,
                                                           chunk_bytes, per_tile);
      break;
    case 1:
      banked_copy_kernel<uint8_t><<<g, kThreads, 0, st>>>(dst, src, tbl, NB, tile_bytes,
                                                          chunk_bytes, per_tile);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int banked_copy_floor(long long grid, void* stream) {
  floor_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
