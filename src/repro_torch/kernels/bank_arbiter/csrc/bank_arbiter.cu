// Per-bank QoS arbitration (the paper's §II-C comparator tree) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `bank_arbiter` of the reference package
// (src/repro/kernels/bank_arbiter/kernel.py, body `_arbiter_kernel`).  For each
// batch lane and each bank it finds the eligible slot with the smallest packed
// (QoS level, FCFS age, round-robin) key, the lowest slot winning a tie, and
// reports S for a bank with no eligible slot.
//
// Packing.  Keys and slot ids are both below 2^30 (`_age_cap` in
// core/simulator.py, KEY_FILLER in ref.py), so `(key << 32) | slot` packs the
// lexicographic (key, slot) order into one unsigned 64-bit value and the
// per-bank winner is a minimum over such values.  The minimum does not depend
// on the order in which it is taken, so the result repeats to the bit.  The
// init value (KEY_FILLER << 32) | S loses to any eligible slot, including one
// whose key equals KEY_FILLER, as in both reference versions.
//
// Design.
// - A lane is spread over a thread-block cluster of C CTAs (C in {1, 2, 4, 8},
//   the portable sizes).  The wrapper picks C, the block size and the tile
//   from B and S (`launch_shape` in ops.py): enough CTAs to cover the SMs at
//   small B, C = 1 once B alone fills the card.  Lanes x C CTAs lie on
//   gridDim.x, lane = blockIdx.x / C.  CTA r folds a contiguous share of
//   ceil(S / C) slots, rounded up to 16, tile by tile (at most 4096 slots).
// - Every load of a tile is in flight before the first atomic: one thread
//   issues a TMA bulk copy (cp.async.bulk, completing on an mbarrier) of each
//   input array's 16-byte-aligned middle into shared memory, and threads
//   0..15 copy the scalar head and tail of each array, under 16 bytes each.
//   A lane's rows start at lane * S, which is not 16-byte aligned when S is
//   not a multiple of 16, and a tensor may carry a storage offset, so each
//   array's staging buffer mirrors its device address modulo 16 and the
//   split into head, middle and tail is made per CTA, tile and array.
// - The fold is one small loop over the staged tile, about two slots per
//   thread, into the CTA's best[NB] by shared `atomicMin` on the packed
//   values.  A loop and not an unrolled body: the kernel runs once per
//   simulated cycle, and a long straight-line body costs more in cold
//   instruction fetches than it saves.
// - The merge goes through distributed shared memory in the same launch.
//   Each CTA arrives (relaxed) on the cluster barrier when it starts and
//   waits on it after its fold, so every CTA's shared memory exists before
//   any CTA writes to it, and the wait hides behind the loads.  CTA r owns a
//   contiguous share of the banks; each CTA pushes each bank's minimum into
//   the owner's inbox with a remote store (`cluster.map_shared_rank`), which
//   needs no round trip.  One release/acquire barrier later each CTA takes
//   the minimum of its inbox in its own shared memory and writes win; no CTA
//   touches another's shared memory after it, so any CTA may exit.  No global
//   atomics, no scratch, no second launch: one launch on the caller's stream,
//   which a CUDA graph can capture.
//
// Bound.  A lane reads S * (4 + sizeof(BankT) + 1) bytes and writes NB * 4:
// about 57 KB at the paper's S = 8192, NB = 256, which takes ~17 ns at
// 3.35 TB/s.  So the kernel is bound by latency: the launch of its grid and
// cluster (`bank_arbiter_floor` launches an empty kernel of the same shape),
// one memory round trip for the bulk copies, the fold's shared atomics (a
// compare-and-swap loop each: sm_90 has no 64-bit shared atomicMin), one
// cluster barrier and the remote stores before it.
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks dtypes,
// shapes, contiguity, the bank count (at most 6144: up to 132 KB of dynamic
// shared memory per CTA, opted into above 48 KB) and the launch shape, allocates
// `win`, and raises on a non-zero return, which is the cudaError_t of the
// launch (a cluster size the card refuses included).

#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kKeyFiller = 1ull << 30;
constexpr int kMaxThreads = 512;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Banks a CTA of a C-CTA cluster owns in the merge.
__host__ __device__ constexpr int bank_share(int NB, int C) { return (NB + C - 1) / C; }

// Dynamic shared memory of one CTA: best[NB]; for C > 1 the inbox of the
// banks it owns, C x bank_share u64; the mbarrier; then one staging buffer per
// input array of `tile` slots plus 16 bytes, so that the buffer can mirror the
// array's address modulo 16.
__host__ __device__ constexpr int inbox_offset(int NB) { return round16(NB * 8); }
__host__ __device__ constexpr int bar_offset(int NB, int C) {
  return inbox_offset(NB) + (C > 1 ? round16(C * bank_share(NB, C) * 8) : 0);
}
__host__ __device__ constexpr int smem_bytes(int NB, int C, int tile, int bank_bytes) {
  return bar_offset(NB, C) + 16 + round16(tile + 16) + round16(4 * tile + 16) +
         round16(bank_bytes * tile + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster barrier split in its two halves: arrive (relaxed: orders
// nothing, only counts; or release: this thread's writes first) and wait
// (acquire).  Every thread of every CTA of the cluster takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One input array's part of a tile [a, b): `stage` holds slot a + i at
// stage[i], at the same address modulo 16 as in device memory, so that the
// 16-byte-aligned middle [mid_lo, mid_hi) is one bulk copy and the head
// [a, mid_lo) and tail [mid_hi, b), under 16 bytes each, are scalar copies.
template <typename T>
struct Part {
  const T* src;
  T* stage;
  int mid_lo, mid_hi;

  __device__ __forceinline__ Part(const T* base, uint8_t* buf, int a, int b) : src(base) {
    constexpr int z = sizeof(T);
    const auto pa = reinterpret_cast<uintptr_t>(base + a);
    const auto pb = reinterpret_cast<uintptr_t>(base + b);
    stage = reinterpret_cast<T*>(buf + (pa & 15));
    mid_lo = min(b, a + static_cast<int>(((16 - (pa & 15)) & 15) / z));
    mid_hi = max(mid_lo, b - static_cast<int>((pb & 15) / z));
  }

  __device__ __forceinline__ uint32_t bulk_bytes() const {
    return static_cast<uint32_t>((mid_hi - mid_lo) * sizeof(T));
  }

  // thread 0: the middle, completing on `bar`
  __device__ __forceinline__ void bulk(int a, uint32_t bar) const {
    if (mid_hi > mid_lo) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(stage + (mid_lo - a))),
          "l"(src + mid_lo), "r"(bulk_bytes()), "r"(bar)
          : "memory");
    }
  }

  // threads 0..15: one head and one tail slot each
  __device__ __forceinline__ void edges(int a, int b, int t) const {
    if (a + t < mid_lo) stage[t] = src[a + t];
    if (mid_hi + t < b) stage[mid_hi - a + t] = src[mid_hi + t];
  }
};

template <typename BankT>
struct Tile {
  Part<uint8_t> e;
  Part<int32_t> k;
  Part<BankT> b;

  __device__ __forceinline__ Tile(const uint8_t* elig, const int32_t* key, const BankT* bank,
                                  uint8_t* buf, int tile, int a, int hi)
      : e(elig, buf, a, hi),
        k(key, buf + round16(tile + 16), a, hi),
        b(bank, buf + round16(tile + 16) + round16(4 * tile + 16), a, hi) {}

  // Every load of the tile goes out at once: thread 0 issues the bulk copies
  // (expecting their bytes on `bar`), threads 0..15 the scalar edges.
  __device__ __forceinline__ void load(int a, int hi, uint32_t bar) const {
    const int t = threadIdx.x;
    if (t == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the last reads
      const uint32_t bytes = e.bulk_bytes() + k.bulk_bytes() + b.bulk_bytes();
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      e.bulk(a, bar);
      k.bulk(a, bar);
      b.bulk(a, bar);
    }
    if (t < 16) {
      e.edges(a, hi, t);
      k.edges(a, hi, t);
      b.edges(a, hi, t);
    }
  }
};

template <typename BankT, int C>
__global__ void __launch_bounds__(kMaxThreads)
    bank_arbiter_kernel(const int32_t* __restrict__ key, const BankT* __restrict__ bank,
                        const uint8_t* __restrict__ elig, int32_t* __restrict__ win, int S,
                        int NB, int tile) {
  extern __shared__ __align__(16) uint8_t smem[];
  auto* best = reinterpret_cast<unsigned long long*>(smem);
  auto* inbox = reinterpret_cast<unsigned long long*>(smem + inbox_offset(NB));
  const uint32_t bar = smem_u32(smem + bar_offset(NB, C));
  uint8_t* buf = smem + bar_offset(NB, C) + 16;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t lane = blockIdx.x / C;
  const int32_t* k = key + lane * S;
  const BankT* bk = bank + lane * S;
  const uint8_t* e = elig + lane * S;
  const int t = threadIdx.x;

  // CTA `rank` folds slots [lo, hi) of its lane, tile by tile
  const int per = round16((S + C - 1) / C);
  const int lo = min(S, rank * per);
  const int hi = min(S, lo + per);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (lo < hi) {
    const int b = min(hi, lo + tile);
    Tile<BankT>(e, k, bk, buf, tile, lo, b).load(lo, b, bar);
  }
  const unsigned long long init = (kKeyFiller << 32) | static_cast<unsigned int>(S);
  for (int i = t; i < NB; i += blockDim.x) best[i] = init;
  if constexpr (C > 1) cluster_arrive_relaxed();  // this CTA has started
  __syncthreads();

  uint32_t phase = 0;
  for (int a = lo; a < hi; a += tile, phase ^= 1) {
    const int b = min(hi, a + tile);
    const Tile<BankT> tl(e, k, bk, buf, tile, a, b);
    mbar_wait(bar, phase);
    for (int s = a + t; s < b; s += blockDim.x) {
      const int i = s - a;
      if (tl.e.stage[i]) {
        const unsigned long long packed =
            (static_cast<unsigned long long>(static_cast<uint32_t>(tl.k.stage[i])) << 32) |
            static_cast<unsigned int>(s);
        atomicMin(&best[static_cast<int>(tl.b.stage[i])], packed);
      }
    }
    __syncthreads();  // best[] is up to date and the staging buffers are free
    if (b < hi) {
      const int c = min(hi, b + tile);
      Tile<BankT>(e, k, bk, buf, tile, b, c).load(b, c, bar);
      __syncthreads();  // the next tile's scalar edges are in place
    }
  }

  int32_t* w = win + lane * NB;
  if constexpr (C == 1) {
    for (int i = t; i < NB; i += blockDim.x) w[i] = static_cast<int32_t>(best[i] & 0xFFFFFFFFull);
  } else {
    // Every CTA of the cluster has started, so each one's shared memory
    // exists: push each bank's minimum into the inbox of the CTA that owns
    // the bank (remote stores, no round trip), then one release/acquire
    // barrier, after which no CTA touches another's shared memory.
    cluster_wait();
    const int share = bank_share(NB, C);
    for (int i = t; i < NB; i += blockDim.x) {
      const int q = i / share;
      cluster.map_shared_rank(inbox, q)[rank * share + i - q * share] = best[i];
    }
    cluster_arrive_release();
    cluster_wait();
    const int b_lo = rank * share;
    const int b_hi = min(NB, b_lo + share);
    for (int i = b_lo + t; i < b_hi; i += blockDim.x) {
      unsigned long long v[C];
#pragma unroll
      for (int q = 0; q < C; ++q) v[q] = inbox[q * share + i - b_lo];
      unsigned long long m = v[0];
#pragma unroll
      for (int q = 1; q < C; ++q) m = v[q] < m ? v[q] : m;
      w[i] = static_cast<int32_t>(m & 0xFFFFFFFFull);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) floor_kernel() {}

template <typename Kernel, typename... Args>
int launch_clustered(Kernel kernel, int B, int cluster, int threads, int smem, void* stream,
                     Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * static_cast<unsigned int>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears the launch error, if any
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename BankT>
int launch(const void* key, const void* bank, const void* elig, void* win, int B, int S, int NB,
           int cluster, int threads, int tile, void* stream) {
  const auto* k = static_cast<const int32_t*>(key);
  const auto* bk = static_cast<const BankT*>(bank);
  const auto* e = static_cast<const uint8_t*>(elig);
  auto* w = static_cast<int32_t*>(win);
  const int smem = smem_bytes(NB, cluster, tile, sizeof(BankT));
  switch (cluster) {
    case 1:
      return launch_clustered(bank_arbiter_kernel<BankT, 1>, B, 1, threads, smem, stream, k, bk,
                              e, w, S, NB, tile);
    case 2:
      return launch_clustered(bank_arbiter_kernel<BankT, 2>, B, 2, threads, smem, stream, k, bk,
                              e, w, S, NB, tile);
    case 4:
      return launch_clustered(bank_arbiter_kernel<BankT, 4>, B, 4, threads, smem, stream, k, bk,
                              e, w, S, NB, tile);
    case 8:
      return launch_clustered(bank_arbiter_kernel<BankT, 8>, B, 8, threads, smem, stream, k, bk,
                              e, w, S, NB, tile);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bank_arbiter_i16(const void* key, const void* bank, const void* elig, void* win,
                                int B, int S, int NB, int cluster, int threads, int tile,
                                void* stream) {
  return launch<int16_t>(key, bank, elig, win, B, S, NB, cluster, threads, tile, stream);
}

extern "C" int bank_arbiter_i32(const void* key, const void* bank, const void* elig, void* win,
                                int B, int S, int NB, int cluster, int threads, int tile,
                                void* stream) {
  return launch<int32_t>(key, bank, elig, win, B, S, NB, cluster, threads, tile, stream);
}

// An empty kernel of the arbiter's launch shape (grid, block, cluster, dynamic
// shared memory) for banks of `bank_bytes` bytes: the floor under its device time.
extern "C" int bank_arbiter_floor(int B, int NB, int cluster, int threads, int tile, int bank_bytes,
                                  void* stream) {
  return launch_clustered(floor_kernel, B, cluster, threads,
                          smem_bytes(NB, cluster, tile, bank_bytes), stream);
}

// Dynamic shared memory of one CTA of that launch shape, in bytes (tests).
extern "C" int bank_arbiter_smem_bytes(int NB, int cluster, int tile, int bank_bytes) {
  return smem_bytes(NB, cluster, tile, bank_bytes);
}
