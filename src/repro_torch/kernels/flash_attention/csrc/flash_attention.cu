// Flash-attention forward (causal / windowed GQA, online softmax) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` of the reference package
// (src/repro/kernels/flash_attention/kernel.py), which the reference's prefill
// attention (`models/attention.py::chunked_attention`) mirrors.  For batch b,
// query head h (KV group h / (H / G)) and query row i < S, it attends to the
// keys j < T with j <= i where causal and i - j < window where windowed.  Keys
// at or past T are masked by the true length; the reference's ops.py pads T
// without masking the padding (ROADMAP Queue 3), which is not carried over.
//
// Two routes, chosen by the input type (the wrapper dispatches; neither falls
// back to the other):
//
// bfloat16: the tensor cores.  One CTA per (64-row q tile, head, batch): one
// consumer warpgroup and one producer warp.  The producer's lane 0 brings the
// Q tile and then each K/V tile through TMA (4-D tensor maps over
// [B, rows, heads, D], so rows past S or T are zeros and never another batch's
// rows) into a two-stage ring guarded by mbarriers, so the next tile's loads
// overlap this tile's math.  The consumers compute S = Q K^T with
// `wgmma.mma_async ... .f32.bf16.bf16` on 128/64/32-byte swizzled tiles in
// shared memory (the swizzle follows D * 2 bytes; D = 128 is two 128-byte
// atoms, 192 three), mask by the true T, the causal diagonal and the window, and run the
// online softmax in float32 on the accumulator fragments: each row belongs to
// the four lanes of a quad, so its max and sum take two shuffles.  P is
// rounded to bf16 in registers and fed to the second `wgmma` as its register
// A operand; V is read through a transposed (MN-major) descriptor.  The two
// products are software-pipelined: the softmax of tile i + 1 runs while the
// tensor cores compute tile i's P V.  KV tiles that the causal or window mask
// rules out are never loaded, and the longest causal q tiles are launched
// first.
//
// Widths.  q and k have one head width DK, v its own DV, and the output DV:
// the square GQA widths 16, 32, 64 and 128, and MLA's prefill (deepseek-v2:
// DK = 192, the 128 up-projected dims and the 64 RoPE dims of each head, DV =
// 128).  At (192, 128) S = Q K^T takes 12 k-steps of 16 over 192, P V has N =
// 128, the Q and K tiles are three 128-byte swizzle atoms wide and the V tile
// two; V is never padded to DK.
//
// float32: the CUDA cores (the tensor cores offer only TF32 for float32, which
// keeps about three digits; the float32 contract is 2e-5).  One block per
// (64-row q tile, head, batch) loops over its KV tiles through shared memory;
// four threads share a query row, each owning D / 4 of its dims in
// interleaved float4 groups, and the row's score is two shuffles.
//
// Bound.  2 * (DK + DV) FLOP per unmasked (row, key) pair: ~4.3 GFLOP per
// layer at S = 1024, H = 32, D = 64 causal, 4.4 us at the card's 989 TFLOP/s
// bf16 tensor-core rate; reading Q, K, V and writing O once is ~5 us at
// 3.35 TB/s.  MLA's prefill at S = 1024 (H = G = 16, 192 / 128): ~5.4 GFLOP,
// 5.4 us, against ~21 MB, 6.3 us.
//
// Log-sum-exp.  Where the caller passes an `lse` pointer ([B, H, S] float32),
// each row's m + log(l) in the scaled-score domain is written beside its
// output (-inf for a row with no key): what the training backward
// (kernels/flash_attention_bwd) needs to recompute P.  A null pointer, as
// serving's prefill calls pass it, writes nothing: it selects the kLse =
// false instantiation, whose code has no lse path at all.  Every width pair
// builds both instantiations: the square ones train GQA, (192, 128) trains
// MLA.
//
// Interface: plain C, loaded with ctypes.  q [B, S, H, DK], k [B, T, G, DK],
// v [B, T, G, DV] and out [B, S, H, DV], contiguous.  The wrapper (ops.py)
// checks shapes, dtypes, devices and alignment; each function returns the
// cudaError_t of its launch.
// The bf16 route encodes its tensor maps on the host at every call with
// cuTensorMapEncodeTiled from libcuda, found through dlopen and dlsym so that
// the library needs no link against libcuda.

#include <math.h>

#include "../../include/hopper.cuh"

namespace {

// ------------------------------------------------------------ float32: CUDA cores

constexpr int kRows = 64;  // query rows per CUDA block
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kRows * kThreadsPerRow;

// Thread c of a row owns dims 16 * j + 4 * c + e, j < DK / 16 (of q and k) or
// j < DV / 16 (of v and the output), e < 4.
template <int DK, int DV, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                  int S, int Tk, int H, int G, int causal, int window, float scale) {
  constexpr int BK = DK + DV >= 256 ? 32 : 64;  // keys per tile: 32-40 KB of K + V
  constexpr int NJ = DK / 16;
  constexpr int NV = DV / 16;
  __shared__ __align__(16) float ks[BK][DK];
  __shared__ __align__(16) float vs[BK][DV];

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int r = threadIdx.x / kThreadsPerRow;
  const int c = threadIdx.x % kThreadsPerRow;
  const int qi = q0 + r;

  float qr[NJ][4], acc[NV][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * j + 4 * c + e;
      qr[j][e] = qi < S ? q[((static_cast<long long>(b) * S + qi) * H + h) * DK + d] * scale : 0.f;
    }
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float mx = -INFINITY, sum = 0.f;

  // KV tiles that can hold an unmasked key for rows q0 .. q0 + kRows - 1
  int hi = Tk;
  if (causal) hi = min(hi, q0 + kRows);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - window + 1);
  const int t_lo = lo / BK;
  const int t_hi = (hi + BK - 1) / BK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * DK; idx += kThreads) {
      const int kr = idx / DK;
      const int d = idx % DK;
      const int kj = k0 + kr;
      ks[kr][d] = kj < Tk ? k[((static_cast<long long>(b) * Tk + kj) * G + g) * DK + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * DV; idx += kThreads) {
      const int kr = idx / DV;
      const int d = idx % DV;
      const int kj = k0 + kr;
      vs[kr][d] = kj < Tk ? v[((static_cast<long long>(b) * Tk + kj) * G + g) * DV + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int kr = 0; kr < BK; ++kr) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[kr][16 * j + 4 * c]);
        p += qr[j][0] * kv.x + qr[j][1] * kv.y + qr[j][2] * kv.z + qr[j][3] * kv.w;
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int kj = k0 + kr;
      bool ok = kj < Tk;
      if (causal) ok = ok && kj <= qi;
      if (window > 0) ok = ok && qi - kj < window;
      s[kr] = ok ? p : -INFINITY;
      tile_max = fmaxf(tile_max, s[kr]);
    }
    const float m_new = fmaxf(mx, tile_max);
    if (m_new == -INFINITY) continue;  // nothing unmasked for this row yet
    const float alpha = __expf(mx - m_new);
    sum *= alpha;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
#pragma unroll
    for (int kr = 0; kr < BK; ++kr) {
      const float p = __expf(s[kr] - m_new);
      sum += p;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[kr][16 * j + 4 * c]);
        acc[j][0] += p * vv.x;
        acc[j][1] += p * vv.y;
        acc[j][2] += p * vv.z;
        acc[j][3] += p * vv.w;
      }
    }
    mx = m_new;
  }

  if (qi >= S) return;
  if constexpr (kLse) {
    if (c == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qi] = sum > 0.f ? mx + logf(sum) : -INFINITY;
  }
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * j + 4 * c + e;
      out[((static_cast<long long>(b) * S + qi) * H + h) * DV + d] = acc[j][e] * inv;
    }
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
               int Tk, int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  const auto kernel =
      lse != nullptr ? flash_fwd_f32<DK, DV, true> : flash_fwd_f32<DK, DV, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), S, Tk, H, G, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bfloat16: wgmma + TMA

constexpr int kBM = kTileRows;  // query rows per CTA: one wgmma M
constexpr int kBN = kTileRows;  // keys per KV tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreadsTC = kConsumers + 32;    // + the producer warp

// Shared memory: the Q tile, kStages K tiles, kStages V tiles, then the
// barriers; every tile a multiple of 1024 bytes.  (192, 128): 24 + 2 x (24 +
// 16) KB = 104 KB.
template <int DK, int DV>
struct Tile {
  static constexpr int kQBytes = kBM * DK * 2;
  static constexpr int kKBytes = kBN * DK * 2;
  static constexpr int kVBytes = kBN * DV * 2;
  static constexpr int kBarOffset = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr int kSmem = kBarOffset + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

// Masks one tile's scores (by the true T, the causal diagonal, the window)
// and turns them into P against the new running max, in place, float32.  A
// row's four lanes form a quad, so its max takes two shuffles.  Returns the
// factor that rescales the rows' earlier sums in alpha; l_run takes this
// thread's share of the rows' sums (the quad's shares are added at the end).
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int q0, int r0,
                                             int c0, int k0, int Tk, int causal, int window,
                                             float scale_log2) {
  const bool edge = k0 + kBN > Tk || (causal && k0 + kBN - 1 > q0 + r0 - r0 % 16) ||
                    (window > 0 && q0 + kBM - 1 - k0 >= window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + 8 * (e / 2);
        const int col = k0 + 8 * j + c0 + e % 2;
        bool ok = col < Tk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
  float m_base[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    m_base[rr] = mx[rr] == -INFINITY ? 0.f : mx[rr] * scale_log2;
    alpha[rr] = exp2f(m_run[rr] * scale_log2 - m_base[rr]);
    m_run[rr] = mx[rr];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[4 * j + e] * scale_log2 - m_base[e / 2]);
      sc[4 * j + e] = p;
      rowsum[e / 2] += p;
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l_run[rr] = l_run[rr] * alpha[rr] + rowsum[rr];
}

// The accumulator's two rows of this thread times alpha.
template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
}

// One CTA per (q tile, head, batch); the accumulator fragments are those of
// include/hopper.cuh.
template <int DK, int DV, bool kLse>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int S, int Tk, int H, int G, int causal, int window,
                   float scale_log2) {
  using TS = Tile<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t q_s = base;
  const uint32_t kv_s = base + TS::kQBytes;  // K stages, then V stages
  const uint32_t bars = base + TS::kBarOffset;
  const uint32_t q_bar = bars + 16 * kStages;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  auto k_tile = [&](int i) { return kv_s + (i % kStages) * TS::kKBytes; };  // KV tile i
  auto v_tile = [&](int i) {
    return kv_s + kStages * TS::kKBytes + (i % kStages) * TS::kVBytes;
  };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  int hi = Tk;
  if (causal) hi = min(hi, q0 + kBM);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / kBN;
  const int n_tiles = max(0, (hi + kBN - 1) / kBN - t_lo);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, TS::kQBytes);
      tma_tile<DK>(q_s, &qmap, q_bar, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (t_lo + i) * kBN;
        mbar_wait(empty_bar(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), TS::kKBytes + TS::kVBytes);
        tma_tile<DK>(k_tile(i), &kmap, full_bar(s), g, k0, b);
        tma_tile<DV>(v_tile(i), &vmap, full_bar(s), g, k0, b);
      }
    }
    return;
  }

  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (tid % 4);
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  // Software pipeline within the warpgroup: tile i + 1's S = Q K^T is issued
  // first and O is rescaled for tile i's P while it runs; then tile i's
  // O += P V is issued, and the softmax of tile i + 1 runs on the CUDA cores
  // while the tensor cores finish P V.
  float sc[kBN / 2], alpha[2];
  uint32_t pa[kBN / 16][4];
  if (n_tiles > 0) {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) sc[j] = 0.f;
    mbar_wait(full_bar(0), 0);
    wgmma_fence();
    issue_scores<DK>(sc, q_s, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m_run, l_run, alpha, q0, r0, c0, t_lo * kBN, Tk, causal, window, scale_log2);
    pack_p(sc, pa);
    for (int i = 0; i + 1 < n_tiles; ++i) {
      mbar_wait(full_bar((i + 1) % kStages), ((i + 1) / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_scores<DK>(sc, q_s, k_tile(i + 1));
      wgmma_commit();
      fence_regs(sc);
      scale_rows(o, alpha);
      fence_regs(o);
      wgmma_fence();
      issue_pv<DV>(o, pa, v_tile(i));
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<1>();  // the scores of tile i + 1; P V of tile i may still run
      fence_regs(sc);
      softmax_tile(sc, m_run, l_run, alpha, q0, r0, c0, (t_lo + i + 1) * kBN, Tk, causal, window,
                   scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty_bar(i % kStages));
      pack_p(sc, pa);
    }
    scale_rows(o, alpha);
    fence_regs(o);
    wgmma_fence();
    issue_pv<DV>(o, pa, v_tile(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty_bar((n_tiles - 1) % kStages));
  }
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = l > 0.f ? 1.f / l : 0.f;
    if constexpr (kLse) {  // ln(l) + m * scale, through log2
      const int row = q0 + r0 + 8 * rr;
      if (c0 == 0 && row < S)
        lse[(static_cast<long long>(b) * H + h) * S + row] =
            l > 0.f ? (m_run[rr] * scale_log2 + log2f(l)) * 0.6931471805599453f : -INFINITY;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= S) continue;
    __nv_bfloat16* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * DV + c0;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * rr] * inv[rr], o[4 * j + 2 * rr + 1] * inv[rr]);
  }
}

__global__ void fill_f32(float* __restrict__ x, long long n, float value) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) x[i] = value;
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
                int Tk, int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using TS = Tile<DK, DV>;
  if (Tk == 0) {  // no key: every row gets 0, and lse -inf
    const size_t bytes = static_cast<size_t>(B) * S * H * DV * 2;
    if (lse != nullptr) {
      const long long n = static_cast<long long>(B) * H * S;
      fill_f32<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
          static_cast<float*>(lse), n, -INFINITY);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaMemsetAsync(out, 0, bytes, stream));
  }
  CUtensorMap qm, km, vm;
  if (!encode_tile_map<DK>(&qm, q, B, S, H) || !encode_tile_map<DK>(&km, k, B, Tk, G) ||
      !encode_tile_map<DV>(&vm, v, B, Tk, G))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      lse != nullptr ? flash_fwd_bf16<DK, DV, true> : flash_fwd_bf16<DK, DV, false>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<DK, DV, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, TS::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_bf16<DK, DV, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, TS::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  kernel<<<grid, kThreadsTC, TS::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, Tk, H, G, causal,
      window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widths the kernels are built for: (D, D) for D in 16, 32, 64, 128, and
// MLA's (192, 128).
#define FLASH_DISPATCH(fn)                                                              \
  if (D == Dv) {                                                                        \
    switch (D) {                                                                        \
      case 16:                                                                          \
        return fn<16, 16>(q, k, v, out, lse, B, S, T, H, G, causal, window, scale, s);  \
      case 32:                                                                          \
        return fn<32, 32>(q, k, v, out, lse, B, S, T, H, G, causal, window, scale, s);  \
      case 64:                                                                          \
        return fn<64, 64>(q, k, v, out, lse, B, S, T, H, G, causal, window, scale, s);  \
      case 128:                                                                         \
        return fn<128, 128>(q, k, v, out, lse, B, S, T, H, G, causal, window, scale, s); \
      default:                                                                          \
        return static_cast<int>(cudaErrorInvalidValue);                                 \
    }                                                                                   \
  }                                                                                     \
  if (D == 192 && Dv == 128)                                                            \
    return fn<192, 128>(q, k, v, out, lse, B, S, T, H, G, causal, window, scale, s);    \
  return static_cast<int>(cudaErrorInvalidValue);

// float32 inputs: the CUDA-core kernel.  D is the width of q and k, Dv that of
// v and the output.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                       int B, int S, int T, int H, int G, int D, int Dv,
                                       int causal, int window, float scale, void* lse,
                                       void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_f32)
}

// bfloat16 inputs: the wgmma + TMA kernel.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                        int B, int S, int T, int H, int G, int D, int Dv,
                                        int causal, int window, float scale, void* lse,
                                        void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_bf16)
}
