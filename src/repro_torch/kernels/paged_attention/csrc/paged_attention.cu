// Paged single-token decode attention over the banked KV pool, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` of the reference
// package (src/repro/kernels/paged_attention/kernel.py) and the per-group loop
// around it (ops.py there).  For request b and KV group g, the m = H / G query
// heads of the group attend to the tokens 0 .. lengths[b]-1 that the block
// table places in the pool: token t lies in pool block block_table[b, t / bs],
// row t % bs.  A token whose table entry is -1 is masked, as in the reference.
// A request with no valid token gets 0.
//
// Design (flash-decoding).  The Pallas grid (B, blocks) walks one request's
// blocks in order and carries the online softmax in VMEM, one launch per KV
// group.  Here the KV length is split instead: `paged_split` runs one CTA per
// (group, request, split), each split a fixed span of `bps` pool blocks, so a
// batch of long requests fills the card.  A CTA whose span starts at or past
// the request's length exits at once.  Inside a CTA every token row of K and
// V is read as 16-byte vectors, LPR lanes to a row, and each thread loads the
// K and V pieces of eight rows before it uses any, so many rows are in
// flight; the table entries of the next batch's rows are loaded a batch
// ahead (the first batch's with the request's length).  The scores of a
// batch of rows (128 on the serving path, two batches per split) go to
// shared memory; the softmax then takes one max pass and one exp pass per
// head over the batch, against a running max across batches, and P V
// accumulates per row slot, reduced by shuffles and then across the four
// warps in a fixed order.  The query heads of a group (up to 8) share every
// K and V load; the kernel is built for 1, 2, 4 and 8 of them.  Each
// (request, head, split) writes a float32 partial (max, sum, acc[D]) to
// scratch that the wrapper allocates.  `paged_merge`, the second kernel,
// combines the live splits of each (request, head) in split order: no float
// atomics, so the output is the same bit for bit from run to run.  The pool may
// be a strided view (one layer's K or V of the engine's all-layer pool): blocks
// and rows are addressed by their strides, heads and dims are contiguous.
//
// Bound.  It must read each valid token's K and V row of the group once:
// 2 * sum(lengths) * G * D * sizeof(T) bytes, over 3.35 TB/s.  On the serving
// path (8 requests of ~800 tokens, 32 groups of 64 dims, bf16) that is ~14 us.
// The arithmetic (2 FLOP per byte) is far below the card's ridge, and the
// partials add ~1 % to the bytes.
//
// MLA's latent rows (deepseek-v2, the absorbed decode).  One call has one KV
// group of 16 query heads; K is the layer's latent row of 576 (c_kv, 512, then
// k_pe, 64) and V the first 512 columns of the same row, so each row is read
// once.  16 heads x 576 floats of q do not fit in a thread's registers, and 576
// bf16 is 72 sixteen-byte pieces, not a warp's worth, so `paged_latent_split`
// works through shared memory on the CUDA cores: one CTA of 256 threads per
// (request, split); q (pre-scaled, float) and a batch of 64 rows (cp.async,
// padded by 16 bytes a row so that eight lanes reading eight rows hit
// distinct banks) in shared memory; each thread scores 2 heads x 2 rows over
// the 576 columns, one warp per 2 heads takes the batch's softmax against the
// running max, and each thread adds P V for 4 heads x 8 of the 512 columns.
// The partials go to the same scratch layout as `paged_split`'s (D = 512), and
// `paged_merge` combines them with 512 threads per (request, head).  Its bound
// is the rows' bytes, 1152 per bf16 token: ~7 MB, ~2 us, on the serving path;
// 34.8 kFLOP per token on 16 heads put it on the CUDA cores' side of that at
// their 67 TFLOP/s (a tensor-core version, mma.sync m16n8k16 with the 16
// heads as M, is the redesign this first kernel leaves open).
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks shapes,
// dtypes, strides, alignment and devices; each function returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;    // rows each thread loads before it uses any
constexpr int kMaxHeads = 8;  // query heads per KV group

// 16 bytes of T as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&f)[4]) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&f)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One CTA per (group g, request b, split sp), for up to M query heads per
// group.  The split's rows go in batches of RPP * kUnroll; each thread loads
// the K and V pieces of its kUnroll rows of a batch before it uses any.  Per
// batch the scores go to shared memory, one warp per head takes the batch's
// max and exps them against the running max (the online softmax, per batch,
// not per token), and every thread adds P V for its rows.  Dynamic shared
// memory: scores [M][rows per batch], the warps' accumulators [kWarps][M][D],
// and per head (running max, running sum, rescale).
template <typename T, int D, int M>
__global__ void __launch_bounds__(kThreads)
    paged_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int32_t* __restrict__ table, const int32_t* __restrict__ lengths,
                float* __restrict__ part_acc, float* __restrict__ part_ms, int H, int m, int mb,
                int bs, int bps, int nsplit, long long blk_stride, long long row_stride,
                float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = D / VEC;       // lanes per token row
  constexpr int RPP = kThreads / LPR;  // rows per CTA per pass
  constexpr int ROWS = RPP * kUnroll;  // rows per batch
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int span = bps * bs;
  const int t0 = sp * span;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slot = tid / LPR;  // row slot within a pass
  const int c = tid % LPR;     // this thread's 16-byte piece of a row
  const int32_t* tbl = table + static_cast<long long>(b) * mb;
  // pool blocks of this thread's rows in a batch, loaded a batch ahead (the
  // first batch's together with the length, before it is known)
  int blk[kUnroll];
  auto load_blocks = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + r0 + u * RPP + slot;
      blk[u] = t < mb * bs ? tbl[t / bs] : -1;
    }
  };
  load_blocks(0);
  const int len = min(max(lengths[b], 0), mb * bs);
  if (t0 >= len) return;  // the merge reads live splits only
  const int n = min(span, len - t0);
  float* sc = smem;                      // [M][ROWS]
  float* wacc = smem + M * ROWS;         // [kWarps][M][D]
  float* stat = wacc + kWarps * M * D;   // [M][3]: running max, running sum, rescale
  if (tid < M) {
    stat[3 * tid] = -INFINITY;
    stat[3 * tid + 1] = 0.f;
  }

  float qv[M][VEC], acc[M][VEC];
#pragma unroll
  for (int h = 0; h < M; ++h) {
    if (h < m) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + (static_cast<long long>(b) * H + g * m + h) * D + c * VEC));
      Vec<T>::unpack(raw, qv[h]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[h][i] = h < m ? qv[h][i] * scale : 0.f;
      acc[h][i] = 0.f;
    }
  }
  const long long piece = static_cast<long long>(g) * D + c * VEC;

  for (int r0 = 0; r0 < n; r0 += ROWS) {
    long long off[kUnroll];  // -1: a row past n or in a -1 block
    uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * RPP + slot;
      const int t = t0 + r;
      off[u] = r < n && blk[u] >= 0 ? blk[u] * blk_stride + (t % bs) * row_stride + piece : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = off[u] >= 0;
      kraw[u] = ok ? __ldg(reinterpret_cast<const uint4*>(k + off[u])) : make_uint4(0, 0, 0, 0);
      vraw[u] = ok ? __ldg(reinterpret_cast<const uint4*>(v + off[u])) : make_uint4(0, 0, 0, 0);
    }
    if (r0 + ROWS < n) load_blocks(r0 + ROWS);
    __syncthreads();  // the previous batch's P is consumed
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC];
      Vec<T>::unpack(kraw[u], kf);
#pragma unroll
      for (int h = 0; h < M; ++h) {
        if (h >= m) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qv[h][i] * kf[i];
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
        if (c == 0) sc[h * ROWS + u * RPP + slot] = off[u] >= 0 ? s : -INFINITY;
      }
    }
    __syncthreads();

    // one max pass and one exp pass per head over the batch
    const int nrows = min(ROWS, n - r0);
    for (int h = warp; h < m; h += kWarps) {
      float* row = sc + h * ROWS;
      float mx = -INFINITY;
      for (int r = lane; r < nrows; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = stat[3 * h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < nrows; r += 32) {
        const float p = m_new == -INFINITY ? 0.f : expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        stat[3 * h] = m_new;
        stat[3 * h + 1] = stat[3 * h + 1] * alpha + sum;
        stat[3 * h + 2] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < M; ++h) {
      if (h >= m) break;
      const float alpha = stat[3 * h + 2];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[h][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (off[u] < 0) continue;  // rows past the end may hold anything
      float vf[VEC];
      Vec<T>::unpack(vraw[u], vf);
#pragma unroll
      for (int h = 0; h < M; ++h) {
        if (h >= m) break;
        const float p = sc[h * ROWS + u * RPP + slot];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[h][i] += p * vf[i];
      }
    }
  }

  // reduce the row slots: within the warp by shuffles, then across warps
#pragma unroll
  for (int h = 0; h < M; ++h) {
    if (h >= m) break;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
#pragma unroll
      for (int w = LPR; w < 32; w <<= 1) acc[h][i] += __shfl_xor_sync(0xffffffffu, acc[h][i], w);
      if (lane < LPR) wacc[(warp * M + h) * D + c * VEC + i] = acc[h][i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < m * D; idx += kThreads) {
    const int h = idx / D;
    const int d = idx % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += wacc[(w * M + h) * D + d];
    const long long part = (static_cast<long long>(b) * H + g * m + h) * nsplit + sp;
    part_acc[part * D + d] = o;
    if (d == 0) {
      part_ms[2 * part] = stat[3 * h];
      part_ms[2 * part + 1] = stat[3 * h + 1];
    }
  }
}

// out[b, h, :] from the live splits of (b, h), in split order: one CTA of D
// threads per (b, h); the splits' (max, sum) are staged in shared memory, and
// each thread loads its dim of the first kMergeChunk splits' accumulators
// before it waits for them.
constexpr int kMergeChunk = 16;

template <typename T>
__global__ void paged_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ms,
                            const int32_t* __restrict__ lengths, T* __restrict__ out, int H, int D,
                            int nsplit, int span, int max_len) {
  extern __shared__ float smem[];  // [nsplit] max, then [nsplit] sum
  float* s_max = smem;
  float* s_sum = smem + nsplit;
  const long long bh = blockIdx.x;
  const int b = bh / H;
  const int d = threadIdx.x;
  const int len = min(max(lengths[b], 0), max_len);
  const int live = (len + span - 1) / span;
  const float* ms = part_ms + bh * nsplit * 2;
  const float* acc = part_acc + bh * nsplit * D + d;
  float a[kMergeChunk];
#pragma unroll
  for (int u = 0; u < kMergeChunk; ++u) a[u] = u < live ? acc[static_cast<long long>(u) * D] : 0.f;
  for (int sp = d; sp < live; sp += blockDim.x) {
    const float sum = ms[2 * sp + 1];
    s_max[sp] = sum > 0.f ? ms[2 * sp] : -INFINITY;
    s_sum[sp] = sum;
  }
  __syncthreads();
  float big = -INFINITY;
  for (int sp = 0; sp < live; ++sp) big = fmaxf(big, s_max[sp]);
  float total = 0.f, o = 0.f;
  for (int sp = 0; sp < live; ++sp) {  // in split order
    if (!(s_sum[sp] > 0.f)) continue;
    const float w = expf(s_max[sp] - big);
    float x = 0.f;
#pragma unroll
    for (int u = 0; u < kMergeChunk; ++u)
      if (u == sp) x = a[u];
    if (sp >= kMergeChunk) x = acc[static_cast<long long>(sp) * D];
    total += s_sum[sp] * w;
    o += x * w;
  }
  store(out + bh * D + d, total > 0.f ? o / total : 0.f);
}

template <typename T, int D, int M>
int launch_split(const void* q, const void* k, const void* v, const void* table,
                 const void* lengths, float* part_acc, float* part_ms, int B, int H, int G, int mb,
                 int bs, int bps, long long blk_stride, long long row_stride, float scale,
                 cudaStream_t stream) {
  constexpr int kRowsPerBatch = kThreads / (D / Vec<T>::N) * kUnroll;
  const int nsplit = (mb + bps - 1) / bps;
  const size_t smem = (M * kRowsPerBatch + kWarps * M * D + 3 * M) * sizeof(float);
  paged_split<T, D, M><<<dim3(G, B, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths), part_acc, part_ms,
      H, H / G, mb, bs, bps, nsplit, blk_stride, row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// Heads per group: the kernel holds the next power of two of them in registers.
template <typename T, int D>
int dispatch_heads(const void* q, const void* k, const void* v, const void* table,
                   const void* lengths, float* part_acc, float* part_ms, int B, int H, int G,
                   int mb, int bs, int bps, long long blk_stride, long long row_stride,
                   float scale, cudaStream_t s) {
  const int m = H / G;
#define PAGED_LAUNCH(M)                                                                         \
  return launch_split<T, D, M>(q, k, v, table, lengths, part_acc, part_ms, B, H, G, mb, bs, bps, \
                               blk_stride, row_stride, scale, s)
  if (m == 1) PAGED_LAUNCH(1);
  if (m == 2) PAGED_LAUNCH(2);
  if (m <= 4) PAGED_LAUNCH(4);
  PAGED_LAUNCH(8);
#undef PAGED_LAUNCH
}

template <typename T>
int dispatch_split(int D, const void* q, const void* k, const void* v, const void* table,
                   const void* lengths, float* part_acc, float* part_ms, int B, int H, int G,
                   int mb, int bs, int bps, long long blk_stride, long long row_stride,
                   float scale, cudaStream_t s) {
#define PAGED_DIM(D)                                                                          \
  return dispatch_heads<T, D>(q, k, v, table, lengths, part_acc, part_ms, B, H, G, mb, bs, bps, \
                              blk_stride, row_stride, scale, s)
  switch (D) {
    case 16:
      PAGED_DIM(16);
    case 32:
      PAGED_DIM(32);
    case 64:
      PAGED_DIM(64);
    case 128:
      PAGED_DIM(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_DIM
}

// ------------------------------------------------------------ MLA's latent rows

constexpr int kLatHeads = 16;   // query heads of the one KV group
constexpr int kLatK = 576;      // K width: c_kv (512), then k_pe (64)
constexpr int kLatV = 512;      // V width: the first 512 columns of the same row
constexpr int kLatRows = 64;    // rows of a batch in shared memory
constexpr int kLatWarps = 8;
constexpr int kLatThreads = kLatWarps * 32;

// A row of T in shared memory, padded by 16 bytes: eight lanes that read the
// same 16-byte piece of eight consecutive rows hit distinct banks.
template <typename T>
struct LatRow {
  static constexpr int kStride = kLatK + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPieces = kLatK * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kSmem = kLatHeads * kLatK * sizeof(float) +             // q
                                  kLatRows * kStride * sizeof(T) +                // rows
                                  kLatRows * kLatHeads * sizeof(float) +          // P
                                  3 * kLatHeads * sizeof(float) + kLatRows * 4;  // stats, blocks
};

// 8 values of T at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  Vec<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One CTA per (request b, split sp).  kv element (blk, row, d) lies at
// blk * blk_stride + row * row_stride + d; q is [B, 16, 576].
template <typename T>
__global__ void __launch_bounds__(kLatThreads)
    paged_latent_split(const T* __restrict__ q, const T* __restrict__ kv,
                       const int32_t* __restrict__ table, const int32_t* __restrict__ lengths,
                       float* __restrict__ part_acc, float* __restrict__ part_ms, int mb, int bs,
                       int bps, int nsplit, long long blk_stride, long long row_stride,
                       float scale) {
  using LR = LatRow<T>;
  extern __shared__ __align__(16) uint8_t lat_smem[];
  float* qs = reinterpret_cast<float*>(lat_smem);                    // [16][576], scaled
  T* rows = reinterpret_cast<T*>(qs + kLatHeads * kLatK);           // [64][kStride]
  float* ps = reinterpret_cast<float*>(rows + kLatRows * LR::kStride);  // [64][16]
  float* stat = ps + kLatRows * kLatHeads;  // [16][3]: running max, running sum, rescale
  int* blk_s = reinterpret_cast<int*>(stat + 3 * kLatHeads);        // [64]

  const int b = blockIdx.x;
  const int sp = blockIdx.y;
  const int t0 = sp * bps * bs;
  const int len = min(max(lengths[b], 0), mb * bs);
  if (t0 >= len) return;  // the merge reads live splits only
  const int n = min(bps * bs, len - t0);
  const int32_t* tbl = table + static_cast<long long>(b) * mb;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + static_cast<long long>(b) * kLatHeads * kLatK;
  for (int i = tid; i < kLatHeads * kLatK; i += kLatThreads) {
    if constexpr (sizeof(T) == 4)
      qs[i] = qb[i] * scale;
    else
      qs[i] = __bfloat162float(qb[i]) * scale;
  }
  if (tid < kLatHeads) {
    stat[3 * tid] = -INFINITY;
    stat[3 * tid + 1] = 0.f;
  }
  // P V: this thread's 4 heads (h4 .. h4 + 3) and 8 columns (c8 .. c8 + 7)
  const int h4 = 4 * (warp / 2);
  const int c8 = 8 * ((warp % 2) * 32 + lane);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int r0 = 0; r0 < n; r0 += kLatRows) {
    const int nrows = min(kLatRows, n - r0);
    __syncthreads();  // the previous batch's rows and P are consumed
    if (tid < kLatRows) blk_s[tid] = tid < nrows ? tbl[(t0 + r0 + tid) / bs] : -1;
    __syncthreads();
    for (int idx = tid; idx < kLatRows * LR::kPieces; idx += kLatThreads) {
      const int r = idx / LR::kPieces;
      const int c = idx % LR::kPieces;
      T* dst = rows + r * LR::kStride + c * LR::kVec;
      const int blk = blk_s[r];
      if (blk >= 0) {  // rows past the length or in a -1 block are zeros
        const int t = t0 + r0 + r;
        cp_async16(dst, kv + blk * blk_stride + (t % bs) * row_stride + c * LR::kVec);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores: heads 2 warp, 2 warp + 1 against rows lane, lane + 32
    {
      const int h0 = 2 * warp;
      const float* qa = qs + h0 * kLatK;
      const float* qc = qa + kLatK;
      const T* ka = rows + lane * LR::kStride;
      const T* kc = ka + 32 * LR::kStride;
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;  // [head][row]
#pragma unroll 4
      for (int j = 0; j < kLatK; j += 8) {
        float fa[8], fc[8], q0[8], q1[8];
        load8(ka + j, fa);
        load8(kc + j, fc);
        load8(qa + j, q0);
        load8(qc + j, q1);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s00 += q0[e] * fa[e];
          s01 += q0[e] * fc[e];
          s10 += q1[e] * fa[e];
          s11 += q1[e] * fc[e];
        }
      }
      const bool ok0 = blk_s[lane] >= 0;
      const bool ok1 = blk_s[lane + 32] >= 0;
      ps[lane * kLatHeads + h0] = ok0 ? s00 : -INFINITY;
      ps[lane * kLatHeads + h0 + 1] = ok0 ? s10 : -INFINITY;
      ps[(lane + 32) * kLatHeads + h0] = ok1 ? s01 : -INFINITY;
      ps[(lane + 32) * kLatHeads + h0 + 1] = ok1 ? s11 : -INFINITY;
    }
    __syncthreads();

    // one max pass and one exp pass per head over the batch
    for (int h = warp; h < kLatHeads; h += kLatWarps) {
      float v0 = ps[lane * kLatHeads + h];
      float v1 = ps[(lane + 32) * kLatHeads + h];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = stat[3 * h];
      const float m_new = fmaxf(m_old, mx);
      v0 = m_new == -INFINITY ? 0.f : expf(v0 - m_new);
      v1 = m_new == -INFINITY ? 0.f : expf(v1 - m_new);
      ps[lane * kLatHeads + h] = v0;
      ps[(lane + 32) * kLatHeads + h] = v1;
      float sum = v0 + v1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        stat[3 * h] = m_new;
        stat[3 * h + 1] = stat[3 * h + 1] * alpha + sum;
        stat[3 * h + 2] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = stat[3 * (h4 + i) + 2];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    for (int r = 0; r < nrows; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(ps + r * kLatHeads + h4);
      float vf[8];
      load8(rows + r * LR::kStride + c8, vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[0][e] += p.x * vf[e];
        acc[1][e] += p.y * vf[e];
        acc[2][e] += p.z * vf[e];
        acc[3][e] += p.w * vf[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long part = (static_cast<long long>(b) * kLatHeads + h4 + i) * nsplit + sp;
    float* dst = part_acc + part * kLatV + c8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (tid < kLatHeads) {
    const long long part = (static_cast<long long>(b) * kLatHeads + tid) * nsplit + sp;
    part_ms[2 * part] = stat[3 * tid];
    part_ms[2 * part + 1] = stat[3 * tid + 1];
  }
}

template <typename T>
int launch_latent(const void* q, const void* kv, const void* table, const void* lengths,
                  float* part_acc, float* part_ms, int B, int mb, int bs, int bps,
                  long long blk_stride, long long row_stride, float scale, cudaStream_t stream) {
  const int nsplit = (mb + bps - 1) / bps;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_latent_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(LatRow<T>::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  paged_latent_split<T><<<dim3(B, nsplit), kLatThreads, LatRow<T>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), part_acc, part_ms, mb, bs, bps, nsplit, blk_stride,
      row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split pass.  dtype: 0 = float32, 1 = bfloat16.  q [B, H, D] contiguous;
// k/v element (blk, row, g, d) at blk * blk_stride + row * row_stride + g * D + d;
// part_acc [B, H, nsplit, D] and part_ms [B, H, nsplit, 2] float32 scratch,
// nsplit = ceil(mb / bps).
extern "C" int paged_attention_split(const void* q, const void* k, const void* v,
                                     const void* table, const void* lengths, void* part_acc,
                                     void* part_ms, int B, int H, int G, int D, int mb, int bs,
                                     int bps, long long blk_stride, long long row_stride,
                                     float scale, int dtype, void* stream) {
  if (B == 0 || mb == 0) return 0;
  if (G <= 0 || H % G != 0 || H / G > kMaxHeads || bps <= 0 || bs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<float*>(part_acc);
  auto* ms = static_cast<float*>(part_ms);
  if (dtype == 1)
    return dispatch_split<__nv_bfloat16>(D, q, k, v, table, lengths, acc, ms, B, H, G, mb, bs, bps,
                                         blk_stride, row_stride, scale, s);
  return dispatch_split<float>(D, q, k, v, table, lengths, acc, ms, B, H, G, mb, bs, bps,
                               blk_stride, row_stride, scale, s);
}

// The split pass over MLA's latent rows: q [B, 16, 576] contiguous; kv element
// (blk, row, d) at blk * blk_stride + row * row_stride + d, d < 576 (V is d <
// 512 of the same rows); part_acc [B, 16, nsplit, 512] and part_ms [B, 16,
// nsplit, 2] float32 scratch, nsplit = ceil(mb / bps).  The merge pass then
// runs with H = 16, D = 512.
extern "C" int paged_attention_latent_split(const void* q, const void* kv, const void* table,
                                            const void* lengths, void* part_acc, void* part_ms,
                                            int B, int mb, int bs, int bps, long long blk_stride,
                                            long long row_stride, float scale, int dtype,
                                            void* stream) {
  if (B == 0 || mb == 0) return 0;
  if (bps <= 0 || bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<float*>(part_acc);
  auto* ms = static_cast<float*>(part_ms);
  if (dtype == 1)
    return launch_latent<__nv_bfloat16>(q, kv, table, lengths, acc, ms, B, mb, bs, bps,
                                        blk_stride, row_stride, scale, s);
  return launch_latent<float>(q, kv, table, lengths, acc, ms, B, mb, bs, bps, blk_stride,
                              row_stride, scale, s);
}

// The merge pass: out [B, H, D] in q's dtype.
extern "C" int paged_attention_merge(const void* part_acc, const void* part_ms,
                                     const void* lengths, void* out, int B, int H, int D, int mb,
                                     int bs, int bps, int dtype, void* stream) {
  if (B == 0) return 0;
  if (bps <= 0 || bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nsplit = (mb + bps - 1) / bps;
  const size_t smem = 2 * static_cast<size_t>(nsplit) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>(B) * H;
  const auto* acc = static_cast<const float*>(part_acc);
  const auto* ms = static_cast<const float*>(part_ms);
  const auto* len = static_cast<const int32_t*>(lengths);
  if (dtype == 1)
    paged_merge<<<blocks, D, smem, s>>>(acc, ms, len, static_cast<__nv_bfloat16*>(out), H, D,
                                        nsplit, bps * bs, mb * bs);
  else
    paged_merge<<<blocks, D, smem, s>>>(acc, ms, len, static_cast<float*>(out), H, D, nsplit,
                                        bps * bs, mb * bs);
  return static_cast<int>(cudaGetLastError());
}
