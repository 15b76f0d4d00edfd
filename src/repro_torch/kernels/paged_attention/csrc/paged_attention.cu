// Paged single-token decode attention over the banked KV pool, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` of the reference
// package (src/repro/kernels/paged_attention/kernel.py) and the per-group loop
// around it (ops.py there).  For request b and KV group g, the m = H / G query
// heads of the group attend to the tokens 0 .. lengths[b]-1 that the block
// table places in the pool: token t lies in pool block block_table[b, t / bs],
// row t % bs.  A token whose table entry is -1 is masked, as in the reference.
// A request with no valid token gets 0.  With a sliding window (window > 0,
// h2o-danube) request b attends to tokens start_b .. lengths[b]-1 only,
// start_b = max(0, lengths[b] - window): the reference's mask q - t < window
// at q = lengths[b] - 1 (src/repro/models/attention.py:64-74).  The TPU
// kernel has no window, because the reference rolls a window-sized cache;
// the port keeps every block of a request in the pool, so the kernel masks.
//
// Design (flash-decoding).  The Pallas grid (B, blocks) walks one request's
// blocks in order and carries the online softmax in VMEM, one launch per KV
// group.  Here the KV length is split instead: `paged_split` runs one CTA per
// (group, request, split), each split a fixed span of `bps` pool blocks, so a
// batch of long requests fills the card.  A CTA whose span starts at or past
// the request's length, or ends at or before its window's start, exits at
// once; the CTA whose span holds the window's start masks the rows below it
// and skips its whole batches there.  Inside a CTA every token row of K and
// V is read as 16-byte vectors, LPR lanes to a row (`RowLanes`: the next power
// of two of a row's pieces, so a row's shuffles stay within its lanes; at D =
// 80 a 160-byte bf16 row is 10 pieces on 16 lanes, a float32 row 20 on 32,
// the rest idle), and each thread loads the
// K and V pieces of eight rows before it uses any, so many rows are in
// flight; the table entries of the next batch's rows are loaded a batch
// ahead (the first batch's with the request's length).  The scores of a
// batch of rows (128 on the serving path, two batches per split) go to
// shared memory; the softmax then takes one max pass and one exp pass per
// head over the batch, against a running max across batches, and P V
// accumulates per row slot, reduced by shuffles and then across the four
// warps in a fixed order.  The query heads of a group (up to 8) share every
// K and V load; the kernel is built for 1, 2, 4 and 8 of them, at D = 16, 32,
// 64, 80 and 128.  Each
// (request, head, split) writes a float32 partial (max, sum, acc[D]) to
// scratch that the wrapper allocates.  `paged_merge`, the second kernel,
// combines the live splits of each (request, head) in split order, from the
// split that holds the window's start (the splits before it write no
// partial): no float atomics, so the output is the same bit for bit from run to run.  The pool may
// be a strided view (one layer's K or V of the engine's all-layer pool): blocks
// and rows are addressed by their strides, heads and dims are contiguous.
//
// Bound.  It must read each valid token's K and V row of the group once:
// 2 * sum(lengths) * G * D * sizeof(T) bytes, over 3.35 TB/s.  On the serving
// path (8 requests of ~800 tokens, 32 groups of 64 dims, bf16) that is ~14 us.
// The arithmetic (2 FLOP per byte) is far below the card's ridge, and the
// partials add ~1 % to the bytes.
//
// MLA's latent rows (deepseek-v2, the absorbed decode; the reference's
// einsums at src/repro/models/attention.py:448-456).  One call has one KV
// group of 16 query heads; K is the layer's latent row of 576 (c_kv, 512,
// then k_pe, 64) and V the first 512 columns of the same row, so each row is
// read once.  Bound, on the serving path (8 requests of 269..926 tokens, 5821
// in all, bf16): the rows and q, 6.99 MB, 2.09 us at 3.35 TB/s; 34.8 kFLOP a
// token, 0.20 GFLOP, 0.2 us on the tensor cores (3.0 us on the CUDA cores,
// past the byte bound: the first design's first limit).
// `paged_latent_bf16` is the redesign for Hopper; what each part answers:
//   - the products on the tensor cores: mma.sync m16n8k16, the 16 heads as M
//     (wgmma's 64-row M would waste three quarters of each tile), q and the
//     rows in bf16 with float32 accumulators, q's A fragments held in
//     registers, the rows read by ldmatrix from padded shared memory rows;
//   - the scale applied to the float32 scores, P rounded to bf16 before P V,
//     as the reference's absorbed form does;
//   - loads ahead of compute: TMA bulk copies, one per 1152-byte row, into a
//     ring of two 32-row stages on mbarriers (a block's rows lie a layer's
//     stride apart, so a 3-D tensor map would cut a row into 64-column boxes
//     and buy nothing over one copy a row);
//   - the split: one thread-block cluster of 16 CTAs per request, each
//     ceil(length / 16) tokens, so the 8 requests of the serving path fill
//     128 of the 132 SMs with at most two stages each, whatever their lengths;
//   - the merge: inside the same launch, through distributed shared memory
//     (each CTA owns 32 output columns and sums the 16 CTAs' float32 partials
//     in rank order), so no partial goes to device memory (the first design
//     wrote 3.1 MB of them and launched `paged_merge` after it) and the
//     output repeats bit for bit;
//   - q read once per cluster: each CTA multicasts one of its 16 rows.
// The float32 route (the check path) stays on the CUDA cores as the first
// design left it (`paged_latent_split_f32`, 64-token splits, then
// `paged_merge` at width 512), with the scale moved onto the scores.
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks shapes,
// dtypes, strides, alignment and devices; each function returns the
// cudaError_t of its launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../../include/hopper.cuh"

namespace {

namespace cg = cooperative_groups;

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

// A token row of D elements of T as 16-byte pieces on kLanes lanes: the next
// power of two of the pieces, so that a row's shuffles stay within its lanes
// and kThreads holds whole rows.  Lanes at or past kPieces (D = 80: 6 of 16
// in bf16, 12 of 32 in float32) load nothing and add zeros.
template <typename T, int D>
struct RowLanes {
  static constexpr int kPieces = D / Vec<T>::N;
  static constexpr int kLanes = kPieces <= 2    ? kPieces
                                : kPieces <= 4  ? 4
                                : kPieces <= 8  ? 8
                                : kPieces <= 16 ? 16
                                                : 32;
  static constexpr int kRowsPerPass = kThreads / kLanes;
  static constexpr int kRowsPerBatch = kRowsPerPass * kUnroll;
  static_assert(kPieces * Vec<T>::N == D && kPieces <= 32, "a row in 16-byte pieces on one warp");
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
                float scale, int window) {
  constexpr int VEC = Vec<T>::N;
  using RL = RowLanes<T, D>;
  constexpr int LPR = RL::kLanes;         // lanes per token row
  constexpr int RPP = RL::kRowsPerPass;   // rows per CTA per pass
  constexpr int ROWS = RL::kRowsPerBatch;  // rows per batch
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
  const bool live = c < RL::kPieces;  // whether that piece is in the row
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
  const int start = window > 0 ? max(len - window, 0) : 0;  // first token in the window
  if (t0 >= len || t0 + span <= start) return;  // the merge reads live splits only
  const int n = min(span, len - t0);
  const int lo = max(start - t0, 0);  // rows below lo lie before the window
  const int r_begin = lo / ROWS * ROWS;  // whole batches before it are skipped
  if (r_begin) load_blocks(r_begin);
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
    const bool on = h < m && live;
    if (on) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + (static_cast<long long>(b) * H + g * m + h) * D + c * VEC));
      Vec<T>::unpack(raw, qv[h]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[h][i] = on ? qv[h][i] * scale : 0.f;
      acc[h][i] = 0.f;
    }
  }
  const long long piece = static_cast<long long>(g) * D + c * VEC;

  for (int r0 = r_begin; r0 < n; r0 += ROWS) {
    long long off[kUnroll];  // -1: a row past n, before the window or in a -1 block
    uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * RPP + slot;
      const int t = t0 + r;
      off[u] = r < n && r >= lo && blk[u] >= 0
                   ? blk[u] * blk_stride + (t % bs) * row_stride + piece
                   : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = live && off[u] >= 0;
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

    // one max pass and one exp pass per head over the batch (rows before the
    // window hold -inf)
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
      if (lane < LPR && live) wacc[(warp * M + h) * D + c * VEC + i] = acc[h][i];
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
// each thread loads its dim of the first kMergeChunk live splits'
// accumulators before it waits for them.  The live splits run from the one
// that holds the window's start (split 0 without a window) to the one that
// holds the request's last token.
constexpr int kMergeChunk = 16;

template <typename T>
__global__ void paged_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ms,
                            const int32_t* __restrict__ lengths, T* __restrict__ out, int H, int D,
                            int nsplit, int span, int max_len, int window) {
  extern __shared__ float smem[];  // [nsplit] max, then [nsplit] sum
  float* s_max = smem;
  float* s_sum = smem + nsplit;
  const long long bh = blockIdx.x;
  const int b = bh / H;
  const int d = threadIdx.x;
  const int len = min(max(lengths[b], 0), max_len);
  const int first = window > 0 ? max(len - window, 0) / span : 0;
  const int live = (len + span - 1) / span;
  const float* ms = part_ms + bh * nsplit * 2;
  const float* acc = part_acc + bh * nsplit * D + d;
  float a[kMergeChunk];  // a[u]: split first + u
#pragma unroll
  for (int u = 0; u < kMergeChunk; ++u)
    a[u] = first + u < live ? acc[static_cast<long long>(first + u) * D] : 0.f;
  for (int sp = first + d; sp < live; sp += blockDim.x) {
    const float sum = ms[2 * sp + 1];
    s_max[sp] = sum > 0.f ? ms[2 * sp] : -INFINITY;
    s_sum[sp] = sum;
  }
  __syncthreads();
  float big = -INFINITY;
  for (int sp = first; sp < live; ++sp) big = fmaxf(big, s_max[sp]);
  float total = 0.f, o = 0.f;
  for (int sp = first; sp < live; ++sp) {  // in split order
    if (!(s_sum[sp] > 0.f)) continue;
    const float w = expf(s_max[sp] - big);
    float x = 0.f;
#pragma unroll
    for (int u = 0; u < kMergeChunk; ++u)
      if (first + u == sp) x = a[u];
    if (sp >= first + kMergeChunk) x = acc[static_cast<long long>(sp) * D];
    total += s_sum[sp] * w;
    o += x * w;
  }
  store(out + bh * D + d, total > 0.f ? o / total : 0.f);
}

template <typename T, int D, int M>
int launch_split(const void* q, const void* k, const void* v, const void* table,
                 const void* lengths, float* part_acc, float* part_ms, int B, int H, int G, int mb,
                 int bs, int bps, long long blk_stride, long long row_stride, float scale,
                 int window, cudaStream_t stream) {
  constexpr int kRowsPerBatch = RowLanes<T, D>::kRowsPerBatch;
  const int nsplit = (mb + bps - 1) / bps;
  const size_t smem = (M * kRowsPerBatch + kWarps * M * D + 3 * M) * sizeof(float);
  paged_split<T, D, M><<<dim3(G, B, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths), part_acc, part_ms,
      H, H / G, mb, bs, bps, nsplit, blk_stride, row_stride, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// Heads per group: the kernel holds the next power of two of them in registers.
template <typename T, int D>
int dispatch_heads(const void* q, const void* k, const void* v, const void* table,
                   const void* lengths, float* part_acc, float* part_ms, int B, int H, int G,
                   int mb, int bs, int bps, long long blk_stride, long long row_stride,
                   float scale, int window, cudaStream_t s) {
  const int m = H / G;
#define PAGED_LAUNCH(M)                                                                         \
  return launch_split<T, D, M>(q, k, v, table, lengths, part_acc, part_ms, B, H, G, mb, bs, bps, \
                               blk_stride, row_stride, scale, window, s)
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
                   float scale, int window, cudaStream_t s) {
#define PAGED_DIM(D)                                                                          \
  return dispatch_heads<T, D>(q, k, v, table, lengths, part_acc, part_ms, B, H, G, mb, bs, bps, \
                              blk_stride, row_stride, scale, window, s)
  switch (D) {
    case 16:
      PAGED_DIM(16);
    case 32:
      PAGED_DIM(32);
    case 64:
      PAGED_DIM(64);
    case 80:
      PAGED_DIM(80);
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
constexpr int kLatWarps = 8;
constexpr int kLatThreads = kLatWarps * 32;

// Phase marks of paged_latent_bf16, compiled in with -DLATENT_MARKS only
// (chip_smoke.py's latent timing line): thread 0 of each CTA writes
// %globaltimer (ns) at mark k to marks[blockIdx.x][k] and its SM to [15].
#ifdef LATENT_MARKS
__device__ unsigned long long* g_latent_marks = nullptr;
__device__ __forceinline__ void LAT_MARK(int k) {
  if (threadIdx.x == 0 && g_latent_marks) {
    unsigned long long t;
    unsigned sm_id;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_id));
    g_latent_marks[blockIdx.x * 16 + k] = t;
    g_latent_marks[blockIdx.x * 16 + 15] = sm_id;
  }
}
#else
__device__ __forceinline__ void LAT_MARK(int) {}
#endif

// ---- the float32 route (the check path): CUDA cores, then `paged_merge`
//
// One CTA per (request b, split sp): q (float) and a batch of 64 rows
// (cp.async, padded by 16 bytes a row so that eight lanes reading eight rows
// hit distinct banks) in shared memory; each thread scores 2 heads x 2 rows
// over the 576 columns, one warp per 2 heads takes the batch's softmax
// against the running max, and each thread adds P V for 4 heads x 8 of the
// 512 columns.  The partials go to paged_split's scratch layout (D = 512).
constexpr int kF32Rows = 64;                // rows of a batch
constexpr int kF32Stride = kLatK + 4;       // floats per row in shared memory
constexpr int kF32Pieces = kLatK * 4 / 16;  // 16-byte pieces of a row
constexpr size_t kF32Smem = kLatHeads * kLatK * sizeof(float) +      // q
                            kF32Rows * kF32Stride * sizeof(float) +  // rows
                            kF32Rows * kLatHeads * sizeof(float) +   // P
                            3 * kLatHeads * sizeof(float) + kF32Rows * 4;  // stats, blocks

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// kv element (blk, row, d) lies at blk * blk_stride + row * row_stride + d;
// q is [B, 16, 576].
__global__ void __launch_bounds__(kLatThreads)
    paged_latent_split_f32(const float* __restrict__ q, const float* __restrict__ kv,
                           const int32_t* __restrict__ table, const int32_t* __restrict__ lengths,
                           float* __restrict__ part_acc, float* __restrict__ part_ms, int mb,
                           int bs, int bps, int nsplit, long long blk_stride,
                           long long row_stride, float scale) {
  extern __shared__ __align__(16) uint8_t f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem);             // [16][576]
  float* rows = qs + kLatHeads * kLatK;                       // [64][kF32Stride]
  float* ps = rows + kF32Rows * kF32Stride;                   // [64][16]
  float* stat = ps + kF32Rows * kLatHeads;  // [16][3]: running max, running sum, rescale
  int* blk_s = reinterpret_cast<int*>(stat + 3 * kLatHeads);  // [64]

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

  const float* qb = q + static_cast<long long>(b) * kLatHeads * kLatK;
  for (int i = tid; i < kLatHeads * kLatK; i += kLatThreads) qs[i] = qb[i];
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

  for (int r0 = 0; r0 < n; r0 += kF32Rows) {
    const int nrows = min(kF32Rows, n - r0);
    __syncthreads();  // the previous batch's rows and P are consumed
    if (tid < kF32Rows) blk_s[tid] = tid < nrows ? tbl[(t0 + r0 + tid) / bs] : -1;
    __syncthreads();
    for (int idx = tid; idx < kF32Rows * kF32Pieces; idx += kLatThreads) {
      const int r = idx / kF32Pieces;
      const int c = idx % kF32Pieces;
      float* dst = rows + r * kF32Stride + c * 4;
      const int blk = blk_s[r];
      if (blk >= 0) {  // rows past the length or in a -1 block are zeros
        const int t = t0 + r0 + r;
        cp_async16(dst, kv + blk * blk_stride + (t % bs) * row_stride + c * 4);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores: heads 2 warp, 2 warp + 1 against rows lane, lane + 32
    {
      const int h0 = 2 * warp;
      const float* qa = qs + h0 * kLatK;
      const float* qc = qa + kLatK;
      const float* ka = rows + lane * kF32Stride;
      const float* kc = ka + 32 * kF32Stride;
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
      ps[lane * kLatHeads + h0] = ok0 ? s00 * scale : -INFINITY;
      ps[lane * kLatHeads + h0 + 1] = ok0 ? s10 * scale : -INFINITY;
      ps[(lane + 32) * kLatHeads + h0] = ok1 ? s01 * scale : -INFINITY;
      ps[(lane + 32) * kLatHeads + h0 + 1] = ok1 ? s11 * scale : -INFINITY;
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
      load8(rows + r * kF32Stride + c8, vf);
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

// ---- the bf16 route: the tensor cores, one thread-block cluster per request
//
// Request b is one cluster of kCluster = 16 CTAs (8 warps each); CTA `rank`
// takes the tokens [rank chunk, rank chunk + chunk), chunk = ceil(length /
// 16).  The CTAs read the request's length and block table, then (after a
// cluster barrier that makes their mbarriers known to each other) each
// multicasts one of q's 16 rows to all 16.  A CTA's rows go through a ring
// of kMmaRing stages of kMmaRows rows in shared memory, each row one TMA bulk
// copy of 1152 bytes (the rows of a pool block lie a layer's stride apart,
// so a row is the longest contiguous run) completing on the stage's
// mbarrier; warp 0 issues a stage whenever its ring slot is free.  Per stage:
//   S = Q K^T: warp (kq, ng) multiplies its 9 of the 36 k-steps of q (A
//     fragments by ldmatrix, held in registers) by the rows 16 ng ..
//     16 ng + 15 (B fragments by ldmatrix) and writes its partial S;
//   softmax: warp w sums the four partials of heads 2w, 2w + 1 in a fixed
//     order (lane = row), scales the float32 score, takes the stage's max
//     (one redux.sync on the scores' order-preserving integer images)
//     against the running max, rounds P to bf16 (as the reference's
//     absorbed form rounds its softmax weights) and adds the rounded P to
//     the lane's running sum, summed over the lanes once, at the end;
//   O = alpha O + P V: warp w owns output columns 64 w .. 64 w + 63, P by
//     ldmatrix, V (the same rows' first 512 columns) by ldmatrix.trans.
// Rows are padded by 16 bytes (1168 a row), so the eight rows an ldmatrix
// phase reads fall on distinct banks.
//
// The merge goes through distributed shared memory.  Each CTA leaves its O
// (16 heads x 512 columns, float32) and (max, sum) per head in its ring,
// which it is done with; after a cluster barrier, CTA `rank` owns the
// output columns [32 rank, 32 rank + 32): 16 lanes a head weigh the 16
// CTAs' maxima against the largest, then each thread loads two columns of
// the 16 CTAs' O from their shared memory and sums them in rank order.  No
// partial leaves the chip, there is no second launch and no atomic: the
// output is the same bit for bit from run to run.
constexpr int kMmaRows = 32;            // token rows of a stage
constexpr int kMmaRing = 2;             // stages in shared memory
constexpr int kMmaPitch = kLatK + 8;    // bf16 per row in shared memory
constexpr int kRowBytes = kLatK * 2;    // one latent row, one bulk copy
constexpr int kMmaKq = 4;               // warps along S's 576 columns
constexpr int kMmaKSteps = kLatK / 16 / kMmaKq;  // k-steps of 16 per warp: 9
constexpr int kMmaSPitch = kMmaRows + 8;  // floats per head of a partial S
constexpr int kMmaPPitch = kMmaRows + 8;  // bf16 per head of P (80 bytes)
constexpr int kMaxTbl = 1024;           // block table entries a request may have
constexpr int kCluster = 16;            // CTAs per request

// What a CTA leaves for the merge: O with its 8-byte column pairs swizzled
// by head (`merge_at`), (max, sum) per head; and the weights it merges with.
struct MergeSmem {
  float o[kLatHeads][kLatV];
  float2 ml[kLatHeads];
  float w[kLatHeads][kCluster];  // [head][source rank]: exp(max - largest max), 0 where sum is 0
  float total[kLatHeads];  // over the sources, in rank order: sum x w
};

struct MmaSmem {
  union {
    __nv_bfloat16 rows[kMmaRing][kMmaRows][kMmaPitch];
    MergeSmem merge;
  };
  __nv_bfloat16 q[kLatHeads][kMmaPitch];
  float s[kMmaKq][kLatHeads][kMmaSPitch];
  __nv_bfloat16 p[kLatHeads][kMmaPPitch];
  float alpha[kLatHeads];                 // the stage's rescale of O per head
  unsigned long long bar[kMmaRing + 1];   // ring slots, then q
  int blk[kMaxTbl];                       // the request's block table
};

// Index of O's column c of head h in MergeSmem::o: the fragment stores of a
// half-warp (heads g, column pairs t) hit distinct banks.
__device__ __forceinline__ int merge_at(int h, int c) {
  return 2 * ((c >> 1) ^ ((h & 3) << 2)) + (c & 1);
}

// Row `src` of kRowBytes from device memory into shared memory at `dst` of
// the CTAs of `mask`, completing on each one's mbarrier at `bar`.
__device__ __forceinline__ void bulk_row_multicast(void* dst, const void* src, uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(static_cast<uint32_t>(kRowBytes)), "r"(bar), "h"(mask)
      : "memory");
}

// One row of kRowBytes from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_row(void* dst, const void* src, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(static_cast<uint32_t>(kRowBytes)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The largest x over the warp: one redux.sync on order-preserving images.
__device__ __forceinline__ float warp_max(float x) {
  uint32_t u = __float_as_uint(x);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  u = __reduce_max_sync(0xffffffffu, u);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(kLatThreads, 2)
    paged_latent_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
                      const int32_t* __restrict__ table, const int32_t* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, int mb, int bs, long long blk_stride,
                      long long row_stride, float scale) {
  constexpr int kOwn = kLatV / kCluster;  // output columns a CTA merges: 32
  extern __shared__ __align__(128) uint8_t lat_smem[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(lat_smem);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / kCluster;
  LAT_MARK(0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t qbar = smem_u32(&sm.bar[kMmaRing]);
  if (tid == 0) {
    for (int i = 0; i <= kMmaRing; ++i) mbar_init(smem_u32(&sm.bar[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, kLatHeads * kRowBytes);
  }
  cluster_arrive_relaxed();  // this CTA's barriers exist
  // the request's length and block table, one round trip
  for (int j = tid; j < mb; j += kLatThreads) sm.blk[j] = table[static_cast<long long>(b) * mb + j];
  const int len = min(max(lengths[b], 0), mb * bs);
  const int chunk = (len + kCluster - 1) / kCluster;
  const int t_begin = rank * chunk;
  const int n = max(0, min(chunk, len - t_begin));  // this CTA's tokens
  const int nst = (n + kMmaRows - 1) / kMmaRows;
  __syncthreads();  // the table
  cluster_wait();   // every CTA's barriers exist
  LAT_MARK(1);
  // q's 16 rows, each loaded once for the cluster: CTA `rank` multicasts row `rank`
  static_assert(kCluster == kLatHeads, "one q row per CTA of the cluster");
  if (warp == 0 && lane == rank)
    bulk_row_multicast(&sm.q[lane][0], q + (static_cast<long long>(b) * kLatHeads + lane) * kLatK,
                       qbar, static_cast<uint16_t>((1u << kCluster) - 1));

  // warp 0: stage s into ring slot s % kMmaRing, lane = row; rows past the
  // CTA's tokens or in a -1 block are zeros (P V multiplies them by 0)
  auto issue = [&](int s) {
    if (s >= nst) return;
    const int slot = s % kMmaRing;
    const uint32_t bar = smem_u32(&sm.bar[slot]);
    const int r = s * kMmaRows + lane;
    const int t = t_begin + r;
    const int blk = r < n ? sm.blk[t / bs] : -1;
    uint32_t zero = __ballot_sync(0xffffffffu, blk < 0);
    const int valid = kMmaRows - __popc(zero);
    while (zero) {
      const int row = __ffs(zero) - 1;
      zero &= zero - 1;
      for (int c = lane; c < kRowBytes / 16; c += 32)
        *reinterpret_cast<uint4*>(&sm.rows[slot][row][8 * c]) = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(valid) * kRowBytes);
    if (blk >= 0)
      bulk_row(&sm.rows[slot][lane][0], kv + blk * blk_stride + (t % bs) * row_stride, bar);
  };
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kMmaRing; ++s) issue(s);
  }

  const int g = lane / 4;
  const int t4 = lane % 4;
  const int kq = warp % kMmaKq;
  const int ng = warp / kMmaKq;
  // ldmatrix lane addresses: an A operand (q, P) reads row lr, column
  // 8 (lane / 16) of its k-step; S's B reads row 16 ng + lb, column
  // 8 ((lane / 8) % 2); V's B reads row lr, column 64 warp + 8 (lane / 16)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lb = (lane & 7) + ((lane >> 4) << 3);
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // heads 2 warp + i: running max and this lane's running sum of P
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  LAT_MARK(2);
  if (n > 0) {
    uint32_t qa[kMmaKSteps][4];  // q's A fragments for this warp's k-steps
    {
      const uint32_t base = smem_u32(&sm.q[lr][kq * kMmaKSteps * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < kMmaKSteps; ++j) ldmatrix_x4(qa[j], base + 32 * j);
    }
    const uint32_t p_addr = smem_u32(&sm.p[lr][(lane >> 4) * 8]);

    for (int s = 0; s < nst; ++s) {
      const int slot = s % kMmaRing;
      mbar_wait(smem_u32(&sm.bar[slot]), (s / kMmaRing) & 1);
      if (s < 2) LAT_MARK(3 + 4 * s);  // stage s is in
      const auto& buf = sm.rows[slot];

      // S: this warp's partial over its 9 k-steps, two n-tiles of 8 rows
      {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint32_t base =
            smem_u32(&buf[16 * ng + lb][kq * kMmaKSteps * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int j = 0; j < kMmaKSteps; ++j) {
          uint32_t kb[4];
          ldmatrix_x4(kb, base + 32 * j);
          mma_bf16(sc[0], qa[j], kb[0], kb[1]);
          mma_bf16(sc[1], qa[j], kb[2], kb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = 16 * ng + 8 * nt + 2 * t4;
          *reinterpret_cast<float2*>(&sm.s[kq][g][r]) = make_float2(sc[nt][0], sc[nt][1]);
          *reinterpret_cast<float2*>(&sm.s[kq][g + 8][r]) = make_float2(sc[nt][2], sc[nt][3]);
        }
      }
      __syncthreads();
      if (s == 0) LAT_MARK(4);

      // softmax of heads 2 warp, 2 warp + 1 over the stage's rows (lane = row)
      {
        const int r = s * kMmaRows + lane;
        const bool ok = r < n && sm.blk[(t_begin + r) / bs] >= 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int h = 2 * warp + i;
          float x = sm.s[0][h][lane];
#pragma unroll
          for (int k = 1; k < kMmaKq; ++k) x += sm.s[k][h][lane];
          x = ok ? x * scale : -INFINITY;
          const float m_new = fmaxf(m_run[i], warp_max(x));
          const __nv_bfloat16 p = __float2bfloat16(m_new == -INFINITY ? 0.f : expf(x - m_new));
          const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
          sm.p[h][lane] = p;
          l_run[i] = l_run[i] * alpha + __bfloat162float(p);
          m_run[i] = m_new;
          if (lane == 0) sm.alpha[h] = alpha;
        }
      }
      __syncthreads();
      if (s == 0) LAT_MARK(5);

      // O = alpha O + P V over this warp's 64 columns
      {
        const float a_lo = sm.alpha[g];
        const float a_hi = sm.alpha[g + 8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][0] *= a_lo;
          o[i][1] *= a_lo;
          o[i][2] *= a_hi;
          o[i][3] *= a_hi;
        }
#pragma unroll
        for (int kk = 0; kk < kMmaRows / 16; ++kk) {
          uint32_t pa[4];
          ldmatrix_x4(pa, p_addr + 32 * kk);
          const uint32_t v_addr = smem_u32(&buf[16 * kk + lr][64 * warp + (lane >> 4) * 8]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, v_addr + 32 * np);
            mma_bf16(o[2 * np], pa, vb[0], vb[1]);
            mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this ring slot and with P
      if (s == 0) LAT_MARK(6);
      if (warp == 0) issue(s + kMmaRing);
    }
  }

  // the merge: O's fragments (heads g, g + 8; columns 2 t4, 2 t4 + 1 of
  // each n-tile) and the heads' (max, sum) into this CTA's ring
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 64 * warp + 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(&sm.merge.o[g][merge_at(g, col)]) = make_float2(o[i][0], o[i][1]);
    *reinterpret_cast<float2*>(&sm.merge.o[g + 8][merge_at(g + 8, col)]) =
        make_float2(o[i][2], o[i][3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    if (lane == 0) sm.merge.ml[2 * warp + i] = make_float2(m_run[i], l);
  }
  LAT_MARK(8);
  cluster_arrive();
  cluster_wait();  // every CTA's O and (max, sum) are in place
  LAT_MARK(9);
  {
    // the weights of source rank tid % 16 for head tid / 16 (16 lanes a head)
    const int h = tid / 16;
    const int j = tid % 16;
    const float2 ml = cluster.map_shared_rank(&sm, j)->merge.ml[h];
    float big = ml.y > 0.f ? ml.x : -INFINITY;
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, w));
    const float wt = ml.y > 0.f ? expf(ml.x - big) : 0.f;
    sm.merge.w[h][j] = wt;
    float total = 0.f;  // in rank order
#pragma unroll
    for (int k = 0; k < kCluster; ++k)
      total += __shfl_sync(0xffffffffu, ml.y * wt, (lane & 16) + k);
    if (j == 0) sm.merge.total[h] = total;
  }
  __syncthreads();
  LAT_MARK(10);
  {
    // head tid / 16, columns c0 and c0 + 1 of this CTA's 32
    const int h = tid / 16;
    const int c0 = rank * kOwn + 2 * (tid % 16);
    const float2* mine = reinterpret_cast<const float2*>(&sm.merge.o[h][merge_at(h, c0)]);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kCluster; ++j) {  // in rank order
      const float wt = sm.merge.w[h][j];
      const float2 x = *cluster.map_shared_rank(mine, j);
      acc.x += x.x * wt;
      acc.y += x.y * wt;
    }
    const float total = sm.merge.total[h];
    cluster_arrive();  // this CTA's loads from the others are performed (before its stores)
    LAT_MARK(11);
    __nv_bfloat16* dst = out + (static_cast<long long>(b) * kLatHeads + h) * kLatV + c0;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        total > 0.f ? __floats2bfloat162_rn(acc.x / total, acc.y / total)
                    : __floats2bfloat162_rn(0.f, 0.f);
  }
  cluster_wait();  // and so are everyone's loads from this one
  LAT_MARK(12);
}

int launch_latent_bf16(const void* q, const void* kv, const void* table, const void* lengths,
                       void* out, int B, int mb, int bs, long long blk_stride,
                       long long row_stride, float scale, cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_latent_bf16,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(MmaSmem)));
    if (err == cudaSuccess)  // a cluster of 16 is past the portable 8
      err = cudaFuncSetAttribute(paged_latent_bf16,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * kCluster);
  cfg.blockDim = dim3(kLatThreads);
  cfg.dynamicSmemBytes = sizeof(MmaSmem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_latent_bf16, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out), mb, bs, blk_stride,
      row_stride, scale);
  const cudaError_t last = cudaGetLastError();  // clears the launch error, if any
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The split pass.  dtype: 0 = float32, 1 = bfloat16.  q [B, H, D] contiguous;
// k/v element (blk, row, g, d) at blk * blk_stride + row * row_stride + g * D + d;
// part_acc [B, H, nsplit, D] and part_ms [B, H, nsplit, 2] float32 scratch,
// nsplit = ceil(mb / bps); window 0 (none) or the tokens a request attends to.
extern "C" int paged_attention_split(const void* q, const void* k, const void* v,
                                     const void* table, const void* lengths, void* part_acc,
                                     void* part_ms, int B, int H, int G, int D, int mb, int bs,
                                     int bps, long long blk_stride, long long row_stride,
                                     float scale, int window, int dtype, void* stream) {
  if (B == 0 || mb == 0) return 0;
  if (G <= 0 || H % G != 0 || H / G > kMaxHeads || bps <= 0 || bs <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<float*>(part_acc);
  auto* ms = static_cast<float*>(part_ms);
  if (dtype == 1)
    return dispatch_split<__nv_bfloat16>(D, q, k, v, table, lengths, acc, ms, B, H, G, mb, bs, bps,
                                         blk_stride, row_stride, scale, window, s);
  return dispatch_split<float>(D, q, k, v, table, lengths, acc, ms, B, H, G, mb, bs, bps,
                               blk_stride, row_stride, scale, window, s);
}

// MLA's latent call in bf16, one launch: q [B, 16, 576] contiguous; kv
// element (blk, row, d) at blk * blk_stride + row * row_stride + d, d < 576 (V
// is d < 512 of the same rows); out [B, 16, 512] bf16; mb <= 1024.
extern "C" int paged_attention_latent(const void* q, const void* kv, const void* table,
                                      const void* lengths, void* out, int B, int mb, int bs,
                                      long long blk_stride, long long row_stride, float scale,
                                      void* stream) {
  if (B == 0) return 0;
  if (bs <= 0 || mb < 0 || mb > kMaxTbl) return static_cast<int>(cudaErrorInvalidValue);
  return launch_latent_bf16(q, kv, table, lengths, out, B, mb, bs, blk_stride, row_stride, scale,
                            static_cast<cudaStream_t>(stream));
}

// The split pass of MLA's latent call in float32: q [B, 16, 576] float32,
// kv as above; part_acc [B, 16, nsplit, 512] and part_ms [B, 16, nsplit, 2]
// float32 scratch, nsplit = ceil(mb / bps).  The merge pass then runs with
// H = 16, D = 512.
extern "C" int paged_attention_latent_split(const void* q, const void* kv, const void* table,
                                            const void* lengths, void* part_acc, void* part_ms,
                                            int B, int mb, int bs, int bps, long long blk_stride,
                                            long long row_stride, float scale, void* stream) {
  if (B == 0 || mb == 0) return 0;
  if (bps <= 0 || bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_latent_split_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int nsplit = (mb + bps - 1) / bps;
  paged_latent_split_f32<<<dim3(B, nsplit), kLatThreads, kF32Smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ms), mb, bs, bps, nsplit,
      blk_stride, row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LATENT_MARKS
// Where paged_latent_bf16 writes its marks: [B * 16 CTAs][16] uint64, or null.
extern "C" int paged_attention_latent_marks(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_latent_marks, &buf, sizeof(buf)));
}
#endif

// The merge pass: out [B, H, D] in q's dtype; window as the split pass's.
extern "C" int paged_attention_merge(const void* part_acc, const void* part_ms,
                                     const void* lengths, void* out, int B, int H, int D, int mb,
                                     int bs, int bps, int window, int dtype, void* stream) {
  if (B == 0) return 0;
  if (bps <= 0 || bs <= 0 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nsplit = (mb + bps - 1) / bps;
  const size_t smem = 2 * static_cast<size_t>(nsplit) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>(B) * H;
  const auto* acc = static_cast<const float*>(part_acc);
  const auto* ms = static_cast<const float*>(part_ms);
  const auto* len = static_cast<const int32_t*>(lengths);
  if (dtype == 1)
    paged_merge<<<blocks, D, smem, s>>>(acc, ms, len, static_cast<__nv_bfloat16*>(out), H, D,
                                        nsplit, bps * bs, mb * bs, window);
  else
    paged_merge<<<blocks, D, smem, s>>>(acc, ms, len, static_cast<float*>(out), H, D, nsplit,
                                        bps * bs, mb * bs, window);
  return static_cast<int>(cudaGetLastError());
}
