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
// Design.  The Pallas grid (B, blocks) walks one request's blocks in order and
// carries the online softmax in VMEM, one launch per KV group.  Here one launch
// covers every group: one CUDA block per (group, request) with all m heads of
// the group, so K and V are read once for all of them.  The block loads its own
// table entries (the TPU's scalar prefetch).  Its 8 warps split the tokens,
// 4 consecutive tokens per warp at a time with their loads issued together;
// inside a warp each lane owns D / 32 of the head dims, so a token's K row is
// one coalesced read and the score is a warp reduction.  Each warp keeps its
// own online softmax (max, sum, accumulator per head, float32); the warps'
// states are merged through shared memory at the end.  The pool may be a
// strided view (one layer's K or V of the engine's all-layer pool): blocks and
// rows are addressed by their strides, heads and dims are contiguous.
//
// Bound.  It must read each valid token's K and V row of the group once:
// 2 * sum(lengths) * G * D * sizeof(T) bytes, over 3.35 TB/s.  On the serving
// path (8 requests of ~600 tokens, 32 groups of 64 dims, bf16) that is ~39 MB,
// ~12 us.  The arithmetic (2 FLOP per byte) is far below the card's ridge.
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks shapes,
// dtypes, strides and devices; the function returns the cudaError_t of the
// launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxHeads = 8;  // query heads per KV group

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int32_t* __restrict__ table,
                           const int32_t* __restrict__ lengths, T* __restrict__ out, int H, int m,
                           int mb, int bs, long long blk_stride, long long row_stride,
                           float scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];  // [kWarps][m][D + 2]: acc, max, sum
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int32_t* tbl = table + static_cast<long long>(b) * mb;
  int len = lengths[b];
  len = len < mb * bs ? len : mb * bs;

  float qr[kMaxHeads][DPL], acc[kMaxHeads][DPL], mx[kMaxHeads], sum[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    mx[h] = -INFINITY;
    sum[h] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[h][i] = 0.f;
      qr[h][i] = h < m ? to_float(q[(static_cast<long long>(b) * H + g * m + h) * D +
                                    lane * DPL + i]) * scale
                       : 0.f;
    }
  }

  const long long head_off = static_cast<long long>(g) * D + lane * DPL;
  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const int blk = t < len ? tbl[t / bs] : -1;
      ok[u] = blk >= 0;
      const long long off = ok[u] ? blk * blk_stride + (t % bs) * row_stride + head_off : 0;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = ok[u] ? to_float(k[off + i]) : 0.f;
        vr[u][i] = ok[u] ? to_float(v[off + i]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // uniform across the warp
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h >= m) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s += qr[h][i] * kr[u][i];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
        const float m_new = fmaxf(mx[h], s);
        const float alpha = expf(mx[h] - m_new);
        const float p = expf(s - m_new);
        sum[h] = sum[h] * alpha + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] = acc[h][i] * alpha + p * vr[u][i];
        mx[h] = m_new;
      }
    }
  }

  // merge the warps' softmax states
  const int row = D + 2;
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h >= m) break;
    float* st = smem + (warp * m + h) * row;
#pragma unroll
    for (int i = 0; i < DPL; ++i) st[lane * DPL + i] = acc[h][i];
    if (lane == 0) {
      st[D] = mx[h];
      st[D + 1] = sum[h];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * D; idx += blockDim.x) {
    const int h = idx / D;
    const int d = idx % D;
    float big = -INFINITY;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, smem[(w * m + h) * row + D]);
    float total = 0.f, o = 0.f;
    if (big > -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float* st = smem + (w * m + h) * row;
        if (st[D + 1] == 0.f) continue;
        const float c = expf(st[D] - big);
        total += st[D + 1] * c;
        o += st[d] * c;
      }
    }
    store(out + (static_cast<long long>(b) * H + g * m + h) * D + d, total > 0.f ? o / total : 0.f);
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, const void* table, const void* lengths,
           void* out, int B, int H, int G, int mb, int bs, long long blk_stride,
           long long row_stride, float scale, cudaStream_t stream) {
  const int m = H / G;
  const size_t smem = static_cast<size_t>(kWarps) * m * (32 * DPL + 2) * sizeof(float);
  paged_attention_kernel<T, DPL><<<dim3(G, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), H, m, mb, bs, blk_stride, row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* table,
             const void* lengths, void* out, int B, int H, int G, int mb, int bs,
             long long blk_stride, long long row_stride, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 1>(q, k, v, table, lengths, out, B, H, G, mb, bs, blk_stride, row_stride,
                          scale, s);
    case 64:
      return launch<T, 2>(q, k, v, table, lengths, out, B, H, G, mb, bs, blk_stride, row_stride,
                          scale, s);
    case 128:
      return launch<T, 4>(q, k, v, table, lengths, out, B, H, G, mb, bs, blk_stride, row_stride,
                          scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, H, D] contiguous; k/v element
// (blk, row, g, d) at blk * blk_stride + row * row_stride + g * D + d.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* table,
                               const void* lengths, void* out, int B, int H, int G, int D, int mb,
                               int bs, long long blk_stride, long long row_stride, float scale,
                               int dtype, void* stream) {
  if (B == 0) return 0;
  if (G <= 0 || H % G != 0 || H / G > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, table, lengths, out, B, H, G, mb, bs, blk_stride,
                                   row_stride, scale, s);
  return dispatch<float>(D, q, k, v, table, lengths, out, B, H, G, mb, bs, blk_stride, row_stride,
                         scale, s);
}
