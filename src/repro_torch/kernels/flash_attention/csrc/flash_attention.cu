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
// Design.  The Pallas grid (heads, q blocks, kv blocks) runs the kv blocks in
// order and carries the softmax state in VMEM.  Here one CUDA block owns one
// (q tile of 64 rows, head, batch) and loops over the KV tiles itself, so
// nothing carries between blocks.  Tiles that the causal or window mask rules
// out entirely are never visited (the Pallas grid visits and masks them).
// K and V tiles go through shared memory as float32.  Four threads share a
// query row; each owns D / 4 of its dims, in float4 groups interleaved so the
// four threads read four different bank groups, and the row's score is two
// shuffles.  Scores of a tile stay in registers; the softmax state, the
// accumulator and every sum are float32.  This is the simple, right first
// version: CUDA-core FMAs, no tensor cores.  Moving the two products to
// `wgmma` with TMA-fed tiles is later work.
//
// Bound.  The work it must do is 4 * D FLOP per unmasked (row, key) pair:
// ~4.3 GFLOP per layer at S = 1024, H = 32, D = 64 causal, 4.4 us at the
// card's 989 TFLOP/s bf16 tensor-core rate.  This version runs on the CUDA
// cores (67 TFLOP/s float32), so it stays far from that bound.
//
// Interface: plain C, loaded with ctypes.  q/out [B, S, H, D] and k/v
// [B, T, G, D], contiguous.  The wrapper (ops.py) checks shapes, dtypes and
// devices; the function returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;         // query rows per CUDA block
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kRows * kThreadsPerRow;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Thread c of a row owns dims 16 * j + 4 * c + e, j < D / 16, e < 4.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int S, int Tk, int H, int G, int causal, int window,
                     float scale) {
  constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile: 32 KB of float K + V in shared memory
  constexpr int NJ = D / 16;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int r = threadIdx.x / kThreadsPerRow;
  const int c = threadIdx.x % kThreadsPerRow;
  const int qi = q0 + r;

  float qr[NJ][4], acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * j + 4 * c + e;
      qr[j][e] = qi < S ? to_float(q[((static_cast<long long>(b) * S + qi) * H + h) * D + d]) * scale
                        : 0.f;
      acc[j][e] = 0.f;
    }
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
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int kr = idx / D;
      const int d = idx % D;
      const int kj = k0 + kr;
      float kval = 0.f, vval = 0.f;
      if (kj < Tk) {
        const long long off = ((static_cast<long long>(b) * Tk + kj) * G + g) * D + d;
        kval = to_float(k[off]);
        vval = to_float(v[off]);
      }
      ks[kr][d] = kval;
      vs[kr][d] = vval;
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
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
#pragma unroll
    for (int kr = 0; kr < BK; ++kr) {
      const float p = __expf(s[kr] - m_new);
      sum += p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
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
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * j + 4 * c + e;
      store(out + ((static_cast<long long>(b) * S + qi) * H + h) * D + d, acc[j][e] * inv);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
           int G, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, G, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
             int H, int G, int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, S, Tk, H, G, causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, Tk, H, G, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, Tk, H, G, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, Tk, H, G, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                   int S, int T, int H, int G, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, S, T, H, G, causal, window, scale, s);
  return dispatch<float>(D, q, k, v, out, B, S, T, H, G, causal, window, scale, s);
}
