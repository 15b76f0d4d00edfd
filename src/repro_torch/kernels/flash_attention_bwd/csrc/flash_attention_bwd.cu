// Flash-attention backward (causal / windowed GQA) for Hopper, sm_90a: dQ, dK, dV.
//
// The reference has no Pallas kernel for this: its backward is the jnp custom
// VJP `_flash_vjp_bwd` (src/repro/models/attention.py:214) of the attention
// whose forward the Pallas kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py:72) mirrors.  This kernel is
// the port's counterpart of that VJP.  For batch b, query head h (KV group
// g = h / (H / G)), row i < S and key j < T, with the mask of the forward
// (j <= i where causal, i - j < window where windowed, j < T):
//   D_i   = sum_d dO[i, d] O[i, d]
//   P_ij  = exp(scale * q_i . k_j - lse_i)       (0 where masked)
//   dV_j  = sum_{h in g, i} P_ij dO_i            dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) scale
//   dQ_i  = sum_j dS_ij k_j                      dK_j = sum_{h in g, i} dS_ij q_i
// all in float32 from float32 or bfloat16 inputs; the outputs are rounded to
// the input type.  lse ([B, H, S] float32) is what the forward wrote.
//
// Deterministic by construction: no atomics.  Three launches on the caller's
// stream: `flash_bwd_prep` writes D ([B, H, S] float32, scratch the wrapper
// allocates); `flash_bwd_dq` runs one block per (64-row q tile, head, batch)
// and loops over the KV tiles that can hold an unmasked key; `flash_bwd_dkv`
// runs one block per (64-key KV tile, group, batch) and loops over the group's
// query heads and the q tiles that can see it, recomputing P.  Each output
// element is summed by one thread in a fixed order.
//
// A simple kernel on the CUDA cores: tiles staged in shared memory as float32
// (rows padded by 4 floats so that float4 reads of 8 neighbouring rows fall in
// distinct banks), 256 threads, each computing a 4 x 4 block of the 64 x 64
// score and dP tiles (rows tr + 16 i, columns tc + 16 j) from float4 reads,
// then a 4-row x D/16-dim block of the dK/dV (or dQ) accumulators.  Bound:
// 5 S T D FLOP per head for a dense mask (half for causal) at the card's
// 989 TFLOP/s bf16 tensor-core rate, against the ~67 TFLOP/s of float32 FMA
// this kernel can reach at best and 7 S T D of work (S and dP are computed in
// both passes).  wgmma and TMA (FA3's dQ / dKV split) are left for its
// redesign.
//
// Interface: plain C, loaded with ctypes.  q/out/dout [B, S, H, D], k/v
// [B, T, G, D], contiguous; D in {16, 32, 64, 128}.  The wrapper
// (kernels/flash_attention/ops.py) checks shapes, dtypes and devices; each
// entry point returns the cudaError_t of its launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBN + 4;  // padded row stride of a 64 x 64 score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Thread layout of the D-wide accumulators: thread t owns the dims
// dim(c, w) = (t % 16) * W + 16 * W * c + w, c < D / 16 / W, w < W, so each
// chunk of W dims is contiguous and a warp's chunks are neighbours.
template <int D>
struct Dims {
  static constexpr int kPer = D / 16;  // dims per thread
  static constexpr int kW = kPer < 4 ? kPer : 4;
  static constexpr int kChunks = kPer / kW;
  static constexpr int kPad = D + 4;  // padded row stride of a 64 x D tile
  __device__ static __forceinline__ int dim(int td, int c, int w) {
    return td * kW + 16 * kW * c + w;
  }
  // the thread's dims of row `row` of a padded tile, into x[kPer]
  __device__ static __forceinline__ void load(const float* tile, int row, int td, float (&x)[kPer]) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float* src = tile + row * kPad + dim(td, c, 0);
      if constexpr (kW == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        x[4 * c] = v.x, x[4 * c + 1] = v.y, x[4 * c + 2] = v.z, x[4 * c + 3] = v.w;
      } else if constexpr (kW == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src);
        x[2 * c] = v.x, x[2 * c + 1] = v.y;
      } else {
        x[c] = src[0];
      }
    }
  }
};

// Rows [r0, r0 + 64) of head `head` of a [B, rows, heads, D] tensor into a
// float tile [64][D + 4], zeros past `rows`.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, int b, int r0,
                                          int rows, int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    float x = 0.f;
    if (row < rows) x = to_f32(src[((static_cast<long long>(b) * rows + row) * heads + head) * D + d]);
    tile[r * Dims<D>::kPad + d] = x;
  }
}

// The 4 x 4 blocks of S = Q K^T and dP = dO V^T of thread (tr, tc): rows
// tr + 16 i of the q-side tiles, rows tc + 16 j of the k-side tiles.
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int P = Dims<D>::kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 kb[4], vb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * P + d);
      vb[j] = *reinterpret_cast<const float4*>(vs + (tc + 16 * j) * P + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + (tr + 16 * i) * P + d);
      const float4 oa = *reinterpret_cast<const float4*>(dos + (tr + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += dot4(qa, kb[j]);
        dp[i][j] += dot4(oa, vb[j]);
      }
    }
  }
}

__device__ __forceinline__ bool unmasked(int row, int col, int S, int Tk, int causal, int window) {
  bool ok = row < S && col < Tk;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// D_i = rowsum(dO * O): D / 4 threads per row, 4 dims each.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ drow,
                   int S, int H, long long rows) {
  constexpr int NT = D / 4;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / NT) + threadIdx.x / NT;
  const int lane = threadIdx.x % NT;
  float acc = 0.f;
  if (row < rows) {
    const long long base = row * D + lane * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc += to_f32(out[base + e]) * to_f32(dout[base + e]);
  }
#pragma unroll
  for (int off = NT / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    const long long h = row % H, i = (row / H) % S, b = row / (static_cast<long long>(H) * S);
    drow[(b * H + h) * S + i] = acc;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * 64 * Dims<D>::kPad + kBN * (kBM + 4) + 2 * kBM;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * 64 * Dims<D>::kPad + 2 * kBM * kPS + 2 * kBM;
}

// dQ: one block per (q tile, head, batch), looping over its live KV tiles.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ drow, T* __restrict__ dq, int S, int Tk, int H, int G,
                 int causal, int window, float scale) {
  using DM = Dims<D>;
  constexpr int P = DM::kPad;
  constexpr int PQ = kBM + 4;  // dS^T tile [key][row]
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + 64 * P;
  float* ks = dos + 64 * P;
  float* vs = ks + 64 * P;
  float* dst = vs + 64 * P;
  float* lse_s = dst + kBN * PQ;
  float* d_s = lse_s + kBM;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  load_tile<D>(qs, q, b, q0, S, H, h);
  load_tile<D>(dos, dout, b, q0, S, H, h);
  if (t < kBM) {
    const int row = q0 + t;
    const long long at = (static_cast<long long>(b) * H + h) * S + row;
    lse_s[t] = row < S ? lse[at] : 0.f;
    d_s[t] = row < S ? drow[at] : 0.f;
  }
  float acc[4][DM::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DM::kPer; ++e) acc[i][e] = 0.f;

  int hi = Tk;
  if (causal) hi = min(hi, q0 + kBM);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = lo / kBN * kBN; k0 < hi; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k, b, k0, Tk, G, g);
    load_tile<D>(vs, v, b, k0, Tk, G, g);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = unmasked(q0 + r, k0 + c, S, Tk, causal, window)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        dst[c * PQ + r] = p * (dp[i][j] - d_s[r]) * scale;
      }
    }
    __syncthreads();
    // dQ[r, :] += sum_c dS[r, c] K[c, :], rows tr * 4 + i
    for (int c = 0; c < kBN; ++c) {
      const float4 dsr = *reinterpret_cast<const float4*>(dst + c * PQ + tr * 4);
      float kd[DM::kPer];
      DM::load(ks, c, tc, kd);
#pragma unroll
      for (int e = 0; e < DM::kPer; ++e) {
        acc[0][e] += dsr.x * kd[e];
        acc[1][e] += dsr.y * kd[e];
        acc[2][e] += dsr.z * kd[e];
        acc[3][e] += dsr.w * kd[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= S) continue;
    T* dst_row = dq + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DM::kChunks; ++c)
#pragma unroll
      for (int w = 0; w < DM::kW; ++w) dst_row[DM::dim(tc, c, w)] = from_f32<T>(acc[i][c * DM::kW + w]);
  }
}

// dK, dV: one block per (KV tile, group, batch), looping over the group's
// query heads and, for each, the q tiles that can see the tile.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ drow, T* __restrict__ dk, T* __restrict__ dv, int S,
                  int Tk, int H, int G, int causal, int window, float scale) {
  using DM = Dims<D>;
  constexpr int P = DM::kPad;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + 64 * P;
  float* qs = vs + 64 * P;
  float* dos = qs + 64 * P;
  float* ps = dos + 64 * P;  // P tile [row][key]
  float* dss = ps + kBM * kPS;  // dS tile [row][key]
  float* lse_s = dss + kBM * kPS;
  float* d_s = lse_s + kBM;

  const int k0 = blockIdx.x * kBN, g = blockIdx.y, b = blockIdx.z;
  const int M = H / G;
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  load_tile<D>(ks, k, b, k0, Tk, G, g);
  load_tile<D>(vs, v, b, k0, Tk, G, g);
  float acc_k[4][DM::kPer], acc_v[4][DM::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DM::kPer; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kBN - 1 + window) : S;
  for (int m = 0; m < M; ++m) {
    const int h = g * M + m;
    for (int q0 = i_lo / kBM * kBM; q0 < i_hi; q0 += kBM) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(qs, q, b, q0, S, H, h);
      load_tile<D>(dos, dout, b, q0, S, H, h);
      if (t < kBM) {
        const int row = q0 + t;
        const long long at = (static_cast<long long>(b) * H + h) * S + row;
        lse_s[t] = row < S ? lse[at] : 0.f;
        d_s[t] = row < S ? drow[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(qs, dos, ks, vs, tr, tc, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          const float p = unmasked(q0 + r, k0 + c, S, Tk, causal, window)
                              ? expf(s[i][j] * scale - lse_s[r])
                              : 0.f;
          ps[r * kPS + c] = p;
          dss[r * kPS + c] = p * (dp[i][j] - d_s[r]) * scale;
        }
      }
      __syncthreads();
      // dV[c, :] += sum_r P[r, c] dO[r, :];  dK[c, :] += sum_r dS[r, c] Q[r, :]
      for (int r = 0; r < kBM; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(ps + r * kPS + tr * 4);
        const float4 sr = *reinterpret_cast<const float4*>(dss + r * kPS + tr * 4);
        float od[DM::kPer], qd[DM::kPer];
        DM::load(dos, r, tc, od);
        DM::load(qs, r, tc, qd);
#pragma unroll
        for (int e = 0; e < DM::kPer; ++e) {
          acc_v[0][e] += pr.x * od[e];
          acc_v[1][e] += pr.y * od[e];
          acc_v[2][e] += pr.z * od[e];
          acc_v[3][e] += pr.w * od[e];
          acc_k[0][e] += sr.x * qd[e];
          acc_k[1][e] += sr.y * qd[e];
          acc_k[2][e] += sr.z * qd[e];
          acc_k[3][e] += sr.w * qd[e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr * 4 + i;
    if (key >= Tk) continue;
    const long long at = ((static_cast<long long>(b) * Tk + key) * G + g) * D;
#pragma unroll
    for (int c = 0; c < DM::kChunks; ++c)
#pragma unroll
      for (int w = 0; w < DM::kW; ++w) {
        const int d = DM::dim(tc, c, w);
        dk[at + d] = from_f32<T>(acc_k[i][c * DM::kW + w]);
        dv[at + d] = from_f32<T>(acc_v[i][c * DM::kW + w]);
      }
  }
}

template <int D, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int Tk,
               int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_floats<D>() * 4;
  constexpr int dkv_bytes = dkv_smem_floats<D>() * 4;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<D, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkv<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dkv_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  float* drowf = static_cast<float*>(drow);
  const long long rows = static_cast<long long>(B) * S * H;
  const int rows_per_block = kThreads / (D / 4);
  flash_bwd_prep<D, T><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                         kThreads, 0, stream>>>(static_cast<const T*>(out), dot, drowf, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<D, T><<<dim3((S + kBM - 1) / kBM, H, B), kThreads, dq_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dq), S, Tk, H, G, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv<D, T><<<dim3((Tk + kBN - 1) / kBN, G, B), kThreads, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, G, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int T_,
             int H, int G, int D, int causal, int window, float scale, void* stream) {
  if (B == 0 || S == 0 || T_ == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bwd<16, T>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T_, H, G, causal,
                               window, scale, s);
    case 32:
      return launch_bwd<32, T>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T_, H, G, causal,
                               window, scale, s);
    case 64:
      return launch_bwd<64, T>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T_, H, G, causal,
                               window, scale, s);
    case 128:
      return launch_bwd<128, T>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T_, H, G, causal,
                                window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// float32 inputs.  `drow` is [B, H, S] float32 scratch.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* drow, void* dq,
                                       void* dk, void* dv, int B, int S, int T, int H, int G, int D,
                                       int causal, int window, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, D, causal,
                         window, scale, stream);
}

// bfloat16 inputs (float32 arithmetic, bfloat16 outputs).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* drow, void* dq, void* dk, void* dv, int B, int S,
                                        int T, int H, int G, int D, int causal, int window,
                                        float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, D,
                                 causal, window, scale, stream);
}
