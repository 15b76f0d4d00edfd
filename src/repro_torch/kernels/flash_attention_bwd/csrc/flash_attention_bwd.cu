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
// lse ([B, H, S] float32) is what the forward wrote; the outputs are rounded
// to the input type.
//
// Deterministic by construction: no atomics, and every output element is
// summed by one thread in a fixed order, so two calls agree bit for bit.
// Three launches on the caller's stream: `flash_bwd_prep` writes D
// ([B, H, S] float32, scratch the wrapper allocates); a dQ pass with one CTA
// per (64-row q tile, head, batch) looping over the KV tiles that can hold an
// unmasked key; a dK/dV pass with one CTA per (64-key tile, group, batch)
// looping over the group's query heads and the q tiles that can see it.
// Both passes recompute P, so S and dP are computed twice: 7 products of
// 2 D flop per (row, key) pair where FA3's atomic dQ needs 5.  Two routes,
// chosen by the input type (the wrapper dispatches; neither falls back to
// the other):
//
// bfloat16: the tensor cores (`flash_bwd_dq_bf16`, `flash_bwd_dkv_bf16`).  A
// CTA is one consumer warpgroup and one producer warp, built from the
// forward's blocks (include/hopper.cuh).  The producer's lane 0 brings the
// CTA's resident tiles (dQ: Q and dO; dK/dV: K and V) and then each streamed
// pair (dQ: K and V; dK/dV: the (head, q tile)'s Q and dO, with its rows'
// lse * log2(e) and D written to shared memory by the producer's 32 lanes)
// through TMA into a two-stage mbarrier ring.  The consumers compute the two
// score products with `wgmma` on swizzled K-major tiles: S = Q K^T and
// dP = dO V^T, or in the dK/dV pass their transposes S^T = K Q^T and
// dP^T = V dO^T, so that keys are the fragment's rows.  P and dS are formed
// in float32 on the accumulator fragments (lse and D per row from
// registers, or per column from the staged vectors), masked only on the
// tiles that the causal diagonal, the window or the true S and T cut, and
// rounded to bf16 in registers as the A operand of the register-A `wgmma`:
// dQ += dS K, dV += P^T dO, dK += dS^T Q, each B tile read MN-major.  The
// accumulators stay in float32 registers until one store at the end.  KV or
// q tiles that the mask rules out entirely are never loaded; under causal
// the longest CTAs of each (head, batch) launch first.  Registers: the dK/dV
// pass holds dK and dV (D / 2 floats each) plus S^T and dP^T (32 each) per
// thread, ~200 at D = 128, so it runs one CTA per SM there and two below.
//
// float32: the CUDA cores (`flash_bwd_dq`, `flash_bwd_dkv`; TF32 would keep
// about three digits against the float32 contract of 1e-4).  Tiles are
// staged in shared memory as float32 (rows padded by 4 floats so that float4
// reads of 8 neighbouring rows fall in distinct banks), 256 threads, each
// computing a 4 x 4 block of the 64 x 64 score and dP tiles (rows tr + 16 i,
// columns tc + 16 j) from float4 reads, then a 4-row x D/16-dim block of the
// dK/dV (or dQ) accumulators.
//
// Bound: 5 products of 2 D flop per unmasked (row, key) pair at the card's
// 989 TFLOP/s bf16 tensor-core rate (0.69 ms at stablelm-1.6b's training
// shape, B 4, S 4096, 32 heads of 64, causal).
//
// Interface: plain C, loaded with ctypes.  q/out/dout [B, S, H, D], k/v
// [B, T, G, D], contiguous; D in {16, 32, 64, 128}.  The wrapper
// (kernels/flash_attention/ops.py) checks shapes, dtypes, devices and the
// 16-byte alignment TMA needs; each entry point returns the cudaError_t of
// its launches.  The bf16 route encodes its tensor maps on the host at every
// call, as the forward does.

#include <math.h>

#include "../../include/hopper.cuh"

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

// D_i = rowsum(dO * O): D / 4 threads per row, 4 dims each (both routes).
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

// float32 dQ: one block per (q tile, head, batch), looping over its live KV tiles.
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

// float32 dK, dV: one block per (KV tile, group, batch), looping over the
// group's query heads and, for each, the q tiles that can see the tile.
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
int launch_prep(const void* out, const void* dout, void* drow, int B, int S, int H,
                cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int rows_per_block = kThreads / (D / 4);
  flash_bwd_prep<D, T><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                         kThreads, 0, stream>>>(static_cast<const T*>(out),
                                                static_cast<const T*>(dout),
                                                static_cast<float*>(drow), S, H, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int Tk,
               int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using T = float;
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
  int err = launch_prep<D, T>(out, dout, drow, B, S, H, stream);
  if (err != 0) return err;
  flash_bwd_dq<D, T><<<dim3((S + kBM - 1) / kBM, H, B), kThreads, dq_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dq), S, Tk, H, G, causal, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dkv<D, T><<<dim3((Tk + kBN - 1) / kBN, G, B), kThreads, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, G, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bfloat16: wgmma + TMA

constexpr int kStagesTC = 2;
constexpr int kConsumersTC = 128;              // one warpgroup
constexpr int kThreadsTC = kConsumersTC + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of both passes: two resident tiles, then kStagesTC stages of
// two streamed tiles; the dK/dV pass then stages each q tile's lse * log2(e)
// and D ([stage][2][64] floats); then the mbarriers.
template <int D>
struct BwdTiles {
  static constexpr int kT = Swizzle<D>::kTileBytes;
  static constexpr int kTilesBytes = 2 * kT + kStagesTC * 2 * kT;
  static constexpr int kVecBytes = kStagesTC * 2 * kTileRows * 4;
  static constexpr int kBarBytes = 8 * (2 * kStagesTC + 1);
  static constexpr int kSmemDq = kTilesBytes + kBarBytes + 1024;  // + alignment slack
  static constexpr int kSmemDkv = kTilesBytes + kVecBytes + kBarBytes + 1024;
};

// dQ pass, in place on one tile's fragments (rows queries, columns keys):
// s <- P = exp2(s scale log2(e) - lse2) (0 where masked), dp <- dS =
// P (dP - D) scale, with lse2 = lse * log2(e) and D of this thread's two
// rows.  Only an edge tile evaluates the mask.
__device__ __forceinline__ void grads_by_row(float (&s)[kTileRows / 2], float (&dp)[kTileRows / 2],
                                             const float (&lse2)[2], const float (&dr)[2],
                                             int row0, int col0, bool edge, int Tk, int causal,
                                             int window, float scale, float scale_log2) {
#pragma unroll
  for (int j = 0; j < kTileRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      float p = exp2f(s[x] * scale_log2 - lse2[e / 2]);
      if (edge) {
        const int row = row0 + 8 * (e / 2), col = col0 + 8 * j + e % 2;
        bool ok = col < Tk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) p = 0.f;
      }
      s[x] = p;
      dp[x] = p * (dp[x] - dr[e / 2]) * scale;
    }
}

// dK/dV pass, the same on transposed fragments (rows keys, columns queries):
// lse2 and D per column from the stage's vectors `vec` ([lse2 | D][64]).
__device__ __forceinline__ void grads_by_col(float (&s)[kTileRows / 2], float (&dp)[kTileRows / 2],
                                             const float* vec, int key0, int q0, int c0, bool edge,
                                             int S, int Tk, int causal, int window, float scale,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < kTileRows / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + c0);
    const float2 d2 = *reinterpret_cast<const float2*>(vec + kTileRows + 8 * j + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      float p = exp2f(s[x] * scale_log2 - (e % 2 ? l2.y : l2.x));
      if (edge) {
        const int key = key0 + 8 * (e / 2), row = q0 + 8 * j + c0 + e % 2;
        bool ok = row < S && key < Tk;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && row - key < window;
        if (!ok) p = 0.f;
      }
      s[x] = p;
      dp[x] = p * (dp[x] - (e % 2 ? d2.y : d2.x)) * scale;
    }
  }
}

// Rows r0 and r0 + 8 of a 64 x D accumulator fragment, rounded to bf16, into
// rows `row0` and `row0 + 8` (those below `rows`) of dst [.., rows, heads, D]
// at head `head`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const float (&acc)[D / 2],
                                           int b, int row0, int rows, int heads, int head, int c0) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= rows) continue;
    __nv_bfloat16* p = dst + ((static_cast<long long>(b) * rows + row) * heads + head) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// bf16 dQ: one CTA per (q tile, head, batch); Q and dO resident, K and V
// streamed.  S = Q K^T, dP = dO V^T, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                      const float* __restrict__ drow, __nv_bfloat16* __restrict__ dq, int S,
                      int Tk, int H, int G, int causal, int window, float scale,
                      float scale_log2) {
  using BT = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t q_s = base, do_s = base + BT::kT;
  auto k_tile = [&](int s) { return base + (2 + 2 * s) * BT::kT; };
  auto v_tile = [&](int s) { return base + (3 + 2 * s) * BT::kT; };
  const uint32_t bars = base + BT::kTilesBytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStagesTC + s); };
  const uint32_t q_bar = bars + 16 * kStagesTC;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  int hi = Tk;
  if (causal) hi = min(hi, q0 + kTileRows);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / kTileRows;
  const int n_tiles = max(0, (hi + kTileRows - 1) / kTileRows - t_lo);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStagesTC; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumersTC);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumersTC) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumersTC && n_tiles > 0) {
      mbar_expect_tx(q_bar, 2 * BT::kT);
      tma_tile<D>(q_s, &qmap, q_bar, h, q0, b);
      tma_tile<D>(do_s, &domap, q_bar, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStagesTC;
        const int k0 = (t_lo + i) * kTileRows;
        mbar_wait(empty_bar(s), ((i / kStagesTC) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), 2 * BT::kT);
        tma_tile<D>(k_tile(s), &kmap, full_bar(s), g, k0, b);
        tma_tile<D>(v_tile(s), &vmap, full_bar(s), g, k0, b);
      }
    }
    return;
  }

  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (tid % 4);
  float lse2[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    const long long at = (static_cast<long long>(b) * H + h) * S + row;
    lse2[rr] = row < S ? lse[at] * kLog2e : 0.f;
    dr[rr] = row < S ? drow[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  if (n_tiles > 0) {
    float sc[kTileRows / 2], dp[kTileRows / 2];
#pragma unroll
    for (int x = 0; x < kTileRows / 2; ++x) sc[x] = dp[x] = 0.f;
    uint32_t da[kTileRows / 16][4];
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStagesTC;
      const int k0 = (t_lo + i) * kTileRows;
      mbar_wait(full_bar(s), (i / kStagesTC) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(sc, q_s, k_tile(s));
      issue_scores<D>(dp, do_s, v_tile(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool edge = k0 + kTileRows > Tk || (causal && k0 + kTileRows - 1 > q0) ||
                        (window > 0 && q0 + kTileRows - 1 - k0 >= window);
      grads_by_row(sc, dp, lse2, dr, q0 + r0, k0 + c0, edge, Tk, causal, window, scale,
                   scale_log2);
      pack_p(dp, da);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D>(acc, da, k_tile(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty_bar(s));
    }
  }
  store_rows<D>(dq, acc, b, q0 + r0, S, H, h, c0);
}

// bf16 dK, dV: one CTA per (key tile, group, batch); K and V resident, the
// group's heads' Q and dO tiles streamed.  S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, D >= 128 ? 1 : 2)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                       const float* __restrict__ drow, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int Tk, int H, int G, int causal,
                       int window, float scale, float scale_log2) {
  using BT = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + BT::kT;
  auto q_tile = [&](int s) { return base + (2 + 2 * s) * BT::kT; };
  auto do_tile = [&](int s) { return base + (3 + 2 * s) * BT::kT; };
  float* vecs = reinterpret_cast<float*>(smem_raw + (base - raw) + BT::kTilesBytes);
  const uint32_t bars = base + BT::kTilesBytes + BT::kVecBytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStagesTC + s); };
  const uint32_t kv_bar = bars + 16 * kStagesTC;

  const int k0 = blockIdx.x * kTileRows;  // under causal the first key tiles see the most rows
  const int g = blockIdx.y, b = blockIdx.z;
  const int M = H / G;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kTileRows - 1 + window) : S;
  const int t_lo = i_lo / kTileRows;
  const int n_q = max(0, (i_hi + kTileRows - 1) / kTileRows - t_lo);
  const int n_steps = M * n_q;  // (head, q tile) pairs, heads outer

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStagesTC; ++s) {
      mbar_init(full_bar(s), 32);  // every producer lane, lane 0 with the TMA bytes
      mbar_init(empty_bar(s), kConsumersTC);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumersTC) {  // the producer warp
    const int lane = tid - kConsumersTC;
    if (n_steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * BT::kT);
      tma_tile<D>(k_s, &kmap, kv_bar, g, k0, b);
      tma_tile<D>(v_s, &vmap, kv_bar, g, k0, b);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStagesTC;
      const int h = g * M + i / n_q;
      const int q0 = (t_lo + i % n_q) * kTileRows;
      mbar_wait(empty_bar(s), ((i / kStagesTC) & 1) ^ 1);
      float* vec = vecs + s * 2 * kTileRows;
      for (int r = lane; r < kTileRows; r += 32) {
        const int row = q0 + r;
        const long long at = (static_cast<long long>(b) * H + h) * S + row;
        vec[r] = row < S ? lse[at] * kLog2e : 0.f;
        vec[kTileRows + r] = row < S ? drow[at] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full_bar(s), 2 * BT::kT);
        tma_tile<D>(q_tile(s), &qmap, full_bar(s), h, q0, b);
        tma_tile<D>(do_tile(s), &domap, full_bar(s), h, q0, b);
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's keys: r0 and r0 + 8
  const int c0 = 2 * (tid % 4);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  if (n_steps > 0) {
    float st[kTileRows / 2], dpt[kTileRows / 2];
#pragma unroll
    for (int x = 0; x < kTileRows / 2; ++x) st[x] = dpt[x] = 0.f;
    uint32_t pa[kTileRows / 16][4], da[kTileRows / 16][4];
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStagesTC;
      const int q0 = (t_lo + i % n_q) * kTileRows;
      mbar_wait(full_bar(s), (i / kStagesTC) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_scores<D>(st, k_s, q_tile(s));
      issue_scores<D>(dpt, v_s, do_tile(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const bool edge = q0 + kTileRows > S || k0 + kTileRows > Tk ||
                        (causal && k0 + kTileRows - 1 > q0) ||
                        (window > 0 && q0 + kTileRows - 1 - k0 >= window);
      grads_by_col(st, dpt, vecs + s * 2 * kTileRows, k0 + r0, q0, c0, edge, S, Tk, causal,
                   window, scale, scale_log2);
      pack_p(st, pa);
      pack_p(dpt, da);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      issue_pv<D>(dv_acc, pa, do_tile(s));
      issue_pv<D>(dk_acc, da, q_tile(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty_bar(s));
    }
  }
  store_rows<D>(dk, dk_acc, b, k0 + r0, Tk, G, g, c0);
  store_rows<D>(dv, dv_acc, b, k0 + r0, Tk, G, g, c0);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int Tk,
                int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using BT = BwdTiles<D>;
  CUtensorMap qm, km, vm, dom;
  if (!encode_tile_map<D>(&qm, q, B, S, H) || !encode_tile_map<D>(&dom, dout, B, S, H) ||
      !encode_tile_map<D>(&km, k, B, Tk, G) || !encode_tile_map<D>(&vm, v, B, Tk, G))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, BT::kSmemDq);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, BT::kSmemDkv);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const float* lsef = static_cast<const float*>(lse);
  const float* drowf = static_cast<const float*>(drow);
  int err = launch_prep<D, __nv_bfloat16>(out, dout, drow, B, S, H, stream);
  if (err != 0) return err;
  flash_bwd_dq_bf16<D><<<dim3((S + kTileRows - 1) / kTileRows, H, B), kThreadsTC, BT::kSmemDq,
                         stream>>>(qm, km, vm, dom, lsef, drowf, static_cast<__nv_bfloat16*>(dq),
                                   S, Tk, H, G, causal, window, scale, scale * kLog2e);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dkv_bf16<D><<<dim3((Tk + kTileRows - 1) / kTileRows, G, B), kThreadsTC,
                          BT::kSmemDkv, stream>>>(
      qm, km, vm, dom, lsef, drowf, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Tk, H, G, causal, window, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BWD_DISPATCH(fn)                                                                        \
  if (B == 0 || S == 0 || T == 0) return 0;                                                     \
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);                     \
  switch (D) {                                                                                  \
    case 16:                                                                                    \
      return fn<16>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, causal, window,   \
                    scale, static_cast<cudaStream_t>(stream));                                  \
    case 32:                                                                                    \
      return fn<32>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, causal, window,   \
                    scale, static_cast<cudaStream_t>(stream));                                  \
    case 64:                                                                                    \
      return fn<64>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, causal, window,   \
                    scale, static_cast<cudaStream_t>(stream));                                  \
    case 128:                                                                                   \
      return fn<128>(q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, causal, window,  \
                     scale, static_cast<cudaStream_t>(stream));                                 \
    default:                                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                                           \
  }

// float32 inputs: the CUDA-core kernels.  `drow` is [B, H, S] float32 scratch.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* drow, void* dq,
                                       void* dk, void* dv, int B, int S, int T, int H, int G, int D,
                                       int causal, int window, float scale, void* stream) {
  BWD_DISPATCH(launch_f32)
}

// bfloat16 inputs: the wgmma + TMA kernels (float32 accumulation, bfloat16 outputs).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* drow, void* dq, void* dk, void* dv, int B, int S,
                                        int T, int H, int G, int D, int causal, int window,
                                        float scale, void* stream) {
  BWD_DISPATCH(launch_bf16)
}
