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
// Both passes recompute P, so S and dP are computed twice: 7 products per
// (row, key) pair where FA3's atomic dQ needs 5.  Widths: q and k have one
// head width DK, v, out and dout their own DV (dQ and dK are DK wide, dV DV):
// the square widths 16, 32, 64, 80 and 128, and MLA's (192, 128) (deepseek-v2's
// 128 up-projected and 64 RoPE dims of each head, v 128).  Two routes,
// chosen by the input type (the wrapper dispatches; neither falls back to
// the other):
//
// bfloat16: the tensor cores (`flash_bwd_dq_bf16`, `flash_bwd_dkv_bf16`).  A
// CTA is one consumer warpgroup and one producer warp (MLA's dK/dV pass:
// two and a producer warpgroup, below), built from the
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
// thread, ~200 at D = 128, so it runs one CTA per SM there and two at 64
// and below.  At D = 80 (stablelm-3b) the tiles are five 32-byte swizzle
// atoms wide (include/hopper.cuh), S^T and dP^T take five k-steps of 16, dQ,
// dK and dV are N = 80 products, and the dK/dV pass holds dK 40 + dV 40 +
// S^T 32 + dP^T 32 floats a thread: the square pass as it is, at one CTA
// per SM (at two, ptxas caps a thread at 168 registers, spills 544 bytes
// and serializes the wgmma, C7512).
// At (192, 128) one warpgroup would hold dK 96 + dV 64 + S^T 32 + dP^T 32 =
// 224 floats before its bf16 operands, and spill; so that pass
// (`flash_bwd_dkv_split_bf16`) splits its accumulators over two consumer
// warpgroups that share the CTA's tiles and ring: one forms P from its own
// S^T and owns dV, the other forms S^T and dP^T, then dS, and owns dK.  Each
// computes S^T, an eighth product, where handing P over through shared
// memory would cost a barrier between the two per tile; one CTA per SM (120
// KB of tiles).  It is a kernel of its own: sharing one template with the
// square pass made that pass slower at D = 64 and 128 on the card (the same
// registers, other instruction scheduling).  The dQ pass holds dQ 96 + S 32
// + dP 32 at (192, 128), in one warpgroup.
//
// float32: the CUDA cores (`flash_bwd_dq`, `flash_bwd_dkv`; TF32 would keep
// about three digits against the float32 contract of 1e-4).  Tiles are
// staged in shared memory as float32 (rows padded by 4 floats so that float4
// reads of 8 neighbouring rows fall in distinct banks), 256 threads, each
// computing a 4 x 4 block of the 64 x 64 score and dP tiles (rows tr + 16 i,
// columns tc + 16 j) from float4 reads, then a 4-row x D/16-dim block of the
// dK/dV (or dQ) accumulators (at D = 80 five dims a thread, 16 apart).  At
// (192, 128) the four staged tiles take 164 KB and the whole dK/dV pass 199
// KB of the 227 KB a block may use; at (80, 80) 86 and 121 KB.
//
// Bound: 5 products per unmasked (row, key) pair, 2 DK flop each for S, dQ
// and dK and 2 DV for dP and dV, at the card's 989 TFLOP/s bf16 tensor-core
// rate (0.69 ms at stablelm-1.6b's training shape, B 4, S 4096, 32 heads of
// 64, causal; 0.452 ms at deepseek-v2-lite-16b's, B 2, S 4096, 16 heads of
// 192 / 128).
//
// Interface: plain C, loaded with ctypes.  q/dq [B, S, H, DK], out/dout
// [B, S, H, DV], k/dk [B, T, G, DK], v/dv [B, T, G, DV], contiguous; (DK, DV)
// one of the pairs above.  The wrapper
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
// chunk of W dims is contiguous and a warp's chunks are neighbours.  W is the
// widest of 4, 2 and 1 that divides the thread's D / 16 dims (D = 80: 1).
template <int D>
struct Dims {
  static constexpr int kPer = D / 16;  // dims per thread
  static constexpr int kW = kPer % 4 == 0 ? 4 : kPer % 2 == 0 ? 2 : 1;
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
// tr + 16 i of the q-side tiles, rows tc + 16 j of the k-side tiles.  Both
// over the first DV dims together, then S over the rest of DK.
template <int DK, int DV>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int PK = Dims<DK>::kPad, PV = Dims<DV>::kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DV; d += 4) {
    float4 kb[4], vb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * PK + d);
      vb[j] = *reinterpret_cast<const float4*>(vs + (tc + 16 * j) * PV + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + (tr + 16 * i) * PK + d);
      const float4 oa = *reinterpret_cast<const float4*>(dos + (tr + 16 * i) * PV + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += dot4(qa, kb[j]);
        dp[i][j] += dot4(oa, vb[j]);
      }
    }
  }
#pragma unroll 4
  for (int d = DV; d < DK; d += 4) {
    float4 kb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kb[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * PK + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + (tr + 16 * i) * PK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += dot4(qa, kb[j]);
    }
  }
}

__device__ __forceinline__ bool unmasked(int row, int col, int S, int Tk, int causal, int window) {
  bool ok = row < S && col < Tk;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// Threads per row of `flash_bwd_prep`: D / 4 where that is a power of two,
// else 16 (D = 80: 5 dims each), so that the row's shuffles stay in its lanes.
template <int D>
struct PrepLanes {
  static constexpr int kN = (D / 4 & (D / 4 - 1)) == 0 ? D / 4 : 16;
};

// D_i = rowsum(dO * O): PrepLanes threads per row (both routes).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ drow,
                   int S, int H, long long rows) {
  constexpr int NT = PrepLanes<D>::kN;
  constexpr int E = D / NT;  // dims per thread
  static_assert(NT <= 32 && (NT & (NT - 1)) == 0 && D % NT == 0, "a row's lanes");
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / NT) + threadIdx.x / NT;
  const int lane = threadIdx.x % NT;
  float acc = 0.f;
  if (row < rows) {
    const long long base = row * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc += to_f32(out[base + e]) * to_f32(dout[base + e]);
  }
#pragma unroll
  for (int off = NT / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    const long long h = row % H, i = (row / H) % S, b = row / (static_cast<long long>(H) * S);
    drow[(b * H + h) * S + i] = acc;
  }
}

// Two DK-wide and two DV-wide staged tiles of each pass, then its own.
template <int DK, int DV>
constexpr int tiles_floats() {
  return 2 * 64 * (Dims<DK>::kPad + Dims<DV>::kPad);
}
template <int DK, int DV>
constexpr int dq_smem_floats() {
  return tiles_floats<DK, DV>() + kBN * (kBM + 4) + 2 * kBM;
}
template <int DK, int DV>
constexpr int dkv_smem_floats() {
  return tiles_floats<DK, DV>() + 2 * kBM * kPS + 2 * kBM;
}
static_assert(dkv_smem_floats<192, 128>() * 4 <= 232448, "the float32 dK/dV pass's tiles");
static_assert(dkv_smem_floats<80, 80>() * 4 <= 232448, "the float32 dK/dV pass's tiles");

// float32 dQ: one block per (q tile, head, batch), looping over its live KV tiles.
template <int DK, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ drow, T* __restrict__ dq, int S, int Tk, int H, int G,
                 int causal, int window, float scale) {
  using DM = Dims<DK>;
  constexpr int PK = DM::kPad, PV = Dims<DV>::kPad;
  constexpr int PQ = kBM + 4;  // dS^T tile [key][row]
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + 64 * PK;
  float* ks = dos + 64 * PV;
  float* vs = ks + 64 * PK;
  float* dst = vs + 64 * PV;
  float* lse_s = dst + kBN * PQ;
  float* d_s = lse_s + kBM;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  load_tile<DK>(qs, q, b, q0, S, H, h);
  load_tile<DV>(dos, dout, b, q0, S, H, h);
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
    load_tile<DK>(ks, k, b, k0, Tk, G, g);
    load_tile<DV>(vs, v, b, k0, Tk, G, g);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<DK, DV>(qs, dos, ks, vs, tr, tc, s, dp);
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
    T* dst_row = dq + ((static_cast<long long>(b) * S + row) * H + h) * DK;
#pragma unroll
    for (int c = 0; c < DM::kChunks; ++c)
#pragma unroll
      for (int w = 0; w < DM::kW; ++w) dst_row[DM::dim(tc, c, w)] = from_f32<T>(acc[i][c * DM::kW + w]);
  }
}

// float32 dK, dV: one block per (KV tile, group, batch), looping over the
// group's query heads and, for each, the q tiles that can see the tile.
template <int DK, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ drow, T* __restrict__ dk, T* __restrict__ dv, int S,
                  int Tk, int H, int G, int causal, int window, float scale) {
  using DMK = Dims<DK>;
  using DMV = Dims<DV>;
  constexpr int PK = DMK::kPad, PV = DMV::kPad;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + 64 * PK;
  float* qs = vs + 64 * PV;
  float* dos = qs + 64 * PK;
  float* ps = dos + 64 * PV;  // P tile [row][key]
  float* dss = ps + kBM * kPS;  // dS tile [row][key]
  float* lse_s = dss + kBM * kPS;
  float* d_s = lse_s + kBM;

  const int k0 = blockIdx.x * kBN, g = blockIdx.y, b = blockIdx.z;
  const int M = H / G;
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  load_tile<DK>(ks, k, b, k0, Tk, G, g);
  load_tile<DV>(vs, v, b, k0, Tk, G, g);
  float acc_k[4][DMK::kPer], acc_v[4][DMV::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < DMK::kPer; ++e) acc_k[i][e] = 0.f;
#pragma unroll
    for (int e = 0; e < DMV::kPer; ++e) acc_v[i][e] = 0.f;
  }

  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kBN - 1 + window) : S;
  for (int m = 0; m < M; ++m) {
    const int h = g * M + m;
    for (int q0 = i_lo / kBM * kBM; q0 < i_hi; q0 += kBM) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<DK>(qs, q, b, q0, S, H, h);
      load_tile<DV>(dos, dout, b, q0, S, H, h);
      if (t < kBM) {
        const int row = q0 + t;
        const long long at = (static_cast<long long>(b) * H + h) * S + row;
        lse_s[t] = row < S ? lse[at] : 0.f;
        d_s[t] = row < S ? drow[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<DK, DV>(qs, dos, ks, vs, tr, tc, s, dp);
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
        float od[DMV::kPer], qd[DMK::kPer];
        DMV::load(dos, r, tc, od);
        DMK::load(qs, r, tc, qd);
#pragma unroll
        for (int e = 0; e < DMV::kPer; ++e) {
          acc_v[0][e] += pr.x * od[e];
          acc_v[1][e] += pr.y * od[e];
          acc_v[2][e] += pr.z * od[e];
          acc_v[3][e] += pr.w * od[e];
        }
#pragma unroll
        for (int e = 0; e < DMK::kPer; ++e) {
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
    const long long at = (static_cast<long long>(b) * Tk + key) * G + g;
#pragma unroll
    for (int c = 0; c < DMK::kChunks; ++c)
#pragma unroll
      for (int w = 0; w < DMK::kW; ++w)
        dk[at * DK + DMK::dim(tc, c, w)] = from_f32<T>(acc_k[i][c * DMK::kW + w]);
#pragma unroll
    for (int c = 0; c < DMV::kChunks; ++c)
#pragma unroll
      for (int w = 0; w < DMV::kW; ++w)
        dv[at * DV + DMV::dim(tc, c, w)] = from_f32<T>(acc_v[i][c * DMV::kW + w]);
  }
}

template <int D, typename T>
int launch_prep(const void* out, const void* dout, void* drow, int B, int S, int H,
                cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  const int rows_per_block = kThreads / PrepLanes<D>::kN;
  flash_bwd_prep<D, T><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                         kThreads, 0, stream>>>(static_cast<const T*>(out),
                                                static_cast<const T*>(dout),
                                                static_cast<float*>(drow), S, H, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int Tk,
               int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using T = float;
  constexpr int dq_bytes = dq_smem_floats<DK, DV>() * 4;
  constexpr int dkv_bytes = dkv_smem_floats<DK, DV>() * 4;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<DK, DV, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkv<DK, DV, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  float* drowf = static_cast<float*>(drow);
  int err = launch_prep<DV, T>(out, dout, drow, B, S, H, stream);
  if (err != 0) return err;
  flash_bwd_dq<DK, DV, T><<<dim3((S + kBM - 1) / kBM, H, B), kThreads, dq_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dq), S, Tk, H, G, causal, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dkv<DK, DV, T><<<dim3((Tk + kBN - 1) / kBN, G, B), kThreads, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lsef, drowf, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, G, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bfloat16: wgmma + TMA

constexpr int kStagesTC = 2;
constexpr int kWarpgroup = 128;
constexpr int kThreadsTC = kWarpgroup + 32;  // a consumer warpgroup + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of both passes: a resident pair of tiles (one DK wide, one
// DV wide), then kStagesTC stages of a streamed pair; the dK/dV pass then
// stages each q tile's lse * log2(e) and D ([stage][2][64] floats); then the
// mbarriers.  Pair i (0 resident, 1 + s stage s) holds its DK-wide tile
// (dQ pass: Q, K; dK/dV pass: K, Q) and then its DV-wide one (dO, V; V, dO).
template <int DK, int DV>
struct BwdTiles {
  static constexpr int kWide = Swizzle<DK>::kTileBytes;
  static constexpr int kPair = kWide + Swizzle<DV>::kTileBytes;
  static constexpr int kTilesBytes = (1 + kStagesTC) * kPair;
  static constexpr int kVecBytes = kStagesTC * 2 * kTileRows * 4;
  static constexpr int kBarBytes = 8 * (2 * kStagesTC + 1);
  static constexpr int kSmemDq = kTilesBytes + kBarBytes + 1024;  // + alignment slack
  static constexpr int kSmemDkv = kTilesBytes + kVecBytes + kBarBytes + 1024;
  __device__ static __forceinline__ uint32_t wide(uint32_t base, int pair) {
    return base + pair * kPair;
  }
  __device__ static __forceinline__ uint32_t narrow(uint32_t base, int pair) {
    return base + pair * kPair + kWide;
  }
};
static_assert(BwdTiles<192, 128>::kSmemDkv <= 232448, "MLA's dK/dV tiles");

// The dK/dV pass at MLA's widths (DK + DV > 256: dK, dV, S^T and dP^T would
// be 224 accumulator floats a thread in one warpgroup): two consumer
// warpgroups, one per accumulator, each computing S^T itself.  A warp
// scheduler holds 16384 registers, so a CTA of 9 warps (two warpgroups and
// a producer warp) would get 168 a thread; the producer is a warpgroup
// instead, which gives its registers to the consumers (`setmaxnreg`: 40 a
// thread for it, 232 for each consumer, so a scheduler's three warps hold
// 504 x 32 of its 16384), and only its first warp works.
constexpr int kSplitThreads = 3 * kWarpgroup;

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

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
// Without kDs only P (the dV warpgroup of the split pass): dp is not touched.
template <bool kDs>
__device__ __forceinline__ void grads_by_col(float (&s)[kTileRows / 2], float (&dp)[kTileRows / 2],
                                             const float* vec, int key0, int q0, int c0, bool edge,
                                             int S, int Tk, int causal, int window, float scale,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < kTileRows / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + c0);
    float2 d2;
    if constexpr (kDs) d2 = *reinterpret_cast<const float2*>(vec + kTileRows + 8 * j + c0);
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
      if constexpr (kDs) dp[x] = p * (dp[x] - (e % 2 ? d2.y : d2.x)) * scale;
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

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// bf16 dQ: one CTA per (q tile, head, batch); Q and dO resident, K and V
// streamed.  S = Q K^T, dP = dO V^T, dQ += dS K.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsTC, DK > 128 ? 1 : 2)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                      const float* __restrict__ drow, __nv_bfloat16* __restrict__ dq, int S,
                      int Tk, int H, int G, int causal, int window, float scale,
                      float scale_log2) {
  using BT = BwdTiles<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t q_s = BT::wide(base, 0), do_s = BT::narrow(base, 0);
  auto k_tile = [&](int s) { return BT::wide(base, 1 + s); };
  auto v_tile = [&](int s) { return BT::narrow(base, 1 + s); };
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
      mbar_init(empty_bar(s), kWarpgroup);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWarpgroup) {  // the producer warp: lane 0 issues every load
    if (tid == kWarpgroup && n_tiles > 0) {
      mbar_expect_tx(q_bar, BT::kPair);
      tma_tile<DK>(q_s, &qmap, q_bar, h, q0, b);
      tma_tile<DV>(do_s, &domap, q_bar, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStagesTC;
        const int k0 = (t_lo + i) * kTileRows;
        mbar_wait(empty_bar(s), ((i / kStagesTC) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), BT::kPair);
        tma_tile<DK>(k_tile(s), &kmap, full_bar(s), g, k0, b);
        tma_tile<DV>(v_tile(s), &vmap, full_bar(s), g, k0, b);
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
  float acc[DK / 2];
#pragma unroll
  for (int x = 0; x < DK / 2; ++x) acc[x] = 0.f;
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
      issue_scores<DK>(sc, q_s, k_tile(s));
      issue_scores<DV>(dp, do_s, v_tile(s));
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
      issue_pv<DK>(acc, da, k_tile(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty_bar(s));
    }
  }
  store_rows<DK>(dq, acc, b, q0 + r0, S, H, h, c0);
}

// bf16 dK, dV: one CTA per (key tile, group, batch); K and V resident, the
// group's heads' Q and dO tiles streamed.  S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, D > 64 ? 1 : 2)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                       const float* __restrict__ drow, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int Tk, int H, int G, int causal,
                       int window, float scale, float scale_log2) {
  using BT = BwdTiles<D, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = BT::wide(base, 0), v_s = BT::narrow(base, 0);
  auto q_tile = [&](int s) { return BT::wide(base, 1 + s); };
  auto do_tile = [&](int s) { return BT::narrow(base, 1 + s); };
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
      mbar_init(empty_bar(s), kWarpgroup);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWarpgroup) {  // the producer warp
    const int lane = tid - kWarpgroup;
    if (n_steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, BT::kPair);
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
        mbar_expect_tx(full_bar(s), BT::kPair);
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
      grads_by_col<true>(st, dpt, vecs + s * 2 * kTileRows, k0 + r0, q0, c0, edge, S, Tk, causal,
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

// bf16 dK, dV at MLA's widths: the square pass's loop split over two
// consumer warpgroups (`kSplitThreads`, see the note at the top): the dV
// warpgroup computes S^T, P^T and dV += P^T dO, the dK warpgroup S^T, dP^T,
// dS^T and dK += dS^T Q.  The producer warpgroup's first warp loads as the
// square pass's producer warp does.
template <int DK, int DV>
__global__ void __launch_bounds__(kSplitThreads, 1)
    flash_bwd_dkv_split_bf16(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap domap,
                             const float* __restrict__ lse, const float* __restrict__ drow,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                             int Tk, int H, int G, int causal, int window, float scale,
                             float scale_log2) {
  using BT = BwdTiles<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = BT::wide(base, 0), v_s = BT::narrow(base, 0);
  auto q_tile = [&](int s) { return BT::wide(base, 1 + s); };
  auto do_tile = [&](int s) { return BT::narrow(base, 1 + s); };
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
      mbar_init(empty_bar(s), 2 * kWarpgroup);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kWarpgroup) {  // the producer warpgroup: its first warp loads
    const int lane = tid - 2 * kWarpgroup;
    setmaxnreg_dec<40>();
    if (lane >= 32 || n_steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, BT::kPair);
      tma_tile<DK>(k_s, &kmap, kv_bar, g, k0, b);
      tma_tile<DV>(v_s, &vmap, kv_bar, g, k0, b);
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
        mbar_expect_tx(full_bar(s), BT::kPair);
        tma_tile<DK>(q_tile(s), &qmap, full_bar(s), h, q0, b);
        tma_tile<DV>(do_tile(s), &domap, full_bar(s), h, q0, b);
      } else {
        mbar_arrive(full_bar(s));
      }
    }
    return;
  }

  setmaxnreg_inc<232>();  // the registers the producer gave away
  const int wg = tid / kWarpgroup, lt = tid % kWarpgroup;  // wg 0: dV, 1: dK
  const int r0 = (lt / 32) * 16 + (lt % 32) / 4;  // this thread's keys: r0 and r0 + 8
  const int c0 = 2 * (lt % 4);
  // Both warpgroups' walk over the ring: body(stage, q0, edge) per (head, q tile).
  auto walk = [&](auto&& body) {
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStagesTC;
      const int q0 = (t_lo + i % n_q) * kTileRows;
      mbar_wait(full_bar(s), (i / kStagesTC) & 1);
      body(s, q0,
           q0 + kTileRows > S || k0 + kTileRows > Tk || (causal && k0 + kTileRows - 1 > q0) ||
               (window > 0 && q0 + kTileRows - 1 - k0 >= window));
      mbar_arrive(empty_bar(s));
    }
  };
  if (wg == 0) {  // the dV warpgroup: S^T, P^T and dV
    float dv_acc[DV / 2];
    zero(dv_acc);
    if (n_steps > 0) {
      float st[kTileRows / 2];
      zero(st);
      uint32_t pa[kTileRows / 16][4];
      walk([&](int s, int q0, bool edge) {
        fence_regs(st);
        wgmma_fence();
        issue_scores<DK>(st, k_s, q_tile(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        grads_by_col<false>(st, st, vecs + s * 2 * kTileRows, k0 + r0, q0, c0, edge, S, Tk,
                            causal, window, scale, scale_log2);
        pack_p(st, pa);
        fence_regs(dv_acc);
        wgmma_fence();
        issue_pv<DV>(dv_acc, pa, do_tile(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(pa);
      });
    }
    store_rows<DV>(dv, dv_acc, b, k0 + r0, Tk, G, g, c0);
  } else {  // the dK warpgroup: S^T, dP^T, dS^T and dK
    float dk_acc[DK / 2];
    zero(dk_acc);
    if (n_steps > 0) {
      float st[kTileRows / 2], dpt[kTileRows / 2];
      zero(st);
      zero(dpt);
      uint32_t da[kTileRows / 16][4];
      walk([&](int s, int q0, bool edge) {
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        issue_scores<DK>(st, k_s, q_tile(s));
        issue_scores<DV>(dpt, v_s, do_tile(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        grads_by_col<true>(st, dpt, vecs + s * 2 * kTileRows, k0 + r0, q0, c0, edge, S, Tk,
                           causal, window, scale, scale_log2);
        pack_p(dpt, da);
        fence_regs(dk_acc);
        wgmma_fence();
        issue_pv<DK>(dk_acc, da, q_tile(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(da);
      });
    }
    store_rows<DK>(dk, dk_acc, b, k0 + r0, Tk, G, g, c0);
  }
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, void* drow, void* dq, void* dk, void* dv, int B, int S, int Tk,
                int H, int G, int causal, int window, float scale, cudaStream_t stream) {
  using BT = BwdTiles<DK, DV>;
  CUtensorMap qm, km, vm, dom;
  if (!encode_tile_map<DK>(&qm, q, B, S, H) || !encode_tile_map<DV>(&dom, dout, B, S, H) ||
      !encode_tile_map<DK>(&km, k, B, Tk, G) || !encode_tile_map<DV>(&vm, v, B, Tk, G))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, BT::kSmemDq);
    if (err == cudaSuccess) {
      if constexpr (DK == DV)
        err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<DK>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, BT::kSmemDkv);
      else
        err = cudaFuncSetAttribute(flash_bwd_dkv_split_bf16<DK, DV>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, BT::kSmemDkv);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const float* lsef = static_cast<const float*>(lse);
  const float* drowf = static_cast<const float*>(drow);
  int err = launch_prep<DV, __nv_bfloat16>(out, dout, drow, B, S, H, stream);
  if (err != 0) return err;
  flash_bwd_dq_bf16<DK, DV><<<dim3((S + kTileRows - 1) / kTileRows, H, B), kThreadsTC,
                              BT::kSmemDq, stream>>>(qm, km, vm, dom, lsef, drowf,
                                                     static_cast<__nv_bfloat16*>(dq), S, Tk, H, G,
                                                     causal, window, scale, scale * kLog2e);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((Tk + kTileRows - 1) / kTileRows, G, B);
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(dv);
  if constexpr (DK == DV)
    flash_bwd_dkv_bf16<DK><<<grid, kThreadsTC, BT::kSmemDkv, stream>>>(
        qm, km, vm, dom, lsef, drowf, dkb, dvb, S, Tk, H, G, causal, window, scale,
        scale * kLog2e);
  else
    flash_bwd_dkv_split_bf16<DK, DV><<<grid, kSplitThreads, BT::kSmemDkv, stream>>>(
        qm, km, vm, dom, lsef, drowf, dkb, dvb, S, Tk, H, G, causal, window, scale,
        scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widths the kernels are built for: (D, D) for D in 16, 32, 64, 80, 128,
// and MLA's (192, 128).  D is the width of q and k, Dv that of v, out and dout.
#define BWD_ARGS q, k, v, out, dout, lse, drow, dq, dk, dv, B, S, T, H, G, causal, window, scale, st
#define BWD_DISPATCH(fn)                                                    \
  if (B == 0 || S == 0 || T == 0) return 0;                                 \
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue); \
  const auto st = static_cast<cudaStream_t>(stream);                        \
  if (D == Dv) {                                                            \
    switch (D) {                                                            \
      case 16:                                                              \
        return fn<16, 16>(BWD_ARGS);                                        \
      case 32:                                                              \
        return fn<32, 32>(BWD_ARGS);                                        \
      case 64:                                                              \
        return fn<64, 64>(BWD_ARGS);                                        \
      case 80:                                                              \
        return fn<80, 80>(BWD_ARGS);                                        \
      case 128:                                                             \
        return fn<128, 128>(BWD_ARGS);                                      \
      default:                                                              \
        return static_cast<int>(cudaErrorInvalidValue);                     \
    }                                                                       \
  }                                                                         \
  if (D == 192 && Dv == 128) return fn<192, 128>(BWD_ARGS);                 \
  return static_cast<int>(cudaErrorInvalidValue);

// float32 inputs: the CUDA-core kernels.  `drow` is [B, H, S] float32 scratch.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* drow, void* dq,
                                       void* dk, void* dv, int B, int S, int T, int H, int G, int D,
                                       int Dv, int causal, int window, float scale, void* stream) {
  BWD_DISPATCH(launch_f32)
}

// bfloat16 inputs: the wgmma + TMA kernels (float32 accumulation, bfloat16 outputs).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* drow, void* dq, void* dk, void* dv, int B, int S,
                                        int T, int H, int G, int D, int Dv, int causal, int window,
                                        float scale, void* stream) {
  BWD_DISPATCH(launch_bf16)
}
