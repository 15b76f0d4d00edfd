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
// atoms), mask by the true T, the causal diagonal and the window, and run the
// online softmax in float32 on the accumulator fragments: each row belongs to
// the four lanes of a quad, so its max and sum take two shuffles.  P is
// rounded to bf16 in registers and fed to the second `wgmma` as its register
// A operand; V is read through a transposed (MN-major) descriptor.  The two
// products are software-pipelined: the softmax of tile i + 1 runs while the
// tensor cores compute tile i's P V.  KV tiles that the causal or window mask
// rules out are never loaded, and the longest causal q tiles are launched
// first.
//
// float32: the CUDA cores (the tensor cores offer only TF32 for float32, which
// keeps about three digits; the float32 contract is 2e-5).  One block per
// (64-row q tile, head, batch) loops over its KV tiles through shared memory;
// four threads share a query row, each owning D / 4 of its dims in
// interleaved float4 groups, and the row's score is two shuffles.
//
// Bound.  4 * D FLOP per unmasked (row, key) pair: ~4.3 GFLOP per layer at
// S = 1024, H = 32, D = 64 causal, 4.4 us at the card's 989 TFLOP/s bf16
// tensor-core rate; reading Q, K, V and writing O once is ~5 us at 3.35 TB/s.
//
// Interface: plain C, loaded with ctypes.  q/out [B, S, H, D] and k/v
// [B, T, G, D], contiguous.  The wrapper (ops.py) checks shapes, dtypes,
// devices and alignment; each function returns the cudaError_t of its launch.
// The bf16 route encodes its tensor maps on the host at every call with
// cuTensorMapEncodeTiled from libcuda, found through dlopen and dlsym so that
// the library needs no link against libcuda.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>

namespace {

// ------------------------------------------------------------ float32: CUDA cores

constexpr int kRows = 64;  // query rows per CUDA block
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kRows * kThreadsPerRow;

// Thread c of a row owns dims 16 * j + 4 * c + e, j < D / 16, e < 4.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int S, int Tk, int H,
                  int G, int causal, int window, float scale) {
  constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile: 32 KB of K + V in shared memory
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
      qr[j][e] = qi < S ? q[((static_cast<long long>(b) * S + qi) * H + h) * D + d] * scale : 0.f;
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
        kval = k[off];
        vval = v[off];
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
      out[((static_cast<long long>(b) * S + qi) * H + h) * D + d] = acc[j][e] * inv;
    }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
               int G, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, Tk, H, G, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bfloat16: wgmma + TMA

constexpr int kBM = 64;  // query rows per CTA: one wgmma M
constexpr int kBN = 64;  // keys per KV tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreadsTC = kConsumers + 32;    // + the producer warp

template <int D>
struct Tile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;  // bytes per row of a swizzle atom
  static constexpr int kAtom = kSwizzle / 2;              // bf16 per atom row
  static constexpr int kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;  // wgmma enum
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving an access to a wgmma operand across the
// wait, or from giving its registers to other values while wgmma reads them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D(64 x N, f32) (+)= A(64 x 16) * B(16 x N): A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// The same with A in registers and B MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Issues S = Q K^T for one KV tile: D / 16 steps of 16 along the head dim
// (32 bytes into an atom row).  Q and K are K-major.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[kBN / 2], uint32_t q_s, uint32_t k_tile) {
  using TS = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = (kk * 16) / TS::kAtom, within = (kk * 16) % TS::kAtom * 2;
    const uint64_t da = wgmma_desc(q_s + atom * kBM * TS::kSwizzle + within, 0,
                                   8 * TS::kSwizzle, TS::kLayout);
    const uint64_t db = wgmma_desc(k_tile + atom * kBN * TS::kSwizzle + within, 0,
                                   8 * TS::kSwizzle, TS::kLayout);
    wgmma_ss<kBN>(sc, da, db, kk > 0);
  }
}

// Issues O += P V for one KV tile: V [keys, D] is MN-major for this product;
// 16 keys per step, P from registers.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v_tile) {
  using TS = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = wgmma_desc(v_tile + kk * 16 * TS::kSwizzle, kBN * TS::kSwizzle,
                                   8 * TS::kSwizzle, TS::kLayout);
    wgmma_rs<D>(o, pa[kk], db, 1);
  }
}

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

// P rounded to bf16 as the register A operand: k step kk covers key columns
// 16 kk .. 16 kk + 15, i.e. accumulator chunks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// Accumulator fragment of a 64 x N wgmma tile: thread t of the warpgroup holds
// d[4 * j + e] at row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2) and column
// 8 * j + 2 * (t % 4) + e % 2.
template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   int S, int Tk, int H, int G, int causal, int window, float scale_log2) {
  using TS = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t q_s = base;
  const uint32_t kv_s = base + TS::kQBytes;  // K stages, then V stages
  const uint32_t bars = base + TS::kBarOffset;
  const uint32_t q_bar = bars + 16 * kStages;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  auto k_tile = [&](int i) { return kv_s + (i % kStages) * TS::kKVBytes; };  // KV tile i
  auto v_tile = [&](int i) { return kv_s + (kStages + i % kStages) * TS::kKVBytes; };

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
      for (int a = 0; a < D / TS::kAtom; ++a)
        tma_load(q_s + a * kBM * TS::kSwizzle, &qmap, q_bar, a * TS::kAtom, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (t_lo + i) * kBN;
        mbar_wait(empty_bar(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), 2 * TS::kKVBytes);
        for (int a = 0; a < D / TS::kAtom; ++a) {
          tma_load(k_tile(i) + a * kBN * TS::kSwizzle, &kmap, full_bar(s), a * TS::kAtom, g, k0, b);
          tma_load(v_tile(i) + a * kBN * TS::kSwizzle, &vmap, full_bar(s), a * TS::kAtom, g, k0, b);
        }
      }
    }
    return;
  }

  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (tid % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
    issue_scores<D>(sc, q_s, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m_run, l_run, alpha, q0, r0, c0, t_lo * kBN, Tk, causal, window, scale_log2);
    pack_p(sc, pa);
    for (int i = 0; i + 1 < n_tiles; ++i) {
      mbar_wait(full_bar((i + 1) % kStages), ((i + 1) / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_scores<D>(sc, q_s, k_tile(i + 1));
      wgmma_commit();
      fence_regs(sc);
      scale_rows(o, alpha);
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, v_tile(i));
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
    issue_pv<D>(o, pa, v_tile(n_tiles - 1));
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
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row >= S) continue;
    __nv_bfloat16* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * rr] * inv[rr], o[4 * j + 2 * rr + 1] * inv[rr]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// [B, rows, heads, D] bf16, boxes of `box_rows` rows x `atom` dims of one head.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int D, int box_rows,
                int atom, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row_bytes, row_bytes * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(atom), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
                int G, int causal, int window, float scale, cudaStream_t stream) {
  using TS = Tile<D>;
  if (Tk == 0) {  // no key: every row gets 0
    const size_t bytes = static_cast<size_t>(B) * S * H * D * 2;
    return static_cast<int>(cudaMemsetAsync(out, 0, bytes, stream));
  }
  const CUtensorMapSwizzle swizzle = TS::kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : TS::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, B, S, H, D, kBM, TS::kAtom, swizzle) ||
      !encode_map(&km, k, B, Tk, G, D, kBN, TS::kAtom, swizzle) ||
      !encode_map(&vm, v, B, Tk, G, D, kBN, TS::kAtom, swizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, TS::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  flash_fwd_bf16<D><<<grid, kThreadsTC, TS::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, Tk, H, G, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_DISPATCH(fn)                                                            \
  switch (D) {                                                                        \
    case 16:                                                                          \
      return fn<16>(q, k, v, out, B, S, T, H, G, causal, window, scale, s);           \
    case 32:                                                                          \
      return fn<32>(q, k, v, out, B, S, T, H, G, causal, window, scale, s);           \
    case 64:                                                                          \
      return fn<64>(q, k, v, out, B, S, T, H, G, causal, window, scale, s);           \
    case 128:                                                                         \
      return fn<128>(q, k, v, out, B, S, T, H, G, causal, window, scale, s);          \
    default:                                                                          \
      return static_cast<int>(cudaErrorInvalidValue);                                 \
  }

// float32 inputs: the CUDA-core kernel.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                       int B, int S, int T, int H, int G, int D, int causal,
                                       int window, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_f32)
}

// bfloat16 inputs: the wgmma + TMA kernel.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                        int B, int S, int T, int H, int G, int D, int causal,
                                        int window, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_bf16)
}
