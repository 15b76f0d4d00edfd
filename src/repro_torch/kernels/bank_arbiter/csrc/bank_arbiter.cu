// Per-bank QoS arbitration (the paper's §II-C comparator tree) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `bank_arbiter` of the reference package
// (src/repro/kernels/bank_arbiter/kernel.py, body `_arbiter_kernel`).  For each
// batch lane and each bank it finds the eligible slot with the smallest packed
// (QoS level, FCFS age, round-robin) key, the lowest slot winning a tie, and
// reports S for a bank with no eligible slot.
//
// Design.  The Pallas kernel folds every slot row once per 128-bank block in
// VMEM.  Here it is one pass over the slots: keys and slot ids are both below
// 2^30 (`_age_cap` in core/simulator.py, KEY_FILLER in ref.py), so
// `(key << 32) | slot` packs the lexicographic (key, slot) order into one
// unsigned 64-bit value, and the per-bank minimum is a shared-memory
// `atomicMin` on NB such values.  The minimum does not depend on the order of
// the atomics, so the result is deterministic.  The eligibility mask is
// applied inside the loop; ineligible slots never touch shared memory.  The
// init value (KEY_FILLER << 32) | S loses to any eligible slot, including one
// whose key equals KEY_FILLER, as in both reference versions.
//
// Bound.  One block per batch lane reads S * (4 + sizeof(BankT) + 1) bytes and
// writes NB * 4: about 57 KB at the paper's S = 8192, NB = 256.  At 3.35 TB/s
// that is ~17 ns, far below a kernel launch, so the kernel is bound by launch
// latency.  Spreading one lane over several SMs and capturing the cycle loop in
// a CUDA graph are left for later work.
//
// Interface: plain C, loaded with ctypes.  The wrapper (ops.py) checks dtypes,
// shapes, contiguity and the shared-memory size, allocates `win`, and raises
// on a non-zero return, which is the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kKeyFiller = 1ull << 30;
constexpr int kThreads = 512;

template <typename BankT>
__global__ void bank_arbiter_kernel(const int32_t* __restrict__ key,
                                    const BankT* __restrict__ bank,
                                    const uint8_t* __restrict__ elig,
                                    int32_t* __restrict__ win, int S, int NB) {
  extern __shared__ unsigned long long best[];
  const size_t lane = blockIdx.x;
  const unsigned long long init = (kKeyFiller << 32) | static_cast<unsigned int>(S);
  for (int b = threadIdx.x; b < NB; b += blockDim.x) best[b] = init;
  __syncthreads();

  const int32_t* k = key + lane * S;
  const BankT* bk = bank + lane * S;
  const uint8_t* e = elig + lane * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    if (e[s]) {
      const unsigned long long packed =
          (static_cast<unsigned long long>(static_cast<uint32_t>(k[s])) << 32) |
          static_cast<unsigned int>(s);
      atomicMin(&best[static_cast<int>(bk[s])], packed);
    }
  }
  __syncthreads();

  int32_t* w = win + lane * NB;
  for (int b = threadIdx.x; b < NB; b += blockDim.x) {
    w[b] = static_cast<int32_t>(best[b] & 0xFFFFFFFFull);
  }
}

template <typename BankT>
int launch(const void* key, const void* bank, const void* elig, void* win, int B, int S, int NB,
           void* stream) {
  const size_t smem = static_cast<size_t>(NB) * sizeof(unsigned long long);
  bank_arbiter_kernel<BankT><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const BankT*>(bank),
      static_cast<const uint8_t*>(elig), static_cast<int32_t*>(win), S, NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bank_arbiter_i16(const void* key, const void* bank, const void* elig, void* win,
                                int B, int S, int NB, void* stream) {
  return launch<int16_t>(key, bank, elig, win, B, S, NB, stream);
}

extern "C" int bank_arbiter_i32(const void* key, const void* bank, const void* elig, void* win,
                                int B, int S, int NB, void* stream) {
  return launch<int32_t>(key, bank, elig, win, B, S, NB, stream);
}
