// Staging and span chaining for Hopper (sm_90a), shared by scan1.cu (the
// offline first-order scan), scan_stream.cu (S1) and comb_stream.cu (S2).
//
// Staging: a kernel moves a tile of its input into shared memory by cp.async
// (tdf2::cp_async16 / cp_async4: copies that every thread issues, committed
// as groups and waited for with cp_async_wait) or by the tensor memory
// accelerator (TMA): one thread asks for a whole contiguous range
// (bulk_load, 16-byte aligned) or a box of a tensor map (tma_load3), and
// the bytes arrive on an mbarrier (expect_bytes, tdf2::mbar_wait). A copy
// that every thread issues holds a slot of the SM's load pipe until its data
// is back, so such copies keep only some tens of lines in flight an SM
// (2-20 GB/s an SM, measured on an H100); a TMA copy keeps its whole
// range in flight. scan1's y goes back by TMA too (tma_store3), in groups
// (bulk_commit) that bulk_wait waits for.
//
// Span chaining: a call's thread blocks each own a span of a lane (a row, or
// a delay lane) and hand one value from span to span in lane order. A block
// takes an atomic ticket when it starts, so the block with the previous
// ticket has started before it (it runs, or is done): a block waits only on
// blocks that hold an SM, whatever order the hardware starts them in. The
// value travels with its flag in one 64-bit word (value in the high 32 bits,
// flag in the low), stored and polled relaxed at gpu scope: no other write
// has to be ordered before it, so neither side waits for its copies in
// flight, as a release or acquire fence would. The call zeroes the ticket
// and the words first (a memset on its stream, capturable in a CUDA graph),
// so calls back to back on one stream never see each other's words.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is found at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "tdf2.cuh"

// Stage timings for kernels/carried_times.py --stages, which builds
// scan_stream.cu and comb_stream.cu each alone with STAGE_STAMPS and sets
// the stamp array: STAGE_TIME(i) has thread 0 write the global timer (ns)
// to slot i, STAGE_SUM(i, v) adds thread 0's SM cycles since STAGE_TICK(v)
// (STAGE_SUM_BY: the cycles of the threads where `who` holds).
// Nothing in the kernels' build.
#ifdef STAGE_STAMPS
__device__ long long* g_stage_stamps;
extern "C" int stage_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stage_stamps, &p, sizeof(p));
}
#define STAGE_TIME(i)                                         \
  do {                                                        \
    if (threadIdx.x == 0) {                                   \
      long long ns_;                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_)); \
      g_stage_stamps[i] = ns_;                                \
    }                                                         \
  } while (0)
#define STAGE_TICK(v) const long long v = clock64()
#define STAGE_SUM_BY(who, i, v)                       \
  do {                                                \
    if (who) g_stage_stamps[i] += clock64() - (v);    \
  } while (0)
#else
#define STAGE_TIME(i) \
  do {                \
  } while (0)
#define STAGE_TICK(v) \
  do {                \
  } while (0)
#define STAGE_SUM_BY(who, i, v) \
  do {                          \
  } while (0)
#endif
#define STAGE_SUM(i, v) STAGE_SUM_BY(threadIdx.x == 0, i, v)

namespace stage {

constexpr int kMaxDevices = 64;

// The call's ticket counter and one word per (lane, span): the value out of
// the span and its flag, zero until published.
struct Chain {
  unsigned* ticket;
  unsigned long long* words;
};

// Zero `words` 64-bit words of scratch on `st` (the ticket in the first) and
// return the chain over them.
inline cudaError_t chain_of(void* scratch, int64_t words, cudaStream_t st,
                            Chain* chain) {
  unsigned long long* w = static_cast<unsigned long long*>(scratch);
  *chain = {reinterpret_cast<unsigned*>(w), w + 1};
  return cudaMemsetAsync(scratch, 0,
                         (size_t)words * sizeof(unsigned long long), st);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

namespace {

__device__ __forceinline__ void publish(unsigned long long* w, float v) {
  const unsigned long long bits =
      ((unsigned long long)__float_as_uint(v) << 32) | 1ull;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(w), "l"(bits)
               : "memory");
}

__device__ __forceinline__ float await_carry(const unsigned long long* w) {
  unsigned long long v;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(w)
                 : "memory");
  } while ((unsigned)v == 0u);
  return __uint_as_float((unsigned)(v >> 32));
}

// The block's ticket, taken by thread 0 and shared through `slot`.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket,
                                                unsigned* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1u);
  __syncthreads();
  return *slot;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0-4) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// The mbarriers' initialisation, made visible to the copy engine; shared
// memory that threads wrote, made visible to it before a store reads it.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on `bar` and expect `bytes` more of copies on its current phase.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tdf2::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tdf2::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tdf2::smem_addr(bar))
      : "memory");
}

// A box of a 3-D tensor map at coordinates (c0, c1, c2) into dst, counted
// on bar; and from src back to the map's tensor, in the current bulk group.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* m,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tdf2::smem_addr(dst)),
      "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(tdf2::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* m, int c0,
                                           int c1, int c2, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3}], [%4];\n" ::"l"(m),
      "r"(c0), "r"(c1), "r"(c2), "r"(tdf2::smem_addr(src))
      : "memory");
}

// Close the thread's current bulk group (an empty one too).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the bulk groups issued so far have read shared memory (kRead), or
// are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Allow `n` kernels `bytes` of dynamic shared memory on the current device,
// once per device (done: the caller's flags).
inline int allow_smem(bool (&done)[kMaxDevices], const void* const* kernels,
                      int n, int bytes) {
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  for (int i = 0; i < n; ++i) {
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
  }
  done[dev] = true;
  return 0;
}

}  // namespace
}  // namespace stage
