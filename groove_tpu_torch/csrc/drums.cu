// One-shot drum accumulation for Hopper (sm_90a): K1.
//
// Replaces groove_tpu/ops/pallas_drums.py `_kernel` (pallas_call in
// `_accumulate_oneshots_jit`). That kernel walks the timeline in 65536-frame
// chunks on a sequential grid, carries rows that spill past a chunk edge in
// a VMEM halo, DMAs each hit's sample row and, because Mosaic wants
// 128-aligned lane offsets, pre-shifts rows by 64 frames. None of that is
// semantics. Here the kernel is output-stationary: each thread owns one
// output frame (both channels) and sums, in exactly the order the host's
// prepare_hits lays the hits out (stable by chunk), every hit that covers
// its frame:
//     acc = acc + row[t - on] * (vel / 127)
// the same products, in the same order, as the reference's
// `row * mask * (vel / 127)` then `acc + row` (for masked-out frames the
// reference adds a zero, which leaves acc unchanged). No float atomics:
// the sum order is fixed, so renders are reproducible, and with -fmad=false
// the result is bitwise the plain twin's (ops/drums.py).
//
// What bounds it on the H100: reading the table rows (each hit row is read
// by the threads that own its frames, coalesced across a warp) and the
// per-thread scan over the hits of the chunks that can reach a thread
// block's frames. Hit metadata is warp-uniform, so those loads broadcast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// table: [slots, 2, row_len]; counts: [nchunks]; slots, starts, shifts,
// limits, vels: [nchunks, M] (hit i of chunk c at c * M + i; starts are
// chunk-local and shifts add 64 frames); y: [2, n].
__global__ void drums_kernel(const float* __restrict__ table, int row_len,
                             const int* __restrict__ counts,
                             const int* __restrict__ slots,
                             const int* __restrict__ starts,
                             const int* __restrict__ shifts,
                             const int* __restrict__ limits,
                             const float* __restrict__ vels, int nchunks,
                             int M, int chunk, float* __restrict__ y,
                             int64_t n) {
  int64_t t0 = (int64_t)blockIdx.x * blockDim.x;
  int64_t t = t0 + threadIdx.x;
  // chunks whose hits can reach frames [t0, t0 + blockDim.x): a hit starts
  // at most 64 frames after its chunk-local start and covers fewer than
  // row_len frames
  int64_t lo = t0 - row_len - 128;
  int c_lo = lo <= 0 ? 0 : (int)(lo / chunk);
  int64_t hi = t0 + blockDim.x - 1;
  int c_hi = (int)min((int64_t)(nchunks - 1), hi / chunk);
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int c = c_lo; c <= c_hi; ++c) {
    int cnt = counts[c];
    for (int i = 0; i < cnt; ++i) {
      int64_t h = (int64_t)c * M + i;
      int64_t on = (int64_t)c * chunk + starts[h] + 64 * (int64_t)shifts[h];
      int64_t k = t - on;
      if (k >= 0 && k < limits[h]) {
        float scale = vels[h] / 127.0f;
        const float* row = table + (int64_t)slots[h] * 2 * row_len;
        acc0 = acc0 + row[k] * scale;
        acc1 = acc1 + row[row_len + k] * scale;
      }
    }
  }
  if (t < n) {
    y[t] = acc0;
    y[n + t] = acc1;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int drums_accumulate(const float* table, int row_len,
                                const int* counts, const int* slots,
                                const int* starts, const int* shifts,
                                const int* limits, const float* vels,
                                int nchunks, int M, int chunk, float* y,
                                int64_t n, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  if (grid > 0) {
    drums_kernel<<<grid, kThreads, 0, stream>>>(
        table, row_len, counts, slots, starts, shifts, limits, vels, nchunks,
        M, chunk, y, n);
  }
  return (int)cudaGetLastError();
}
