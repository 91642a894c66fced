// One-shot drum accumulation for Hopper (sm_90a): K1.
//
// Replaces groove_tpu/ops/pallas_drums.py `_kernel` (pallas_call in
// `_accumulate_oneshots_jit`). That kernel walks the timeline in 65536-frame
// chunks on a sequential grid, carries rows that spill past a chunk edge in
// a VMEM halo, DMAs each hit's sample row and, because Mosaic wants
// 128-aligned lane offsets, pre-shifts rows by 64 frames. None of that is
// semantics. What is: every output frame t (both channels) sums, in exactly
// the order the host's prepare_hits lays the hits out (chunk by chunk,
// stable within a chunk), every hit that covers it:
//     acc = acc + row[t - on] * (vel / 127)
// the same products, in the same order, as the reference's
// `row * mask * (vel / 127)` then `acc + row` (for masked-out frames the
// reference adds a zero, which leaves acc unchanged). No float atomics: the
// sum order is fixed, so renders are reproducible, and with -fmad=false the
// result is bitwise the plain twin's (ops/drums.py).
//
// What bounds it on the H100: the bytes of y (8 a frame) and of the table,
// each moved once. A frame has a handful of covering hits; their row reads
// are coalesced and mostly hit L2. What the kernel must not do is test
// every hit of the chunks near a frame from every frame's thread (a
// 2-second measure has 17 hits and a crash row spans two chunks, so 25-40
// tests a frame): that bound the first design by instruction rate. So it
// is output-stationary on frame tiles, with a cull of the hit list per
// tile:
//   tile       a thread block owns kTile = 2048 consecutive frames: 256
//              threads, each holding kGroups = 2 groups of 4 consecutive
//              frames 1,024 frames apart, so a warp's row reads and its
//              stores of both channels are coalesced float4. 2048 fills the
//              132 SMs at both sizes the renders run: 216 blocks at 10 s
//              (441,024 frames; 4096 would give 108) and 3,876 at 3
//              minutes. A smaller tile costs a block one more cull of the
//              same few hits.
//   cull       the block walks the hits of the chunks that can reach the
//              tile in layout order: from the chunk holding
//              tile_start - row_len - 128 (a hit starts at most 64 frames
//              after its chunk-local start and covers fewer than row_len
//              frames) to the chunk holding the tile's last frame. One hit
//              per thread, coalesced loads of starts, shifts, limits, slots
//              and vels; a hit passes when on < tile_end and
//              on + limit > tile_start. The hits that pass are compacted
//              into a shared-memory list in layout order: __ballot_sync and
//              __popc inside a warp, an exclusive scan of the eight warp
//              counts across the block. An entry is the row's offset
//              (slot * 2 * row_len), on - tile_start, limit and
//              vel / 127.0f (the scale of the first design, the twin's
//              bits).
//   batches    the list holds kList entries. When a round of passing hits
//              would overflow it, the block accumulates the batch it holds
//              and starts the next: order is kept and any density is exact.
//              No hit is dropped.
//   accumulate each thread runs over the list once. on is a multiple of 64
//              and row_len of 128, so k = t - on is a multiple of 4 at a
//              group's first frame and a channel's four samples are one
//              16-byte load through the read-only path, masked at the hit's
//              end. A masked frame adds nothing: adding zero would turn a
//              -0.0 accumulator into +0.0.
// Preconditions (ops/drums.py checks what it can without touching the
// card): starts 128-aligned as prepare_hits lays them, chunk a multiple of
// 64, row_len of 4, the table 16-byte aligned with fewer than 2^31 floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;
constexpr int kGroupStride = 4 * kThreads;  // frames between a thread's groups
constexpr int kTile = kGroups * kGroupStride;
constexpr int kList = 256;
static_assert(kTile == 2048, "the tile of the header comment");
static_assert(kList >= kThreads, "a round of passing hits fits a new batch");

// One channel's four frames of a group: acc + row * scale for the `left`
// (>= 1) frames still inside the hit.
__device__ __forceinline__ void add4(float4& acc, float4 r, float scale,
                                     int left) {
  acc.x = acc.x + r.x * scale;
  if (left > 1) acc.y = acc.y + r.y * scale;
  if (left > 2) acc.z = acc.z + r.z * scale;
  if (left > 3) acc.w = acc.w + r.w * scale;
}

// The batch `list[0 .. count)` (row offset, on - tile_start, limit, scale
// bits) added, in order, to this thread's frames.
__device__ __forceinline__ void accumulate(const float* __restrict__ table,
                                           int row_len, const int4* list,
                                           int count,
                                           float4 (&acc)[2][kGroups]) {
  // unrolled so that the row loads of the next entries are in flight
  // while this entry's adds wait on its own
#pragma unroll 4
  for (int e = 0; e < count; ++e) {
    const int4 h = list[e];
    const float scale = __int_as_float(h.w);
    const float* row = table + h.x;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int k = g * kGroupStride + 4 * (int)threadIdx.x - h.y;
      if (k < 0 || k >= h.z) continue;
      const float4 r0 = __ldg(reinterpret_cast<const float4*>(row + k));
      const float4 r1 =
          __ldg(reinterpret_cast<const float4*>(row + row_len + k));
      add4(acc[0][g], r0, scale, h.z - k);
      add4(acc[1][g], r1, scale, h.z - k);
    }
  }
}

// table: [slots, 2, row_len]; counts: [nchunks]; slots, starts, shifts,
// limits, vels: [nchunks, M] (hit i of chunk c at c * M + i; starts are
// chunk-local and shifts add 64 frames); y: [2, n]. One block per tile.
__global__ void __launch_bounds__(kThreads)
    drums_kernel(const float* __restrict__ table, int row_len,
                 const int* __restrict__ counts, const int* __restrict__ slots,
                 const int* __restrict__ starts,
                 const int* __restrict__ shifts,
                 const int* __restrict__ limits,
                 const float* __restrict__ vels, int nchunks, int M,
                 int chunk, float* __restrict__ y, int64_t n) {
  __shared__ int4 list[kList];
  __shared__ int warp_count[kWarps];
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  const int64_t t1 = min(t0 + kTile, n);
  const int64_t lo = t0 - row_len - 128;
  const int c_lo = lo <= 0 ? 0 : (int)(lo / chunk);
  const int c_hi = (int)min((int64_t)(nchunks - 1), (t1 - 1) / chunk);
  int total = 0;  // candidate hits, chunks c_lo .. c_hi
  for (int c = c_lo; c <= c_hi; ++c) total += __ldg(counts + c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 acc[2][kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    acc[0][g] = acc[1][g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int fill = 0;  // entries of the batch in the list (the same in every thread)
  for (int base = 0; base < total; base += kThreads) {
    bool keep = false;
    int4 entry = make_int4(0, 0, 0, 0);
    int f = base + (int)threadIdx.x;
    if (f < total) {
      int c = c_lo;
      for (int cnt; f >= (cnt = __ldg(counts + c)); ++c) f -= cnt;
      const int64_t h = (int64_t)c * M + f;
      const int64_t on =
          (int64_t)c * chunk + starts[h] + 64 * (int64_t)shifts[h];
      const int limit = min(limits[h], row_len);
      keep = on < t1 && on + limit > t0;
      if (keep)
        entry = make_int4(slots[h] * 2 * row_len, (int)(on - t0), limit,
                          __float_as_int(vels[h] / 127.0f));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = warp_count[w];
      before += w < warp ? cw : 0;
      round += cw;
    }
    if (fill + round > kList) {
      accumulate(table, row_len, list, fill, acc);
      __syncthreads();
      fill = 0;
    }
    if (keep)
      list[fill + before + __popc(ballot & ((1u << lane) - 1u))] = entry;
    fill += round;
    __syncthreads();
  }
  accumulate(table, row_len, list, fill, acc);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t t = t0 + g * kGroupStride + 4 * (int64_t)threadIdx.x;
    if (t >= n) continue;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      float* yc = y + ch * n + t;
      const float4 v = acc[ch][g];
      if (t + 4 <= n && (reinterpret_cast<uintptr_t>(yc) & 15) == 0) {
        *reinterpret_cast<float4*>(yc) = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t + u < n) yc[u] = w[u];
      }
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue, launching nothing, when chunk or row_len breaks
// the alignment the float4 row reads rely on).
extern "C" int drums_accumulate(const float* table, int row_len,
                                const int* counts, const int* slots,
                                const int* starts, const int* shifts,
                                const int* limits, const float* vels,
                                int nchunks, int M, int chunk, float* y,
                                int64_t n, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (chunk <= 0 || chunk % 64 != 0 || row_len <= 0 || row_len % 4 != 0 ||
      nchunks <= 0 || (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kTile - 1) / kTile);
  if (grid > 0) {
    drums_kernel<<<grid, kThreads, 0, stream>>>(
        table, row_len, counts, slots, starts, shifts, limits, vels, nchunks,
        M, chunk, y, n);
  }
  return (int)cudaGetLastError();
}
