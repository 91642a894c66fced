// First-order scans for Hopper (sm_90a): the recurrences that the reference
// runs as XLA associative scans, not as Pallas kernels:
//   kLinear    y[k] = a[k] * y[k-1] + b[k] * x[k]    (iir.one_pole,
//              groove_tpu/ops/iir.py:630: the compressor's attack smoothing
//              and every comb and all-pass of the reverb, in block space)
//   kMaxDecay  y[k] = max(x[k], a[k] * y[k-1])        (dynamics.max_decay,
//              groove_tpu/ops/dynamics.py:46: the release-rate peak hold)
// from a zero state. Each multiply and add rounds on its own (-fmad=false;
// b * x is formed first, as the reference forms bx), in the order of the
// plain twin (ops/scan_kernels.py), which the kernel equals bit for bit.
//
// Layout: lanes x steps. A call sees x as [R, S, D] through strides (rs, ks,
// ds): R * D independent lanes of S steps. The time axis is [R, n, 1] (step
// stride 1); block space [R, nb, D] scans over nb with step stride D and D
// lanes side by side. A coefficient is a value (by value) or a stream read
// through strides of its own (0 where it broadcasts). y is contiguous
// [R, S, D].
//
// The arithmetic is the twin's decomposition, which fixes the bits: chunks
// of C steps (ops/scan_kernels.py chunk_for), each scanned from zero by one
// thread (its end value and the product P of its a: the chunk's aggregate);
// the carries folded chunk after chunk in lane order (carry = P * carry +
// end; kMaxDecay: max(end, P * carry)); then y = local + Q * carry-in
// (kMaxDecay: max(local, Q * carry-in)), Q the running product of a from
// the chunk's start, in every chunk but a lane's first. Aggregates of
// several chunks are never composed: that would re-associate the maps.
//
// What bounds it on the H100: the bytes (x read, y written, per-sample
// coefficients read) at 3.35 TB/s, and the lane's serial carry fold, 2
// dependent operations a chunk (7,752 chunks a lane at 3 minutes; a fold
// step measures 11.7 cycles, some 46 us in all). The design, one launch a
// call (after a memset of the call's ticket and flags):
//   chained   a thread block scans a span of consecutive chunks of a lane
//             (one chunk a thread), takes its place in the lane by an atomic
//             ticket (blocks that started earlier come first, so a block
//             waits only on blocks that are running or done), waits for the
//             carry that the block before it publishes (one 64-bit word,
//             flag and carry together, stored and polled relaxed), folds
//             its own chunks' aggregates in order from shared memory, one
//             thread a lane, publishes its carry-out, then scans its span
//             again from inputs read again and writes y once. Moves x and
//             the per-sample coefficients twice and y once.
//   time axis (D < 32) a block is kTimeThreads chunks of one lane. x and
//             each per-sample coefficient stream are staged through shared
//             memory in tiles of kTile steps of every chunk, a ring of 2-6
//             stages (as many as kStageBytes holds; two blocks fit an SM);
//             row j's float4 q sits at q ^ (j & 7), so a thread reading its
//             own row four steps at a time touches 8 different 16-byte bank
//             groups. Where the rows are contiguous and 16-byte aligned (the
//             wrapper's common case) one thread moves a whole tile of a
//             stream with TMA, and y back the same way: 16-byte cp.async
//             copies from every thread cost some 45 cycles of issue each
//             (4 lines) and held an SM to about 20 GB/s. Else every stream
//             moves by cp.async (4-byte copies where strided or unaligned)
//             and y by coalesced stores. A thread writes y over its x in the
//             tile. The next tiles' copies, the second scan's first ones
//             too, are in flight while a tile is scanned and while the carry
//             is awaited.
//   block space (D >= 32) a block is 32 neighbouring lanes of one row times
//             up to 16 chunks (a warp a chunk); a warp reads and writes 32
//             neighbouring floats a step, coalesced without staging, eight
//             steps' loads ahead of the arithmetic. Warp 0 folds, a lane
//             each.
// kernels/scan1_times.py times the calls of the kitchen-sink analogue and,
// with --timeline, the stages of every block (the stamps below).

#include <cuda.h>  // CUtensorMap; the encoder is found at run time

#include "stage.cuh"  // tdf2.cuh's copies, the ticket and carry words

// Timeline stamps for kernels/scan1_times.py --timeline, which builds this
// file with SCAN1_STAMPS: thread 0 of a block writes the global timer (ns)
// to stamps[ticket * 16 + k] at k = 0 start, 1 its chunks scanned, 2 carry
// in hand, 3 carry published, 4 its own work done, and sums SM cycles into
// k = 8 waiting for a tile, 9 walking tiles, 10 draining them, 11 folding,
// 12 issuing the copies of a tile.
// Nothing in the kernels' build.
#ifdef SCAN1_STAMPS
__device__ long long* g_scan1_stamps;
#define SCAN1_STAMP(t, k)                                           \
  do {                                                              \
    if (threadIdx.x == 0) {                                         \
      long long ns_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));       \
      g_scan1_stamps[(t) * 16 + (k)] = ns_;                         \
    }                                                               \
  } while (0)
#define SCAN1_TICK(v) const long long v = clock64()
#define SCAN1_SUM(t, k, v)                                          \
  do {                                                              \
    if (threadIdx.x == 0)                                           \
      g_scan1_stamps[(t) * 16 + (k)] += clock64() - (v);            \
  } while (0)
#else
#define SCAN1_STAMP(t, k) \
  do {                    \
  } while (0)
#define SCAN1_TICK(v) \
  do {                \
  } while (0)
#define SCAN1_SUM(t, k, v) \
  do {                     \
  } while (0)
#endif

namespace {

enum Mode { kLinear = 0, kMaxDecay = 1 };
enum Layout { kTime = 0, kLanes = 1 };

constexpr int kTile = 32;               // steps of a chunk's row per stage
constexpr int kRow4 = kTile / 4;        // float4s of a row
constexpr int kTimeThreads = 128;       // chunks of a time-axis block
constexpr int kLaneThreads = 512;       // 32 lanes x 16 chunks, at most
constexpr int kMaxStages = 6;
constexpr int kStreamStage = kTimeThreads * kTile * 4;  // bytes
constexpr int kStageBytes = 98304;      // a time-axis block's ring, at most
constexpr int kAlign = 1024;            // the ring's start: TMA's swizzle
constexpr int kStatic = 3 * kTimeThreads * 4 + kMaxStages * (8 + 3 * 128);
static_assert(kStageBytes == kMaxStages * kStreamStage, "x alone: 6 stages");
static_assert(2 * (kStageBytes + kAlign + kStatic + 1024) <= 232448,
              "two time-axis blocks to an SM");

// A coefficient: p == nullptr means the value v everywhere.
struct Coef {
  const float* p;
  float v;
  int64_t rs, ks, ds;
};

struct Shape {
  int64_t R, S, D, C, nc;  // rows, steps, lanes per row, chunk, chunks
  int K, spans;            // chunks a block, blocks a lane
};

template <int M>
__device__ __forceinline__ float step(float y, float ak, float bk, float xk) {
  if (M == kLinear) {
    float bx = bk * xk;
    float ay = ak * y;
    return ay + bx;
  }
  return fmaxf(xk, ak * y);
}

// y from the local value, the running product and the carry-in.
template <int M>
__device__ __forceinline__ float join(float y, float p, float carry) {
  float pc = p * carry;
  return M == kLinear ? y + pc : fmaxf(y, pc);
}

// The carry past a chunk of aggregate (p, end).
template <int M>
__device__ __forceinline__ float fold(float carry, float p, float end) {
  float pc = p * carry;
  return M == kLinear ? pc + end : fmaxf(end, pc);
}

// Fold `n` chunks' aggregates (stride apart in aggp, aggy) from the carry
// that the lane's previous span published (0 for a lane's first span),
// leave each chunk's carry-in in cin, and publish the carry out unless
// this is the lane's last span. t: the block's ticket (stamps).
// The aggregates come kBatch at a time into registers ahead of the folds
// that use them, full batches without a bound check, so that only the
// fold's two operations a chunk lie on the chain.
template <int M>
__device__ __forceinline__ void fold_span(const float* __restrict__ aggp,
                                          const float* __restrict__ aggy,
                                          float* __restrict__ cin, int n,
                                          int stride,
                                          unsigned long long* word, int span,
                                          int spans, int64_t t) {
  constexpr int kBatch = 16;
  float carry = span == 0 ? 0.0f : stage::await_carry(word - 1);
  SCAN1_STAMP(t, 2);
  SCAN1_TICK(f0);
  int c = 0;
  for (; c + kBatch <= n; c += kBatch) {
    float ps[kBatch], es[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ps[u] = aggp[(c + u) * stride];
      es[u] = aggy[(c + u) * stride];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      cin[(c + u) * stride] = carry;
      carry = fold<M>(carry, ps[u], es[u]);
    }
  }
  for (; c < n; ++c) {
    cin[c * stride] = carry;
    carry = fold<M>(carry, aggp[c * stride], aggy[c * stride]);
  }
  if (span + 1 < spans) stage::publish(word, carry);
  SCAN1_SUM(t, 11, f0);
  SCAN1_STAMP(t, 3);
}

// What a walk writes: nothing (the scan for the aggregate), y = local + Q *
// carry-in (kJoin), or y = local (kLocal: a lane's first chunk).
enum Out { kNone = 0, kJoin = 1, kLocal = 2 };

template <int M, int kOut>
__device__ __forceinline__ float out_of(float acc, float p, float cin) {
  return kOut == kJoin ? join<M>(acc, p, cin) : acc;
}

// ---- the time axis: staged tiles -----------------------------------------

// One lane's stream: its first step, its step stride, and whether 16-byte
// copies can move it (step stride 1, 16-byte aligned: every row and tile
// starts at a multiple of 4 steps).
struct Src {
  const float* p;
  int64_t ks;
  bool vec;
};

__device__ __forceinline__ Src src_of(const float* base, int64_t rs,
                                      int64_t ks, int64_t ds, int64_t r,
                                      int64_t d) {
  const float* p = base + r * rs + d * ds;
  return {p, ks, ks == 1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0};
}

__device__ __forceinline__ int slot_of(int j, int q) {
  return j * kRow4 + (q ^ (j & 7));
}

// Copy steps kt + j * C .. + kTile of rows j < rows into buf (steps at or
// past S are left alone: no thread reads them).
__device__ __forceinline__ void stage_tile(float4* buf, const Src& s,
                                           int rows, int64_t kt, int64_t C,
                                           int64_t S) {
  if (s.vec) {
    for (int g = threadIdx.x; g < rows * kRow4; g += kTimeThreads) {
      const int j = g / kRow4, q = g % kRow4;
      const int64_t k = kt + j * C + 4 * q;
      const int64_t left = S - k;
      if (left > 0)
        tdf2::cp_async16(buf + slot_of(j, q), s.p + k,
                         left >= 4 ? 16 : 4 * (int)left);
    }
  } else {
    for (int g = threadIdx.x; g < rows * kTile; g += kTimeThreads) {
      const int j = g / kTile, e = g % kTile;
      const int64_t k = kt + j * C + e;
      if (k < S)
        tdf2::cp_async4(
            reinterpret_cast<float*>(buf + slot_of(j, e >> 2)) + (e & 3),
            s.p + k * s.ks);
    }
  }
}

// Write rows j < rows of the tile (y over x) to the lane at yl, step
// stride ys, steps below S; 16 bytes a thread where the lane allows.
__device__ __forceinline__ void drain(const float4* buf, float* yl,
                                      int64_t ys, int rows, int64_t kt,
                                      int64_t C, int64_t S) {
  const bool vec = ys == 1 && (reinterpret_cast<uintptr_t>(yl) & 15) == 0;
  if (vec) {
    for (int g = threadIdx.x; g < rows * kRow4; g += kTimeThreads) {
      const int j = g / kRow4, q = g % kRow4;
      const int64_t k = kt + j * C + 4 * q;
      const int64_t left = S - k;
      const float4 v = buf[slot_of(j, q)];
      if (left >= 4) {
        *reinterpret_cast<float4*>(yl + k) = v;
      } else if (left > 0) {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int u = 0; u < left; ++u) yl[k + u] = e[u];
      }
    }
  } else {
    for (int g = threadIdx.x; g < rows * kTile; g += kTimeThreads) {
      const int j = g / kTile, e = g % kTile;
      const int64_t k = kt + j * C + e;
      if (k < S)
        yl[k * ys] =
            reinterpret_cast<const float*>(buf + slot_of(j, e >> 2))[e & 3];
    }
  }
}

// 16 bytes of shared memory: the walk's loads and stores, named as such
// (a pointer that may be the tile or the short chunk's row would otherwise
// compile to generic accesses). Both are ordered with the block's barriers
// and with each other as written: the walk issues the next loads first.
__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(tdf2::smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(float4* p, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   tdf2::smem_addr(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Four steps from (x, a, b) four at a time: all four (kFull) or the first
// `lim`. Returns what the walk writes over x (x where it writes nothing).
template <int M, int kOut, bool kFull>
__device__ __forceinline__ float4 steps4(float4 x4, float4 a4, float4 b4,
                                         int lim, float& acc, float& p,
                                         float cin) {
  const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
  const float as[4] = {a4.x, a4.y, a4.z, a4.w};
  const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
  float out[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (kFull || u < lim) {
      acc = step<M>(acc, as[u], bs[u], xs[u]);
      p = p * as[u];
      out[u] = out_of<M, kOut>(acc, p, cin);
    }
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

// Thread j's walk over its row of a tile: all kTile steps (kFull) or the
// first `lim` (a lane's last chunk). a and b come from their tiles, or by
// value where the tile is null. The next four steps' loads are issued
// before these four are scanned; y goes over x in the tile.
template <int M, int kOut, bool kFull>
__device__ __forceinline__ void walk_tile(float4* xb, const float4* ab,
                                          const float4* bb, float va,
                                          float vb, int j, int lim,
                                          float& acc, float& p, float cin) {
  const float4 av = make_float4(va, va, va, va);
  const float4 bv = make_float4(vb, vb, vb, vb);
  int s = slot_of(j, 0);
  float4 x4 = lds4(xb + s);
  float4 a4 = ab != nullptr ? lds4(ab + s) : av;
  float4 b4 = bb != nullptr ? lds4(bb + s) : bv;
#pragma unroll
  for (int q = 0; q < kRow4; ++q) {
    if (!kFull && 4 * q >= lim) break;
    float4 xn = x4, an = a4, bn = b4;
    const int sn = slot_of(j, q + 1 < kRow4 ? q + 1 : q);
    if (q + 1 < kRow4) {
      xn = lds4(xb + sn);
      an = ab != nullptr ? lds4(ab + sn) : av;
      bn = bb != nullptr ? lds4(bb + sn) : bv;
    }
    const float4 y4 =
        steps4<M, kOut, kFull>(x4, a4, b4, lim - 4 * q, acc, p, cin);
    if (kOut != kNone) sts4(xb + s, y4);
    s = sn;
    x4 = xn;
    a4 = an;
    b4 = bn;
  }
}

template <int M, int kOut>
__device__ __forceinline__ void walk(float4* xb, const float4* ab,
                                     const float4* bb, float va, float vb,
                                     int j, int lim, float& acc, float& p,
                                     float cin) {
  if (lim == kTile) {
    walk_tile<M, kOut, true>(xb, ab, bb, va, vb, j, lim, acc, p, cin);
  } else if (lim > 0) {
    walk_tile<M, kOut, false>(xb, ab, bb, va, vb, j, lim, acc, p, cin);
  }
}

// TMA (the tensor memory accelerator) moves a time-axis tile of a stream
// in one instruction: a box of kTile steps x kTimeThreads chunks (rows C
// steps apart) of one lane, laid out with the 128-byte swizzle, which is
// slot_of's: row j's 16-byte piece q at q ^ (j & 7). Completion is counted
// in bytes on one mbarrier a ring stage. y goes back the same way.
struct Maps {
  CUtensorMap x, a, b, y;
};

// Grid: one block per (span, lane), by ticket: ticket t is span t / L of
// lane t % L, so a lane's previous span holds ticket t - L. kTma: every
// staged stream and y move by TMA (D = 1, rows and lanes 16-byte aligned;
// the wrapper's common case), bcast bits 1, 2, 4 set where x, a, b is one
// row read by every lane; a lane's last chunk, if short of C, is past
// the maps' rows and goes through a row of its own (tail), by cp.async.
// Else every stream moves by cp.async (stage) and y by plain stores (drain).
template <int M, bool kTma>
__global__ void __launch_bounds__(kTimeThreads, 2)
    time_kernel(const float* __restrict__ x, int64_t xrs, int64_t xks,
                int64_t xds, Coef a, Coef b, float* __restrict__ y,
                stage::Chain chain, Shape s, int stages,
                const __grid_constant__ Maps maps, int bcast) {
  extern __shared__ float4 smem[];
  __shared__ float aggp[kTimeThreads], aggy[kTimeThreads],
      cin[kTimeThreads];
  __shared__ uint64_t full[kMaxStages];
  __shared__ float4 tail[kMaxStages][3][kRow4];
  __shared__ unsigned tk;
  // the ring at the next kAlign boundary, as an offset into smem, so that
  // it stays a shared-memory pointer
  float4* ring =
      smem + ((kAlign - (tdf2::smem_addr(smem) & (kAlign - 1))) &
              (kAlign - 1)) / 16;
  if (kTma && threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) tdf2::mbar_init(&full[st], 1);
    stage::fence_mbarrier_init();
  }
  const int64_t L = s.R * s.D;
  const int64_t t = stage::take_ticket(chain.ticket, &tk);
  SCAN1_STAMP(t, 0);
  const int64_t lane = t % L;
  const int span = (int)(t / L);
  const int64_t r = lane / s.D, d = lane % s.D;
  const int64_t c0 = (int64_t)span * kTimeThreads;
  const int rows = (int)min((int64_t)kTimeThreads, s.nc - c0);
  const int64_t k0 = c0 * s.C;
  const int j = threadIdx.x;

  const bool has_a = a.p != nullptr;
  const bool has_b = M == kLinear && b.p != nullptr;
  const int streams = 1 + has_a + has_b;
  const Src sx = src_of(x, xrs, xks, xds, r, d);
  const Src sa = has_a ? src_of(a.p, a.rs, a.ks, a.ds, r, d) : sx;
  const Src sb = has_b ? src_of(b.p, b.rs, b.ks, b.ds, r, d) : sx;
  const int qb = has_a ? 2 : 1;  // b's place among the staged streams
  auto buf = [&](int st, int q) {
    return ring + (st * streams + q) * (kTimeThreads * kRow4);
  };
  // the lane's short last chunk, when this span holds it: its row, and
  // where it starts
  const int64_t full_rows = s.S / s.C;
  const int jt = kTma && full_rows < s.nc && full_rows < c0 + rows
                     ? (int)(full_rows - c0)
                     : -1;
  const int64_t kt0 = full_rows * s.C;
  const int nt = (int)(s.C / kTile);  // tiles of a pass
  // tile ii of 2 nt: pass ii / nt (scan for the aggregates, then scan and
  // write y), steps (ii % nt) * kTile of every row, ring stage ii % stages
  auto issue = [&](int ii) {
    if (ii < 2 * nt) {
      const int st = ii % stages;
      const int i = ii % nt;
      if (!kTma) {
        const int64_t kt = k0 + (int64_t)i * kTile;
        stage_tile(buf(st, 0), sx, rows, kt, s.C, s.S);
        if (has_a) stage_tile(buf(st, 1), sa, rows, kt, s.C, s.S);
        if (has_b) stage_tile(buf(st, qb), sb, rows, kt, s.C, s.S);
      } else {
        if (threadIdx.x == 0) {
          stage::bulk_wait<true>();  // the stage's last y has left
          stage::expect_bytes(&full[st], streams * kStreamStage);
          const int k = i * kTile, row = (int)c0;
          stage::tma_load3(buf(st, 0), &maps.x, k, row,
                           bcast & 1 ? 0 : (int)r, &full[st]);
          if (has_a)
            stage::tma_load3(buf(st, 1), &maps.a, k, row,
                             bcast & 2 ? 0 : (int)r, &full[st]);
          if (has_b)
            stage::tma_load3(buf(st, qb), &maps.b, k, row,
                             bcast & 4 ? 0 : (int)r, &full[st]);
        }
        if (jt >= 0 && threadIdx.x < kRow4) {
          const int64_t k = kt0 + (int64_t)i * kTile + 4 * threadIdx.x;
          const int64_t left = s.S - k;
          const int bytes = left >= 4 ? 16 : 4 * (int)left;
          if (left > 0) {
            tdf2::cp_async16(&tail[st][0][threadIdx.x], sx.p + k, bytes);
            if (has_a)
              tdf2::cp_async16(&tail[st][1][threadIdx.x], sa.p + k, bytes);
            if (has_b)
              tdf2::cp_async16(&tail[st][qb][threadIdx.x], sb.p + k, bytes);
          }
        }
      }
    }
    stage::cp_async_commit();
  };
  for (int ii = 0; ii < stages - 1; ++ii) issue(ii);

  const int64_t kj = k0 + (int64_t)j * s.C;  // row j's first step
  const int64_t kend = min(kj + s.C, s.S);
  const bool first = c0 + j == 0;           // a lane's first chunk
  float* yl = y + r * s.S * s.D + d;
  float acc = 0.0f, p = 1.0f, cj = 0.0f;
  for (int ii = 0; ii < 2 * nt; ++ii) {
    const int st = ii % stages;
    const int i = ii % nt;
    SCAN1_TICK(w0);
    stage::cp_async_wait(stages - 2);
    if (kTma) tdf2::mbar_wait<false>(&full[st], (ii / stages) & 1);
    __syncthreads();  // tile ii is in; tile ii - 1's stage is free
    SCAN1_SUM(t, 8, w0);
    SCAN1_TICK(i0);
    issue(ii + stages - 1);
    SCAN1_SUM(t, 12, i0);
    if (ii == nt) {
      SCAN1_STAMP(t, 1);
      if (j == 0)
        fold_span<M>(aggp, aggy, cin, rows, 1,
                     chain.words + lane * s.spans + span, span, s.spans, t);
      __syncthreads();
      cj = cin[j];
      acc = 0.0f;
      p = 1.0f;
    }
    SCAN1_TICK(w1);
    if (j < rows) {
      const int64_t kt = kj + (int64_t)i * kTile;
      const int lim = (int)max((int64_t)0, min((int64_t)kTile, kend - kt));
      // the short last chunk walks its own row (row 0 of its swizzle)
      const bool own = j == jt;
      float4* xb = own ? tail[st][0] : buf(st, 0);
      const float4* ab =
          !has_a ? nullptr : own ? tail[st][1] : buf(st, 1);
      const float4* bb = !has_b ? nullptr : own ? tail[st][qb] : buf(st, qb);
      const int jw = own ? 0 : j;
      if (ii < nt) {
        walk<M, kNone>(xb, ab, bb, a.v, b.v, jw, lim, acc, p, cj);
        if (ii == nt - 1) {
          aggp[j] = p;
          aggy[j] = acc;
        }
      } else if (first) {
        walk<M, kLocal>(xb, ab, bb, a.v, b.v, jw, lim, acc, p, cj);
      } else {
        walk<M, kJoin>(xb, ab, bb, a.v, b.v, jw, lim, acc, p, cj);
      }
    }
    SCAN1_SUM(t, 9, w1);
    if (ii >= nt) {
      SCAN1_TICK(d0);
      if (!kTma) {
        __syncthreads();
        drain(buf(st, 0), yl, s.D, rows, k0 + (int64_t)i * kTile, s.C, s.S);
      } else {
        // y over x in the tile, made visible to the copy engine
        stage::fence_proxy_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          stage::tma_store3(&maps.y, i * kTile, (int)c0, (int)r, buf(st, 0));
          stage::bulk_commit();
        }
        if (jt >= 0 && threadIdx.x < kTile) {
          const int64_t k = kt0 + (int64_t)i * kTile + threadIdx.x;
          if (k < s.S)
            yl[k] = reinterpret_cast<const float*>(
                tail[st][0])[slot_of(0, threadIdx.x >> 2) * 4 +
                             (threadIdx.x & 3)];
        }
      }
      SCAN1_SUM(t, 10, d0);
    }
  }
  tdf2::cp_async_wait_all();
  if (kTma && threadIdx.x == 0) stage::bulk_wait<false>();
  SCAN1_STAMP(t, 4);
}

// ---- block space: lanes side by side -------------------------------------

// One thread's walk over steps kb .. ke - 1 of its lane, eight steps'
// loads ahead of the arithmetic (full batches without a bound check). y
// written at yl, step stride ys (kOut != kNone).
template <int M, int kOut>
__device__ __forceinline__ void walk_lane(const float* xl, int64_t xks,
                                          const float* al, int64_t aks,
                                          float va, const float* bl,
                                          int64_t bks, float vb, int64_t kb,
                                          int64_t ke, float& acc, float& p,
                                          float* yl, int64_t ys, float cin) {
  constexpr int kAhead = 8;
  int64_t k = kb;
  for (; k + kAhead <= ke; k += kAhead) {
    float xv[kAhead], av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      xv[u] = __ldg(xl + (k + u) * xks);
      av[u] = al == nullptr ? va : __ldg(al + (k + u) * aks);
      bv[u] = bl == nullptr ? vb : __ldg(bl + (k + u) * bks);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      acc = step<M>(acc, av[u], bv[u], xv[u]);
      p = p * av[u];
      if (kOut != kNone) yl[(k + u) * ys] = out_of<M, kOut>(acc, p, cin);
    }
  }
  for (; k < ke; ++k) {
    const float ak = al == nullptr ? va : __ldg(al + k * aks);
    const float bk = bl == nullptr ? vb : __ldg(bl + k * bks);
    acc = step<M>(acc, ak, bk, __ldg(xl + k * xks));
    p = p * ak;
    if (kOut != kNone) yl[k * ys] = out_of<M, kOut>(acc, p, cin);
  }
}

// Grid: one block per (span, group of 32 lanes of a row), by ticket: ticket
// t is span t / G of group t % G; warp w scans the span's chunk w.
template <int M>
__global__ void __launch_bounds__(kLaneThreads, 2)
    lane_kernel(const float* __restrict__ x, int64_t xrs, int64_t xks,
                int64_t xds, Coef a, Coef b, float* __restrict__ y,
                stage::Chain chain, Shape s) {
  __shared__ float aggp[kLaneThreads], aggy[kLaneThreads],
      cin[kLaneThreads];
  __shared__ unsigned tk;
  const int64_t groups = (s.D + 31) / 32;  // of a row
  const int64_t G = s.R * groups;
  const int64_t t = stage::take_ticket(chain.ticket, &tk);
  SCAN1_STAMP(t, 0);
  const int64_t g = t % G;
  const int span = (int)(t / G);
  const int q = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t r = g / groups, d = (g % groups) * 32 + q;
  const int64_t c = (int64_t)span * s.K + w;
  const bool on = d < s.D && c < s.nc;
  const int64_t kb = c * s.C, ke = min(kb + s.C, s.S);
  const float* xl = x + r * xrs + d * xds;
  const bool has_a = a.p != nullptr;
  const bool has_b = M == kLinear && b.p != nullptr;
  const float* al = has_a ? a.p + r * a.rs + d * a.ds : nullptr;
  const float* bl = has_b ? b.p + r * b.rs + d * b.ds : nullptr;
  float* yl = y + r * s.S * s.D + d;
  float acc = 0.0f, p = 1.0f;
  if (on)
    walk_lane<M, kNone>(xl, xks, al, a.ks, a.v, bl, b.ks, b.v, kb, ke, acc,
                        p, yl, s.D, 0.0f);
  aggp[threadIdx.x] = p;
  aggy[threadIdx.x] = acc;
  __syncthreads();
  SCAN1_STAMP(t, 1);
  if (w == 0 && d < s.D) {
    const int n = (int)min((int64_t)s.K, s.nc - (int64_t)span * s.K);
    fold_span<M>(aggp + q, aggy + q, cin + q, n, 32,
                 chain.words + (r * s.D + d) * s.spans + span, span,
                 s.spans, t);
  }
  __syncthreads();
  if (on) {
    acc = 0.0f;
    p = 1.0f;
    if (c == 0) {
      walk_lane<M, kLocal>(xl, xks, al, a.ks, a.v, bl, b.ks, b.v, kb, ke,
                           acc, p, yl, s.D, 0.0f);
    } else {
      walk_lane<M, kJoin>(xl, xks, al, a.ks, a.v, bl, b.ks, b.v, kb, ke,
                          acc, p, yl, s.D, cin[threadIdx.x]);
    }
  }
  SCAN1_STAMP(t, 4);
}

// Allow the time-axis kernels their dynamic shared memory on the current
// device, once per device.
int allow_smem() {
  static bool done[stage::kMaxDevices] = {};
  const void* kernels[4] = {(const void*)time_kernel<kLinear, false>,
                            (const void*)time_kernel<kLinear, true>,
                            (const void*)time_kernel<kMaxDecay, false>,
                            (const void*)time_kernel<kMaxDecay, true>};
  return stage::allow_smem(done, kernels, 4, kStageBytes + kAlign);
}

// Whether a stream (first step p, row stride rs, step stride ks) can move
// by TMA on the time axis: steps contiguous, rows and their start 16-byte
// aligned (rs == 0: one row for every lane).
bool tma_fits(const void* p, int64_t rs, int64_t ks) {
  return ks == 1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (rs * 4) % 16 == 0;
}

// The map of a stream's full chunks: [lanes, rows, C] steps, boxes of
// kTile steps x kTimeThreads rows; lanes = 1 where rs == 0.
bool encode(CUtensorMap* m, const float* p, int64_t rs, Shape s) {
  stage::EncodeTiled fn = stage::encoder();
  if (fn == nullptr) return false;
  const int64_t rows = s.S / s.C;
  const cuuint64_t dims[3] = {(cuuint64_t)s.C, (cuuint64_t)rows,
                              (cuuint64_t)(rs == 0 ? 1 : s.R)};
  const cuuint64_t strides[2] = {(cuuint64_t)s.C * 4,
                                 (cuuint64_t)(rs == 0 ? s.C * rows : rs) * 4};
  const cuuint32_t box[3] = {kTile, kTimeThreads, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int M>
int launch(const float* x, int64_t xrs, int64_t xks, int64_t xds, Coef a,
           Coef b, float* y, stage::Chain chain, Shape s, int layout,
           int threads, int stages, int64_t blocks, cudaStream_t st) {
  if (layout == kLanes) {
    lane_kernel<M><<<(unsigned)blocks, threads, 0, st>>>(x, xrs, xks, xds,
                                                         a, b, y, chain, s);
    return 0;
  }
  const bool has_a = a.p != nullptr;
  const bool has_b = M == kLinear && b.p != nullptr;
  const int streams = 1 + has_a + has_b;
  const unsigned smem = stages * streams * kStreamStage + kAlign;
  Maps maps = {};
  const bool tma =
      s.D == 1 && s.S >= s.C && s.S % 4 == 0 && tma_fits(x, xrs, xks) &&
      (!has_a || tma_fits(a.p, a.rs, a.ks)) &&
      (!has_b || tma_fits(b.p, b.rs, b.ks)) &&
      (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (!tma) {
    time_kernel<M, false><<<(unsigned)blocks, kTimeThreads, smem, st>>>(
        x, xrs, xks, xds, a, b, y, chain, s, stages, maps, 0);
    return 0;
  }
  int bcast = xrs == 0;
  bool ok = encode(&maps.x, x, xrs, s) && encode(&maps.y, y, s.S, s);
  if (has_a) {
    ok = ok && encode(&maps.a, a.p, a.rs, s);
    bcast |= (a.rs == 0) << 1;
  }
  if (has_b) {
    ok = ok && encode(&maps.b, b.p, b.rs, s);
    bcast |= (b.rs == 0) << 2;
  }
  if (!ok) return (int)cudaErrorNotSupported;
  time_kernel<M, true><<<(unsigned)blocks, kTimeThreads, smem, st>>>(
      x, xrs, xks, xds, a, b, y, chain, s, stages, maps, bcast);
  return 0;
}

}  // namespace

// Called once when the library is loaded: checks that the loader's idea of
// the time-axis ring (ops/scan_kernels.py STAGE_BYTES) is this file's and
// allows it on the current device (a call on another device sets it there
// the first time).
extern "C" int scan1_init(int stage_bytes) {
  if (stage_bytes != kStageBytes || stage::encoder() == nullptr)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem();
  return err != 0 ? err : (int)cudaGetLastError();
}

// One first-order scan of x viewed as [R, S, D] (strides xrs, xks, xds)
// along S, into y (contiguous [R, S, D]). Coefficients a and b (b unused
// in kMaxDecay): a null pointer takes the value va / vb, else the array
// through its strides. The plan is the caller's (ops/scan_kernels.py
// plan): chunk C, layout (kTime: `threads` = kTimeThreads chunks a block
// and a ring of `stages`; kLanes: `threads` / 32 chunks a block). scratch
// holds 1 + R * D * spans 64-bit words, spans = ceil(ceil(S / C) / chunks
// a block); it is zeroed on `stream` first. Never synchronises, returns
// cudaGetLastError().
extern "C" int scan1(int mode, const float* x, int64_t xrs, int64_t xks,
                     int64_t xds, const float* a, float va, int64_t ars,
                     int64_t aks, int64_t ads, const float* b, float vb,
                     int64_t brs, int64_t bks, int64_t bds, float* y,
                     void* scratch, int64_t R, int64_t S, int64_t D,
                     int64_t C, int layout, int threads, int stages,
                     void* stream_handle) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  if (R < 1 || S < 1 || D < 1 || C < kTile || C % kTile != 0 ||
      (mode != kLinear && mode != kMaxDecay))
    return (int)cudaErrorInvalidValue;
  const int streams =
      1 + (a != nullptr) + (mode == kLinear && b != nullptr);
  int K;
  if (layout == kTime) {
    if (threads != kTimeThreads || stages < 2 || stages > kMaxStages ||
        stages * streams * kStreamStage > kStageBytes)
      return (int)cudaErrorInvalidValue;
    K = kTimeThreads;
  } else if (layout == kLanes) {
    if (threads < 32 || threads > kLaneThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    K = threads / 32;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = allow_smem();
  if (err != 0) return err;
  const int64_t nc = (S + C - 1) / C;
  const int64_t spans = (nc + K - 1) / K;
  const int64_t groups = layout == kTime ? R * D : R * ((D + 31) / 32);
  const int64_t blocks = groups * spans;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Shape s = {R, S, D, C, nc, K, (int)spans};
  stage::Chain chain;
  const cudaError_t e = stage::chain_of(scratch, 1 + R * D * spans, st,
                                        &chain);
  if (e != cudaSuccess) return (int)e;
  const Coef ca = {a, va, ars, aks, ads};
  const Coef cb = {b, vb, brs, bks, bds};
  err = mode == kLinear
            ? launch<kLinear>(x, xrs, xks, xds, ca, cb, y, chain, s, layout,
                              threads, stages, blocks, st)
            : launch<kMaxDecay>(x, xrs, xks, xds, ca, cb, y, chain, s,
                                layout, threads, stages, blocks, st);
  return err != 0 ? err : (int)cudaGetLastError();
}
