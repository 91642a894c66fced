// Tiled in-block scans for Hopper (sm_90a): the phase 1, the combines and
// the refined cascade's defect and correction scan of the two-level TDF2
// scheme (tdf2.cuh), on tiles of a row that live in shared memory. biquad.cu
// runs K4, K5 and K9 on them (biquad_tiled) and lp24.cu runs K2
// (lp24_refined_tiled), K3 and K6 (lp24_tiled); the chain between the scans
// is tdf2::chain.
//
// What bounds it on the H100. An in-block scan is ln dependent steps per
// ln-block and there are rows * n / ln blocks, so the scans are as parallel
// as the card is wide and should cost what their bytes cost; what they must
// not do is walk device memory a thread at a time (32 lanes ln * 4 bytes
// apart: a sector per lane and a load's latency per step) or keep prefix
// rows in device memory between launches. So:
//   tile      a thread block stages kSlots = 128 consecutive ln-blocks of
//             one row (64 KB at ln = 128, 32 KB at ln = 64, 16 and 8 KB at
//             ln = 32 and 16; three blocks fit an SM, two with a per-sample
//             ring) with coalesced 16-byte cp.async copies, zero-filling
//             past n itself, so the caller pads nothing. A row whose start
//             is not 16-byte aligned (n % 4 != 0) is copied 4 bytes at a
//             time.
//   layout    slot t holds ln-block t as ln / 4 chunks of 16 bytes; chunk j
//             of slot t lives at chunk position j ^ (t & 7) of the slot
//             (j ^ ((t >> 1) & 3) at ln = 16, whose slot is 4 chunks: two
//             neighbouring slots share the 8 bank groups). Thread t scans
//             slot t chunk by chunk as float4: at every step the 8 lanes of
//             a quarter warp touch 8 different 16-byte bank groups
//             (unswizzled they would touch one or two), and the coalesced
//             fills and drains touch consecutive chunks of one or two
//             slots, a permutation within each group of 8.
//   scans     one thread per ln-block keeps the whole recurrence in
//             registers (tdf2::step, tdf2::corr_step, tdf2::lp24_defect: the
//             bits of the multi-launch kernels and of the plain twins) and
//             reads its next chunk while it works on this one. Block-rate
//             coefficients are read once per thread, ahead of the scan;
//             per-sample ones are staged beside the tile (Ring below).
//   no prefix rows in device memory. Phase 1 writes only the block maps
//             (M, C); a combine stages the tile again and re-runs the same
//             scan beside the entry state S, writes its output over the
//             tile in place and drains it to device memory coalesced. K4
//             reads x twice and writes y once. A cascade's first combine
//             also runs the next section's phase 1 on its output in the
//             same loop (kNext), so the section between them is read once.
//   the refined cascade's defect reads the section input z and the solve y0
//             at lags 1 and 2. Inside an ln-block they are the scanning
//             thread's own registers; across ln-blocks they are the
//             previous slot's last two samples, which a first pass (the
//             solve scan, keeping only those edges) leaves in shared
//             memory. At a tile's first block they come from re-running
//             the previous tile's last ln-block from z and its entry state:
//             slot 0 of such a tile is that halo block (zeros before the
//             row starts), so a tile advances kSlots - 1 blocks. The second
//             pass runs solve, defect, correction scan and, in the last
//             kernel of a section, the second combine and the next
//             section's phase 1 in one loop over the block.
// Coefficients. A kernel takes a section's coefficients as a small struct
// (Biquad: b0, b1, b2, a1, a2; Lp24: the positive a1, a2 of a (1, 2, 1)
// section), every stream with its own strides, so a caller passes what it
// was given: a broadcast stays stride 0 and nothing is negated, combined or
// copied on the host. The kernel derives what the recurrence runs on (the
// negated denominators, b1 - a1 b0 and b2 - a2 b0 as one __fmaf_rn each:
// ops/biquad_kernels.py _prep's bits, Biquad::of and Lp24::of). kScalar and
// kBlock hold a coefficient set in registers for 64 frames at a time (an
// ln-block of 16 or 32 samples, a static section's short rows, holds one
// set for the whole block: Held). A per-sample stream (kSample: K9, K6
// with automated denominators) changes at every sample, so it is staged
// beside the tile instead (Ring): a thread walking device memory would
// read its coefficients ln * 4 bytes apart from its neighbours'.

#pragma once

#include "tdf2.cuh"

namespace tiled {

using tdf2::Coef;
using tdf2::Layout;

constexpr int kSlots = 128;  // ln-blocks of a tile = threads of a block
constexpr int kCB = 1 << tdf2::kCBlockShift;
constexpr int kMaxDevices = 64;
// a tile, then one float4 of edges per slot
constexpr int smem_bytes(int ln) { return (kSlots * ln + 4 * kSlots) * 4; }
constexpr int kSmemBytes16 = 10240;
constexpr int kSmemBytes32 = 18432;
constexpr int kSmemBytes64 = 34816;
constexpr int kSmemBytes128 = 67584;
static_assert(smem_bytes(16) == kSmemBytes16, "ln = 16 shared memory");
static_assert(smem_bytes(32) == kSmemBytes32, "ln = 32 shared memory");
static_assert(smem_bytes(64) == kSmemBytes64, "ln = 64 shared memory");
static_assert(smem_bytes(128) == kSmemBytes128, "ln = 128 shared memory");
static_assert(3 * kSmemBytes128 <= 232448, "three blocks to an SM");
// A per-sample walk (kSample) adds the ring of its coefficient streams
// after the edges (Ring): per stream two stages of kRingChunks 16-byte
// chunks for every slot. K9 stages five streams, K6 four (section A's and
// section B's denominators in the combine that runs both); two blocks fit
// an SM.
constexpr int kRingChunks = 2;
constexpr int kRingBytes = 2 * kRingChunks * kSlots * 16;
constexpr int ring_bytes(int mode, int streams) {
  return mode == tdf2::kSample ? streams * kRingBytes : 0;
}
constexpr int kSmemBytesK9 = 108544;
constexpr int kSmemBytesK6 = 100352;
static_assert(smem_bytes(128) + ring_bytes(tdf2::kSample, 5) == kSmemBytesK9,
              "K9's shared memory at ln = 128");
static_assert(smem_bytes(128) + ring_bytes(tdf2::kSample, 4) == kSmemBytesK6,
              "K6's per-sample shared memory at ln = 128");
static_assert(2 * kSmemBytesK9 <= 232448, "two per-sample blocks to an SM");

// Tiles per row of nb ln-blocks; `halo` is 1 for the kernels whose tiles
// carry the previous tile's last block in slot 0.
inline int tiles_of(int nb, int halo) {
  const int per = kSlots - halo;
  return (nb + per - 1) / per;
}

// What one launch covers: tiles tile0 .. tile0 + tiles - 1 of every row,
// one thread block each (a launch's grid is rows * tiles).
struct Span {
  int tile0;
  int tiles;
};

namespace {

// The tile of this thread block: its row and the ln-block that slot 0 holds
// (-1: the halo of a row's first tile, before the row starts).
struct Where {
  int64_t row;
  int first;
};

template <int kHalo>
__device__ __forceinline__ Where where(Span sp) {
  const int tile = sp.tile0 + (int)(blockIdx.x % sp.tiles);
  return {(int64_t)(blockIdx.x / sp.tiles), tile * (kSlots - kHalo) - kHalo};
}

// The samples of an ln-block that share one coefficient set: the 64-frame
// control block, or the whole ln-block when ln < 64.
template <int kLn>
struct CoefSet {
  static constexpr int len = kLn < kCB ? kLn : kCB;
};

// The pattern chunk j of slot `slot` is XORed with (see the layout above).
template <int kLn>
__device__ __forceinline__ int swizzle(int slot) {
  constexpr int kRow = kLn / 4;
  static_assert(kRow == 4 || kRow % 8 == 0, "ln is 16, 32, 64 or 128");
  if constexpr (kRow >= 8) {
    return slot & 7;
  } else {
    return (slot >> 1) & 3;
  }
}

template <int kLn>
__device__ __forceinline__ float4* chunk_of(float* tile, int g) {
  constexpr int kRow = kLn / 4;
  const int slot = g / kRow, j = g % kRow;
  return reinterpret_cast<float4*>(tile) + slot * kRow +
         (j ^ swizzle<kLn>(slot));
}

// Stage ln-blocks first .. first + kSlots - 1 of the row at xr (n samples)
// into the tile; samples before the row or past n read as zeros. The caller
// synchronises.
template <int kLn>
__device__ __forceinline__ void fill(float* tile, const float* xr, int64_t n,
                                     int first) {
  constexpr int kChunks = kSlots * kLn / 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const int64_t e0 = (int64_t)first * kLn;
  for (int g = threadIdx.x; g < kChunks; g += kSlots) {
    float4* dst = chunk_of<kLn>(tile, g);
    const int64_t e = e0 + 4 * (int64_t)g;
    const int64_t left = n - e;
    if (e < 0 || left <= 0) {
      *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (aligned) {
      tdf2::cp_async16(dst, xr + e, left >= 4 ? 16 : 4 * (int)left);
    } else {
      float* d1 = reinterpret_cast<float*>(dst);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < left) {
          tdf2::cp_async4(d1 + u, xr + e + u);
        } else {
          d1[u] = 0.0f;
        }
      }
    }
  }
  tdf2::cp_async_wait_all();
}

// Write the tile's slots from `from` on to the row at yr, samples below n
// only, coalesced. The caller has synchronised.
template <int kLn>
__device__ __forceinline__ void drain(float* tile, float* yr, int64_t n,
                                      int first, int from) {
  constexpr int kChunks = kSlots * kLn / 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(yr) & 15) == 0;
  const int64_t e0 = (int64_t)first * kLn;
  for (int g = from * (kLn / 4) + threadIdx.x; g < kChunks; g += kSlots) {
    const int64_t e = e0 + 4 * (int64_t)g;
    const int64_t left = n - e;
    if (left <= 0) break;
    const float4 v = *chunk_of<kLn>(tile, g);
    if (aligned && left >= 4) {
      *reinterpret_cast<float4*>(yr + e) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < left) yr[e + u] = w[u];
    }
  }
}

// Walk the kLn samples of slot `slot` as float4 chunks through the swizzle:
// enter(cb) at the start of each coefficient set cb of the ln-block
// (CoefSet; a compile-time constant after unrolling), then sample(jl, v) for
// each of its samples, jl = 0 .. CoefSet<kLn>::len - 1, which may change v;
// kStore writes the chunk back. The next chunk is read before this one is
// worked on and stored, so no step waits for its own load.
template <int kLn, bool kStore, class Enter, class Sample>
__device__ __forceinline__ void walk(float* tile, int slot, Enter enter,
                                     Sample sample) {
  constexpr int kRow = kLn / 4;
  constexpr int kSeg = CoefSet<kLn>::len;
  float4* r = reinterpret_cast<float4*>(tile) + slot * kRow;
  const int sw = swizzle<kLn>(slot);
  float4 cur = r[sw];
#pragma unroll
  for (int cb = 0; cb < kLn / kSeg; ++cb) {
    enter(cb);
#pragma unroll 4
    for (int i = 0; i < kSeg / 4; ++i) {
      const int j = cb * (kSeg / 4) + i;
      const float4 nxt = r[min(j + 1, kRow - 1) ^ sw];
      sample(4 * i, cur.x);
      sample(4 * i + 1, cur.y);
      sample(4 * i + 2, cur.z);
      sample(4 * i + 3, cur.w);
      if (kStore) r[j ^ sw] = cur;
      cur = nxt;
    }
  }
}

// One coefficient stream: tdf2::Coef with its own layout.
struct Stream {
  Coef c;
  Layout l;
};

template <int M>
__device__ __forceinline__ float at(const Stream& s, int64_t row, int64_t k) {
  return tdf2::at<M>(s.c, s.l, row, k);
}

// What the recurrence runs on at one control block: the negated
// denominators a, b, the numerator factors g1 = b1 - a1 b0, g2 = b2 - a2 b0
// and g0 = b0.
struct Terms {
  float a, b, g1, g2, g0;
};

// A biquad section's five streams as the caller holds them.
struct Biquad {
  static constexpr int kStreams = 5;
  Stream b0, b1, b2, a1, a2;

  // the terms of one coefficient set v = (b0, b1, b2, a1, a2)
  __device__ __forceinline__ static Terms of(const float* v) {
    Terms t;
    t.g0 = v[0];
    t.a = -v[3];
    t.b = -v[4];
    t.g1 = __fmaf_rn(t.a, t.g0, v[1]);
    t.g2 = __fmaf_rn(t.b, t.g0, v[2]);
    return t;
  }

  template <int M>
  __device__ __forceinline__ Terms terms(int64_t row, int64_t k) const {
    const float v[kStreams] = {at<M>(b0, row, k), at<M>(b1, row, k),
                               at<M>(b2, row, k), at<M>(a1, row, k),
                               at<M>(a2, row, k)};
    return of(v);
  }

  __device__ __forceinline__ void put(Stream* s) const {
    s[0] = b0; s[1] = b1; s[2] = b2; s[3] = a1; s[4] = a2;
  }
};

// An lp24 section: numerator (1, 2, 1), so b1m = 2 + na1, b2m = 1 + na2.
struct Lp24 {
  static constexpr int kStreams = 2;
  Stream a1, a2;

  // the terms of one denominator pair v = (a1, a2)
  __device__ __forceinline__ static Terms of(const float* v) {
    Terms t;
    t.a = -v[0];
    t.b = -v[1];
    t.g1 = 2.0f + t.a;
    t.g2 = 1.0f + t.b;
    t.g0 = 1.0f;
    return t;
  }

  template <int M>
  __device__ __forceinline__ Terms terms(int64_t row, int64_t k) const {
    const float v[kStreams] = {at<M>(a1, row, k), at<M>(a2, row, k)};
    return of(v);
  }

  __device__ __forceinline__ void put(Stream* s) const {
    s[0] = a1; s[1] = a2;
  }
};

// A section's terms over an ln-block, one set per CoefSet (kScalar,
// kBlock; a per-sample stream is staged: Ring).
template <int M, int kLn>
struct Held {
  static_assert(M != tdf2::kSample,
                "a per-sample stream is staged beside the tile (Ring)");
  static constexpr int kSeg = CoefSet<kLn>::len;
  Terms t[kLn / kSeg];

  template <class Sec>
  __device__ __forceinline__ void load(const Sec& sec, int64_t row,
                                       int64_t k0) {
#pragma unroll
    for (int i = 0; i < kLn / kSeg; ++i)
      t[i] = sec.template terms<M>(row, k0 + i * kSeg);
  }
};

// The solve's in-block recurrence: the prefix map P and offset Q BEFORE the
// current sample (identity and zero at the block's start).
struct Solve {
  float P11 = 1.0f, P12 = 0.0f, P21 = 0.0f, P22 = 1.0f, Q1 = 0.0f, Q2 = 0.0f;

  // (p11 S1 + p12 S2) + q1: what the block's entry state adds at this sample
  __device__ __forceinline__ float from_entry(float2 S) const {
    return P11 * S.x + P12 * S.y + Q1;
  }

  __device__ __forceinline__ void step(float a, float b, float g1, float g2,
                                       float z) {
    tdf2::step(a, b, g1 * z, g2 * z, P11, P12, P21, P22, Q1, Q2);
  }

  // the whole-block map, after the last sample
  __device__ __forceinline__ void store(float* m, float* c, int64_t t) const {
    reinterpret_cast<float4*>(m)[t] = make_float4(P11, P12, P21, P22);
    reinterpret_cast<float2*>(c)[t] = make_float2(Q1, Q2);
  }
};

__device__ __forceinline__ float2 pair_at(const float* s, int64_t t) {
  return reinterpret_cast<const float2*>(s)[t];
}

// Per-sample coefficients (kSample), staged beside the tile in a ring of
// two stages. Stage p % 2 holds chunks 2p and 2p + 1 of every slot (8
// samples: one 32-byte sector of each stream's row) of every stream, laid
// out [stream][chunk][slot] as float4, so that thread t reads its slot's
// chunk beside its neighbours' (consecutive 16-byte words: no bank
// conflict). Two threads copy a slot's sector, so the copies of a warp
// fill whole sectors. The block walks its tile in lockstep, one stage a
// step (walk_staged): while the threads scan stage p, stage p + 1 is in
// flight, and one barrier a step hands the stages over. A stream's row
// that starts 16-byte aligned with entry stride 1 is copied 16 bytes at a
// time, any other (a broadcast along time, an odd column offset) 4 bytes
// at a time; past `count` a coefficient reads 0 (tdf2::at's rule). A row
// broadcast (row stride 0) is read where it lies.
template <int kLn, int kS>
__device__ __forceinline__ void stage(float4* ring, const Stream (&s)[kS],
                                      int64_t row, int first, int p) {
  float4* st = ring + (p & 1) * kS * kRingChunks * kSlots;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const float* r = s[i].c.p + row * s[i].l.rs;
    const int64_t ts = s[i].l.ts;
    const bool vec = ts == 1 && (reinterpret_cast<uintptr_t>(r) & 15) == 0;
#pragma unroll
    for (int h = 0; h < kRingChunks; ++h) {
      const int g = h * kSlots + threadIdx.x;
      const int slot = g / kRingChunks, ch = g % kRingChunks;
      float4* dst = st + (i * kRingChunks + ch) * kSlots + slot;
      const int64_t k =
          (int64_t)(first + slot) * kLn + 4 * (kRingChunks * p + ch);
      const int64_t left = s[i].l.count - k;
      if (left <= 0) {
        *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if (vec) {
        tdf2::cp_async16(dst, r + k, left >= 4 ? 16 : 4 * (int)left);
      } else {
        float* d1 = reinterpret_cast<float*>(dst);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < left) {
            tdf2::cp_async4(d1 + u, r + (k + u) * ts);
          } else {
            d1[u] = 0.0f;
          }
        }
      }
    }
  }
}

// Walk the kLn samples of this thread's slot with per-sample coefficients,
// the whole block in lockstep: sample(v, z) gets the kS coefficient values
// of the sample and may change z; kStore writes the tile back. Stage 0 was
// issued before the tile's fill, whose wait covers it, and the caller has
// synchronised since. Every thread of the block must call it.
template <int kLn, bool kStore, int kS, class Sample>
__device__ __forceinline__ void walk_staged(float* tile, float4* ring,
                                            const Stream (&s)[kS],
                                            const Where& w, Sample sample) {
  constexpr int kRow = kLn / 4;
  constexpr int kSteps = kRow / kRingChunks;
  const int slot = threadIdx.x;
  float4* r = reinterpret_cast<float4*>(tile) + slot * kRow;
  const int sw = swizzle<kLn>(slot);
#pragma unroll 1
  for (int p = 0; p < kSteps; ++p) {
    if (p > 0) {
      // stage p has landed, and every thread is done with stage p - 1,
      // whose buffer stage p + 1 fills
      tdf2::cp_async_wait_all();
      __syncthreads();
    }
    if (p + 1 < kSteps) stage<kLn, kS>(ring, s, w.row, w.first, p + 1);
    const float4* st = ring + (p & 1) * kS * kRingChunks * kSlots + slot;
#pragma unroll
    for (int ch = 0; ch < kRingChunks; ++ch) {
      const int j = kRingChunks * p + ch;
      const float4 z4 = r[j ^ sw];
      float4 c4[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) c4[i] = st[(i * kRingChunks + ch) * kSlots];
      float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[kS];
#pragma unroll
        for (int i = 0; i < kS; ++i)
          v[i] = u == 0 ? c4[i].x : u == 1 ? c4[i].y : u == 2 ? c4[i].z
                                                              : c4[i].w;
        sample(v, z[u]);
      }
      if (kStore) r[j ^ sw] = make_float4(z[0], z[1], z[2], z[3]);
    }
  }
}

// Where a section's terms come from over one ln-block: held per
// coefficient set (kScalar, kBlock) or staged per sample (kSample, below).
// A Feed is made before the tile's fill; walk(tile, w, blk, sample) calls
// sample(t, tn, z) with the section's terms t (and with kNext the next
// section's, tn) of every sample of the thread's slot. kAll: every thread
// of the block walks, its ln-block past the row's end or not.
template <int M, int kLn, class Sec, bool kNext>
struct Feed {
  static constexpr bool kAll = false;
  const Sec& sec;
  const Sec& next;

  __device__ __forceinline__ Feed(float*, const Sec& a, const Sec& b,
                                  const Where&)
      : sec(a), next(b) {}

  template <bool kStore, class Sample>
  __device__ __forceinline__ void walk(float* tile, const Where& w, int blk,
                                       Sample sample) const {
    const int64_t k0 = (int64_t)blk * kLn;
    Held<M, kLn> co, cn;
    co.load(sec, w.row, k0);
    if (kNext) cn.load(next, w.row, k0);
    Terms t, tn;
    tiled::walk<kLn, kStore>(
        tile, threadIdx.x,
        [&](int cb) {
          t = co.t[cb];
          if (kNext) tn = cn.t[cb];
        },
        [&](int, float& z) { sample(t, tn, z); });
  }
};

template <int kLn, class Sec, bool kNext>
struct Feed<tdf2::kSample, kLn, Sec, kNext> {
  static constexpr bool kAll = true;
  static constexpr int kS = Sec::kStreams * (kNext ? 2 : 1);
  float4* ring;
  Stream s[kS];

  // the ring sits after the tile and its edges; stage 0 is issued here
  __device__ __forceinline__ Feed(float* tile, const Sec& a, const Sec& b,
                                  const Where& w)
      : ring(reinterpret_cast<float4*>(tile + kSlots * kLn + 4 * kSlots)) {
    a.put(s);
    if (kNext) b.put(s + Sec::kStreams);
    stage<kLn, kS>(ring, s, w.row, w.first, 0);
  }

  template <bool kStore, class Sample>
  __device__ __forceinline__ void walk(float* tile, const Where& w, int,
                                       Sample sample) const {
    walk_staged<kLn, kStore, kS>(tile, ring, s, w,
                                 [&](const float* v, float& z) {
                                   const Terms t = Sec::of(v);
                                   Terms tn;
                                   if (kNext) tn = Sec::of(v + Sec::kStreams);
                                   sample(t, tn, z);
                                 });
  }
};

// Phase 1 of one section: the block maps m [B, nb, 4] and c [B, nb, 2] of
// the rows x [B, n]; nothing else is written.
template <int M, int kLn, class Sec>
__global__ void __launch_bounds__(kSlots, 3)
    maps_kernel(const float* __restrict__ x, Sec sec, float* __restrict__ m,
                float* __restrict__ c, int64_t n, int nb, Span sp) {
  extern __shared__ __align__(16) float tile[];
  const Where w = where<0>(sp);
  const Feed<M, kLn, Sec, false> feed(tile, sec, sec, w);
  fill<kLn>(tile, x + w.row * n, n, w.first);
  __syncthreads();
  const int blk = w.first + threadIdx.x;
  if (!feed.kAll && blk >= nb) return;
  Solve v;
  feed.template walk<false>(tile, w, blk,
                            [&](const Terms& t, const Terms&, float& z) {
                              v.step(t.a, t.b, t.g1, t.g2, z);
                            });
  if (blk < nb) v.store(m, c, w.row * nb + blk);
}

// One section's combine: y = b0 x + ((p11 S1 + p12 S2) + q1) over the rows
// x [B, n], from the entry states s [B, nb, 2]; the prefix rows are
// re-scanned from the staged tile. With kNext the section `next` runs its
// phase 1 on y in the same loop and m_next [B, nb, 4], c_next [B, nb, 2]
// receive its block maps. The samples of the last block past n (which y
// does not keep) are the combine's continuation of the zeros staged there,
// as in the twins' padded section output; they reach only that block's map.
template <int M, int kLn, class Sec, bool kNext>
__global__ void __launch_bounds__(kSlots, 3)
    combine_kernel(const float* __restrict__ x, Sec sec, Sec next,
                   const float* __restrict__ s, float* __restrict__ y,
                   float* __restrict__ m_next, float* __restrict__ c_next,
                   int64_t n, int nb, Span sp) {
  extern __shared__ __align__(16) float tile[];
  const Where w = where<0>(sp);
  const Feed<M, kLn, Sec, kNext> feed(tile, sec, next, w);
  fill<kLn>(tile, x + w.row * n, n, w.first);
  __syncthreads();
  const int blk = w.first + threadIdx.x;
  if (feed.kAll || blk < nb) {
    const int64_t i = w.row * nb + blk;
    const float2 S = blk < nb ? pair_at(s, i) : make_float2(0.0f, 0.0f);
    Solve v, vn;
    feed.template walk<true>(
        tile, w, blk, [&](const Terms& t, const Terms& tn, float& z) {
          const float out = t.g0 * z + v.from_entry(S);
          v.step(t.a, t.b, t.g1, t.g2, z);
          if (kNext) vn.step(tn.a, tn.b, tn.g1, tn.g2, out);
          z = out;
        });
    if (kNext && blk < nb) vn.store(m_next, c_next, i);
  }
  __syncthreads();
  drain<kLn>(tile, y + w.row * n, n, w.first, 0);
}

// The refined cascade's first pass over a tile with a halo: every slot
// re-runs its block's solve scan and leaves (z, z at lag 1, y0, y0 at lag 1)
// of its LAST sample in edge[slot], the history the next slot's defect
// starts from. The slot before the row's start leaves zeros.
template <int M, int kLn>
__device__ __forceinline__ void solve_edges(float* tile, float4* edge,
                                            const Where& w, const Lp24& sec,
                                            const float* __restrict__ s,
                                            int nb) {
  const int slot = threadIdx.x, blk = w.first + slot;
  if (blk < 0) edge[slot] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (blk < 0 || blk >= nb) return;
  Held<M, kLn> co;
  co.load(sec, w.row, (int64_t)blk * kLn);
  const float2 S = pair_at(s, w.row * nb + blk);
  constexpr int kSeg = CoefSet<kLn>::len;
  Solve v;
  Terms t;
  float z1 = 0.0f, z2 = 0.0f, y1 = 0.0f, y2 = 0.0f;
  bool last = false;
  walk<kLn, false>(
      tile, slot,
      [&](int cb) {
        t = co.t[cb];
        last = cb == kLn / kSeg - 1;
      },
      [&](int jl, float& z) {
        if (last && jl >= kSeg - 2) {
          z2 = z1; y2 = y1;
          z1 = z; y1 = z + v.from_entry(S);
        }
        v.step(t.a, t.b, t.g1, t.g2, z);
      });
  edge[slot] = make_float4(z1, z2, y1, y2);
}

// The refined cascade's second pass over one ln-block, in one loop: the
// solve y0 = z + ((p11 S1 + p12 S2) + q1), its defect d against the
// shifted-coefficient recurrence (tdf2::lp24_defect, history from the
// previous slot's edges), the correction's r-only scan of d, and with kOut
// the second combine out = y0 + (((d + p11 Sc1) + p12 Sc2) + r1), written
// over the tile in place. With kNext the next section's phase 1 runs on
// `out` in the same loop. Slot 0 is the halo and does nothing here.
//   kOut false: r [B, nb, 2] receives the correction's block-end pair;
//   kNext:      m_next, c_next receive the next section's block maps.
template <int M, int kLn, bool kOut, bool kNext>
__device__ __forceinline__ void refine_block(
    float* tile, const float4* edge, const Where& w, const Lp24& sec,
    const Lp24& next, const float* __restrict__ s,
    const float* __restrict__ sc, float* __restrict__ r,
    float* __restrict__ m_next, float* __restrict__ c_next, int nb) {
  const int slot = threadIdx.x, blk = w.first + slot;
  if (slot == 0 || blk >= nb) return;
  const int64_t k0 = (int64_t)blk * kLn, i = w.row * nb + blk;
  Held<M, kLn> co, cn;
  co.load(sec, w.row, k0);
  if (kNext) cn.load(next, w.row, k0);
  // the negated denominators of the control block before this ln-block:
  // the defect reads na1 at lag 1 and na2 at lag 2 (zeros before the row
  // starts)
  const float a_before = k0 > 0 ? -at<M>(sec.a1, w.row, k0 - 1) : 0.0f;
  const float b_before = k0 > 0 ? -at<M>(sec.a2, w.row, k0 - 1) : 0.0f;
  const float2 S = pair_at(s, i);
  const float2 Sc = kOut ? pair_at(sc, i) : make_float2(0.0f, 0.0f);
  const float4 e = edge[slot - 1];
  float z1 = e.x, z2 = e.y, y1 = e.z, y2 = e.w;
  Solve v, vn;
  float R1 = 0.0f, R2 = 0.0f;
  Terms t, tn;
  float a_prev, b_prev;
  walk<kLn, kOut>(
      tile, slot,
      [&](int cb) {
        t = co.t[cb];
        a_prev = cb == 0 ? a_before : co.t[cb > 0 ? cb - 1 : 0].a;
        b_prev = cb == 0 ? b_before : co.t[cb > 0 ? cb - 1 : 0].b;
        if (kNext) tn = cn.t[cb];
      },
      [&](int jl, float& z) {
        const float y0 = z + v.from_entry(S);
        const float a1s = jl == 0 ? a_prev : t.a;
        const float a2s = jl < 2 ? b_prev : t.b;
        const float d = tdf2::lp24_defect(z, z1, z2, y0, y1, y2, a1s, a2s);
        float out = 0.0f;
        if (kOut) out = y0 + (d + v.P11 * Sc.x + v.P12 * Sc.y + R1);
        v.step(t.a, t.b, t.g1, t.g2, z);
        tdf2::corr_step(t.a, t.b, d, R1, R2);
        z2 = z1; z1 = z;
        y2 = y1; y1 = y0;
        if (kOut) {
          if (kNext) vn.step(tn.a, tn.b, tn.g1, tn.g2, out);
          z = out;
        }
      });
  if (!kOut) reinterpret_cast<float2*>(r)[i] = make_float2(R1, R2);
  if (kNext) vn.store(m_next, c_next, i);
}

// A refined section's defect and correction scan: from the section input
// z [B, n] and the solve's entry states s, the correction's block-end pairs
// r [B, nb, 2] (the offsets of the second chain, whose maps are the
// solve's).
template <int M, int kLn>
__global__ void __launch_bounds__(kSlots, 3)
    defect_scan_kernel(const float* __restrict__ z, Lp24 sec,
                       const float* __restrict__ s, float* __restrict__ r,
                       int64_t n, int nb, Span sp) {
  extern __shared__ __align__(16) float tile[];
  float4* edge = reinterpret_cast<float4*>(tile + kSlots * kLn);
  const Where w = where<1>(sp);
  fill<kLn>(tile, z + w.row * n, n, w.first);
  __syncthreads();
  solve_edges<M, kLn>(tile, edge, w, sec, s, nb);
  __syncthreads();
  refine_block<M, kLn, false, false>(tile, edge, w, sec, sec, s, nullptr, r,
                                     nullptr, nullptr, nb);
}

// A refined section's second combine: out [B, n] = y0 + correction from the
// section input z, the solve's entry states s and the correction's sc; with
// kNext also the block maps of `out` under the section `next` (its
// phase 1).
template <int M, int kLn, bool kNext>
__global__ void __launch_bounds__(kSlots, 3)
    refine_kernel(const float* __restrict__ z, Lp24 sec, Lp24 next,
                  const float* __restrict__ s, const float* __restrict__ sc,
                  float* __restrict__ out, float* __restrict__ m_next,
                  float* __restrict__ c_next, int64_t n, int nb, Span sp) {
  extern __shared__ __align__(16) float tile[];
  float4* edge = reinterpret_cast<float4*>(tile + kSlots * kLn);
  const Where w = where<1>(sp);
  fill<kLn>(tile, z + w.row * n, n, w.first);
  __syncthreads();
  solve_edges<M, kLn>(tile, edge, w, sec, s, nb);
  __syncthreads();
  refine_block<M, kLn, true, kNext>(tile, edge, w, sec, next, s, sc, nullptr,
                                    m_next, c_next, nb);
  __syncthreads();
  drain<kLn>(tile, out + w.row * n, n, w.first, 1);
}

// Allow `kernel` its dynamic shared memory on the current device.
template <class K>
int allow(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The current device's index, for a source's once-per-device set-up; -1 and
// `err` set when it cannot be read or is out of range.
inline int device_index(int& err) {
  int dev = -1;
  err = (int)cudaGetDevice(&dev);
  if (err == 0 && (dev < 0 || dev >= kMaxDevices))
    err = (int)cudaErrorInvalidDevice;
  return err == 0 ? dev : -1;
}

}  // namespace
}  // namespace tiled
