// S2: the reverb's feedback combs and Schroeder all-passes with carried
// delay-line tails, for Hopper (sm_90a): groove_tpu/ops/stream.py
// comb_feedback_stream (:253), comb_feedback_stream_automated (:275) and
// allpass_stream (:302), which the reference runs as a serial lax.scan over
// delay-length chunks whose body is elementwise across the D lanes:
//   comb     y[t] = x[t-D] + g[t] y[t-D]               (kComb)
//   allpass  w[t] = x[t] + g w[t-D]
//            y[t] = (-g) x[t] + (1 - g^2) w[t-D]       (kAllpass)
// Samples before the segment come from the carried tails (the last D
// samples of x and y, or of w). Each output is one multiply and one add of
// values D samples back, so any segmentation that hands over the last D
// samples gives the same bits. Lane d (t = d, d + D, d + 2D, ...) is one
// thread, which keeps the lane's previous x and y (or w) in registers from
// the tails' entry d; when it ends they are entry (d - S) mod D of the new
// tails (the last D samples of concat(tail, segment) hold one sample of
// every lane), so the kernel writes the tails itself and S need be neither
// a multiple of D nor at least D. The plain twin (ops/stream_kernels.py
// _comb_plain, _allpass_plain) computes the same expressions; -fmad=false
// keeps each multiply and add rounded on its own, so they agree bit for bit.
//
// What bounds it on the H100: a lane's chain, ceil(S / D) steps of two
// dependent operations (the all-pass at D = 75: 105,841 steps at 3 minutes,
// 0.43 ms at 4 cycles an operation), or the bytes of x, y and a per-sample
// g (the combs at D >= 1310: 0.047 ms at 3 minutes, against a chain of
// 17-25 us). The design, one launch a call:
//   tiles  a thread block walks its lanes through tiles of consecutive
//          delay periods, staged in shared memory by TMA in a ring of
//          `stages` (stages - 1 tiles ahead of the walk), by a mover thread
//          in a warp of its own; each step reads its x (and g) from shared
//          memory, so a lane's chain waits on its two operations and not on
//          a global load, and stores its y, a warp's 32 lanes 128
//          neighbouring bytes. x and g are read once and y written once.
//          Copies that every thread issues (cp.async) held an SM to 2-9
//          GB/s on an H100, a load pipe full of them (csrc/stage.cuh).
//   lanes  D <= kMaxContig (the all-passes): a block is every lane of one
//          row, a thread a lane, a tile one contiguous time range, moved by
//          one 1-D bulk copy over its 16-byte aligned middle (the tile sits
//          at the range's 16-byte phase, skew_of) and cp.async at its ends;
//          kContigStages stages share the ring, so that a tile of x alone
//          is 18,432 floats (245 periods at D = 75): a tile's waits and
//          barrier are paid once a tile (54-period tiles took 1.9x as long
//          at 3 minutes).
//          D > kMaxContig (the combs): a block is kGroup neighbouring lanes
//          of a row (61 blocks a row at D = 1927, so the copies spread over
//          the SMs), its tile kGroup-float runs D floats apart. TMA boxes
//          need row strides that are multiples of 16 bytes, which D floats
//          are not at odd D, but 4 D floats are: the row seen as [M, 4 D]
//          (M = S / 4 D) is a tensor map, and box k holds periods 4 i + k
//          of the tile, kBox rows. A box must start on 16 bytes (one at an
//          odd column faults), so it is kRowW = kGroup + 4 floats wide from
//          column k D + d0 rounded down to 4, the lanes at offset
//          (k D + d0) & 3 of its rows. The periods past 4 M (fewer than 4),
//          and rows whose stride is no multiple of 16 bytes, go by cp.async.
//   The all-pass's 150 lanes (two rows at D = 75) are its chain: more
//   blocks would not shorten it, so it takes one block a row.
//
// g: the comb's feedback as a value, or per sample as [R, S] through a row
// stride (0 broadcasts; time contiguous: an automated reverb's RT60); the
// all-pass's g, -g and 1 - g^2 as float32 values (the reference's Python
// float64 constants, rounded once). x and y: contiguous [R, S]; tails:
// contiguous [R, D].

#include "stage.cuh"

namespace {

constexpr int kStageFloats = 4096;  // a lane group's tile of one stream
constexpr int kStages = 6;          // of a lane group's ring
constexpr int kContigStages = 3;    // of a contiguous block's ring
constexpr int kMaxContig = 256;      // lanes of a contiguous block
constexpr int kGroup = 32;           // lanes of a block past kMaxContig
constexpr int kBox = kStageFloats / kGroup / 4;  // rows of a box
constexpr int kRowW = kGroup + 4;    // floats of a box row
constexpr int kStageStride = 4 * kBox * kRowW;  // floats of a stream's stage
constexpr int kAlign = 128;          // TMA's shared-memory alignment
constexpr int kRingBytes = kStages * 2 * kStageStride * 4 + kAlign;
static_assert(kRingBytes == 221312, "ops/stream_kernels.py COMB_RING");
static_assert(kRingBytes + kStages * 8 + 1024 <= 232448,
              "the ring, its barriers and the runtime's 1 KB");
static_assert((kStageStride * 4) % kAlign == 0, "stages stay aligned");
enum Mode { kComb = 0, kAllpass = 1 };

// A call's geometry (ops/stream_kernels.py comb_plan). Periods [0, P4) go
// by tensor map in tma_tiles tiles (lane groups), the rest by cp.async.
struct Geometry {
  int64_t S, D, P, P4;
  int L;       // lanes of a tile row: D (contiguous), else kGroup
  int groups;  // blocks a row
  int TP;      // delay periods a tile
  int tiles;   // of a row
  int tma_tiles;
  int stages;  // of the ring
  int stride;  // floats of a stream's stage
};

struct Maps {
  CUtensorMap x, g;
};

__device__ __forceinline__ int skew_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The 16-byte aligned middle of src[g0, g1): h elements before it, n4
// float4s, tl after.
struct Range {
  int h, tl;
  int64_t n4;
};

__device__ __forceinline__ Range range_of(const float* src, int64_t g0,
                                          int64_t g1) {
  const int64_t n = g1 - g0;
  const int h = (int)min((int64_t)((4 - skew_of(src + g0)) & 3), n);
  const int64_t n4 = (n - h) >> 2;
  return {h, (int)(n - h - 4 * n4), n4};
}

// The mover: src[g0, g1) to dst[skew_of(src + g0) + (g - g0)], the middle by
// one bulk copy counted on bar, the ends by cp.async. Returns the bulk
// bytes.
__device__ __forceinline__ unsigned bulk_bytes(const float* src, int64_t g0,
                                               int64_t g1) {
  return (unsigned)(range_of(src, g0, g1).n4 * 16);
}

__device__ __forceinline__ void copy_range(float* dst, const float* src,
                                           int64_t g0, int64_t g1,
                                           uint64_t* bar) {
  const Range c = range_of(src, g0, g1);
  float* d = dst + skew_of(src + g0);
  const float* s = src + g0;
  if (c.n4 > 0) stage::bulk_load(d + c.h, s + c.h, (unsigned)(c.n4 * 16), bar);
  for (int e = 0; e < c.h; ++e) tdf2::cp_async4(d + e, s + e);
  for (int64_t e = c.h + 4 * c.n4; e < c.h + 4 * c.n4 + c.tl; ++e)
    tdf2::cp_async4(d + e, s + e);
}

// Where a lane group's tile holds period p (from the tile's first) of lane
// q: box k = p & 3, row p >> 2, at the box's offset (k D + d0) & 3.
__device__ __forceinline__ int grouped(int p, int q, int64_t D, int64_t d0) {
  const int k = p & 3;
  return (k * kBox + (p >> 2)) * kRowW + (int)((k * D + d0) & 3) + q;
}

// One step of a lane's chain from x[t] (and g[t]): returns y[t].
template <int kMode>
__device__ __forceinline__ float step(float xt, float gt, float ng, float c1,
                                     float& xp, float& yp) {
  if (kMode == kComb) {
    const float yt = xp + gt * yp;
    xp = xt;
    yp = yt;
    return yt;
  }
  const float yt = ng * xt + c1 * xp;
  xp = xt + gt * xp;
  return yt;
}

// The walks load the next steps' x (and g) in the same straight-line code
// as the chain, so that the loads issue between its operations (a warp
// issues in order: loads apart from the chain would wait their turn on
// it). A lane stores each y as it goes; a warp's stores of a step are 32
// neighbouring floats, 128 bytes, so y leaves in whole lines without a
// pass through shared memory (the store phase's fence and barrier cost
// more than the chain itself at D = 75: kernels/carried_times.py).

// A contiguous block's lane over np periods: x at xb[p L], g at gb[p L]
// (kPerSample, else gv), y at yg[p L]. Two register batches take turns.
template <int kMode, bool kPerSample>
__device__ __forceinline__ void walk_contig(const float* xb, const float* gb,
                                            int L, int np, float* yg,
                                            float gv, float ng, float c1,
                                            float& xp, float& yp) {
  constexpr int kWalk = 8;
  const int whole = np / kWalk * kWalk;
  const int64_t batch = (int64_t)kWalk * L;
  float xa[kWalk], ga[kWalk], xn[kWalk], gn[kWalk];
#pragma unroll
  for (int u = 0; u < kWalk; ++u) {
    const int o = (u < np ? u : 0) * L;
    xa[u] = xb[o];
    ga[u] = kPerSample ? gb[o] : gv;
  }
  const float* xq = xb;
  const float* gq = gb;
  int p = 0;
  while (p < whole) {
    if (p + kWalk < whole) {
      xq += batch;
      if (kPerSample) gq += batch;
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      xn[u] = xq[u * L];
      gn[u] = kPerSample ? gq[u * L] : gv;
      *yg = step<kMode>(xa[u], ga[u], ng, c1, xp, yp);
      yg += L;
    }
    p += kWalk;
    if (p >= whole) break;
    if (p + kWalk < whole) {
      xq += batch;
      if (kPerSample) gq += batch;
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      xa[u] = xq[u * L];
      ga[u] = kPerSample ? gq[u * L] : gv;
      *yg = step<kMode>(xn[u], gn[u], ng, c1, xp, yp);
      yg += L;
    }
    p += kWalk;
  }
  for (; p < np; ++p) {
    *yg = step<kMode>(xb[p * L], kPerSample ? gb[p * L] : gv, ng, c1, xp,
                      yp);
    yg += L;
  }
}

// A lane group's lane over np periods: period p = 4 i + k at
// xb[off_k + i kRowW] (box k, row i; off_k = k kBox kRowW + (k D + d0) & 3),
// g alike; y at yg[p D], stored as it goes.
template <int kMode, bool kPerSample>
__device__ __forceinline__ void walk_grouped(const float* xb,
                                             const float* gb, int np,
                                             int64_t D, int64_t d0,
                                             float* yg, float gv, float ng,
                                             float c1, float& xp,
                                             float& yp) {
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    off[k] = k * kBox * kRowW + (int)((k * D + d0) & 3);
  const int rows = np / 4;
  float xc[4], gc[4], xn[4], gn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xc[k] = rows > 0 ? xb[off[k]] : 0.0f;
    gc[k] = kPerSample && rows > 0 ? gb[off[k]] : gv;
  }
  for (int i = 0; i < rows; ++i) {
    const int in = (i + 1 < rows ? i + 1 : i) * kRowW;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xn[k] = xb[off[k] + in];
      gn[k] = kPerSample ? gb[off[k] + in] : gv;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *yg = step<kMode>(xc[k], gc[k], ng, c1, xp, yp);
      yg += D;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
  }
  for (int k = 0; k < np - 4 * rows; ++k) {
    const int o = off[k] + rows * kRowW;
    *yg = step<kMode>(xb[o], kPerSample ? gb[o] : gv, ng, c1, xp, yp);
    yg += D;
  }
}

// Grid: R * groups blocks; block b holds lanes [d0, d0 + L) of row
// b / groups. Thread q is lane d0 + q; the first thread of the last warp
// (a warp of its own) moves the tiles: TMA copies and stores, their
// barriers and groups.
template <int kMode, bool kPerSample>
__global__ void __launch_bounds__(kMaxContig + 32)
    comb_stream_kernel(const float* __restrict__ x,
                       const float* __restrict__ g, float gv, int64_t grs,
                       float ng, float c1, const float* __restrict__ hx,
                       const float* __restrict__ hy,
                       float* __restrict__ hx_out,
                       float* __restrict__ hy_out, float* __restrict__ y,
                       Geometry s, const __grid_constant__ Maps maps) {
  extern __shared__ float4 smem[];
  __shared__ uint64_t full[kStages];
  constexpr int streams = kPerSample ? 2 : 1;
  float* ring = reinterpret_cast<float*>(smem) +
                ((kAlign - (tdf2::smem_addr(smem) & (kAlign - 1))) &
                 (kAlign - 1)) / 4;
  const int64_t r = blockIdx.x / s.groups;
  const int64_t d0 = (int64_t)(blockIdx.x % s.groups) * s.L;
  const bool contig = s.groups == 1 && s.L == s.D;
  const int q = threadIdx.x;
  const bool mover = threadIdx.x == blockDim.x - 32;
  const int64_t d = d0 + q;
  const bool lane = q < s.L && d < s.D;
  const float* xr = x + r * s.S;
  const float* gr = kPerSample ? g + r * grs : nullptr;
  float* yr = y + r * s.S;
  const int xrow = (int)r, grow = grs == 0 ? 0 : (int)r;
  auto buf = [&](int st, int k) {
    return ring + (st * streams + k) * s.stride;
  };
  // tile i: periods [p0, p1), by tensor map (kind 1), contiguous bulk copy
  // (kind 2) or cp.async (kind 0)
  auto span_of = [&](int i, int64_t& p0, int64_t& p1) {
    if (contig) {
      p0 = (int64_t)i * s.TP;
      p1 = min(p0 + s.TP, s.P);
      return 2;
    }
    if (i < s.tma_tiles) {
      p0 = (int64_t)i * s.TP;
      p1 = min(p0 + s.TP, s.P4);
      return 1;
    }
    p0 = s.P4 + (int64_t)(i - s.tma_tiles) * s.TP;
    p1 = min(p0 + s.TP, s.P);
    return 0;
  };

  auto issue = [&](int i) {
    if (i < s.tiles) {
      const int st = i % s.stages;
      int64_t p0, p1;
      const int kind = span_of(i, p0, p1);
      if (kind == 2 && mover) {
        const int64_t g0 = p0 * s.D, g1 = min(s.S, p1 * s.D);
        stage::expect_bytes(&full[st],
                            bulk_bytes(xr, g0, g1) +
                                (kPerSample ? bulk_bytes(gr, g0, g1) : 0u));
        copy_range(buf(st, 0), xr, g0, g1, &full[st]);
        if (kPerSample) copy_range(buf(st, 1), gr, g0, g1, &full[st]);
      } else if (kind == 1 && mover) {
        stage::expect_bytes(&full[st], streams * kStageStride * 4);
        const int row = (int)(p0 / 4);
        for (int k = 0; k < 4; ++k) {
          const int col = (int)((k * s.D + d0) & ~(int64_t)3);
          stage::tma_load3(buf(st, 0) + k * kBox * kRowW, &maps.x, col, row,
                           xrow, &full[st]);
          if (kPerSample)
            stage::tma_load3(buf(st, 1) + k * kBox * kRowW, &maps.g, col,
                             row, grow, &full[st]);
        }
      } else if (kind == 0) {
        if (mover) stage::expect_bytes(&full[st], 0);
        for (int e = threadIdx.x; e < s.TP * kGroup; e += blockDim.x) {
          const int pl = e / kGroup, qq = e % kGroup;
          const int64_t dd = d0 + qq, t = (p0 + pl) * s.D + dd;
          if (p0 + pl < p1 && dd < s.D && t < s.S) {
            const int o = grouped(pl, qq, s.D, d0);
            tdf2::cp_async4(buf(st, 0) + o, xr + t);
            if (kPerSample) tdf2::cp_async4(buf(st, 1) + o, gr + t);
          }
        }
      }
    }
    stage::cp_async_commit();
  };

  STAGE_TIME(blockIdx.x * 8);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) tdf2::mbar_init(&full[st], 1);
    stage::fence_mbarrier_init();
  }
  __syncthreads();
  // the periods of lane d: t = p D + d < S
  const int64_t lane_periods = d < s.S ? (s.S - d + s.D - 1) / s.D : 0;
  float xp = 0.0f, yp = 0.0f;  // the lane's x and y (all-pass: w) D back
  if (lane) {
    xp = hx[r * s.D + d];
    if (kMode == kComb) yp = hy[r * s.D + d];
  }
  const int ahead = s.stages - 1;  // tiles in flight ahead of the walk
  for (int i = 0; i < ahead; ++i) issue(i);
  for (int i = 0; i < s.tiles; ++i) {
    const int st = i % s.stages;
    int64_t p0, p1;
    const int kind = span_of(i, p0, p1);
    STAGE_TICK(w0);
    stage::cp_async_wait(ahead - 1);
    tdf2::mbar_wait<false>(&full[st], (i / s.stages) & 1);
    __syncthreads();  // tile i is in; the stage issue() fills is free
    STAGE_SUM(blockIdx.x * 8 + 2, w0);
    STAGE_TICK(i0);
    issue(i + ahead);
    STAGE_SUM_BY(mover, blockIdx.x * 8 + 3, i0);
    STAGE_TICK(k0);
    if (lane) {
      const int64_t first = p0 * s.D + d;
      const int np = (int)max((int64_t)0, min(p1, lane_periods) - p0);
      if (contig) {
        const int sx = skew_of(xr + p0 * s.D);
        const int sg = kPerSample ? skew_of(gr + p0 * s.D) : 0;
        walk_contig<kMode, kPerSample>(buf(st, 0) + sx + q,
                                       buf(st, 1) + sg + q, s.L, np,
                                       yr + first, gv, ng, c1, xp, yp);
      } else {
        walk_grouped<kMode, kPerSample>(buf(st, 0) + q, buf(st, 1) + q, np,
                                        s.D, d0, yr + first, gv, ng, c1, xp,
                                        yp);
      }
    }
    STAGE_SUM(blockIdx.x * 8 + 4, k0);
  }
  stage::cp_async_wait(0);
  STAGE_TIME(blockIdx.x * 8 + 1);
  if (lane) {
    const int64_t j = ((d - s.S) % s.D + s.D) % s.D;
    hx_out[r * s.D + j] = xp;
    if (kMode == kComb) hy_out[r * s.D + j] = yp;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The row seen as [M, 4 D] rows of 4 D floats, R rows (rows == 1: every
// row reads row 0), boxes of kBox rows x kRowW floats.
bool encode(CUtensorMap* m, const float* p, int64_t rs, int64_t D,
            int64_t M, int64_t rows) {
  stage::EncodeTiled fn = stage::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)(4 * D), (cuuint64_t)M,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)(4 * D) * 4,
                                 (cuuint64_t)rs * 4};
  const cuuint32_t box[3] = {kRowW, kBox, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// One carried-tail comb (mode 0) or all-pass (mode 1) over [R, S] rows with
// delay D. x, y: contiguous [R, S]. Comb: g per sample (pg non-null, row
// stride grs, time contiguous) or the value gv; tails hx, hy in and hx_out,
// hy_out out, contiguous [R, D]. All-pass: g, ng = -g and c1 = 1 - g^2 as
// values (gv, ng, c1); the w tail in hx, out hx_out (hy, hy_out unused).
// The geometry is ops/stream_kernels.py comb_plan's. One launch on
// `stream`; never synchronises; returns cudaGetLastError().
extern "C" int comb_stream(int mode, const float* x, const float* pg,
                           float gv, int64_t grs, float ng, float c1,
                           const float* hx, const float* hy, float* hx_out,
                           float* hy_out, float* y, int R, int64_t S,
                           int64_t D, void* stream_handle) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  if (R <= 0 || S <= 0 || D <= 0 || (mode != kComb && mode != kAllpass))
    return (int)cudaErrorInvalidValue;
  static bool done[stage::kMaxDevices] = {};
  const void* kernels[3] = {(const void*)comb_stream_kernel<kComb, false>,
                            (const void*)comb_stream_kernel<kComb, true>,
                            (const void*)comb_stream_kernel<kAllpass, false>};
  const int err = stage::allow_smem(done, kernels, 3, kRingBytes);
  if (err != 0) return err;
  const bool per_sample = mode == kComb && pg != nullptr;
  const bool contig = D <= kMaxContig;
  Geometry s;
  s.S = S;
  s.D = D;
  s.P = (S + D - 1) / D;
  s.L = contig ? (int)D : kGroup;
  s.groups = contig ? 1 : (int)((D + kGroup - 1) / kGroup);
  const int streams = per_sample ? 2 : 1;
  s.stages = contig ? kContigStages : kStages;
  // a contiguous tile's stage: the ring's share, in 128-byte steps
  s.stride = contig ? (kRingBytes - kAlign) / 4 / (kContigStages * streams) /
                          32 * 32
                    : kStageStride;
  s.TP = contig ? (s.stride - 3) / (int)D : 4 * kBox;
  Maps maps = {};
  const int64_t M = S / (4 * D);
  const bool by_map =
      !contig && S % 4 == 0 && M > 0 && aligned16(x) &&
      (!per_sample || (aligned16(pg) && (grs * 4) % 16 == 0)) &&
      encode(&maps.x, x, S, D, M, R) &&
      (!per_sample || encode(&maps.g, pg, grs == 0 ? S : grs, D, M,
                             grs == 0 ? 1 : R));
  s.P4 = by_map ? 4 * M : 0;
  const int64_t tma_tiles = (s.P4 + s.TP - 1) / s.TP;
  const int64_t tiles = tma_tiles + (s.P - s.P4 + s.TP - 1) / s.TP;
  if (tiles > 0x7fffffff || (int64_t)R * s.groups > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  s.tiles = (int)tiles;
  s.tma_tiles = (int)tma_tiles;
  const unsigned smem = (unsigned)(kAlign + s.stages * streams * s.stride * 4);
  const unsigned grid = (unsigned)(R * s.groups);
  const unsigned threads =
      (contig ? (unsigned)((D + 31) / 32 * 32) : kGroup) + 32;
  if (per_sample)
    comb_stream_kernel<kComb, true><<<grid, threads, smem, st>>>(
        x, pg, 0.0f, grs, 0.0f, 0.0f, hx, hy, hx_out, hy_out, y, s, maps);
  else if (mode == kComb)
    comb_stream_kernel<kComb, false><<<grid, threads, smem, st>>>(
        x, nullptr, gv, 0, 0.0f, 0.0f, hx, hy, hx_out, hy_out, y, s, maps);
  else
    comb_stream_kernel<kAllpass, false><<<grid, threads, smem, st>>>(
        x, nullptr, gv, 0, ng, c1, hx, nullptr, hx_out, nullptr, y, s, maps);
  return (int)cudaGetLastError();
}
