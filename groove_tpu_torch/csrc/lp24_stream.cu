// The stream kernels K7 and K8 for Hopper (sm_90a): the lp24 cascade with
// block-rate denominators and its state carried from call to call, single
// pass (K7) or refined (K8: solve, defect, correction scan, second chain and
// second combine per section). One launch per call computes both sections;
// nothing but x, the four denominators, the state in, y and the state out
// touches device memory.
//
// Replaces groove_tpu/ops/pallas_iir.py:
//   K7  _make_kernel_lp24_blk_state (pallas_call in _lp24_blk_state_2d)
//   K8  _make_kernel_lp24_refined_blk, state_io=True (pallas_call in
//       _lp24_refined_blk_state_2d)
// and, in this package, their earlier route through lp24.cu (6 launches for
// K7, 16 for K8, every intermediate a round trip through device memory).
//
// What bounds it on the H100. A sliced Welsh voice calls it once per
// 4096-frame segment on 8-16 rows: 0.4 MB in and out and a dependency chain
// of about 0.003 ms, both far below one kernel launch's latency. So the
// call costs what its launches and its host work cost, and the design is
// one launch with no scratch buffers. Tensor cores do not apply: the work
// is a serial 2x2 affine recurrence in float32 with a fixed rounding order,
// not a matrix product, and composing the 2x2 maps associatively (which a
// matrix formulation would need) diverges in f32 near z = 1.
//
// Design.
//   grid      one thread block per row; rows are independent, so there are
//             no clusters and no communication between blocks.
//   tiles     the block walks its row in tiles of kTile = 4096 frames (64
//             control blocks of 64). A tile is a chained call that never
//             leaves the SM: ln is pinned to 64 and each chain seeds from
//             the carried pair, so chaining tiles is bitwise one call (the
//             property the twins and the earlier route already have across
//             calls). The state between tiles (K7: 4 floats; K8: 20, the
//             layout of ops/iir_kernels.py STATE_ROWS) stays in shared
//             memory; it is read from state_in at entry and written to
//             state_out at exit. Any n that is a multiple of 64 works; the
//             last tile may be short.
//   smem      per tile: two x buffers (the one in use becomes z, section
//             A's output overwrites it to become section B's input), p11,
//             p12, q1 (the correction's shifted r1 rows overwrite q1), for
//             K8 also y0 and d; the tile's 64 block maps (M, C, S); two
//             buffers of the 4 x 64 denominators; the state. K7 87,424
//             bytes, K8 120,704 (dynamic shared memory; the attribute that
//             allows it is set when the library is loaded, see
//             lp24_stream_init).
//   layout    a tile is stored with one pad word after every 64 frames:
//             frame i lives at word i + (i >> 6). Phase 1's threads each
//             walk one 64-frame block, so at step j the 32 threads of a warp
//             touch frames 64 b + j, words 65 b + j + const: 32 consecutive
//             banks, no conflict (unpadded they would all hit one bank).
//             The fill, the combines and the defect touch 32 consecutive
//             frames of one block per warp, also 32 consecutive banks. The
//             pad breaks 16-byte alignment of the rows, so the fill uses
//             4-byte cp.async copies; a warp's copies still read 128
//             contiguous bytes of x.
//   loads     tile t + 1's x and denominators are fetched with cp.async
//             (one commit group per tile) while tile t computes, double
//             buffered; a one-tile call pays nothing for it.
//   stages    per section, separated by __syncthreads(): phase 1 by 3 x 64
//             threads (a block's two map columns and its offset are
//             independent recurrences); phase 2 by one thread walking the
//             tile's 64 maps from the carried pair; combine by all
//             threads; for K8 then the defect by all threads, the
//             correction scan by 64 threads (while another thread exports
//             the section's history edges), the second chain and the
//             second combine. Section B's last combine writes y, coalesced.
//             Inside a tile the SM's instruction rate and shared-memory
//             latency bind, not bytes: the scans and chains are lone warps
//             (kernels/stage_cycles.py prints the cycles of each stage).
// The arithmetic is the twins' (ops/iir_kernels.py _section, phase1,
// _corr_phase1, chain), operation for operation: the build is -fmad=false
// and the in-block recurrences call tdf2::step_p, tdf2::step_q and
// tdf2::corr_step with their explicit __fmaf_rn, the device functions K2-K6
// run too (tdf2::step is the first two together). The kernel takes
// the POSITIVE denominators a1, a2, each through its own strides, and
// negates in registers (exact), so the caller makes no negated copy and a
// row-broadcast coefficient (stride 0) is never materialised.

#include "tdf2.cuh"

namespace {

constexpr int kTile = 4096;                    // frames per tile
constexpr int kCB = 1 << tdf2::kCBlockShift;   // 64-frame control block
constexpr int kBlocks = kTile / kCB;           // control blocks per tile
constexpr int kTileWords = kTile + kBlocks;    // padded tile
constexpr int kStreamThreads = 512;
// after the tiles: M [64] float4, C and S [64] float2 each, the
// denominators [2][4][64], the state (32 words reserved)
constexpr int kMapWords = kBlocks * 8;
constexpr int kCoefWords = 2 * 4 * kBlocks;
constexpr int kStateWords = 32;
constexpr int kMaxDevices = 64;

constexpr int tiles_of(bool refined) { return refined ? 7 : 5; }
constexpr int smem_bytes(bool refined) {
  return (tiles_of(refined) * kTileWords + kMapWords + kCoefWords +
          kStateWords) * (int)sizeof(float);
}
constexpr int kSmemBytesK7 = 87424;
constexpr int kSmemBytesK8 = 120704;
static_assert(kTile % kCB == 0, "a tile is whole control blocks");
static_assert(smem_bytes(false) == kSmemBytesK7, "K7 shared memory");
static_assert(smem_bytes(true) == kSmemBytesK8, "K8 shared memory");
static_assert(kSmemBytesK8 <= 232448, "above a block's 227 KB");
static_assert(kStreamThreads >= 4 * kBlocks, "one thread per denominator");

// The four positive denominators (a1a, a2a, a1b, a2b), each [B, n / 64]
// read through its own row and entry strides.
struct Den {
  const float* p[4];
  int64_t rs[4];
  int64_t ts[4];
};

__device__ __forceinline__ int phys(int i) { return i + (i >> 6); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory loads are started in batches ahead of the stores that
// follow them. Every buffer here is carved from one array, so the compiler
// must assume that a store may alias any later load and cannot hoist loads
// over stores by itself; written in program order, each step of a scan
// would wait a shared-memory latency (about 30 cycles) for its own input.
constexpr int kBatch = 8;       // scan inputs loaded together
constexpr int kChainBatch = 4;  // block maps loaded together
constexpr int kPer = kTile / kStreamThreads;  // frames a thread combines
// A thread's frames in the elementwise passes are tid + u * kStreamThreads,
// u < kPer: kStreamThreads is whole control blocks, so frame u lives at
// word phys(tid) + u * kPerWords in block (tid >> 6) + u * kPerBlocks.
constexpr int kPerBlocks = kStreamThreads / kCB;
constexpr int kPerWords = kStreamThreads + kPerBlocks;
static_assert(kCB % kBatch == 0 && kTile % kStreamThreads == 0 &&
                  kStreamThreads % kCB == 0,
              "whole batches");

__device__ __forceinline__ void load_batch(const float* src,
                                           float (&v)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) v[u] = src[u];
}

// Phase 1 of one 64-frame control block, split over three threads, one for
// each of its independent recurrences (a lone warp starts an instruction
// every other cycle at best, and one thread per block would run all 17
// of a step). scan_column walks one column of the 2x2 map from (p1, p2),
// storing its shifted top entries into `prow` (p11 or p12) and leaving the
// block map's column in m1, m2.
__device__ __forceinline__ void scan_column(float* prow, int blk, float a,
                                            float b, float p1, float p2,
                                            float& m1, float& m2) {
  const int o = blk * (kCB + 1);
#pragma unroll
  for (int j = 0; j < kCB; ++j) {
    prow[o + j] = p1;
    tdf2::step_p(a, b, p1, p2);
  }
  m1 = p1;
  m2 = p2;
}

// scan_offset walks the offset Q over the block's input z, storing the
// shifted q1 row and the block-end (Q1, Q2) into c[blk].
__device__ __forceinline__ void scan_offset(const float* z, float* q1,
                                            float2* c, int blk, float a,
                                            float b) {
  const float g1 = 2.0f + a, g2 = 1.0f + b;  // (1, 2, 1): b1m, b2m
  float Q1 = 0.0f, Q2 = 0.0f;
  const int o = blk * (kCB + 1);
  float cur[kBatch], nxt[kBatch];
  load_batch(z + o, cur);
#pragma unroll
  for (int j0 = 0; j0 < kCB; j0 += kBatch) {
    if (j0 + kBatch < kCB) load_batch(z + o + j0 + kBatch, nxt);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      q1[o + j0 + u] = Q1;
      tdf2::step_q(a, b, g1 * cur[u], g2 * cur[u], Q1, Q2);
    }
    if (j0 + kBatch < kCB) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
    }
  }
  c[blk] = make_float2(Q1, Q2);
}

// The correction's r-only scan of one block over the defect d: the shifted
// r1 rows into q1 and the block-end (r1, r2) into c[blk].
__device__ __forceinline__ void corr_block(const float* d, float* q1,
                                           float2* c, int blk, float a,
                                           float b) {
  float R1 = 0.0f, R2 = 0.0f;
  const int o = blk * (kCB + 1);
  float cur[kBatch], nxt[kBatch];
  load_batch(d + o, cur);
#pragma unroll
  for (int j0 = 0; j0 < kCB; j0 += kBatch) {
    if (j0 + kBatch < kCB) load_batch(d + o + j0 + kBatch, nxt);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      q1[o + j0 + u] = R1;
      tdf2::corr_step(a, b, cur[u], R1, R2);
    }
    if (j0 + kBatch < kCB) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
    }
  }
  c[blk] = make_float2(R1, R2);
}

// Phase 2 of one tile, by one thread: S[k+1] = M[k] S[k] + C[k] from the
// carried pair at `pair`, which it leaves holding the tile's exit. The maps
// are never composed. The maps of kChainBatch steps are loaded together,
// those of the next batch before this batch's steps run, and the steps of
// a batch carry no branch: a lone thread can hide neither.
__device__ __forceinline__ void chain(const float* m, const float2* c,
                                      float2* s, int nbt, float* pair) {
  const float4* m4 = reinterpret_cast<const float4*>(m);
  float s1 = pair[0], s2 = pair[1];
  float4 mk[kChainBatch], mn[kChainBatch];
  float2 ck[kChainBatch], cn[kChainBatch];
#pragma unroll
  for (int u = 0; u < kChainBatch; ++u) {
    mk[u] = m4[u];
    ck[u] = c[u];
  }
  int k0 = 0;
  for (; k0 + kChainBatch <= nbt; k0 += kChainBatch) {
#pragma unroll
    for (int u = 0; u < kChainBatch; ++u) {  // clamped: never past the end
      int k = min(k0 + kChainBatch + u, kBlocks - 1);
      mn[u] = m4[k];
      cn[u] = c[k];
    }
#pragma unroll
    for (int u = 0; u < kChainBatch; ++u) {
      s[k0 + u] = make_float2(s1, s2);
      float n1 = mk[u].x * s1 + mk[u].y * s2 + ck[u].x;
      float n2 = mk[u].z * s1 + mk[u].w * s2 + ck[u].y;
      s1 = n1;
      s2 = n2;
    }
#pragma unroll
    for (int u = 0; u < kChainBatch; ++u) {
      mk[u] = mn[u];
      ck[u] = cn[u];
    }
  }
  for (int k = k0; k < nbt; ++k) {  // a short last tile's odd blocks
    s[k] = make_float2(s1, s2);
    float4 mm = m4[k];
    float2 cc = c[k];
    float n1 = mm.x * s1 + mm.y * s2 + cc.x;
    float n2 = mm.z * s1 + mm.w * s2 + cc.y;
    s1 = n1;
    s2 = n2;
  }
  pair[0] = s1;
  pair[1] = s2;
}

// Frames of tile t of a row of n.
__device__ __forceinline__ int tile_len(int64_t n, int t) {
  int64_t left = n - (int64_t)t * kTile;
  return left < kTile ? (int)left : kTile;
}

// Start the copy of tile t's x (row `xr`) and denominators into x buffer
// and denominator buffer t & 1, as one commit group.
__device__ __forceinline__ void fetch(const float* __restrict__ xr,
                                      const Den& den, int64_t row, int64_t n,
                                      int t, float* smem, float* coef) {
  const int tid = threadIdx.x;
  const int len = tile_len(n, t);
  const float* src = xr + (int64_t)t * kTile;
  float* zb = smem + (t & 1) * kTileWords;
  const int p0 = phys(tid);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    int i = tid + u * kStreamThreads;
    if (i < len) cp_async4(zb + p0 + u * kPerWords, src + i);
  }
  const int which = tid >> tdf2::kCBlockShift, b = tid & (kCB - 1);
  if (b < (len >> tdf2::kCBlockShift)) {
    const int64_t blk = (int64_t)t * kBlocks + b;
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // constant indices into the parameters
      if (w == which)
        cp_async4(coef + ((t & 1) * 4 + w) * kBlocks + b,
                  den.p[w] + row * den.rs[w] + blk * den.ts[w]);
    }
  }
  cp_async_commit();
}

template <bool kRefined>
__global__ void __launch_bounds__(kStreamThreads, 1)
    stream_kernel(const float* __restrict__ x, Den den,
                  const float* __restrict__ state_in,
                  float* __restrict__ state_out, float* __restrict__ y,
                  int64_t n) {
  extern __shared__ __align__(16) float smem[];
  // smem + {0, 1} * kTileWords: the two x buffers
  float* p11 = smem + 2 * kTileWords;
  float* p12 = smem + 3 * kTileWords;
  float* q1 = smem + 4 * kTileWords;
  float* y0 = smem + 5 * kTileWords;  // K8 only
  float* d = smem + 6 * kTileWords;   // K8 only
  float* tail = smem + (kRefined ? 7 : 5) * kTileWords;  // tiles_of()
  float* m = tail;  // [64][4]: m11, m12, m21, m22
  float2* c = reinterpret_cast<float2*>(tail + kBlocks * 4);
  float2* s = reinterpret_cast<float2*>(tail + kBlocks * 6);
  float* coef = tail + kMapWords;
  float* st = coef + kCoefWords;

  constexpr int kRows = kRefined ? 20 : 4;  // state words per row
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * n;
  float* yr = y + row * n;
  const int ntiles = (int)((n + kTile - 1) / kTile);
  const int p0 = phys(tid), blk0 = tid >> tdf2::kCBlockShift;
  // the defect's lags 1 and 2: words back from a frame (one more across a
  // block's pad word) and blocks back for the shifted denominators
  const int in_blk = tid & (kCB - 1);
  const int w1 = in_blk >= 1 ? 1 : 2, w2 = in_blk >= 2 ? 2 : 3;
  const int b1 = in_blk >= 1 ? 0 : 1, b2 = in_blk >= 2 ? 0 : 1;

  fetch(xr, den, row, n, 0, smem, coef);
  if (tid < kRows) st[tid] = state_in[row * kRows + tid];

  for (int t = 0; t < ntiles; ++t) {
    const int len = tile_len(n, t);
    const int nbt = len >> tdf2::kCBlockShift;
    if (t + 1 < ntiles) {
      fetch(xr, den, row, n, t + 1, smem, coef);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* z = smem + (t & 1) * kTileWords;
    for (int sec = 0; sec < 2; ++sec) {
      const float* a1 = coef + (t & 1) * 4 * kBlocks + sec * 2 * kBlocks;
      const float* a2 = a1 + kBlocks;
      float* sst = st + sec * (kRows / 2);  // this section's state rows
      float* out = sec == 1 ? yr + (int64_t)t * kTile : nullptr;

      // phase 1: shifted prefix rows and the block maps
      {
        const int part = tid >> tdf2::kCBlockShift, blk = tid & (kCB - 1);
        if (part < 3 && blk < nbt) {
          const float a = -a1[blk], b = -a2[blk];
          float* mb = m + 4 * blk;
          if (part == 0) {
            scan_column(p11, blk, a, b, 1.0f, 0.0f, mb[0], mb[2]);
          } else if (part == 1) {
            scan_column(p12, blk, a, b, 0.0f, 1.0f, mb[1], mb[3]);
          } else {
            scan_offset(z, q1, c, blk, a, b);
          }
        }
      }
      __syncthreads();
      if (tid == 0) chain(m, c, s, nbt, sst);
      __syncthreads();
      // combine: y0 = z + ((p11 S1 + p12 S2) + q1)
      float o[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        int i = tid + u * kStreamThreads;
        if (i < len) {
          int pi = p0 + u * kPerWords;
          float2 S = s[blk0 + u * kPerBlocks];
          float v = p11[pi] * S.x + p12[pi] * S.y + q1[pi];
          o[u] = z[pi] + v;
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        int i = tid + u * kStreamThreads;
        if (i < len) {
          if constexpr (kRefined) {
            y0[p0 + u * kPerWords] = o[u];
          } else if (out != nullptr) {
            out[i] = o[u];
          } else {
            z[p0 + u * kPerWords] = o[u];
          }
        }
      }
      __syncthreads();
      if constexpr (kRefined) {
        // defect of the solve, with the carried history before frame 0:
        // h = z1, z2, y1, y2, na1, na2 of the previous tile or call
        const float* h = sst + 4;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          int i = tid + u * kStreamThreads;
          if (i < len) {
            int pi = p0 + u * kPerWords, blk = blk0 + u * kPerBlocks;
            float z1, z2, y1, y2, a1s, a2s;
            if (u == 0 && tid < 2) {  // frames 0 and 1 reach into h
              z1 = tid == 1 ? z[0] : h[0];
              z2 = tid == 1 ? h[0] : h[1];
              y1 = tid == 1 ? y0[0] : h[2];
              y2 = tid == 1 ? h[2] : h[3];
              a1s = tid == 1 ? -a1[0] : h[4];
              a2s = h[5];
            } else {
              z1 = z[pi - w1];
              z2 = z[pi - w2];
              y1 = y0[pi - w1];
              y2 = y0[pi - w2];
              a1s = -a1[blk - b1];
              a2s = -a2[blk - b2];
            }
            o[u] = tdf2::lp24_defect(z[pi], z1, z2, y0[pi], y1, y2, a1s,
                                     a2s);
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          int i = tid + u * kStreamThreads;
          if (i < len) d[p0 + u * kPerWords] = o[u];
        }
        __syncthreads();
        // correction scan (the maps are the solve's); meanwhile one other
        // thread exports this section's history edges: nothing reads them
        // again in this tile, and z and y0 are not written in this stage
        if (tid < nbt) {
          corr_block(d, q1, c, tid, -a1[tid], -a2[tid]);
        } else if (tid == kStreamThreads - 1) {
          float* e = sst + 4;
          e[0] = z[phys(len - 1)];
          e[1] = z[phys(len - 2)];
          e[2] = y0[phys(len - 1)];
          e[3] = y0[phys(len - 2)];
          e[4] = -a1[nbt - 1];
          e[5] = -a2[nbt - 1];
        }
        __syncthreads();
        if (tid == 0) chain(m, c, s, nbt, sst + 2);
        __syncthreads();
        // second combine: y = y0 + (((d + p11 S1) + p12 S2) + q1)
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          int i = tid + u * kStreamThreads;
          if (i < len) {
            int pi = p0 + u * kPerWords;
            float2 S = s[blk0 + u * kPerBlocks];
            float v = d[pi] + p11[pi] * S.x + p12[pi] * S.y + q1[pi];
            o[u] = y0[pi] + v;
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          int i = tid + u * kStreamThreads;
          if (i < len) {
            if (out != nullptr) {
              out[i] = o[u];
            } else {
              z[p0 + u * kPerWords] = o[u];
            }
          }
        }
        __syncthreads();
      }
    }
  }
  if (tid < kRows) state_out[row * kRows + tid] = st[tid];
}

__global__ void empty_kernel() {}

// Allow the kernels their dynamic shared memory on the current device, once
// per device.
int allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(stream_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytesK7);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stream_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytesK8);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

}  // namespace

// Called once when the library is loaded: checks that the loader's idea of
// the kernels' shared memory (ops/iir_kernels.py stream_smem_bytes) is this
// file's, and sets the attribute that allows it on the current device, so
// that no call does (a call on another device of the process sets it there
// the first time).
extern "C" int lp24_stream_init(int k7_bytes, int k8_bytes) {
  if (k7_bytes != kSmemBytesK7 || k8_bytes != kSmemBytesK8)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem();
  return err != 0 ? err : (int)cudaGetLastError();
}

// One stream-cascade call over [B, n] rows, n a multiple of 64: K7
// (refined = 0, state [B, 4]) or K8 (refined = 1, state [B, 20]). x and y
// are contiguous [B, n]; the positive denominators a1a, a2a, a1b, a2b are
// [B, n / 64] arrays read through their own row and entry strides (rs*,
// ts*, in elements; 0 broadcasts); state_in and state_out are distinct
// contiguous buffers. One launch on `stream`; never synchronises, allocates
// nothing, and returns cudaGetLastError().
extern "C" int lp24_stream(int refined, const float* x, const float* a1a,
                           const float* a2a, const float* a1b,
                           const float* a2b, int64_t rs_a1a, int64_t ts_a1a,
                           int64_t rs_a2a, int64_t ts_a2a, int64_t rs_a1b,
                           int64_t ts_a1b, int64_t rs_a2b, int64_t ts_a2b,
                           const float* state_in, float* state_out, float* y,
                           int B, int64_t n, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (B <= 0 || n <= 0 || n % kCB != 0) return (int)cudaErrorInvalidValue;
  int err = allow_smem();
  if (err != 0) return err;
  const Den den = {{a1a, a2a, a1b, a2b},
                   {rs_a1a, rs_a2a, rs_a1b, rs_a2b},
                   {ts_a1a, ts_a2a, ts_a1b, ts_a2b}};
  if (refined) {
    stream_kernel<true><<<B, kStreamThreads, kSmemBytesK8, stream>>>(
        x, den, state_in, state_out, y, n);
  } else {
    stream_kernel<false><<<B, kStreamThreads, kSmemBytesK7, stream>>>(
        x, den, state_in, state_out, y, n);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched the same way (one block on `stream`): the floor
// under any one-launch call's time.
extern "C" int launch_floor(void* stream_handle) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_handle)>>>();
  return (int)cudaGetLastError();
}
