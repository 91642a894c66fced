"""lp24 cascade kernels K2, K3, K6, K7 and K8 (port of the lp24 family of
groove_tpu/ops/pallas_iir.py), and the pieces every TDF2 kernel twin
shares (ops/biquad_kernels.py uses them too). K7 and K8 are K3 and K2
with their state carried from call to call (STATE_ROWS): ln is pinned to
64 and n must be a multiple of 64, so that chained calls are bitwise one
long call. On a card each is one launch of csrc/lp24_stream.cu, which
walks a row in shared-memory tiles (chained calls that never leave the
SM); their wrappers check, allocate the two outputs and launch.

The cascade is two TDF2 sections with numerators (1, 2, 1). K3 and K2
hold the denominators for each 64-frame control block; K6 reads them per
sample (static cascades pass two scalars). Each section runs the
two-level serial scheme of the reference (never associative doubling of
the 2x2 maps, which diverges in f32 near z = 1):

  phase 1  in-block prefix maps: per row and per ln-sample block, a serial
           scan over ln samples storing the SHIFTED prefix rows p11, p12,
           q1 (identity at j = 0) and the whole-block map (M, C);
  phase 2  cross-block entry states: the serial chain
           S[k+1] = M[k] S[k] + C[k] per row over all blocks;
  combine  y = b0 x + ((p11 S1 + p12 S2) + q1), b0 = 1 here.

K2 (the refined cascade) adds, per section, the defect of the solve
against the shifted-coefficient TDF2 recurrence in its epsilon-regrouped
form, and an r-only correction scan that reuses the solve's p11/p12.

On a card K2, K3 and K6 run on shared-memory tiles (csrc/tiled.cuh
through csrc/lp24.cu's lp24_refined_tiled and lp24_tiled): nine launches
for K2 and five for K3 and K6 (per segment of a long row, whose chains
then run as a wavefront along time) that keep no prefix row, solve or
defect array in device memory, from a wrapper that checks, allocates y,
the first section's output and one scratch buffer, and launches. K6's
per-sample denominators are staged beside the tile (a ring of coefficient
chunks); static ones are passed by value.

Each kernel has its plain torch twin here, written in the same operation
order: the CPU runs the twin, a CUDA tensor runs the kernel
(csrc/lp24.cu, csrc/lp24_stream.cu, csrc/tiled.cuh, csrc/tdf2.cuh), and
LAUNCHES counts kernel launches. Every
multiply and add rounds separately except the in-block scans'
recurrences, which use one correctly rounded fused multiply-add per map
entry (fma32 here, __fmaf_rn in the kernel): near z = 1 the unfused
prefix products lost 12 dB against the f64 reference on the north-star
analogue (measured on the CPU), where XLA's contracted evaluation of the
reference kernels does not. ln is max(block_for(n, 128), 64) for the
block-rate kernels and block_for(n, 128) for K6, as in the reference
kernels, so both group the recurrence identically.

Coefficient streams (csrc/tdf2.cuh): SCALAR (one value per call, passed
by value), BLOCK (one per 64-frame block) or SAMPLE (one per sample),
the latter two read through the strides of a [rows, count] view, so a
broadcast coefficient is never materialised on the card. Past `count` a
coefficient reads as 0, as in the reference's zero-padded tiles.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

CBLOCK = 64
SCALAR, BLOCK, SAMPLE = 0, 1, 2  # tdf2::Mode

# kernel launches per wrapper (one per call of the C entry point)
LAUNCHES = {"lp24": 0, "lp24_refined": 0, "lp24_cascade": 0,
            "lp24_stream": 0, "lp24_refined_stream": 0}


def geometry(n: int, blockrate: bool = True) -> tuple[int, int, int]:
    """(ln, nb, npad): in-block length, number of ln-blocks, padded n.
    ln = block_for(n, 128), at least CBLOCK for block-rate kernels."""
    from groove_tpu_torch.ops.iir import block_for

    ln = block_for(n, max_block=128)
    if blockrate:
        ln = max(ln, CBLOCK)
    nb = -(-n // ln)
    return ln, nb, nb * ln


def is_scalar(c) -> bool:
    """A static coefficient: a Python number, numpy scalar or 0-dim
    array or tensor."""
    return np.ndim(c) == 0 if not torch.is_tensor(c) else c.dim() == 0


def scalar32(c) -> np.float32:
    return np.float32(c.item() if torch.is_tensor(c) else c)


def as_f32(c, device) -> torch.Tensor:
    """A coefficient as a float32 tensor on `device`. A scalar becomes a
    0-dim tensor by a fill, not a host-to-device copy, which would wait
    for the device's queue."""
    if torch.is_tensor(c):
        return c.to(device=device, dtype=torch.float32)
    if np.ndim(c) == 0:
        return torch.full((), float(np.float32(c)), dtype=torch.float32,
                          device=device)
    return torch.as_tensor(np.asarray(c, np.float32), device=device)


def rows_view(c, shape, device) -> torch.Tensor:
    """A coefficient broadcast to `shape` ([..., count]) as a float32
    [rows, count] view on `device` (no copy where strides allow)."""
    return as_f32(c, device).expand(shape).reshape(-1, shape[-1])


class Streams:
    """The coefficient streams of one kernel call: mode, the arrays
    (BLOCK/SAMPLE) or values (SCALAR), and the one layout (row stride,
    entry stride, count) the kernel reads every array through."""

    def __init__(self, mode: int, coefs: list, count: int):
        self.mode = mode
        self.count = count
        if mode == SCALAR:
            self.values = [float(scalar32(c)) for c in coefs]
            self.arrays = [None] * len(coefs)
            self.layout = (0, 0, 1)
            return
        if len({t.stride() for t in coefs}) != 1:
            coefs = [t.contiguous() for t in coefs]
        self.values = [0.0] * len(coefs)
        self.arrays = coefs
        self.layout = (*coefs[0].stride(), count)

    def check(self, x2: torch.Tensor, what: str) -> None:
        B = x2.shape[0]
        for t in self.arrays:
            if t is None:
                continue
            if not (t.is_cuda and t.dtype == torch.float32
                    and t.device == x2.device):
                raise ValueError(f"{what}: coefficients must be float32 on "
                                 f"{x2.device}")
            if tuple(t.shape) != (B, self.count):
                raise ValueError(f"{what}: coefficients {tuple(t.shape)} "
                                 f"!= {(B, self.count)}")

    def per_sample(self, B: int, npad: int, device) -> list:
        """The twins' form: every stream as a [B, npad] tensor, as the
        kernel reads it at each padded sample."""
        out = []
        for v, t in zip(self.values, self.arrays):
            if self.mode == SCALAR:
                out.append(torch.full((B, npad), v, dtype=torch.float32,
                                      device=device))
            elif self.mode == BLOCK:
                out.append(_per_sample(t, npad))
            else:
                out.append(torch.nn.functional.pad(t, (0, npad - self.count)))
        return out


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def raw_stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, without building a
    torch.cuda.Stream object around it (a stream kernel's call is a few
    tens of microseconds of host work in all)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(raw_stream(t.device))


def check_input(x2: torch.Tensor, what: str) -> None:
    if not (x2.is_cuda and x2.dtype == torch.float32
            and x2.is_contiguous()):
        raise ValueError(f"{what}: input must be contiguous float32 on a "
                         "CUDA device")


def dispatch(x2: torch.Tensor, plain, launch, key: str, counts: dict,
             what: str) -> torch.Tensor:
    """The wrappers' device rule: the twin for a CPU tensor, the kernel
    (counted) for a CUDA tensor, an error otherwise — no fallback."""
    if x2.device.type == "cpu":
        return plain()
    if x2.device.type == "cuda":
        y = launch()
        counts[key] += 1
        return y
    raise RuntimeError(f"{what}: unsupported device {x2.device}")


# --------------------------------------------------------------------------
# Block-rate cascades K3 and K2


def _denoms(sections_b, rows: int, nb64: int):
    """Negated denominators (na1, na2) of both sections as contiguous
    [rows, nb64] f32 tensors: (na1a, na2a, na1b, na2b)."""
    out = []
    for sec in sections_b:
        for c in (sec[3], sec[4]):
            out.append((-c).reshape(rows, nb64).contiguous())
    return tuple(out)


def _prepare(x: torch.Tensor, sections_b, cblock: int):
    if cblock != CBLOCK:
        raise ValueError(f"lp24 kernels take cblock {CBLOCK}, got {cblock}")
    if x.dtype != torch.float32:
        raise TypeError(f"lp24 kernels take float32, got {x.dtype}")
    n = x.shape[-1]
    nb64 = -(-n // cblock)
    cshape = x.shape[:-1] + (nb64,)
    sections_b = [tuple(as_f32(c, x.device).expand(cshape) for c in sec)
                  for sec in sections_b]
    x2 = x.reshape(-1, n).contiguous()
    return x2, _denoms(sections_b, x2.shape[0], nb64)


def lp24_blockrate(x: torch.Tensor, sections_b,
                   cblock: int = CBLOCK) -> torch.Tensor:
    """K3: fused single-pass lp24 cascade over [..., n] with block-rate
    sections (the reference's lp24_blockrate_pallas). On a card the
    kernels read the sections' denominators as they are given
    (block_views), so the call makes no torch operation on x or the
    coefficients."""
    if cblock != CBLOCK:
        raise ValueError(f"lp24 kernels take cblock {CBLOCK}, got {cblock}")
    x2, den = block_views(x, [sec[i] for sec in sections_b for i in (3, 4)],
                          "lp24 kernels")
    y = dispatch(x2, lambda: _twin(x, sections_b, refined=False),
                 lambda: _launch_lp24_tiled(x2, geometry(x2.shape[1])[0],
                                            den=den),
                 "lp24", LAUNCHES, "lp24 kernel")
    return y.reshape(x.shape)


def lp24_refined_blockrate(x: torch.Tensor, sections_b,
                           cblock: int = CBLOCK) -> torch.Tensor:
    """K2: fused refined lp24 cascade (solve + defect + correction per
    section) over [..., n] (the reference's
    lp24_refined_blockrate_pallas). On a card the kernels read the
    sections' denominators as they are given (block_views), so the call
    makes no torch operation on x or the coefficients."""
    if cblock != CBLOCK:
        raise ValueError(f"lp24 kernels take cblock {CBLOCK}, got {cblock}")
    x2, den = block_views(x, [sec[i] for sec in sections_b for i in (3, 4)],
                          "lp24 kernels")
    y = dispatch(x2, lambda: _twin(x, sections_b, refined=True),
                 lambda: _launch_refined_tiled(x2, den),
                 "lp24_refined", LAUNCHES, "lp24 kernel")
    return y.reshape(x.shape)


def _twin(x: torch.Tensor, sections_b, refined: bool) -> torch.Tensor:
    x2, den = _prepare(x, sections_b, CBLOCK)
    return _blockrate_plain(x2, den, refined)


def _refined_earlier(x: torch.Tensor, sections_b) -> torch.Tensor:
    """K2's earlier route on a card: csrc/lp24.cu's multi-launch
    lp24_cascade with its padded copy of x and its six [B, npad] scratch
    arrays. On no render path and not counted: the yardstick the tiled
    kernels are timed and compared against."""
    x2, den = _prepare(x, sections_b, CBLOCK)
    y = _launch(True, x2, Streams(BLOCK, list(den), den[0].shape[1]),
                geometry(x2.shape[1])[0])
    return y.reshape(x.shape)


def _cascade_earlier(x: torch.Tensor, sections,
                     blockrate: bool) -> torch.Tensor:
    """K3's (blockrate) or K6's earlier route on a card: csrc/lp24.cu's
    multi-launch lp24_cascade with its negated denominators (K6: static
    ones by value, per-sample ones as SAMPLE streams), its padded copy of
    x and its four [B, npad] scratch arrays. On no path and not counted:
    the yardstick lp24_tiled is timed and compared against."""
    if blockrate:
        x2, den = _prepare(x, sections, CBLOCK)
        st = Streams(BLOCK, list(den), den[0].shape[1])
    else:
        x2, st = _prepare_cascade(x, sections)
    y = _launch(False, x2, st, geometry(x2.shape[1], blockrate)[0])
    return y.reshape(x.shape)


# csrc/tiled.cuh stages TILED_SLOTS consecutive ln-blocks of a row per
# thread block, one thread per ln-block; a per-sample walk stages each
# coefficient stream in a ring of two stages of RING_CHUNKS 16-byte chunks
# per slot.
TILED_SLOTS = 128
RING_CHUNKS = 2


def tiled_smem_bytes(ln: int, streams: int = 0) -> int:
    """Dynamic shared memory of one block of a tiled kernel: the tile
    (TILED_SLOTS blocks of ln floats), one float4 of edges per slot and,
    for a per-sample walk, the ring of its `streams` coefficient streams
    (K9: 5; per-sample K6: 4, both sections' in the combine that runs
    both)."""
    ring = streams * 2 * RING_CHUNKS * TILED_SLOTS * 16
    return 4 * (TILED_SLOTS * ln + 4 * TILED_SLOTS) + ring


def tiled_buffers(x2: torch.Tensor, ln: int, outputs: int, pairs: int,
                  carries: int = 0):
    """What a tiled kernel call allocates, and nothing else touches a
    tensor: `outputs` arrays like x2 [B, n] (y; K2's first section's
    output too) and ONE scratch buffer of 16 + 8 * pairs bytes per
    ln-block, carved into the block maps m [B, nb, 4] (first, so 16-byte
    aligned) and `pairs` arrays [B, nb, 2] (c, s; K2's second s, r and
    sc), then `carries` arrays [B, 2] (the states K2's chains hand from
    segment to segment). Returns (outputs, scratch, pointers into it).
    Device-independent."""
    B, n = x2.shape
    blocks = B * -(-n // ln)
    outs = [torch.empty_like(x2) for _ in range(outputs)]
    scratch = torch.empty((4 + 2 * pairs) * blocks + 2 * B * carries,
                          dtype=torch.float32, device=x2.device)
    base = scratch.data_ptr()
    ptrs = [base] + [base + (16 + 8 * i) * blocks for i in range(pairs)]
    if carries:
        ptrs.append(base + (16 + 8 * pairs) * blocks)
    return outs, scratch, ptrs


def rows_of(x: torch.Tensor, what: str) -> torch.Tensor:
    """x as contiguous float32 [B, n] rows; free (x itself) for a
    contiguous 2-D float32 tensor."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what} take float32, got {x.dtype}")
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    return x2 if x2.is_contiguous() else x2.contiguous()


def block_views(x: torch.Tensor, coefs, what: str,
                per_sample: bool = False):
    """What a tiled or stream kernel call needs of its arguments: x as
    contiguous [B, n], and each block-rate coefficient as a float32
    [B, ceil(n / 64)] view (per_sample: each per-sample one as a [B, n]
    view) of whatever strides on x's device (the kernels read every stream
    through its own; a broadcast stays stride 0). Device-independent, and
    free for contiguous or expanded float32 tensors of those shapes on x's
    device: every torch operation here is behind a check that found it
    necessary."""
    f32, dev = torch.float32, x.device
    x2 = rows_of(x, what)
    n = x2.shape[1]
    want = (x2.shape[0], n if per_sample else -(-n // CBLOCK))
    views = []
    for c in coefs:
        if not (isinstance(c, torch.Tensor) and c.dtype == f32
                and c.device == dev):
            c = as_f32(c, dev)
        if c.shape != want:
            c = c.expand(x.shape[:-1] + want[1:]).reshape(want)
        views.append(c)
    return x2, views


def strides_of(views) -> ctypes.Array:
    """(row stride, entry stride) of every view, in elements, as the C
    entry points of the tiled kernels take them."""
    flat = [s for v in views for s in v.stride()]
    return (ctypes.c_int64 * len(flat))(*flat)


def _launch_refined_tiled(x2: torch.Tensor, den) -> torch.Tensor:
    """Run csrc/lp24.cu's lp24_refined_tiled on [B, n] CUDA inputs and the
    four positive denominators [B, ceil(n / 64)]: three allocations, no
    copy, no synchronisation, so a call can be captured in a CUDA graph.
    Raises on a refused launch."""
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "lp24 kernel")
    B, n = x2.shape
    ln = geometry(n)[0]
    (y, ya), _scratch, ptrs = tiled_buffers(x2, ln, outputs=2, pairs=5,
                                            carries=4)
    err = library().lp24_refined_tiled(
        x2.data_ptr(), *(d.data_ptr() for d in den), strides_of(den),
        den[0].shape[1], y.data_ptr(), ya.data_ptr(), *ptrs, B, n, ln,
        raw_stream(x2.device))
    if err:
        raise RuntimeError(f"lp24 kernel launch failed: CUDA error {err}")
    return y


def _launch_lp24_tiled(x2: torch.Tensor, ln: int, den=None, values=None,
                       mode: int = BLOCK) -> torch.Tensor:
    """Run csrc/lp24.cu's lp24_tiled on [B, n] CUDA inputs: the four
    positive denominators `den` in `mode` (K3: BLOCK, [B, ceil(n / 64)];
    K6: SAMPLE, [B, n]), or K6 with the four positive static denominators
    `values`. Three allocations, no copy, no synchronisation, so a call can
    be captured in a CUDA graph. Raises on a refused launch."""
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "lp24 kernel")
    B, n = x2.shape
    (y, ya), _scratch, ptrs = tiled_buffers(x2, ln, outputs=2, pairs=2,
                                            carries=2)
    if den is None:
        mode, arrays, strides, count = SCALAR, [None] * 4, None, 1
    else:
        arrays, strides, count = den, strides_of(den), den[0].shape[1]
        values = [0.0] * 4
    err = library().lp24_tiled(
        mode, x2.data_ptr(), *(ptr(a) for a in arrays), strides, count,
        *values, y.data_ptr(), ya.data_ptr(), *ptrs, B, n, ln,
        raw_stream(x2.device))
    if err:
        raise RuntimeError(f"lp24 kernel launch failed: CUDA error {err}")
    return y


# --------------------------------------------------------------------------
# K6: per-sample (or static) denominators


def _prepare_cascade(x: torch.Tensor, sections):
    """x2 [B, n] and the negated denominators of both sections as Streams
    (SCALAR when all four are static, else SAMPLE views of x's shape)."""
    x2 = rows_of(x, "lp24 kernels")
    dens = [sec[i] for sec in sections for i in (3, 4)]
    if all(is_scalar(c) for c in dens):
        return x2, Streams(SCALAR, [-scalar32(c) for c in dens], 1)
    views = [rows_view(-as_f32(c, x.device), x.shape, x.device)
             for c in dens]
    return x2, Streams(SAMPLE, views, x2.shape[1])


def lp24_cascade(x: torch.Tensor, sections) -> torch.Tensor:
    """K6: fused single-pass lp24 cascade over [..., n] whose sections'
    denominators are per-sample arrays broadcastable to x.shape, or
    scalars (the reference's lp24_cascade_pallas). Only the denominators
    reach the kernel: the numerators are filters004's constant (1, 2, 1).
    On a card both forms run csrc/lp24.cu's lp24_tiled: static
    denominators (every render path's) by value, per-sample ones as the
    caller holds them (block_views per sample: strided [B, n] views, a
    broadcast stays stride 0), so the call makes no torch operation on x
    or on coefficients of that form."""
    dens = [sec[i] for sec in sections for i in (3, 4)]
    if all(is_scalar(c) for c in dens):
        x2 = rows_of(x, "lp24 kernels")
        args = dict(values=[scalar32(c) for c in dens])
    else:
        x2, den = block_views(x, dens, "lp24 kernels", per_sample=True)
        args = dict(den=den, mode=SAMPLE)
    ln = geometry(x2.shape[1], blockrate=False)[0]
    launch = lambda: _launch_lp24_tiled(x2, ln, **args)  # noqa: E731
    y = dispatch(x2, lambda: _lp24_cascade_plain(
        *_prepare_cascade(x, sections)), launch, "lp24_cascade", LAUNCHES,
        "lp24 kernel")
    return y.reshape(x.shape)


def lp24_cascade_plain(x: torch.Tensor, sections) -> torch.Tensor:
    """K6's plain twin on x's device, whatever the device."""
    x2, st = _prepare_cascade(x, sections)
    return _lp24_cascade_plain(x2, st).reshape(x.shape)


def _lp24_cascade_plain(x2, st: Streams) -> torch.Tensor:
    B, n = x2.shape
    ln, _, npad = geometry(n, blockrate=False)
    return _cascade_plain(x2, st.per_sample(B, npad, x2.device), ln,
                          refined=False)


def _launch(refined: bool, x2: torch.Tensor, st: Streams, ln: int,
            state: torch.Tensor | None = None):
    """Run csrc/lp24.cu's lp24_cascade on [B, n] CUDA inputs. Allocates
    the output, the exported state (for a carried `state`) and every
    scratch buffer; raises on a refused launch. Returns y, or (y, state')
    for the stream kernels."""
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "lp24 kernel")
    st.check(x2, "lp24 kernel")
    B, n = x2.shape
    nb = -(-n // ln)
    npad = nb * ln
    f32 = dict(dtype=torch.float32, device=x2.device)
    xp = torch.nn.functional.pad(x2, (0, npad - n))
    y = torch.empty((B, n), **f32)
    full = [torch.empty((B, npad), **f32) for _ in range(6 if refined else 4)]
    m = torch.empty((B, nb, 4), **f32)
    c = torch.empty((B, nb, 2), **f32)
    s = torch.empty((B, nb, 2), **f32)
    p11, p12, q1, ya = full[:4]
    y0, d = (full[4], full[5]) if refined else (None, None)
    state_out = None
    if state is not None:
        check_input(state, "lp24 stream kernel state")
        state_out = torch.empty_like(state)
    err = library().lp24_cascade(
        int(refined), st.mode, ptr(xp), *(ptr(t) for t in st.arrays),
        *st.values, *st.layout, ptr(state), ptr(state_out), ptr(y),
        ptr(p11), ptr(p12), ptr(q1), ptr(ya), ptr(y0), ptr(d), ptr(m),
        ptr(c), ptr(s), B, n, npad, ln, stream_of(x2))
    if err:
        raise RuntimeError(f"lp24 kernel launch failed: CUDA error {err}")
    return y if state is None else (y, state_out)


# --------------------------------------------------------------------------
# K7 and K8: the block-rate cascades with carried state (sliced Welsh)

# Carried state rows per kernel. K7 [B, 4]: (s1a, s2a, s1b, s2b), each
# section's solve pair. K8 [B, 20]: per section (A at 0, B at 10) the solve
# pair, the correction pair, the section input z at lags 1 and 2, the
# solve y0 at lags 1 and 2, and the last block's na1 and na2 — the
# reference's layouts (pallas_iir._make_kernel_lp24_refined_blk), so a
# state moves between the packages unchanged.
STATE_ROWS = {"lp24_stream": 4, "lp24_refined_stream": 20}

# csrc/lp24_stream.cu walks a row in tiles of STREAM_TILE frames that live
# in shared memory, each stored with one pad word per control block.
STREAM_TILE = 4096


def stream_smem_bytes(refined: bool) -> int:
    """Dynamic shared memory of one block of the stream kernel: 5 padded
    tiles for K7 (two x buffers, p11, p12, q1), 7 for K8 (y0 and d too),
    then a tile's block maps (M 4, C 2, S 2 words per control block), two
    buffers of the four denominators, and 32 words for the state. The
    loader hands these numbers to the library, which refuses any other."""
    blocks = STREAM_TILE // CBLOCK
    words = ((7 if refined else 5) * (STREAM_TILE + blocks) + 8 * blocks
             + 2 * 4 * blocks + 32)
    return 4 * words


def stream_args(x: torch.Tensor, sections_b, state, rows: int):
    """What a stream kernel call needs, from what the wrappers are given:
    x as contiguous [B, n], the POSITIVE denominators (a1a, a2a, a1b, a2b)
    as float32 [B, n / 64] views of whatever strides (the kernel reads
    each through its own; a row broadcast stays stride 0), and the state
    as contiguous float32 [B, rows]. Device-independent, and free for the
    arguments the sliced render passes (contiguous float32 tensors of
    those shapes on x's device): every torch operation here is behind a
    check that found it necessary."""
    f32, dev = torch.float32, x.device
    n = x.shape[-1]
    if n % CBLOCK or n == 0:
        raise ValueError(
            f"stateful stream kernel needs n % {CBLOCK} == 0, got {n} "
            "(exported state would include padded samples)")
    x2, den = block_views(x, [sec[i] for sec in sections_b for i in (3, 4)],
                          "lp24 kernels")
    want = (x2.shape[0], n // CBLOCK)
    st = state
    if not (isinstance(st, torch.Tensor) and st.dtype == f32
            and st.device == dev):
        st = torch.as_tensor(st).to(device=dev, dtype=f32)
    if st.shape != (want[0], rows):
        st = st.reshape(want[0], rows)
    if not st.is_contiguous():
        st = st.contiguous()
    return x2, den, st


def _launch_stream(refined: bool, x2, den, st):
    """One launch of csrc/lp24_stream.cu on prepared CUDA arguments: two
    allocations (y and the exported state), no copy, no synchronisation,
    so a call can be captured in a CUDA graph. Raises on a refused
    launch."""
    from groove_tpu_torch.kernels.build import library

    y = torch.empty_like(x2)
    st2 = torch.empty_like(st)
    a1a, a2a, a1b, a2b = den
    err = library().lp24_stream(
        refined, x2.data_ptr(), a1a.data_ptr(), a2a.data_ptr(),
        a1b.data_ptr(), a2b.data_ptr(), *a1a.stride(), *a2a.stride(),
        *a1b.stride(), *a2b.stride(), st.data_ptr(), st2.data_ptr(),
        y.data_ptr(), x2.shape[0], x2.shape[1], raw_stream(x2.device))
    if err:
        raise RuntimeError(
            f"lp24 stream kernel launch failed: CUDA error {err}")
    return y, st2


def _stream(refined: bool, key: str, x, sections_b, state):
    rows = STATE_ROWS[key]
    x2, den, st = stream_args(x, sections_b, state, rows)
    y, st2 = dispatch(
        x2, lambda: _stream_plain(refined, x2, [-d for d in den], st),
        lambda: _launch_stream(refined, x2, den, st),
        key, LAUNCHES, "lp24 stream kernel")
    if x.dim() != 2:
        y = y.reshape(x.shape)
        st2 = st2.reshape(x.shape[:-1] + (rows,))
    return y, st2


def lp24_blockrate_stream(x: torch.Tensor, sections_b,
                          state) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: K3 over [..., n] (n a multiple of 64) with the TDF2 state
    [..., 4] carried in and out (the reference's
    lp24_blockrate_stream_pallas). ln is pinned to 64, so chaining calls
    through the state is bitwise one long call. Returns (y, state')."""
    return _stream(False, "lp24_stream", x, sections_b, state)


def lp24_refined_blockrate_stream(x: torch.Tensor, sections_b,
                                  state) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """K8: K2 over [..., n] (n a multiple of 64) with the state [..., 20]
    carried in and out (the reference's
    lp24_refined_blockrate_stream_pallas; zeros to start). Returns
    (y, state')."""
    return _stream(True, "lp24_refined_stream", x, sections_b, state)


def _stream_earlier(refined: bool, x: torch.Tensor, sections_b, state):
    """The stream cascades' earlier route on a card: csrc/lp24.cu's
    multi-launch lp24_cascade with state_in/state_out, its negated
    contiguous denominators and its scratch buffers. On no render path
    and not counted: the yardstick csrc/lp24_stream.cu is timed and
    compared against. Returns (y, state') as [B, n] and [B, rows]."""
    x2, den, st = stream_args(x, sections_b, state, 20 if refined else 4)
    neg = [(-d).contiguous() for d in den]
    return _launch(refined, x2, Streams(BLOCK, neg, neg[0].shape[1]), CBLOCK,
                   st)


def launch_floor(device) -> None:
    """Launch csrc/lp24_stream.cu's empty kernel on `device`'s current
    stream, as the wrappers launch theirs: the floor under a one-launch
    call's time."""
    from groove_tpu_torch.kernels.build import library

    err = library().launch_floor(raw_stream(torch.device(device)))
    if err:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def _stream_plain(refined: bool, x2, den, state):
    npad = x2.shape[1]
    return _cascade_plain(x2, [_per_sample(d, npad) for d in den], CBLOCK,
                          refined, state)


def lp24_blockrate_stream_plain(x2, na1a, na2a, na1b, na2b, state):
    """K7's plain twin: x2 [B, n], negated denominators [B, n / 64],
    state [B, 4]. Returns (y, state')."""
    return _stream_plain(False, x2, (na1a, na2a, na1b, na2b), state)


def lp24_refined_blockrate_stream_plain(x2, na1a, na2a, na1b, na2b, state):
    """K8's plain twin: x2 [B, n], negated denominators [B, n / 64],
    state [B, 20]. Returns (y, state')."""
    return _stream_plain(True, x2, (na1a, na2a, na1b, na2b), state)


# --------------------------------------------------------------------------
# Plain torch twins: the kernels' arithmetic in the same operation order,
# vectorised over rows and blocks, serial where the kernels are serial.


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add a * b + c (CUDA's
    __fmaf_rn), for CPU and CUDA tensors alike. The f32 product is exact
    in f64; TwoSum gives the f64 sum's exact error, which rounds the sum
    to odd (a sticky bit), so the final rounding to f32 is the single
    correct one — no double-rounding case."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _per_sample(na: torch.Tensor, npad: int) -> torch.Tensor:
    """Block-rate [B, nb64] -> per-sample [B, npad] (zeros past nb64)."""
    from groove_tpu_torch.ops.iir import upsample_hold

    nbp = npad // CBLOCK
    na = torch.nn.functional.pad(na, (0, nbp - na.shape[-1]))
    return upsample_hold(na, npad)


def phase1(na1, na2, b1m, b2m, z, ln: int):
    """In-block prefix maps over [B, nb, ln] with numerator terms
    b1m * z and b2m * z: shifted rows (p11, p12, q1) and the block maps
    m [B, nb, 4], c [B, nb, 2]."""
    p11s, p12s, q1s = (torch.empty_like(z) for _ in range(3))
    one = torch.ones_like(z[..., 0])
    zero = torch.zeros_like(z[..., 0])
    p11, p12, p21, p22, q1, q2 = one, zero, zero, one, zero, zero
    for j in range(ln):
        p11s[..., j] = p11
        p12s[..., j] = p12
        q1s[..., j] = q1
        a, b, xj = na1[..., j], na2[..., j], z[..., j]
        c1 = b1m[..., j] * xj
        c2 = b2m[..., j] * xj
        p11, p12, p21, p22, q1, q2 = (
            fma32(a, p11, p21), fma32(a, p12, p22), b * p11, b * p12,
            fma32(a, q1, q2) + c1, fma32(b, q1, c2))
    return (p11s, p12s, q1s, torch.stack([p11, p12, p21, p22], -1),
            torch.stack([q1, q2], -1))


def _corr_phase1(na1, na2, d, ln: int):
    """r-only in-block scan of the correction (numerator (1, 0, 0)): the
    shifted r1 rows and the block-end (r1, r2) [B, nb, 2]."""
    q1s = torch.empty_like(d)
    r1 = torch.zeros_like(d[..., 0])
    r2 = torch.zeros_like(d[..., 0])
    for j in range(ln):
        q1s[..., j] = r1
        a, b, dj = na1[..., j], na2[..., j], d[..., j]
        r1, r2 = fma32(a, r1, r2) + a * dj, fma32(b, r1, b * dj)
    return q1s, torch.stack([r1, r2], -1)


def chain(m: torch.Tensor, c: torch.Tensor, seed=None):
    """Serial cross-block chain per row from the pair `seed` [B, 2] (zeros
    when None): entry states S [B, nb, 2] and the exit state [B, 2]."""
    B, nb = m.shape[:2]
    s = torch.empty((B, nb, 2), dtype=m.dtype, device=m.device)
    if seed is None:
        s1 = torch.zeros(B, dtype=m.dtype, device=m.device)
        s2 = torch.zeros_like(s1)
    else:
        s1, s2 = seed[:, 0], seed[:, 1]
    for k in range(nb):
        s[:, k, 0] = s1
        s[:, k, 1] = s2
        mk, ck = m[:, k], c[:, k]
        s1, s2 = (mk[:, 0] * s1 + mk[:, 1] * s2 + ck[:, 0],
                  mk[:, 2] * s1 + mk[:, 3] * s2 + ck[:, 1])
    return s, torch.stack([s1, s2], -1)


def phase2(m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Serial cross-block chain per row from zero: entry states
    S [B, nb, 2]."""
    return chain(m, c)[0]


def _shift(v: torch.Tensor, k: int, h1=None, h2=None) -> torch.Tensor:
    """Shift right by k (1 or 2) along the last axis; the samples before
    the start are h1 (lag 1) and h2 (lag 2), [B, 1] columns, or zeros."""
    if h1 is None:
        return torch.nn.functional.pad(v, (k, 0))[..., :-k]
    head = [h1] if k == 1 else [h2, h1]
    return torch.cat([*head, v[..., :-k]], dim=-1)


def fold_back(v: torch.Tensor) -> torch.Tensor:
    """[B, nb, ln] -> [B, nb * ln]."""
    return v.reshape(v.shape[0], -1)


def _section(z, na1, na2, ln: int, refined: bool, st=None):
    """One cascade section on a padded [B, npad] input. st: None (zero
    state) or the section's carried rows, [B, 2] (K7: the solve pair) or
    [B, 10] (K8: STATE_ROWS' section layout). Returns (y, exported rows or
    None)."""
    B, npad = z.shape
    nb = npad // ln
    fold = lambda v: v.reshape(B, nb, ln)  # noqa: E731
    col = (lambda j: None) if st is None \
        else (lambda j: st[:, j:j + 1])  # noqa: E731
    p11, p12, q1, m, c = phase1(fold(na1), fold(na2), fold(2.0 + na1),
                                fold(1.0 + na2), fold(z), ln)
    s, exit_solve = chain(m, c, None if st is None else st[:, 0:2])
    S1, S2 = s[..., 0:1], s[..., 1:2]
    y0 = z + fold_back(p11 * S1 + p12 * S2 + q1)
    if not refined:
        return y0, None if st is None else exit_solve
    z1, z2 = _shift(z, 1, col(4)), _shift(z, 2, col(4), col(5))
    y1, y2 = _shift(y0, 1, col(6)), _shift(y0, 2, col(6), col(7))
    e1 = 2.0 - _shift(na1, 1, col(8))
    e2 = -_shift(na2, 2, col(9), col(9)) - 1.0
    second = (y0 - y1) - (y1 - y2)
    d = (z + 2.0 * z1 + z2) - second - e1 * y1 - e2 * y2
    q1c, r = _corr_phase1(fold(na1), fold(na2), fold(d), ln)
    sc, exit_corr = chain(m, r, None if st is None else st[:, 2:4])
    corr = fold(d) + p11 * sc[..., 0:1] + p12 * sc[..., 1:2] + q1c
    y = y0 + fold_back(corr)
    if st is None:
        return y, None
    edges = torch.stack([z[:, -1], z[:, -2], y0[:, -1], y0[:, -2],
                         na1[:, -1], na2[:, -1]], -1)
    return y, torch.cat([exit_solve, exit_corr, edges], -1)


def _cascade_plain(x2, dens, ln: int, refined: bool, state=None):
    """Both sections over x2 [B, n]; dens: the four negated denominators
    as per-sample [B, npad] tensors; state: None, or the carried [B, 4]
    (K7) or [B, 20] (K8) state, and then (y, state') is returned."""
    n = x2.shape[1]
    npad = dens[0].shape[1]
    z = torch.nn.functional.pad(x2, (0, npad - n))
    half = None if state is None else state.shape[1] // 2
    sa = None if state is None else state[:, :half]
    sb = None if state is None else state[:, half:]
    ya, oa = _section(z, dens[0], dens[1], ln, refined, sa)
    y, ob = _section(ya, dens[2], dens[3], ln, refined, sb)
    y = y[:, :n].contiguous()
    if state is None:
        return y
    return y, torch.cat([oa, ob], -1)


def _blockrate_plain(x2, den, refined: bool):
    ln, _, npad = geometry(x2.shape[1])
    return _cascade_plain(x2, [_per_sample(d, npad) for d in den], ln,
                          refined)


def lp24_blockrate_plain(x2, na1a, na2a, na1b, na2b) -> torch.Tensor:
    """K3's plain twin: x2 [B, n], negated denominators [B, nb64]."""
    return _blockrate_plain(x2, (na1a, na2a, na1b, na2b), refined=False)


def lp24_refined_blockrate_plain(x2, na1a, na2a, na1b,
                                 na2b) -> torch.Tensor:
    """K2's plain twin: x2 [B, n], negated denominators [B, nb64]."""
    return _blockrate_plain(x2, (na1a, na2a, na1b, na2b), refined=True)
