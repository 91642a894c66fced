"""First-order scans on a kernel of the port's own (csrc/scan1.cu): the
recurrences the reference runs as XLA associative scans, not as Pallas
kernels, from a zero state:

  linear     y[k] = a[k] * y[k-1] + b[k] * x[k]   (iir.one_pole,
             groove_tpu/ops/iir.py:630)
  max_decay  y[k] = max(x[k], a[k] * y[k-1])       (dynamics.max_decay,
             groove_tpu/ops/dynamics.py:46)

along one axis of x. x is seen as [R, S, D] (the axis is S): R * D lanes
of S steps, read through strides, so the block-space combs' [..., nb, D]
scan over nb without a copy. Each coefficient is a number (passed by
value, rounded to float32) or a tensor broadcastable to x (read through
its strides; 0 where it broadcasts). b * x is formed first, as the
reference forms bx.

Both modes run the same chunk decomposition (chunk_for picks C): (1) each
(lane, chunk) scans from zero, keeping the product P of its a and its end
value; (2) each lane walks its chunks in order for every chunk's carry-in;
(3) every chunk but the first adds its carry through the running product
of a: y += P * carry (max_decay: y = max(y, P * carry)). scan1_plain is
the twin: the same decomposition in the same operation order, each
multiply and add rounded on its own, so kernel and twin agree bit for bit
(the build's -fmad=false). The kernel runs all three in one launch: spans
of chunks, one thread block each, hand the carry on in lane order (plan;
csrc/scan1.cu). Neither keeps the reference's operation order, which is
XLA's associative_scan tree: against groove_tpu the scans are held to a
dBFS bar set from measurement (tests/test_torch_effects.py), not
bitwise. Products of a underflow toward 0 over long runs by design; both
keep denormals (no flush to zero).

A CPU tensor runs the twin, a CUDA tensor the kernel (LAUNCHES["scan1"]
counts its calls); there is no fallback."""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from groove_tpu_torch.ops.iir_kernels import dispatch, on_device, ptr, \
    stream_of

LINEAR, MAX_DECAY = 0, 1  # csrc/scan1.cu Mode
TIME, LANES = 0, 1        # csrc/scan1.cu Layout
TILE = 32                 # kTile: steps of a chunk's row per ring stage
TIME_THREADS = 128        # kTimeThreads: chunks of a time-axis block
LANE_THREADS = 512        # kLaneThreads: 32 lanes x 16 chunks, at most
MAX_STAGES = 6            # kMaxStages
STAGE_BYTES = 98304       # kStageBytes: a time-axis block's ring, at most
ALIGN = 1024              # kAlign: the ring starts on it (TMA's swizzle)
LAUNCHES = {"scan1": 0}


def chunk_for(steps: int) -> int:
    """The chunk C: the power of two nearest above sqrt(steps / 8), within
    [32, 2048]. A thread walks C steps twice (for the aggregate, then for
    y) and a lane folds its S / C aggregates in order."""
    c = 32
    while c < 2048 and c * c * 8 < steps:
        c *= 2
    return c


@dataclass(frozen=True)
class Plan:
    """One kernel call's launch (csrc/scan1.cu): chunk C and the chunks
    of a lane; the layout (TIME: a block stages `per_block` =
    TIME_THREADS chunks of one lane through a ring of `stages` tiles of
    `streams` streams, `smem_bytes` of dynamic shared memory; LANES: a
    block is 32 neighbouring lanes times `per_block` chunks, a warp a
    chunk, nothing staged); `spans` blocks a lane chained one after the
    other, `blocks` in all; `scratch_words` 64-bit words of ticket and
    flags."""

    layout: int
    chunk: int
    chunks: int
    threads: int
    per_block: int
    spans: int
    blocks: int
    stages: int
    streams: int
    smem_bytes: int
    scratch_words: int


@functools.lru_cache(maxsize=256)
def plan(R: int, S: int, D: int, streams: int) -> Plan:
    """The launch for x seen as [R, S, D] with `streams` streams to stage
    on the time axis (x, and a and b where they are tensors; max_decay
    reads no b). Block space when 32 lanes or more sit side by side."""
    C = chunk_for(S)
    nc = -(-S // C)
    if D >= 32:
        layout, K, stages, smem = LANES, min(LANE_THREADS // 32, nc), 0, 0
        threads, groups = 32 * K, R * -(-D // 32)
    else:
        layout, K, threads, groups = TIME, TIME_THREADS, TIME_THREADS, R * D
        per_stage = streams * TIME_THREADS * TILE * 4
        stages = min(MAX_STAGES, STAGE_BYTES // per_stage)
        smem = stages * per_stage + ALIGN
    spans = -(-nc // K)
    return Plan(layout, C, nc, threads, K, spans, groups * spans, stages,
                streams, smem, 1 + R * D * spans)


def _canonical(shape, axis: int):
    """(R, S, D) of `shape` scanned along `axis`."""
    axis = axis % len(shape)
    return (math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]))


def _view(t: torch.Tensor, shape, rsd) -> torch.Tensor:
    """t broadcast to `shape`, as an [R, S, D] view (no copy where the
    strides allow; broadcast dimensions keep stride 0)."""
    return t.expand(shape).reshape(rsd)


class _Coef:
    """A coefficient: a float32 value, or an [R, S, D] tensor view."""

    def __init__(self, c, x: torch.Tensor, rsd):
        if torch.is_tensor(c):
            if c.dtype != torch.float32 or c.device != x.device:
                raise ValueError("scan1: coefficients must be float32 "
                                 f"tensors on {x.device}")
            self.value, self.view = 0.0, _view(c, x.shape, rsd)
        else:
            self.value, self.view = float(np.float32(c)), None

    def args(self) -> list:
        if self.view is None:
            return [ptr(None), self.value, 0, 0, 0]
        return [ptr(self.view), 0.0, *self.view.stride()]

    def plain(self):
        """The coefficient as the twin reads it: a number, or a tensor in
        the twin's lanes x steps layout."""
        return self.value if self.view is None else _lanes(self.view)


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """[R, S, D] -> [R * D, S]."""
    R, S, D = t.shape
    return t.permute(0, 2, 1).reshape(R * D, S)


def _check(x: torch.Tensor, mode: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"scan1 takes float32, got {x.dtype}")
    if mode not in (LINEAR, MAX_DECAY):
        raise ValueError(f"scan1: no mode {mode}")


def scan1(x: torch.Tensor, a, b=1.0, axis: int = -1,
          mode: int = LINEAR) -> torch.Tensor:
    """The scan of x along `axis` (see the module docstring); y has x's
    shape. a and b: numbers or tensors broadcastable to x."""
    _check(x, mode)
    if x.numel() == 0:
        return torch.empty_like(x)
    rsd = _canonical(x.shape, axis)
    xv = x.reshape(rsd)
    ca, cb = _Coef(a, x, rsd), _Coef(b, x, rsd)
    y = dispatch(x, lambda: _plain(xv, ca, cb, mode),
                 lambda: _launch(xv, ca, cb, mode), "scan1", LAUNCHES,
                 "scan1 kernel")
    return y.reshape(x.shape)


def scan1_plain(x: torch.Tensor, a, b=1.0, axis: int = -1,
                mode: int = LINEAR) -> torch.Tensor:
    """The twin on x's device, whatever the device."""
    _check(x, mode)
    if x.numel() == 0:
        return torch.empty_like(x)
    rsd = _canonical(x.shape, axis)
    y = _plain(x.reshape(rsd), _Coef(a, x, rsd), _Coef(b, x, rsd), mode)
    return y.reshape(x.shape)


def _launch(xv: torch.Tensor, ca: _Coef, cb: _Coef,
            mode: int) -> torch.Tensor:
    from groove_tpu_torch.kernels.build import library

    R, S, D = xv.shape
    streams = 1 + (ca.view is not None) + (mode == LINEAR
                                           and cb.view is not None)
    p = plan(R, S, D, streams)
    y = torch.empty((R, S, D), dtype=torch.float32, device=xv.device)
    scratch = torch.empty((p.scratch_words,), dtype=torch.int64,
                          device=xv.device)
    with on_device(xv.device):
        err = library().scan1(mode, ptr(xv), *xv.stride(), *ca.args(),
                              *cb.args(), ptr(y), ptr(scratch), R, S, D,
                              p.chunk, p.layout, p.threads, p.stages,
                              stream_of(xv))
    if err:
        raise RuntimeError(f"scan1 kernel launch failed: CUDA error {err}")
    return y


def _chunks(t: torch.Tensor, C: int, fill: float) -> torch.Tensor:
    """[L, S] -> [L, nc, C], the last chunk padded with `fill` (padded
    steps only reach the last chunk's aggregate, which nothing reads)."""
    L, S = t.shape
    nc = -(-S // C)
    return torch.nn.functional.pad(t, (0, nc * C - S),
                                   value=fill).reshape(L, nc, C)


def _plain(xv: torch.Tensor, ca: _Coef, cb: _Coef,
           mode: int) -> torch.Tensor:
    """The kernel's three passes as loops of torch calls over [lanes,
    chunks] (passes 1 and 3: C steps) and [lanes] (pass 2: the chunks)."""
    R, S, D = xv.shape
    C = chunk_for(S)
    x = _lanes(xv)
    L = x.shape[0]
    a = ca.plain()
    if mode == LINEAR:
        b = cb.plain()
        v = b * x  # bx, formed first
    else:
        v = x
    vc = _chunks(v, C, 0.0)
    ac = _chunks(a, C, 1.0) if torch.is_tensor(a) else None
    nc = vc.shape[1]
    # pass 1: each chunk from zero
    acc = torch.zeros((L, nc), dtype=torch.float32, device=x.device)
    p = torch.ones_like(acc)
    ys = []
    for k in range(C):
        ak = ac[:, :, k] if ac is not None else a
        acc = (ak * acc + vc[:, :, k] if mode == LINEAR
               else torch.maximum(vc[:, :, k], ak * acc))
        p = p * ak
        ys.append(acc)
    y = torch.stack(ys, 2)
    if nc > 1:
        # pass 2: carry into each chunk, in order
        carry = torch.zeros((L,), dtype=torch.float32, device=x.device)
        carries = []
        for c in range(nc - 1):
            carries.append(carry)
            pc = p[:, c] * carry
            carry = pc + y[:, c, -1] if mode == LINEAR \
                else torch.maximum(y[:, c, -1], pc)
        carries.append(carry)
        cin = torch.stack(carries[1:], 1)  # chunks 1 .. nc - 1
        # pass 3: the carry through the running product of a
        q = torch.ones_like(cin)
        tail = []
        for k in range(C):
            q = q * (ac[:, 1:, k] if ac is not None else a)
            pc = q * cin
            yk = y[:, 1:, k]
            tail.append(yk + pc if mode == LINEAR else torch.maximum(yk, pc))
        y = torch.cat([y[:, :1], torch.stack(tail, 2)], 1)
    y = y.reshape(L, nc * C)[:, :S]
    return y.reshape(R, D, S).permute(0, 2, 1).contiguous()
