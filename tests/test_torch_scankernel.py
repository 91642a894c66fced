"""scan1 around its one-launch CUDA kernel (groove_tpu_torch/csrc/scan1.cu),
as far as a host without a card can hold it: the launch plan at the
analogues' shapes (layout, chunk, spans and blocks, the time axis's ring
of stages and its shared memory, the scratch of ticket and flags) and its
constants against the source; a torch model of the kernel (every chunk
scanned from zero, one thread each, steps past the lane's end skipped;
the aggregates folded span after span in lane order, each span handing
its carry-out to the next; every chunk scanned again from its inputs to
write y once, a lane's first chunk without a carry) equals the twin bit
for bit; the wrapper's call through a fake library (the plan's
arguments, x and the coefficients through their own strides, two
allocations and no torch operation on data). The kernel itself is held to
the twin on a card by tests/test_torch_cuda.py."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import scan_kernels as sk

N10S, N3MIN = 441024, 7938048  # the analogues' frames: 10 s, 3 minutes


# --------------------------------------------------------------------------
# The plan


@pytest.mark.parametrize("rsd,streams,want", [
    # the compressor's follower on the time axis, 10 s and 3 minutes
    ((2, N10S, 1), 3, dict(layout=sk.TIME, chunk=256, chunks=1723, spans=14,
                           blocks=28, stages=2)),
    ((2, N3MIN, 1), 3, dict(layout=sk.TIME, chunk=1024, chunks=7752,
                            spans=61, blocks=122, stages=2)),
    ((2, N3MIN, 1), 1, dict(layout=sk.TIME, chunk=1024, chunks=7752,
                            spans=61, blocks=122, stages=6)),
    ((2, N3MIN, 1), 2, dict(layout=sk.TIME, chunk=1024, chunks=7752,
                            spans=61, blocks=122, stages=3)),
    # chip_smoke's length off the chunk
    ((2, 100003, 1), 1, dict(layout=sk.TIME, chunk=128, chunks=782, spans=7,
                             blocks=14, stages=6)),
    # the reverb's all-pass and longest comb in block space, 3 minutes
    ((2, -(-N3MIN // 75), 75), 1, dict(layout=sk.LANES, chunk=128,
                                       chunks=827, per_block=16, spans=52,
                                       blocks=2 * 3 * 52, threads=512)),
    ((2, -(-N3MIN // 1927), 1927), 2, dict(layout=sk.LANES, chunk=32,
                                           chunks=129, per_block=16, spans=9,
                                           blocks=2 * 61 * 9, threads=512)),
    # at 10 s; the comb has fewer chunks than a block holds
    ((2, -(-N10S // 75), 75), 1, dict(layout=sk.LANES, chunk=32, chunks=184,
                                      per_block=16, spans=12,
                                      blocks=2 * 3 * 12, threads=512)),
    ((2, -(-N10S // 1927), 1927), 2, dict(layout=sk.LANES, chunk=32,
                                          chunks=8, per_block=8, spans=1,
                                          blocks=2 * 61, threads=256)),
])
def test_plan_at_the_analogues_shapes(rsd, streams, want):
    p = sk.plan(*rsd, streams)
    assert {k: getattr(p, k) for k in want} == want
    R, S, D = rsd
    assert p.chunk == sk.chunk_for(S) and p.chunks == -(-S // p.chunk)
    assert p.spans * p.per_block >= p.chunks > (p.spans - 1) * p.per_block
    assert p.scratch_words == 1 + R * D * p.spans
    if p.layout == sk.TIME:
        assert p.threads == p.per_block == sk.TIME_THREADS
        per_stage = streams * sk.TIME_THREADS * sk.TILE * 4
        assert p.smem_bytes == p.stages * per_stage + sk.ALIGN
        assert p.stages * per_stage <= sk.STAGE_BYTES
        assert 2 <= p.stages <= sk.MAX_STAGES
        assert (p.stages + 1) * per_stage > sk.STAGE_BYTES \
            or p.stages == sk.MAX_STAGES
        assert p.chunk % sk.TILE == 0
    else:
        assert p.threads == 32 * p.per_block <= sk.LANE_THREADS
        assert p.smem_bytes == 0 and p.stages == 0


def _source() -> str:
    return (build.CSRC / "scan1.cu").read_text()


@pytest.mark.parametrize("name,value", [
    ("kTile", sk.TILE), ("kTimeThreads", sk.TIME_THREADS),
    ("kLaneThreads", sk.LANE_THREADS), ("kMaxStages", sk.MAX_STAGES),
    ("kStageBytes", sk.STAGE_BYTES), ("kAlign", sk.ALIGN)])
def test_plan_constants_are_the_sources(name, value):
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    assert m is not None and int(m.group(1)) == value


def test_time_axis_ring_leaves_room_for_two_blocks():
    """Two time-axis blocks fit an SM's 232,448 bytes: the ring at its
    largest and its alignment, the three aggregate arrays, a barrier and
    a short chunk's row of three streams a stage, and the runtime's 1 KB
    each."""
    static = 3 * sk.TIME_THREADS * 4 + sk.MAX_STAGES * (8 + 3 * 128) + 4
    assert 2 * (sk.STAGE_BYTES + sk.ALIGN + static + 1024) <= 232448
    assert sk.STAGE_BYTES == sk.MAX_STAGES * sk.TIME_THREADS * sk.TILE * 4
    text = _source()
    assert "Mode { kLinear = 0, kMaxDecay = 1 }" in text
    assert "Layout { kTime = 0, kLanes = 1 }" in text
    assert (sk.LINEAR, sk.MAX_DECAY, sk.TIME, sk.LANES) == (0, 1, 0, 1)


# --------------------------------------------------------------------------
# The model: what the kernel does, span by span, in torch


def _walk(x, a, b, mode, C, S, cin=None):
    """Every chunk of every lane scanned from zero, one "thread" a chunk
    ([L, nc] at once), steps past S skipped. Returns the aggregates
    (P, end) and, with cin, y [L, nc * C] (a lane's first chunk without
    a carry)."""
    L = x.shape[0]
    nc = -(-S // C)
    acc = torch.zeros((L, nc), dtype=torch.float32)
    p = torch.ones_like(acc)
    ys = []
    for s in range(C):
        k = torch.arange(nc) * C + s
        valid = k < S
        kk = k.clamp(max=S - 1)
        ak = a[:, kk] if torch.is_tensor(a) else a
        if mode == sk.LINEAR:
            bk = b[:, kk] if torch.is_tensor(b) else b
            bx = bk * x[:, kk]
            new = ak * acc + bx
        else:
            new = torch.maximum(x[:, kk], ak * acc)
        acc = torch.where(valid, new, acc)
        p = torch.where(valid, p * ak, p)
        if cin is not None:
            pc = p * cin
            joined = acc + pc if mode == sk.LINEAR else torch.maximum(acc,
                                                                      pc)
            first = torch.arange(nc) == 0
            ys.append(torch.where(first, acc, joined))
    if cin is None:
        return p, acc
    return torch.stack(ys, 2).reshape(L, nc * C)


def _model(x, a, b, axis, mode):
    rsd = sk._canonical(x.shape, axis)
    xv = x.reshape(rsd)
    ca, cb = sk._Coef(a, x, rsd), sk._Coef(b, x, rsd)
    R, S, D = rsd
    streams = 1 + (ca.view is not None) + (mode == sk.LINEAR
                                           and cb.view is not None)
    plan = sk.plan(R, S, D, streams)
    xl, al, bl = sk._lanes(xv), ca.plain(), cb.plain()
    C, K = plan.chunk, plan.per_block
    # pass 1: the aggregates, in whatever order the blocks run
    P, end = _walk(xl, al, bl, mode, C, S)
    # the chained fold: span after span, each from its predecessor's word
    cin = torch.zeros_like(P)
    words = {}
    for span in range(plan.spans):
        carry = (torch.zeros(P.shape[0]) if span == 0 else words[span - 1])
        for c in range(span * K, min((span + 1) * K, plan.chunks)):
            cin[:, c] = carry
            pc = P[:, c] * carry
            carry = (pc + end[:, c] if mode == sk.LINEAR
                     else torch.maximum(end[:, c], pc))
        if span + 1 < plan.spans:
            words[span] = carry
    # pass 2: every chunk again from its inputs, y written once
    y = _walk(xl, al, bl, mode, C, S, cin)[:, :S]
    return y.reshape(R, D, S).permute(0, 2, 1).reshape(x.shape)


@pytest.mark.parametrize("mode", [sk.LINEAR, sk.MAX_DECAY],
                         ids=["linear", "max-decay"])
@pytest.mark.parametrize("coef", ["number", "per-element", "row-broadcast"])
@pytest.mark.parametrize("shape,axis", [((2, 20000), -1), ((3, 4999), -1),
                                        ((1, 40000, 2), -2),
                                        ((2, 600, 75), -2),
                                        ((1, 700, 32), -2)])
def test_kernel_model_equals_twin(mode, coef, shape, axis):
    """Several spans a lane on both layouts (time axis: 3 spans of 128
    chunks at n = 20000; block space: 16 chunks a block), a last chunk
    short of C, the coefficients by value, per element or one row read
    with stride 0: the kernel's decomposition gives the twin's bits."""
    rng = np.random.default_rng(len(shape) * 100 + shape[1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if mode == sk.MAX_DECAY:
        x = x.abs()
    if coef == "number":
        a, b = 0.995, 0.25
    else:
        row = shape if coef == "per-element" else shape[1:]
        a = torch.from_numpy(rng.uniform(0.5, 0.9999, row).astype(np.float32))
        b = 1.0 - a
        if coef == "row-broadcast":
            a, b = a.expand(shape), b.expand(shape)
    rsd = sk._canonical(shape, axis)
    assert sk.plan(*rsd, 1).spans >= 2
    assert torch.equal(_model(x, a, b, axis, mode),
                       sk.scan1(x, a, b, axis=axis, mode=mode))


# --------------------------------------------------------------------------
# The wrapper's call


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("shape,axis,mode,coef", [
    ((2, 30000), -1, sk.LINEAR, "row-broadcast"),
    ((2, 30000), -1, sk.MAX_DECAY, "number"),
    ((2, 900, 75), -2, sk.LINEAR, "per-element"),
])
def test_wrapper_calls_scan1_with_the_plan(monkeypatch, shape, axis, mode,
                                           coef):
    """On a card the wrapper makes two allocations (y and the scratch of
    the plan's words), views, and calls the library's scan1 once with the
    arguments its signature binds: x and each coefficient tensor as they
    are (pointers and strides; stride 0 where a row broadcasts), numbers
    by value, the plan's chunk, layout, threads and stages."""
    calls = []

    class Library:
        def scan1(self, *args):
            assert len(args) == len(build.SIGNATURES["scan1"])
            calls.append((args, list(mode_.ops)))
            return 0

    monkeypatch.setattr(build, "library", Library)
    monkeypatch.setattr(sk, "stream_of", lambda t: None)
    monkeypatch.setattr(sk, "dispatch", lambda x2, plain, launch, *a:
                        launch())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if coef == "number":
        a, b = 0.9, 1.0
    else:
        row = shape if coef == "per-element" else shape[1:]
        a = torch.from_numpy(rng.uniform(0.5, 0.9, row).astype(np.float32))
        b = 1.0 - a
    with _Count() as mode_:
        y = sk.scan1(x, a, b, axis=axis, mode=mode)
    (args, ops), = calls
    empties = [op for op in ops if "empty" in op]
    assert len(empties) == 2, ops
    # the rest only views (x and the coefficients as [R, S, D])
    assert all(op.split(".")[1] in ("view", "expand")
               for op in ops if op not in empties), ops
    rsd = sk._canonical(shape, axis)
    streams = 1 + torch.is_tensor(a) + (mode == sk.LINEAR
                                        and torch.is_tensor(b))
    p = sk.plan(*rsd, streams)
    assert args[0] == mode and args[1].value == x.data_ptr()
    assert tuple(args[2:5]) == x.reshape(rsd).stride()
    for i, c in ((5, a), (10, b)):
        if torch.is_tensor(c):
            view = c.expand(shape).reshape(rsd)
            assert args[i].value == c.data_ptr()
            assert tuple(args[i + 2:i + 5]) == view.stride()
        else:
            assert args[i].value is None and args[i + 1] == np.float32(c)
    assert args[15].value == y.data_ptr()
    assert tuple(args[17:]) == (*rsd, p.chunk, p.layout, p.threads, p.stages,
                                None)
    if coef == "row-broadcast":
        assert args[7] == 0  # a's row stride
