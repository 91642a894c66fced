"""S1 and S2, the unsliced stream's carried-state scan and comb kernels
(groove_tpu_torch/csrc/scan_stream.cu, csrc/comb_stream.cu), as far as a
host without a card can hold them:

- a torch model of each kernel's decomposition equals the plain twin of
  ops/stream_kernels.py bit for bit. S1: spans of 64-blocks, one thread
  block each, every block folded from its staged inputs, the spans
  chained in order from y0 (the walker keeping the value entering each
  batch of 16 blocks, the blocks re-running their batch from it), y from
  the blocks' running maps; both modes, number, per-sample and
  row-broadcast coefficients, lengths of one block, of a span and of
  several spans with a span boundary inside a segment. S2: tiles of delay
  periods staged as the kernel stages them (a contiguous row range at its
  16-byte phase; lane groups through the [M, 4D] tensor map's boxes, 36
  floats wide from a column rounded down to 4, zero past the map, and
  the periods past it copied one by one), each lane walking its periods
  from the staged tiles; lengths no multiple of D, shorter than D, delays
  past 1024 and odd, per-sample g;
- each plan's constants are the sources', and its shared memory stays in
  the sources' budget;
- the wrappers' arguments reach a fake library as the signatures bind
  them, and a launch makes no torch operation but its outputs and the
  ticket words.

The kernels themselves are held to the twins on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import delayfx
from groove_tpu_torch.ops import stream_kernels as sk

SMEM_MAX = 232448  # an H100 block's shared memory, opt-in


def _source(name: str) -> str:
    return (build.CSRC / f"{name}.cu").read_text()


def _const(text: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m is not None, name
    return int(m.group(1))


# --------------------------------------------------------------------------
# S1: the model


def _coef(kind: str, rng, R: int, S: int, lo: float, hi: float):
    if kind == "number":
        return float(np.float32(rng.uniform(lo, hi)))
    shape = (R, S) if kind == "per-row" else (S,)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _s1_model(x, a, b, y0, mode, plan):
    """The kernel's arithmetic, span by span ([R, S] rows)."""
    R, S = x.shape
    nb = S // 64
    ca = sk._time_rows(a, x, R, S)
    cb = sk._time_rows(b, x, R, S) if mode == sk.LINEAR else 1.0
    v = (cb * x if mode == sk.LINEAR else x).reshape(R, nb, 64)
    av = ca.reshape(R, nb, 64) if torch.is_tensor(ca) else None
    # every block folded from its first element (in whatever order the
    # blocks run): the running maps (A_j, C_j)
    As, Cs = [], []
    for j in range(64):
        aj = av[..., j] if av is not None else torch.full((R, nb), ca)
        if j == 0:
            A, C = aj, v[..., 0]
        elif mode == sk.LINEAR:
            C = aj * C + v[..., j]
            A = aj * A
        else:
            C = torch.maximum(v[..., j], C * aj)
            A = A * aj
        As.append(A)
        Cs.append(C)
    A = torch.stack(As, -1)
    C = torch.stack(Cs, -1)

    def chain(m_a, m_c, e):
        return m_a * e + m_c if mode == sk.LINEAR else torch.maximum(
            m_c, m_a * e)

    y = torch.empty((R, nb, 64), dtype=torch.float32)
    exit_value = sk._rows(y0, x, R)
    for sp in range(plan.spans):
        k0 = sp * plan.span
        nk = min(plan.span, nb - k0)
        # the walker: the value entering each batch of 16 blocks kept
        e = exit_value
        keep = {}
        for k in range(nk):
            if k % sk.SCAN_BATCH == 0:
                keep[k // sk.SCAN_BATCH] = e
            e = chain(A[:, k0 + k, -1], C[:, k0 + k, -1], e)
        exit_value = e  # published to the next span (or y_last)
        # each block re-runs its batch from the kept value, then joins
        for k in range(nk):
            ek = keep[k // sk.SCAN_BATCH]
            for j in range(k // sk.SCAN_BATCH * sk.SCAN_BATCH, k):
                ek = chain(A[:, k0 + j, -1], C[:, k0 + j, -1], ek)
            blk = k0 + k
            y[:, blk] = (C[:, blk] + A[:, blk] * ek[:, None]
                         if mode == sk.LINEAR else
                         torch.maximum(C[:, blk], A[:, blk] * ek[:, None]))
    return y.reshape(R, S), exit_value


@pytest.mark.parametrize("mode", [sk.LINEAR, sk.MAX_DECAY],
                         ids=["linear", "max-decay"])
@pytest.mark.parametrize("coef", ["number", "per-row", "broadcast"])
@pytest.mark.parametrize("blocks", [1, 128, 129, 300])
def test_s1_model_equals_twin(mode, coef, blocks):
    """One block, exactly one span (128 blocks), a span and one block, and
    three spans with a short last one: the spans' chain, the kept batch
    values and the blocks' joins give the twin's bits."""
    rng = np.random.default_rng(blocks * 10 + len(coef))
    R, S = 2, 64 * blocks
    x = torch.from_numpy((rng.standard_normal((R, S)) * 0.3)
                         .astype(np.float32))
    if mode == sk.MAX_DECAY:
        x = x.abs()
    a = _coef(coef, rng, R, S, 0.9, 0.9995)
    b = (1 - a) if torch.is_tensor(a) else float(np.float32(1 - a))
    y0 = torch.tensor([0.1, 0.3])
    streams = 1 + torch.is_tensor(a) + (mode == sk.LINEAR
                                        and torch.is_tensor(b))
    plan = sk.scan_plan(R, S, streams)
    assert plan.span == sk.SCAN_MIN_SPAN
    assert plan.spans == -(-blocks // plan.span)
    y, last = _s1_model(x, a, b, y0, mode, plan)
    ty, tlast = sk.scan_stream(x, a, b, y0, mode)
    assert torch.equal(y, ty) and torch.equal(last, tlast)


def test_s1_span_boundary_inside_a_segment():
    """Two calls cut at a block that is no span boundary (the second call's
    first span starts mid-way through the first call's span grid) = one
    call, and both = the model."""
    rng = np.random.default_rng(5)
    R, S = 2, 64 * 400
    x = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.9, 0.999, S).astype(np.float32))
    y0 = torch.tensor([0.1, -0.2])
    cut = 64 * 177
    y1, l1 = sk.scan_stream(x[:, :cut], a[:cut], 1 - a[:cut], y0)
    y2, l2 = sk.scan_stream(x[:, cut:], a[cut:], 1 - a[cut:], l1)
    y, last = _s1_model(x, a, 1 - a, y0, sk.LINEAR,
                        sk.scan_plan(R, S, 3))
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(l2, last)


@pytest.mark.parametrize("R,S,streams,sms,want", [
    # one 262144-frame segment of the stereo bus: a span an SM
    (2, 262144, 3, 132, dict(span=128, spans=32, blocks=64)),
    (2, 262144, 1, 132, dict(span=128, spans=32, blocks=64)),
    # 10 s and 3 minutes: the spans grow to what the stage holds
    (2, 441024, 1, 132, dict(span=128, spans=54, blocks=108)),
    (2, 7938048, 1, 132, dict(span=768, spans=162, blocks=324)),
    (2, 7938048, 2, 132, dict(span=384, spans=323, blocks=646)),
    (2, 7938048, 3, 132, dict(span=256, spans=485, blocks=970)),
    # many rows, and a card of fewer SMs
    (64, 65536, 3, 132, dict(span=256, spans=4, blocks=256)),
    (2, 262144, 1, 16, dict(span=512, spans=8, blocks=16)),
])
def test_s1_plan(R, S, streams, sms, want):
    p = sk.scan_plan(R, S, streams, sms)
    assert {k: getattr(p, k) for k in want} == want
    nb = S // 64
    assert p.span % sk.SCAN_BATCH == 0
    assert sk.SCAN_MIN_SPAN <= p.span <= sk.SCAN_SPAN_ROWS // streams
    assert p.spans * p.span >= nb > (p.spans - 1) * p.span
    assert p.scratch_words == 1 + R * p.spans
    assert p.threads == sk.SCAN_THREADS
    assert p.smem_bytes == streams * min(p.span, nb) * sk.SCAN_ROW * 4


# --------------------------------------------------------------------------
# S2: the model


def _s2_model(mode, x, hx, hy, g, D, plan):
    """The kernel's staging and walks in numpy float32 ([R, S] rows):
    every tile's stage filled as the kernel fills it, every lane walking
    its periods from the stages, y and the tails as it writes them."""
    x = x.numpy()
    R, S = x.shape
    per_sample = torch.is_tensor(g)
    gr = g.expand(R, S).numpy() if per_sample else None
    gv = np.float32(g if mode == sk.COMB else g[0])
    ng, c1 = (np.float32(0), np.float32(0)) if mode == sk.COMB else (
        np.float32(g[1]), np.float32(g[2]))
    xp = hx.numpy().copy()
    yp = hy.numpy().copy() if mode == sk.COMB else None
    y = np.full((R, S), np.nan, np.float32)
    P = -(-S // D)
    P4 = plan.map_periods
    L = plan.lanes
    for grp in range(plan.groups):
        d0 = grp * L
        lanes = np.arange(d0, min(d0 + L, D))
        q = lanes - d0
        for i in range(plan.tiles):
            if plan.contiguous:
                p0 = i * plan.periods
                p1 = min(p0 + plan.periods, P)
            elif i < plan.map_tiles:
                p0 = i * plan.periods
                p1 = min(p0 + plan.periods, P4)
            else:
                p0 = P4 + (i - plan.map_tiles) * plan.periods
                p1 = min(p0 + plan.periods, P)
            stages = [_stage(src, plan, D, d0, p0, p1, i < plan.map_tiles,
                             P4) for src in ([x, gr] if per_sample else [x])]
            for p in range(p0, p1):
                t = p * D + lanes
                on = t < S
                if not on.any():
                    continue
                o = _at(plan, D, d0, p - p0, q)
                xt = stages[0][:, o]
                if mode == sk.COMB:
                    gt = stages[1][:, o] if per_sample else gv
                    yt = (xp[:, lanes] + gt * yp[:, lanes]).astype(
                        np.float32)
                    xp[:, lanes] = np.where(on, xt, xp[:, lanes])
                    yp[:, lanes] = np.where(on, yt, yp[:, lanes])
                else:
                    w = xp[:, lanes]
                    yt = (ng * xt + c1 * w).astype(np.float32)
                    xp[:, lanes] = np.where(on, (xt + gv * w).astype(
                        np.float32), w)
                y[:, t[on]] = yt[:, on]
    # the lanes' registers are the new tails' entries (d - S) mod D
    j = (np.arange(D) - S) % D
    hx2 = np.empty_like(xp)
    hx2[:, j] = xp
    out = [torch.from_numpy(y), torch.from_numpy(hx2)]
    if mode == sk.COMB:
        hy2 = np.empty_like(yp)
        hy2[:, j] = yp
        out.append(torch.from_numpy(hy2))
    return out


def _at(plan, D, d0, p, q):
    """Where the stage holds period p (from the tile's first) of lane q:
    contiguous, at the range's phase (the model's stages start at
    phase 0, so p D + q); lane groups, box p & 3, row p >> 2, at the
    box's offset (k D + d0) & 3."""
    if plan.contiguous:
        return p * D + q
    k = p & 3
    return (k * sk.COMB_BOX + (p >> 2)) * sk.COMB_ROW + ((k * D + d0) & 3) + q


def _stage(src, plan, D, d0, p0, p1, by_map, P4):
    """One stream's stage of a tile, [R, stride], as the copies leave it:
    a contiguous range; four tensor-map boxes of a lane group (36 floats
    from column (k D + d0) rounded down to 4, zero past the map); or the
    group's periods one float at a time."""
    R, S = src.shape
    st = np.full((R, plan.stride), np.nan, np.float32)
    if plan.contiguous:
        g0, g1 = p0 * D, min(S, p1 * D)
        st[:, :g1 - g0] = src[:, g0:g1]
        return st
    if by_map:
        M = P4 // 4
        view = src[:, :M * 4 * D].reshape(R, M, 4 * D)
        for k in range(4):
            col = (k * D + d0) & ~3
            for r in range(sk.COMB_BOX):
                m = p0 // 4 + r
                row = np.zeros((R, sk.COMB_ROW), np.float32)
                if m < M:
                    part = view[:, m, col:col + sk.COMB_ROW]
                    row[:, :part.shape[1]] = part
                base = (k * sk.COMB_BOX + r) * sk.COMB_ROW
                st[:, base:base + sk.COMB_ROW] = row
        return st
    for p in range(p0, p1):
        for q in range(sk.COMB_GROUP):
            d = d0 + q
            t = p * D + d
            if d < D and t < S:
                st[:, _at(plan, D, d0, p - p0, q)] = src[:, t]
    return st


@pytest.mark.parametrize("mode,D,S,per_sample", [
    ("allpass", 75, 3 * 245 * 75 + 123, False),   # four contiguous tiles
    ("allpass", 75, 50, False),                    # S < D
    ("allpass", 221, 40000, False),
    ("comb", 200, 30001, True),                    # contiguous, per-sample g
    ("comb", 1927, 4 * 1927 * 33 + 1000, False),   # odd D: two map tiles,
    ("comb", 1927, 4 * 1927 * 33 + 1000, True),    # then the rest by copies
    ("comb", 1928, 4 * 1928 * 2, True),            # D a multiple of 4
    ("comb", 1310, 4 * 1310 * 3 + 7, True),        # S % 4: no map at all
    ("comb", 300, 12000, False),                   # ten groups, the last
    ("comb", 1100, 900, True),                     # partial; S < D > 1024
])
def test_s2_model_equals_twin(mode, D, S, per_sample):
    """The tiles cut across lanes and periods as the plan cuts them, and
    every lane's walk over the staged tiles gives the twin's bits: y and
    the tails."""
    rng = np.random.default_rng(D + S)
    R = 2
    x = torch.from_numpy((rng.standard_normal((R, S)) * 0.3)
                         .astype(np.float32))
    hx = torch.from_numpy((rng.standard_normal((R, D)) * 0.1)
                          .astype(np.float32))
    if mode == "comb":
        hy = 0.5 * hx
        g = (torch.from_numpy(rng.uniform(0.5, 0.9, S).astype(np.float32))
             if per_sample else 0.83)
        plan = sk.comb_plan(R, S, D, 2 if per_sample else 1)
        model = _s2_model(sk.COMB, x, hx, hy, g, D, plan)
        twin = sk.comb_stream(x, hx, hy, g)
    else:
        plan = sk.comb_plan(R, S, D, 1)
        model = _s2_model(sk.ALLPASS, x, hx, None,
                          sk._allpass_constants(delayfx.ALLPASS_G), D, plan)
        twin = sk.allpass_stream(x, hx, delayfx.ALLPASS_G)
    assert plan.tiles >= 1
    for a, b in zip(model, twin):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,S,D,streams,want", [
    # the all-passes: one block a row, large contiguous tiles
    (2, 7938048, 75, 1, dict(contiguous=True, groups=1, periods=245,
                             tiles=433, stages=3, threads=128, blocks=2)),
    (2, 262144, 221, 1, dict(contiguous=True, periods=83, tiles=15,
                             threads=256)),
    # a per-sample comb of a short delay: two streams share the ring
    (2, 262144, 200, 2, dict(contiguous=True, periods=46, stages=3,
                             stride=9216, threads=256)),
    # the combs: 32-lane groups through the tensor map, the rest copied
    (2, 7938048, 1927, 2, dict(contiguous=False, groups=61, periods=128,
                               tiles=34, map_tiles=33, map_periods=4116,
                               stages=6, threads=64, blocks=122)),
    (2, 262144, 1310, 1, dict(groups=41, tiles=3, map_tiles=2,
                              map_periods=200, blocks=82)),
    (2, 262144 + 2, 1310, 1, dict(map_tiles=0, map_periods=0, tiles=2)),
])
def test_s2_plan(R, S, D, streams, want):
    p = sk.comb_plan(R, S, D, streams)
    assert {k: getattr(p, k) for k in want} == want
    P = -(-S // D)
    assert p.map_periods % 4 == 0 and p.map_periods * D <= S
    assert p.tiles == -(-p.map_periods // p.periods) + -(-(P - p.map_periods)
                                                        // p.periods)
    assert p.smem_bytes <= sk.COMB_RING
    if p.contiguous:
        assert p.periods * D + 3 <= p.stride  # a tile at its phase fits
    else:
        assert p.periods == 4 * sk.COMB_BOX
        assert p.stride == 4 * sk.COMB_BOX * sk.COMB_ROW


# --------------------------------------------------------------------------
# The plans against the sources


@pytest.mark.parametrize("name,value", [
    ("kRow", sk.SCAN_ROW), ("kThreads", sk.SCAN_THREADS),
    ("kSpanRows", sk.SCAN_SPAN_ROWS), ("kBatch", sk.SCAN_BATCH)])
def test_s1_constants_are_the_sources(name, value):
    assert _const(_source("scan_stream"), name) == value


@pytest.mark.parametrize("name,value", [
    ("kStageFloats", sk.COMB_STAGE_FLOATS), ("kStages", sk.COMB_STAGES),
    ("kContigStages", sk.COMB_CONTIG_STAGES),
    ("kMaxContig", sk.COMB_MAX_CONTIG), ("kGroup", sk.COMB_GROUP),
    ("kAlign", sk.COMB_ALIGN)])
def test_s2_constants_are_the_sources(name, value):
    assert _const(_source("comb_stream"), name) == value


def test_shared_memory_stays_in_the_sources_budget():
    """S1: the stage (as kStageBytes states it), the walker's maps and kept
    values, the barrier and ticket, and the runtime's 1 KB fit a block;
    every plan's stage is within it. S2: the ring of either layout and its
    barriers fit, every plan within COMB_RING; both sources state the
    totals the module mirrors."""
    s1, s2 = _source("scan_stream"), _source("comb_stream")
    assert f"kStageBytes == {sk.SCAN_STAGE}" in s1
    assert sk.SCAN_STAGE == sk.SCAN_SPAN_ROWS * sk.SCAN_ROW * 4
    static = (sk.SCAN_SPAN_ROWS + sk.SCAN_BATCH) * 8 + (
        sk.SCAN_SPAN_ROWS // sk.SCAN_BATCH) * 4 + 8 + 4
    assert sk.SCAN_STAGE + static + 1024 <= SMEM_MAX
    for streams in (1, 2, 3):
        for S in (64, 262144, 441024, 7938048):
            assert sk.scan_plan(2, S, streams).smem_bytes <= sk.SCAN_STAGE
    assert f"kRingBytes == {sk.COMB_RING}" in s2
    assert sk.COMB_RING == (sk.COMB_STAGES * 2 * sk.COMB_STAGE_STRIDE * 4
                            + sk.COMB_ALIGN)
    assert sk.COMB_STAGE_STRIDE == 4 * sk.COMB_BOX * sk.COMB_ROW
    assert sk.COMB_BOX * 4 * sk.COMB_GROUP == sk.COMB_STAGE_FLOATS
    assert sk.COMB_RING + sk.COMB_STAGES * 8 + 1024 <= SMEM_MAX
    for D in (75, 221, 300, 1310, 1927):
        for streams in (1, 2):
            p = sk.comb_plan(2, 262144, D, streams)
            assert p.smem_bytes <= sk.COMB_RING
            assert p.threads <= sk.COMB_MAX_CONTIG + 32
    assert "Mode { kLinear = 0, kMaxDecay = 1 }" in s1
    assert "Mode { kComb = 0, kAllpass = 1 }" in s2


def test_stage_header_holds_the_chaining_once():
    """The ticket, the carry word and the copies live in csrc/stage.cuh,
    which scan1.cu, scan_stream.cu and comb_stream.cu include; none keeps
    a copy of its own."""
    stage = (build.CSRC / "stage.cuh").read_text()
    for fn in ("publish", "await_carry", "take_ticket", "cp_async_wait",
               "bulk_load", "tma_load3", "allow_smem"):
        assert f" {fn}(" in stage
    for name in ("scan1", "scan_stream", "comb_stream"):
        text = _source(name)
        assert '#include "stage.cuh"' in text
        for fn in ("publish", "await_carry", "take_ticket"):
            assert f"__forceinline__ void {fn}(" not in text
            assert f"__forceinline__ float {fn}(" not in text
            assert f"__forceinline__ unsigned {fn}(" not in text


# --------------------------------------------------------------------------
# The wrappers' calls


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors through the kernels' launch path: the device rule, the
    input check, the stream and the SM count stubbed; the library a fake
    that records each call's arguments and the torch operations made
    before it."""
    calls = []

    class Library:
        def __init__(self):
            self.mode = None

        def _record(self, name, args):
            assert len(args) == len(build.SIGNATURES[name])
            calls.append((name, args, list(self.mode.ops)))
            return 0

        def scan_stream(self, *args):
            return self._record("scan_stream", args)

        def comb_stream(self, *args):
            return self._record("comb_stream", args)

    lib = Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(sk, "dispatch", lambda x2, plain, launch, *a:
                        launch())
    monkeypatch.setattr(sk, "check_input", lambda *a: None)
    monkeypatch.setattr(sk, "stream_of", lambda t: None)
    monkeypatch.setattr(sk, "_sms", lambda device: sk.H100_SMS)
    return lib, calls


@pytest.mark.parametrize("mode,coef", [(sk.LINEAR, "broadcast"),
                                       (sk.LINEAR, "number"),
                                       (sk.MAX_DECAY, "per-row")])
def test_scan_wrapper_calls_the_library_with_the_plan(fake_card, mode,
                                                      coef):
    """One call: x and each coefficient array by pointer and row stride
    (0 where a row broadcasts), numbers by value, the plan's span, and
    three allocations (y, y_last and the plan's ticket words) — no
    scratch of block maps or entry values."""
    lib, calls = fake_card
    rng = np.random.default_rng(3)
    R, S = 2, 64 * 200
    x = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32))
    a = _coef(coef, rng, R, S, 0.9, 0.999)
    b = 1 - a if torch.is_tensor(a) else 0.25
    y0 = torch.tensor([0.1, 0.2])
    with _Count() as mode_:
        lib.mode = mode_
        y, last = sk.scan_stream(x, a, b, y0, mode)
    (name, args, ops), = calls
    empties = [op for op in ops if "empty" in op]
    assert len(empties) == 3, ops
    streams = 1 + torch.is_tensor(a) + (mode == sk.LINEAR
                                        and torch.is_tensor(b))
    p = sk.scan_plan(R, S, streams)
    assert args[0] == mode and args[1].value == x.data_ptr()
    assert args[2] == x.stride(0)
    for i, c in ((3, a), (6, b)):
        if mode == sk.MAX_DECAY and i == 6:
            continue
        if torch.is_tensor(c):
            assert args[i].value == c.data_ptr()
            assert args[i + 2] == (0 if c.dim() == 1 else c.stride(0))
        else:
            assert args[i].value is None
            assert args[i + 1] == np.float32(c)
    assert args[11].value == y.data_ptr() and args[10].value == \
        last.data_ptr()
    assert tuple(args[13:16]) == (R, S, p.span)


@pytest.mark.parametrize("mode,D,per_sample", [("comb", 1927, True),
                                               ("comb", 75, False),
                                               ("allpass", 75, False)])
def test_comb_wrapper_calls_the_library(fake_card, mode, D, per_sample):
    """One call: x, the per-sample g by pointer and row stride (0: one
    row for every row) or g by value, the all-pass's -g and 1 - g^2 by
    value, the tails in and out, and as many allocations as outputs."""
    lib, calls = fake_card
    rng = np.random.default_rng(4)
    R, S = 2, 5000
    x = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32))
    hx = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
    g = (torch.from_numpy(rng.uniform(0.5, 0.9, S).astype(np.float32))
         if per_sample else 0.7)
    with _Count() as mode_:
        lib.mode = mode_
        if mode == "comb":
            out = sk.comb_stream(x, hx, 0.5 * hx, g)
        else:
            out = sk.allpass_stream(x, hx, g)
    (name, args, ops), = calls
    empties = [op for op in ops if "empty" in op]
    assert len(empties) == (3 if mode == "comb" else 2), ops
    assert args[0] == (sk.COMB if mode == "comb" else sk.ALLPASS)
    assert args[1].value == x.data_ptr()
    if per_sample:
        assert args[2].value == g.data_ptr() and args[4] == 0
    else:
        assert args[2].value is None
        gv, ng, c1 = (sk._allpass_constants(g) if mode == "allpass"
                      else (float(np.float32(g)), 0.0, 0.0))
        assert (args[3], args[5], args[6]) == (gv, ng, c1)
    assert args[11].value == out[0].data_ptr()
    assert args[9].value == out[1].data_ptr()
    assert tuple(args[12:15]) == (R, S, D)


def test_a_launch_makes_no_torch_operation_but_its_outputs(fake_card):
    """_launch_scan on prepared arguments allocates y, y_last and the
    ticket words and nothing else (the earlier route also allocated the
    block maps and the entry values, two allocator calls a call, four
    calls a segment); _launch_comb allocates its outputs."""
    lib, calls = fake_card
    rng = np.random.default_rng(6)
    R, S = 2, 64 * 300
    x2 = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.9, 0.99, (R, S)).astype(np.float32))
    y0 = torch.tensor([0.0, 0.1])
    with _Count() as mode_:
        lib.mode = mode_
        sk._launch_scan(x2, a, 1 - a, y0, sk.LINEAR)
    assert len(mode_.ops) == 4  # 1 - a (the caller's), then 3 empties
    assert sum("empty" in op for op in mode_.ops) == 3
    hx = torch.zeros((R, 75))
    with _Count() as mode_:
        lib.mode = mode_
        sk._launch_comb(sk.ALLPASS, x2, 0.7, -0.7, 0.51, hx, None)
    assert len(mode_.ops) == 2 and all("empty" in op for op in mode_.ops)
