"""K4 and K2 around their tiled CUDA kernels (groove_tpu_torch/csrc/tiled.cuh
through biquad_tiled and lp24_refined_tiled), as far as a host without a
card can hold them: a pure-torch model of the tiled walk (tiles of T
ln-blocks staged with zeros past n, block maps only out of phase 1, prefix
rows re-scanned in every combine, the refined cascade's defect taking its
history across tiles from a re-run halo block, section B's maps from the
values the second combine holds in its tile) equals the plain twins bit for
bit; the wrappers' buffers (allocations counted, no torch operation on x or
the coefficients); the shared-memory budget against the source; the build's
cover of the new header. The kernels themselves are held to the twins and
to their earlier routes on a card by tests/test_torch_cuda.py."""

from __future__ import annotations

import re
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import biquad_kernels, iir, iir_kernels
from groove_tpu_torch.ops.iir_kernels import (BLOCK, TILED_SLOTS, Streams,
                                              _corr_phase1, chain, geometry,
                                              phase1)

SR = 44100.0


# --------------------------------------------------------------------------
# The model: what the kernels do, tile by tile, in torch


def _stage(x2: torch.Tensor, first: int, slots: int, ln: int) -> torch.Tensor:
    """A tile [B, slots, ln]: ln-blocks first .. first + slots - 1 of the
    rows, zeros before the row and past n (the kernels' fill)."""
    B, n = x2.shape
    tile = torch.zeros((B, slots * ln), dtype=x2.dtype)
    lo, hi = first * ln, (first + slots) * ln
    a, b = max(lo, 0), min(hi, n)
    if b > a:
        tile[:, a - lo:b - lo] = x2[:, a:b]
    return tile.reshape(B, slots, ln)


def _blocks(v: torch.Tensor, first: int, count: int, ln: int) -> torch.Tensor:
    """Per-sample coefficients [B, npad] of ln-blocks first .. first +
    count - 1 as [B, count, ln]."""
    return v[:, first * ln:(first + count) * ln].reshape(v.shape[0], count, ln)


def _tiles(nb: int, T: int, halo: int):
    """(first block held by slot 0, real blocks of the tile) per tile."""
    per = T - halo
    for t in range(-(-nb // per)):
        first = t * per - halo
        yield first, min(first + T, nb) - (first + halo)


def model_maps(z2, coefs, ln: int, T: int):
    """Phase 1 on tiles: the block maps only."""
    na1, na2, g1, g2 = coefs
    B, n = z2.shape
    nb = -(-n // ln)
    m = torch.empty((B, nb, 4))
    c = torch.empty((B, nb, 2))
    for first, count in _tiles(nb, T, 0):
        z = _stage(z2, first, T, ln)[:, :count]
        cut = [_blocks(v, first, count, ln) for v in (na1, na2, g1, g2)]
        _, _, _, mt, ct = phase1(*cut, z, ln)
        m[:, first:first + count], c[:, first:first + count] = mt, ct
    return m, c


def model_k4(x2, st: Streams, ln: int, T: int) -> torch.Tensor:
    """biquad_tiled: maps, chain, combine (prefix rows re-scanned)."""
    B, n = x2.shape
    nb = -(-n // ln)
    na1, na2, b1m, b2m, b0 = st.per_sample(B, nb * ln, x2.device)
    m, c = model_maps(x2, (na1, na2, b1m, b2m), ln, T)
    s, _ = chain(m, c)
    y = torch.empty_like(x2)
    for first, count in _tiles(nb, T, 0):
        z = _stage(x2, first, T, ln)[:, :count]
        cut = [_blocks(v, first, count, ln)
               for v in (na1, na2, b1m, b2m, b0)]
        p11, p12, q1, _, _ = phase1(*cut[:4], z, ln)
        S = s[:, first:first + count]
        out = cut[4] * z + (p11 * S[..., 0:1] + p12 * S[..., 1:2] + q1)
        lo = first * ln
        hi = min(lo + count * ln, n)
        y[:, lo:hi] = out.reshape(B, -1)[:, :hi - lo]
    return y


def _lagged(cur, e1, e2):
    """cur [B, S, ln] at lags 1 and 2 along the block, with the samples
    before each block taken from e1 (lag 1) and e2 (lag 2), [B, S]."""
    l1 = torch.cat([e1[..., None], cur[..., :-1]], -1)
    l2 = torch.cat([e2[..., None], e1[..., None], cur[..., :-2]], -1)
    return l1, l2


def model_refined_tile(z2, na1, na2, s, sc, first: int, count: int, ln: int,
                       T: int, nxt):
    """One tile of the defect-scan kernel (sc None: returns the correction's
    block-end pairs) or of the second-combine kernel (returns the tile's
    output and, with the next section's coefficients `nxt`, its maps).
    Slot 0 is the halo: block first, re-run only for its edges."""
    B = z2.shape[0]
    zt = _stage(z2, first, T, ln)[:, :count + 1]
    f0 = max(first, 0)            # the row's first tile has no block -1
    skip = f0 - first             # 1 there, else 0
    span = count + 1 - skip
    cut = lambda v: _blocks(v, f0, span, ln)  # noqa: E731
    a, b = cut(na1), cut(na2)
    p11, p12, q1, _, _ = phase1(a, b, 2.0 + a, 1.0 + b, zt[:, skip:], ln)
    S = s[:, f0:f0 + span]
    y0 = zt[:, skip:] + (p11 * S[..., 0:1] + p12 * S[..., 1:2] + q1)
    # first pass: every slot's last two z and y0; zeros before the row
    edges = torch.zeros((B, count + 1, 4))
    edges[:, skip:] = torch.stack(
        [zt[:, skip:, -1], zt[:, skip:, -2], y0[..., -1], y0[..., -2]], -1)
    # second pass: slots 1 .. count
    z, y0 = zt[:, 1:], y0[:, 1 - skip:]
    p11, p12 = p11[:, 1 - skip:], p12[:, 1 - skip:]
    a, b = a[:, 1 - skip:], b[:, 1 - skip:]
    e = edges[:, :-1]
    z1, z2_ = _lagged(z, e[..., 0], e[..., 1])
    y1, y2 = _lagged(y0, e[..., 2], e[..., 3])
    lo, hi = (first + 1) * ln, (first + 1 + count) * ln
    a1s = iir_kernels._shift(na1, 1)[:, lo:hi].reshape(a.shape)
    a2s = iir_kernels._shift(na2, 2)[:, lo:hi].reshape(b.shape)
    e1 = 2.0 - a1s
    e2 = -a2s - 1.0
    second = (y0 - y1) - (y1 - y2)
    d = (z + 2.0 * z1 + z2_) - second - e1 * y1 - e2 * y2
    q1c, r = _corr_phase1(a, b, d, ln)
    if sc is None:
        return r
    Sc = sc[:, first + 1:first + 1 + count]
    out = y0 + (d + p11 * Sc[..., 0:1] + p12 * Sc[..., 1:2] + q1c)
    maps = None
    if nxt is not None:
        an, bn = (_blocks(v, first + 1, count, ln) for v in nxt)
        maps = phase1(an, bn, 2.0 + an, 1.0 + bn, out, ln)[3:]
    return out, maps


def model_k2(x2, den, ln: int, T: int) -> torch.Tensor:
    """lp24_refined_tiled: section A's maps, then per section chain,
    defect scan, chain, second combine (section A's also section B's
    maps)."""
    B, n = x2.shape
    nb = -(-n // ln)
    na = [iir_kernels._per_sample(d, nb * ln) for d in den]
    m, c = model_maps(x2, (na[0], na[1], 2.0 + na[0], 1.0 + na[1]), ln, T)
    z2 = x2
    for sec in range(2):
        na1, na2 = na[2 * sec], na[2 * sec + 1]
        nxt = (na[2], na[3]) if sec == 0 else None
        s, _ = chain(m, c)
        r = torch.empty((B, nb, 2))
        for first, count in _tiles(nb, T, 1):
            r[:, first + 1:first + 1 + count] = model_refined_tile(
                z2, na1, na2, s, None, first, count, ln, T, None)
        sc, _ = chain(m, r)
        out2 = torch.empty_like(x2)
        m, c = torch.empty_like(m), torch.empty_like(c)
        for first, count in _tiles(nb, T, 1):
            out, maps = model_refined_tile(z2, na1, na2, s, sc, first, count,
                                           ln, T, nxt)
            lo = (first + 1) * ln
            hi = min(lo + count * ln, n)
            out2[:, lo:hi] = out.reshape(B, -1)[:, :hi - lo]
            if maps is not None:
                m[:, first + 1:first + 1 + count] = maps[0]
                c[:, first + 1:first + 1 + count] = maps[1]
        z2 = out2
    return z2


# --------------------------------------------------------------------------
# Inputs


def _x(rows: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((rows, n)) * 0.3)
                            .astype(np.float32))


def _cutoffs(rows: int, nb: int, kind: str) -> np.ndarray:
    """Block-rate cutoffs [rows, nb] near the corner: 'row' one curve for
    all rows, 'time' one value per row held for all time, 'full' a curve
    per row."""
    t = np.linspace(0.05, 0.6, nb)[None, :] + 0.03 * np.arange(rows)[:, None]
    if kind == "row":
        t = np.broadcast_to(t[:1], (rows, nb))
    elif kind == "time":
        t = np.broadcast_to(t[:, :1], (rows, nb))
    return (25.0 * 800.0 ** t).astype(np.float32)


def _as_views(arrays, kind: str, rows: int, nb: int):
    """Coefficient arrays [rows, nb] as the strided views a caller would
    pass: stride 0 along rows ('row') or time ('time')."""
    out = []
    for c in arrays:
        c = torch.from_numpy(np.ascontiguousarray(c))
        if kind == "row":
            c = c[:1].contiguous().expand(rows, nb)
        elif kind == "time":
            c = c[:, :1].contiguous().expand(rows, nb)
        out.append(c)
    return tuple(out)


def _k4_case(rows: int, n: int, kind: str, seed: int):
    nb = -(-n // 64)
    cut = _cutoffs(rows, nb, kind)
    coefs = _as_views(iir.rbj_low_pass(cut, np.float32(2.0), SR), kind, rows,
                      nb)
    return _x(rows, n, seed), coefs


def _k2_case(rows: int, n: int, kind: str, seed: int):
    nb = -(-n // 64)
    cut = _cutoffs(rows, nb, kind)
    gain, secs = iir.lp24_sections(cut, np.float32(2.0), SR)
    x = _x(rows, n, seed) * torch.from_numpy(
        np.repeat(gain, 64, axis=1)[:, :n].astype(np.float32))
    return x, [_as_views(sec, kind, rows, nb) for sec in secs]


LN128 = 128 * TILED_SLOTS  # frames of a whole tile at ln = 128
SIZES = [1, 63, 64, 65, 8191, 8192, 8193, LN128 - 1, LN128 + 1]
ROWS = [1, 2, 5]
KINDS = ["row", "time", "full"]


@pytest.mark.parametrize("i,n", list(enumerate(SIZES)))
def test_k4_tiled_model_equals_twin(i, n):
    """The kernel's tile size, every n around a block and a tile edge."""
    rows, kind = ROWS[i % 3], KINDS[i % 3]
    x, coefs = _k4_case(rows, n, kind, seed=20 + i)
    x2, st, ln = biquad_kernels._prepare(x, coefs, BLOCK)
    assert ln == geometry(n)[0]
    y = model_k4(x2, st, ln, TILED_SLOTS)
    assert torch.equal(y, biquad_kernels.biquad_blockrate_plain(x, coefs))
    assert torch.equal(y, biquad_kernels.biquad_blockrate(x, coefs))
    assert float(y.abs().max()) > 0.0


@pytest.mark.parametrize("i,n", list(enumerate(SIZES)))
def test_k2_tiled_model_equals_twin(i, n):
    rows, kind = ROWS[(i + 1) % 3], KINDS[(i + 2) % 3]
    x, secs = _k2_case(rows, n, kind, seed=40 + i)
    x2, den = iir_kernels._prepare(x, secs, 64)
    y = model_k2(x2, den, geometry(n)[0], TILED_SLOTS)
    assert torch.equal(y, iir_kernels.lp24_refined_blockrate_plain(x2, *den))
    assert torch.equal(y, iir_kernels.lp24_refined_blockrate(x, secs))
    assert float(y.abs().max()) > 0.0


@pytest.mark.parametrize("kernel", ["K4", "K2"])
@pytest.mark.parametrize("rows,kind,T", [(1, "full", 2), (2, "row", 3),
                                         (5, "time", 7)])
def test_many_small_tiles_equal_twin(kernel, rows, kind, T):
    """Many tiles a row (T blocks each, the last one short, a halo at every
    tile edge): the walk does not depend on the tile size."""
    n = 8193 + 64 * rows  # ln = 128; neither a block nor a tile multiple
    if kernel == "K4":
        x, coefs = _k4_case(rows, n, kind, seed=60 + T)
        x2, st, ln = biquad_kernels._prepare(x, coefs, BLOCK)
        y = model_k4(x2, st, ln, T)
        want = biquad_kernels.biquad_blockrate_plain(x, coefs)
    else:
        x, secs = _k2_case(rows, n, kind, seed=70 + T)
        x2, den = iir_kernels._prepare(x, secs, 64)
        y = model_k2(x2, den, geometry(n)[0], T)
        want = iir_kernels.lp24_refined_blockrate_plain(x2, *den)
    assert n % 128 and -(-n // 128) > 3 * T
    assert torch.equal(y, want)


def test_zero_fill_in_the_tile_is_the_twins_padding():
    """A sample past n never reaches an output: the model with garbage
    staged past n still equals the twin below n."""
    n = 8193
    x, secs = _k2_case(2, n, "full", seed=80)
    x2, den = iir_kernels._prepare(x, secs, 64)
    longer = torch.cat([x2, torch.full((2, 100), 3.0)], 1)
    den_l = [torch.nn.functional.pad(d, (0, 2), value=-0.5) for d in den]
    y = model_k2(longer, den_l, 128, TILED_SLOTS)[:, :n]
    assert torch.equal(y, iir_kernels.lp24_refined_blockrate_plain(x2, *den))


# --------------------------------------------------------------------------
# The wrappers' buffers


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,outputs,pairs,carries",
                         [("K4", 1, 2, 0), ("K2", 2, 5, 4)])
@pytest.mark.parametrize("rows,n", [(2, 8193), (5, 64)])
def test_buffers_are_the_only_torch_operations(name, outputs, pairs, carries,
                                               rows, n):
    """A tiled call allocates its outputs (K4: y; K2: y and the first
    section's output) and one scratch buffer, and makes no other torch
    operation: x is neither padded nor copied."""
    x2 = _x(rows, n, seed=90)
    ln = geometry(n)[0]
    blocks = rows * -(-n // ln)
    with _Count() as mode:
        outs, scratch, ptrs = iir_kernels.tiled_buffers(x2, ln, outputs,
                                                        pairs, carries)
    assert len(mode.ops) == outputs + 1, mode.ops
    assert all("empty" in op for op in mode.ops), mode.ops
    assert [tuple(o.shape) for o in outs] == [(rows, n)] * outputs
    base = scratch.data_ptr()
    assert ptrs[0] == base and base % 16 == 0
    sizes = [16 * blocks] + [8 * blocks] * pairs + [8 * rows * carries]
    sizes = [s for s in sizes if s]
    assert ptrs == [base + sum(sizes[:i]) for i in range(len(sizes))]
    assert ptrs[-1] + sizes[-1] == base + 4 * scratch.numel()
    text = _source("lp24.cu" if name == "K2" else "biquad.cu")
    entry = "lp24_refined_tiled" if name == "K2" else "biquad_tiled"
    head = text[text.index(f'extern "C" int {entry}('):]
    head = head[:head.index(")")]
    scratch_args = ("m, c, sa, sb, r, sc, carries" if name == "K2"
                    else "m, c, s")
    assert [a.split("*")[-1].strip() for a in head.split(",")
            if a.split("*")[-1].strip() in scratch_args.split(", ")] \
        == scratch_args.split(", ")
    assert len(ptrs) == len(scratch_args.split(", "))


def test_a_chain_cut_into_segments_is_the_chain():
    """K2 cuts a long row's chains into segments that hand their exit state
    on (the wavefront of csrc/lp24.cu): bitwise one chain."""
    rng = np.random.default_rng(97)
    m = torch.from_numpy(rng.uniform(-0.9, 0.9, (3, 1000, 4))
                         .astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 1000, 2)).astype(np.float32))
    s, exit_state = chain(m, c)
    parts, seed = [], None
    for a, b in ((0, 127), (127, 381), (381, 1000)):
        sp, seed = chain(m[:, a:b], c[:, a:b], seed)
        parts.append(sp)
    assert torch.equal(torch.cat(parts, 1), s)
    assert torch.equal(seed, exit_state)


def test_wrappers_route_block_mode_to_the_tiled_kernels(monkeypatch):
    """On a card K4 launches biquad_tiled and K2 lp24_refined_tiled, on the
    coefficients as they were given; K5 and K9 keep biquad_scan; the
    earlier routes are private helpers that count no launch."""
    import inspect

    seen = []
    run = lambda x2, plain, launch, *a: (launch(), x2)[1]  # noqa: E731
    monkeypatch.setattr(biquad_kernels, "_launch_tiled",
                        lambda x2, views: seen.append(("tiled", views)))
    monkeypatch.setattr(biquad_kernels, "_launch",
                        lambda x2, st, ln: seen.append(("scan", st.mode)))
    monkeypatch.setattr(biquad_kernels, "dispatch", run)
    monkeypatch.setattr(iir_kernels, "_launch_refined_tiled",
                        lambda x2, den: seen.append(("refined", den)))
    monkeypatch.setattr(iir_kernels, "dispatch", run)
    x, coefs = _k4_case(2, 256, "row", seed=91)
    biquad_kernels.biquad_blockrate(x, coefs)
    biquad_kernels.biquad_scalar(x, iir.rbj_low_pass(1000.0, 0.7, SR))
    biquad_kernels.biquad_per_sample(
        x, tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                 iir.rbj_low_pass(np.full(256, 900.0, np.float32),
                                  np.float32(0.7), SR)))
    x, secs = _k2_case(2, 256, "time", seed=94)
    iir_kernels.lp24_refined_blockrate(x, secs)
    assert [s[0] for s in seen] == ["tiled", "scan", "scan", "refined"]
    assert seen[1][1] == iir_kernels.SCALAR
    assert seen[2][1] == iir_kernels.SAMPLE
    # the views are the caller's tensors, strides and all
    assert [v.data_ptr() for v in seen[0][1]] == [c.data_ptr() for c in coefs]
    assert [v.stride() for v in seen[0][1]] == [(0, 1)] * 5
    want = [sec[i] for sec in secs for i in (3, 4)]
    assert [d.data_ptr() for d in seen[3][1]] == [c.data_ptr() for c in want]
    assert [d.stride() for d in seen[3][1]] == [(1, 0)] * 4
    for earlier in (iir_kernels._refined_earlier,
                    biquad_kernels._blockrate_earlier):
        text = inspect.getsource(earlier)
        assert "_launch(" in text and "LAUNCHES" not in text


@pytest.mark.parametrize("name", ["K4", "K2"])
def test_arguments_cost_no_torch_operation(name):
    """block_views hands the kernels what the renderer passes (float32
    tensors expanded to [rows, ceil(n / 64)] on x's device) untouched: no
    torch operation on x or on a coefficient; strides_of reads their
    strides. Scalars, other dtypes and leading dimensions are repaired
    with a few view or cast operations and the same values."""
    n = 8193
    if name == "K4":
        x, coefs = _k4_case(3, n, "row", seed=95)
    else:
        x, secs = _k2_case(3, n, "row", seed=96)
        coefs = [sec[i] for sec in secs for i in (3, 4)]
    with _Count() as mode:
        x2, views = iir_kernels.block_views(x, coefs, "kernels")
        strides = iir_kernels.strides_of(views)
    assert mode.ops == []
    assert x2 is x and all(v is c for v, c in zip(views, coefs))
    assert list(strides) == [0, 1] * len(coefs)
    odd = [c[0].double() for c in coefs[:-1]] + [0.25]
    with _Count() as mode:
        x3, views3 = iir_kernels.block_views(x.reshape(3, 1, n), odd,
                                             "kernels")
    assert 0 < len(mode.ops) <= 4 * len(coefs) + 2, mode.ops
    assert x3.shape == (3, n) and torch.equal(x3, x)
    for v, c in zip(views3[:-1], coefs):
        assert v.dtype == torch.float32 and torch.equal(v, c)
    assert torch.equal(views3[-1], torch.full((3, -(-n // 64)), 0.25))
    with pytest.raises(TypeError, match="float32"):
        iir_kernels.block_views(x.double(), coefs, "kernels")


@pytest.mark.parametrize("name", ["K4", "K2"])
def test_tiled_wrappers_refuse_other_devices_and_types(name):
    """No fallback: a meta tensor is refused, float64 is refused, the CPU
    runs the twin and counts no launch."""
    if name == "K4":
        x, co = _k4_case(2, 128, "full", seed=92)
        fn, counts = biquad_kernels.biquad_blockrate, biquad_kernels.LAUNCHES
        meta = tuple(c.to("meta") for c in co)
    else:
        x, co = _k2_case(2, 128, "full", seed=93)
        fn, counts = iir_kernels.lp24_refined_blockrate, iir_kernels.LAUNCHES
        meta = [tuple(c.to("meta") for c in s) for s in co]
    before = dict(counts)
    with pytest.raises(RuntimeError, match="unsupported device"):
        fn(x.to("meta"), meta)
    with pytest.raises(TypeError, match="float32"):
        fn(x.double(), co)
    fn(x, co)
    assert counts == before


# --------------------------------------------------------------------------
# The sources


def _source(name: str) -> str:
    return (build.CSRC / name).read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", _source("tiled.cuh"))
    assert len(found) == 1, name
    return int(found[0])


@pytest.mark.parametrize("ln,constant", [(64, "kSmemBytes64"),
                                         (128, "kSmemBytes128")])
def test_tiled_shared_memory_budget_matches_the_source(ln, constant):
    """The bytes ops/iir_kernels.py reckons for a tile are the source's
    constant (held to the source's own layout by static_assert), at the
    source's slots; three blocks fit an SM's 227 KB."""
    assert _constant("kSlots") == TILED_SLOTS
    got = iir_kernels.tiled_smem_bytes(ln)
    assert got == _constant(constant)
    assert got <= 232448 and 3 * got <= 232448
    assert got == 4 * TILED_SLOTS * ln + 16 * TILED_SLOTS
    assert f"static_assert(smem_bytes({ln}) == {constant}" \
        in _source("tiled.cuh")
    # geometry() never asks for another in-block length
    assert {geometry(n)[0] for n in (1, 64, 4096, 4097, 10**7)} == {64, 128}


def test_tile_counts_follow_the_halo():
    """A tile with a halo advances one block less: the 3-minute row is 485
    tiles for phase 1 and the combine, 489 for the refined passes; the
    source counts tiles the same way."""
    count = lambda nb, halo: len(list(_tiles(nb, TILED_SLOTS, halo)))  # noqa
    assert count(62016, 0) == 485 and count(62016, 1) == 489
    assert [count(nb, 1) for nb in (1, 127, 128)] == [1, 1, 2]
    code = _source("tiled.cuh")
    assert "const int per = kSlots - halo;" in code
    assert "return (nb + per - 1) / per;" in code


def test_build_covers_the_tiled_header(tmp_path, monkeypatch):
    """csrc/tiled.cuh is in the library's hash; its entry points are bound
    with the arguments the sources declare; the tiled kernels call
    tdf2.cuh's device functions and carry no second copy of the
    arithmetic; the chain walker has no barrier of the whole block on its
    path."""
    assert "tiled.cuh" in [p.name for p in build.headers()]
    for src, entry in (("biquad.cu", "biquad_tiled"),
                       ("lp24.cu", "lp24_refined_tiled")):
        assert entry in build.SIGNATURES
        assert f'extern "C" int {entry}(' in _source(src)
        assert '#include "tiled.cuh"' in _source(src)
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    first = build.library_path()
    with open(copy / "tiled.cuh", "a") as f:
        f.write("// changed\n")
    assert build.library_path() != first
    code = re.sub(r"//.*", "", _source("tiled.cuh"))
    for shared in ("tdf2::step(", "tdf2::corr_step(", "tdf2::lp24_defect("):
        assert shared in code, shared
    # the only fused multiply-adds written here prepare b1 - a1 b0 and
    # b2 - a2 b0 (ops/biquad_kernels.py _prep's fma32)
    assert code.count("__fmaf_rn") == 2
    assert code.count("__fmaf_rn(t.") == 2
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in code
    walker = re.sub(r"//.*", "", _source("tdf2.cuh"))
    walker = walker[walker.index("phase2_kernel("):]
    walker = walker[walker.index("__syncthreads();") + 1:]
    assert "__syncthreads" not in walker[:walker.index("inline void chain(")]


def test_stage_cycles_instruments_the_walker_and_the_tiles():
    """kernels/stage_cycles.py finds its anchors in csrc/tdf2.cuh and
    csrc/tiled.cuh: three stamps and a total around the walker's wait, walk
    and hand-back; a stamp after every barrier and at the end of each tiled
    kernel; nothing else changed."""
    from groove_tpu_torch.kernels import stage_cycles as sc

    chain = sc.instrument_chain(_source("tdf2.cuh"))
    assert re.findall(r"CSTAMP\((\d)\);", chain) == ["0", "1", "2"]
    assert chain.count("atomicAdd(&g_chain[3]") == 1
    assert len(sc.CHAIN_STAGES) == 4
    tiled = sc.instrument_tiled(_source("tiled.cuh"))
    assert tiled.count(sc._TILED_DECL) == 1
    stamps = re.findall(r" TSTAMP\(([^;]*)\);",
                        tiled.replace(sc._TILED_DECL, ""))
    assert len(stamps) == sum(b + 1 for _, _, b in sc._TILED_KERNELS) == 12
    assert len(sc.TILED_STAGES) == 16  # refine_kernel's slots count twice
    plain = re.sub(r" TSTAMP\([^;]*\);", "",
                   tiled.replace(sc._TILED_DECL, "")).replace(
        "\n  long long last = clock64();", "")
    assert re.sub(r"\n\s*\n", "\n", plain) == re.sub(
        r"\n\s*\n", "\n", _source("tiled.cuh"))
    for name in ("biquad_tiled", "lp24_refined_tiled"):
        assert name in build.SIGNATURES
