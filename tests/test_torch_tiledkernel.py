"""K4, K5, K2, K3 and static K6 around their tiled CUDA kernels
(groove_tpu_torch/csrc/tiled.cuh through biquad_tiled, lp24_refined_tiled
and lp24_tiled), as far as a host without a card can hold them: a
pure-torch model of the tiled walk (tiles of T ln-blocks staged with zeros
past n, block maps only out of phase 1, prefix rows re-scanned in every
combine, the refined cascade's defect taking its history across tiles from
a re-run halo block, section B's maps from the values the first section's
last combine holds in its tile, a row cut into segments whose chains hand
their states on) equals the plain twins bit for bit, at every in-block
length; the wrappers' routes and buffers (allocations counted, no torch
operation on x or the coefficients); the shared-memory budget and the
wavefront's segment count against the source; the build's cover of the
new header. The kernels themselves are held to the twins and to their
earlier routes on a card by tests/test_torch_cuda.py."""

from __future__ import annotations

import importlib.util
import re
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import biquad_kernels, iir, iir_kernels
from groove_tpu_torch.ops.iir_kernels import (BLOCK, SCALAR, TILED_SLOTS,
                                              Streams, _corr_phase1, chain,
                                              geometry, phase1)

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


def model_combine(z2, coefs, s, first: int, count: int, ln: int, T: int,
                  nxt=None):
    """One tile of a combine: out = b0 z + ((p11 S1 + p12 S2) + q1) with
    the prefix rows re-scanned from the staged tile (zeros past n) and the
    entry states s; coefs: (na1, na2, b1m, b2m, b0) per sample. With the
    next lp24 section's negated denominators `nxt`, also that section's
    block maps of out, in the same loop (its phase 1)."""
    z = _stage(z2, first, T, ln)[:, :count]
    cut = [_blocks(v, first, count, ln) for v in coefs]
    p11, p12, q1, _, _ = phase1(*cut[:4], z, ln)
    S = s[:, first:first + count]
    out = cut[4] * z + (p11 * S[..., 0:1] + p12 * S[..., 1:2] + q1)
    maps = None
    if nxt is not None:
        an, bn = (_blocks(v, first, count, ln) for v in nxt)
        maps = phase1(an, bn, 2.0 + an, 1.0 + bn, out, ln)[3:]
    return out, maps


def _put(y, out, first: int, count: int, ln: int) -> None:
    """A tile's output blocks into the rows y [B, n], samples below n."""
    lo = first * ln
    hi = min(lo + count * ln, y.shape[1])
    y[:, lo:hi] = out.reshape(y.shape[0], -1)[:, :hi - lo]


def model_k4(x2, st: Streams, ln: int, T: int) -> torch.Tensor:
    """biquad_tiled: maps, chain, combine (prefix rows re-scanned)."""
    B, n = x2.shape
    nb = -(-n // ln)
    coefs = st.per_sample(B, nb * ln, x2.device)
    m, c = model_maps(x2, coefs[:4], ln, T)
    s, _ = chain(m, c)
    y = torch.empty_like(x2)
    for first, count in _tiles(nb, T, 0):
        _put(y, model_combine(x2, coefs, s, first, count, ln, T)[0], first,
             count, ln)
    return y


def model_single(x2, na, ln: int, T: int, segments: int = 1) -> torch.Tensor:
    """lp24_tiled (K3, static K6): section A's maps; then per segment of
    whole tiles section A's chain (from the state the segment before handed
    on), section A's combine, which also gives section B's maps of its
    output, section B's chain (handed on likewise) and section B's combine.
    One array of entry states serves both chains. na: the four negated
    denominators per sample [B, npad]."""
    B, n = x2.shape
    nb = -(-n // ln)
    one = torch.ones_like(na[0])
    sec = [(na[0], na[1], 2.0 + na[0], 1.0 + na[1], one),
           (na[2], na[3], 2.0 + na[2], 1.0 + na[3], one)]
    m, c = model_maps(x2, sec[0][:4], ln, T)
    tiles = list(_tiles(nb, T, 0))
    each = -(-len(tiles) // segments)
    s = torch.empty((B, nb, 2))
    ya, y = torch.empty_like(x2), torch.empty_like(x2)
    seed = [None, None]
    for i in range(0, len(tiles), each):
        part = tiles[i:i + each]
        k0, k1 = part[0][0], part[-1][0] + part[-1][1]
        s[:, k0:k1], seed[0] = chain(m[:, k0:k1], c[:, k0:k1], seed[0])
        for first, count in part:
            out, maps = model_combine(x2, sec[0], s, first, count, ln, T,
                                      nxt=sec[1][:2])
            _put(ya, out, first, count, ln)
            m[:, first:first + count], c[:, first:first + count] = maps
        s[:, k0:k1], seed[1] = chain(m[:, k0:k1], c[:, k0:k1], seed[1])
        for first, count in part:
            _put(y, model_combine(ya, sec[1], s, first, count, ln, T)[0],
                 first, count, ln)
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


def _k5_case(rows: int, n: int, seed: int):
    """A static section (K5's render route: the filter bank's peaking EQ
    and its like), its kind, corner and q from the seed."""
    rng = np.random.default_rng(seed)
    cutoff = float(rng.choice([40.0, 300.0, 2000.0, 8000.0]))
    q = float(rng.uniform(0.5, 4.0))
    coefs = (iir.rbj_peaking_eq(cutoff, q, 6.0, SR) if seed % 2
             else iir.rbj_low_pass(cutoff, q, SR))
    return _x(rows, n, seed), coefs


def _k2_case(rows: int, n: int, kind: str, seed: int):
    nb = -(-n // 64)
    cut = _cutoffs(rows, nb, kind)
    gain, secs = iir.lp24_sections(cut, np.float32(2.0), SR)
    x = _x(rows, n, seed) * torch.from_numpy(
        np.repeat(gain, 64, axis=1)[:, :n].astype(np.float32))
    return x, [_as_views(sec, kind, rows, nb) for sec in secs]


def _k6_case(rows: int, n: int, seed: int):
    """A static lp24 (K6's render route: the filter bank's lp24-8k and its
    like), cutoff and q from the seed, down to the 40 Hz corner."""
    rng = np.random.default_rng(seed)
    cutoff = float(rng.choice([40.0, 300.0, 2000.0, 8000.0]))
    gain, secs = iir.lp24_sections(cutoff, float(rng.uniform(0.5, 2.0)), SR)
    return _x(rows, n, seed) * float(gain), secs


def _single_case(kernel: str, rows: int, n: int, kind: str, seed: int):
    """(x, sections, x2, the four negated denominators per sample, ln) of a
    K3 (block-rate, `kind` strides) or a static K6 call."""
    if kernel == "K3":
        x, secs = _k2_case(rows, n, kind, seed)
        x2, den = iir_kernels._prepare(x, secs, 64)
        ln = geometry(n)[0]
        na = [iir_kernels._per_sample(d, -(-n // ln) * ln) for d in den]
        return x, secs, x2, na, ln
    x, secs = _k6_case(rows, n, seed)
    x2, st = iir_kernels._prepare_cascade(x, secs)
    ln = geometry(n, blockrate=False)[0]
    return x, secs, x2, st.per_sample(rows, -(-n // ln) * ln, x.device), ln


def _single_twin(kernel: str, x, secs) -> torch.Tensor:
    if kernel == "K3":
        x2, den = iir_kernels._prepare(x, secs, 64)
        return iir_kernels.lp24_blockrate_plain(x2, *den)
    return iir_kernels.lp24_cascade_plain(x, secs)


def _single_wrapper(kernel: str):
    return (iir_kernels.lp24_blockrate if kernel == "K3"
            else iir_kernels.lp24_cascade)


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


@pytest.mark.parametrize("i,n", list(enumerate(SIZES)))
def test_k3_tiled_model_equals_twin(i, n):
    """K3 on lp24_tiled: section A's combine also gives section B's maps;
    every n around a block and a tile edge."""
    rows, kind = ROWS[(i + 2) % 3], KINDS[(i + 1) % 3]
    x, secs, x2, na, ln = _single_case("K3", rows, n, kind, seed=100 + i)
    y = model_single(x2, na, ln, TILED_SLOTS)
    assert torch.equal(y, _single_twin("K3", x, secs))
    assert torch.equal(y, iir_kernels.lp24_blockrate(x, secs))
    assert float(y.abs().max()) > 0.0


# n for each in-block length of a static section: ln 16 up to 256 frames,
# 32 up to 1024, 64 up to 4096, then 128
K6_SIZES = [1, 200, 257, 1000, 1025, 4096, 4097, LN128 + 1]


@pytest.mark.parametrize("i,n", list(enumerate(K6_SIZES)))
def test_k6_static_tiled_model_equals_twin(i, n):
    """Static K6 on lp24_tiled at every ln that block_for gives it (16 and
    32 too: one coefficient set a block, the 4-chunk swizzle)."""
    x, secs, x2, na, ln = _single_case("K6", ROWS[i % 3], n, "", 120 + i)
    assert ln == [16, 16, 32, 32, 64, 64, 128, 128][i]
    y = model_single(x2, na, ln, TILED_SLOTS)
    assert torch.equal(y, _single_twin("K6", x, secs))
    assert torch.equal(y, iir_kernels.lp24_cascade(x, secs))
    assert float(y.abs().max()) > 0.0


@pytest.mark.parametrize("i,n", list(enumerate(SIZES + K6_SIZES)))
def test_k5_tiled_model_equals_twin(i, n):
    """K5 on biquad_tiled by value: the walk of K4 with SCALAR streams, at
    every ln that block_for gives a static section (16 up to 256 frames,
    32 up to 1024, 64 up to 4096, then 128) and every n around a block and
    a tile edge."""
    x, coefs = _k5_case(ROWS[i % 3], n, seed=170 + i)
    x2, st, ln = biquad_kernels._prepare(x, coefs, SCALAR)
    assert st.mode == SCALAR and ln == geometry(n, blockrate=False)[0]
    y = model_k4(x2, st, ln, TILED_SLOTS)
    assert torch.equal(y, biquad_kernels.biquad_scalar_plain(x, coefs))
    assert torch.equal(y, biquad_kernels.biquad_scalar(x, coefs))
    assert float(y.abs().max()) > 0.0


def test_k5_sizes_reach_every_in_block_length():
    lns = {geometry(n, blockrate=False)[0] for n in SIZES + K6_SIZES}
    assert lns == {16, 32, 64, 128}


@pytest.mark.parametrize("kernel,n,T,segments", [
    ("K3", 8193 + 64 * 5, 7, 3), ("K3", LN128 + 1, TILED_SLOTS, 2),
    ("K6", 200, 2, 3), ("K6", 1000, 3, 4), ("K6", 8193, 5, 8)])
def test_segments_hand_their_chain_states_on(kernel, n, T, segments):
    """A row cut into segments of whole tiles (the wavefront of
    csrc/lp24.cu): both chains start each segment from the state the one
    before handed on, and the row is bitwise one segment."""
    x, secs, x2, na, ln = _single_case(kernel, 2, n, "full", seed=140 + T)
    nb = -(-n // ln)
    assert -(-nb // T) >= segments
    y = model_single(x2, na, ln, T, segments)
    assert torch.equal(y, model_single(x2, na, ln, T))
    assert torch.equal(y, _single_twin(kernel, x, secs))


@pytest.mark.parametrize("kernel", ["K3", "K6"])
def test_zero_fill_reaches_no_output_of_the_single_pass(kernel):
    """Samples past n (garbage staged there, other denominators) change
    only the last block's maps, never an output below n: the fused
    combine's continuation past n is harmless."""
    n = 8193
    x, secs, x2, na, ln = _single_case(kernel, 2, n, "full", seed=150)
    longer = torch.cat([x2, torch.full((2, 100), 3.0)], 1)
    extra = -(-(n + 100) // ln) * ln - na[0].shape[1]
    na_l = [torch.nn.functional.pad(v, (0, extra), value=-0.5) for v in na]
    y = model_single(longer, na_l, ln, TILED_SLOTS)[:, :n]
    assert torch.equal(y, _single_twin(kernel, x, secs))


@pytest.mark.parametrize("kernel", ["K4", "K5", "K2", "K3", "K6"])
@pytest.mark.parametrize("rows,kind,T", [(1, "full", 2), (2, "row", 3),
                                         (5, "time", 7)])
def test_many_small_tiles_equal_twin(kernel, rows, kind, T):
    """Many tiles a row (T blocks each, the last one short, a halo at every
    tile edge): the walk does not depend on the tile size."""
    n = 8193 + 64 * rows  # ln = 128; neither a block nor a tile multiple
    if kernel in ("K3", "K6"):
        x, secs, x2, na, ln = _single_case(kernel, rows, n, kind, 160 + T)
        y = model_single(x2, na, ln, T)
        want = _single_twin(kernel, x, secs)
    elif kernel == "K4":
        x, coefs = _k4_case(rows, n, kind, seed=60 + T)
        x2, st, ln = biquad_kernels._prepare(x, coefs, BLOCK)
        y = model_k4(x2, st, ln, T)
        want = biquad_kernels.biquad_blockrate_plain(x, coefs)
    elif kernel == "K5":
        x, coefs = _k5_case(rows, n, seed=65 + T)
        x2, st, ln = biquad_kernels._prepare(x, coefs, SCALAR)
        y = model_k4(x2, st, ln, T)
        want = biquad_kernels.biquad_scalar_plain(x, coefs)
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
                         [("K4", 1, 2, 0), ("K5", 1, 2, 0), ("K2", 2, 5, 4),
                          ("K3", 2, 2, 2), ("K6", 2, 2, 2)])
@pytest.mark.parametrize("rows,n", [(2, 8193), (5, 64)])
def test_buffers_are_the_only_torch_operations(name, outputs, pairs, carries,
                                               rows, n):
    """A tiled call allocates its outputs (K4, K5: y; K2: y and the first
    section's output) and one scratch buffer, and makes no other torch
    operation: x is neither padded nor copied."""
    x2 = _x(rows, n, seed=90)
    ln = geometry(n, blockrate=name not in ("K5", "K6"))[0]
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
    text = _source("biquad.cu" if name in ("K4", "K5") else "lp24.cu")
    entry = {"K4": "biquad_tiled", "K5": "biquad_tiled",
             "K2": "lp24_refined_tiled"}.get(name, "lp24_tiled")
    head = text[text.index(f'extern "C" int {entry}('):]
    head = head[:head.index(")")]
    scratch_args = {"K4": "m, c, s", "K5": "m, c, s",
                    "K2": "m, c, sa, sb, r, sc, carries"}.get(
        name, "m, c, s, carries")
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
    """On a card K4 launches biquad_tiled on the coefficients as they were
    given, K5 biquad_tiled on the five static values, K2
    lp24_refined_tiled; K9 keeps biquad_scan; the earlier routes are
    private helpers that count no launch."""
    import inspect

    seen = []
    run = lambda x2, plain, launch, *a: (launch(), x2)[1]  # noqa: E731
    monkeypatch.setattr(biquad_kernels, "_launch_tiled",
                        lambda x2, ln, views=None, values=None: seen.append(
                            ("tiled", ln, views, values)))
    monkeypatch.setattr(biquad_kernels, "_launch",
                        lambda x2, st, ln: seen.append(("scan", st.mode)))
    monkeypatch.setattr(biquad_kernels, "dispatch", run)
    monkeypatch.setattr(iir_kernels, "_launch_refined_tiled",
                        lambda x2, den: seen.append(("refined", den)))
    monkeypatch.setattr(iir_kernels, "dispatch", run)
    x, coefs = _k4_case(2, 256, "row", seed=91)
    biquad_kernels.biquad_blockrate(x, coefs)
    static = iir.rbj_low_pass(1000.0, 0.7, SR)
    biquad_kernels.biquad_scalar(x, static)
    biquad_kernels.biquad_per_sample(
        x, tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                 iir.rbj_low_pass(np.full(256, 900.0, np.float32),
                                  np.float32(0.7), SR)))
    x, secs = _k2_case(2, 256, "time", seed=94)
    iir_kernels.lp24_refined_blockrate(x, secs)
    assert [s[0] for s in seen] == ["tiled", "tiled", "scan", "refined"]
    assert seen[0][1] == 64 and seen[0][3] is None
    assert seen[1][1] == 16 and seen[1][2] is None
    assert seen[1][3] == [np.float32(c) for c in static]
    assert seen[2][1] == iir_kernels.SAMPLE
    # the views are the caller's tensors, strides and all
    assert [v.data_ptr() for v in seen[0][2]] == [c.data_ptr() for c in coefs]
    assert [v.stride() for v in seen[0][2]] == [(0, 1)] * 5
    want = [sec[i] for sec in secs for i in (3, 4)]
    assert [d.data_ptr() for d in seen[3][1]] == [c.data_ptr() for c in want]
    assert [d.stride() for d in seen[3][1]] == [(1, 0)] * 4
    for earlier in (iir_kernels._refined_earlier,
                    biquad_kernels._blockrate_earlier):
        text = inspect.getsource(earlier)
        assert "_launch(" in text and "LAUNCHES" not in text


@pytest.mark.parametrize("rows,n,ln", [(2, 200, 16), (3, 1000, 32),
                                       (1, 4000, 64), (2, 8193, 128)])
def test_biquad_scalar_calls_biquad_tiled_by_value(monkeypatch, rows, n, ln):
    """On a card K5 calls the library's biquad_tiled in scalar mode with
    the arguments its signature binds: x itself, no arrays, the five
    float32 values b0, b1, b2, a1, a2, y and the scratch of tiled_buffers,
    at block_for(n, 128); before the launch the call's only torch
    operations are those two allocations, none on x."""
    from groove_tpu_torch.kernels import build as kbuild

    calls = []

    class Library:
        def biquad_tiled(self, *args):
            assert len(args) == len(kbuild.SIGNATURES["biquad_tiled"])
            calls.append((args, list(mode.ops)))
            return 0

    monkeypatch.setattr(kbuild, "library", Library)
    monkeypatch.setattr(biquad_kernels, "check_input", lambda x2, what: None)
    monkeypatch.setattr(biquad_kernels, "raw_stream", lambda device: 0)
    monkeypatch.setattr(biquad_kernels, "dispatch",
                        lambda x2, plain, launch, *a: launch())
    x, coefs = _k5_case(rows, n, seed=180 + ln)
    before = dict(biquad_kernels.LAUNCHES)
    with _Count() as mode:
        y = biquad_kernels.biquad_scalar(x, coefs)
    (args, ops), = calls
    assert len(ops) == 2 and all("empty" in op for op in ops), ops
    # after the launch: at most a view of y back to x's shape
    assert all("view" in op for op in mode.ops[2:]), mode.ops
    assert args[0] == SCALAR and args[1] == x.data_ptr()
    assert [a.value for a in args[2:7]] == [None] * 5
    assert args[7] is None and args[8] == 1
    assert list(args[9:14]) == [np.float32(c) for c in coefs]
    assert all(type(a) is np.float32 for a in args[9:14])
    assert args[14] == y.data_ptr() and args[-4:] == (rows, n, ln, 0)
    assert biquad_kernels.LAUNCHES == before  # the fake dispatch counts none


def test_lp24_wrappers_route_to_lp24_tiled(monkeypatch):
    """On a card K3 and static K6 call the library's lp24_tiled with the
    arguments its signature binds: K3's denominators are the caller's
    tensors, strides and all, K6's the positive values by value, each at
    its in-block length; per-sample K6 stays on the multi-launch
    lp24_cascade; the earlier route is a private helper that counts no
    launch."""
    import inspect

    from groove_tpu_torch.kernels import build as kbuild

    calls = []

    class Library:
        def lp24_tiled(self, *args):
            assert len(args) == len(kbuild.SIGNATURES["lp24_tiled"])
            calls.append(("tiled", args))
            return 0

    monkeypatch.setattr(kbuild, "library", Library)
    monkeypatch.setattr(iir_kernels, "check_input", lambda x2, what: None)
    monkeypatch.setattr(iir_kernels, "raw_stream", lambda device: 0)
    monkeypatch.setattr(iir_kernels, "_launch", lambda refined, x2, st, ln: (
        calls.append(("cascade", st.mode, ln)), x2)[1])
    monkeypatch.setattr(iir_kernels, "dispatch", lambda x2, plain, launch,
                        *a: launch())
    x, secs = _k2_case(2, 5000, "time", seed=98)
    iir_kernels.lp24_blockrate(x, secs)
    _, static = iir.lp24_sections(8000.0, 0.707, SR)
    iir_kernels.lp24_cascade(x[:, :300], static)
    cut = np.geomspace(60.0, 15000.0, 300).astype(np.float32)
    _, ps = iir.lp24_sections(cut, np.float32(0.9), SR)
    iir_kernels.lp24_cascade(x[:, :300], ps)
    assert [c[0] for c in calls] == ["tiled", "tiled", "cascade"]
    k3, k6 = calls[0][1], calls[1][1]
    want = [sec[i] for sec in secs for i in (3, 4)]
    assert k3[0] == iir_kernels.BLOCK and k3[1] == x.data_ptr()
    assert [a.value for a in k3[2:6]] == [c.data_ptr() for c in want]
    assert list(k3[6]) == [1, 0] * 4 and k3[7] == -(-5000 // 64)
    assert k3[-2] == 128
    assert k6[0] == iir_kernels.SCALAR and k6[6] is None
    assert [a.value for a in k6[2:6]] == [None] * 4
    assert list(k6[8:12]) == [float(np.float32(sec[i])) for sec in static
                              for i in (3, 4)]
    assert k6[-2] == 32
    assert calls[2][1:] == (iir_kernels.SAMPLE, 32)
    text = inspect.getsource(iir_kernels._cascade_earlier)
    assert "_launch(" in text and "LAUNCHES" not in text


def test_static_lp24_arguments_cost_no_torch_operation(monkeypatch):
    """On a card static K6 hands lp24_tiled x itself and the four positive
    denominators by value: no torch operation before the launch."""
    x, secs = _k6_case(3, 8193, seed=99)
    seen = []

    def launch(x2, ln, values):
        seen.append((x2, ln, values, list(mode.ops)))
        return x2

    monkeypatch.setattr(iir_kernels, "_launch_lp24_tiled", launch)
    monkeypatch.setattr(iir_kernels, "dispatch", lambda x2, plain, go,
                        *a: go())
    with _Count() as mode:
        iir_kernels.lp24_cascade(x, secs)
    (x2, ln, values, ops), = seen
    assert ops == [] and x2 is x and ln == 128
    assert values == [np.float32(sec[i]) for sec in secs for i in (3, 4)]
    with pytest.raises(TypeError, match="float32"):
        iir_kernels.lp24_cascade(x.double(), secs)


@pytest.mark.parametrize("name", ["K4", "K2", "K3"])
def test_arguments_cost_no_torch_operation(name):
    """block_views hands the kernels what the renderer passes (float32
    tensors expanded to [rows, ceil(n / 64)] on x's device) untouched: no
    torch operation on x or on a coefficient; strides_of reads their
    strides. Scalars, other dtypes and leading dimensions are repaired
    with a few view or cast operations and the same values."""
    n = 8193
    if name == "K4":
        x, coefs = _k4_case(3, n, "row", seed=95)
    else:  # K2 and K3 take the same denominators
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


@pytest.mark.parametrize("name", ["K4", "K5", "K2", "K3", "K6"])
def test_tiled_wrappers_refuse_other_devices_and_types(name):
    """No fallback: a meta tensor is refused, float64 is refused, the CPU
    runs the twin and counts no launch."""
    if name == "K4":
        x, co = _k4_case(2, 128, "full", seed=92)
        fn, counts = biquad_kernels.biquad_blockrate, biquad_kernels.LAUNCHES
        meta = tuple(c.to("meta") for c in co)
    elif name == "K6":
        x, co = _k6_case(2, 128, seed=93)
        fn, counts = iir_kernels.lp24_cascade, iir_kernels.LAUNCHES
        meta = co
    elif name == "K5":
        x, co = _k5_case(2, 128, seed=93)
        fn, counts = biquad_kernels.biquad_scalar, biquad_kernels.LAUNCHES
        meta = co
    else:
        x, co = _k2_case(2, 128, "full", seed=93)
        fn = (iir_kernels.lp24_refined_blockrate if name == "K2"
              else iir_kernels.lp24_blockrate)
        counts = iir_kernels.LAUNCHES
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


@pytest.mark.parametrize("ln,constant", [(16, "kSmemBytes16"),
                                         (32, "kSmemBytes32"),
                                         (64, "kSmemBytes64"),
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
    # geometry() never asks for another in-block length: 64 and 128 for
    # the block-rate kernels, 16 to 128 for a static section
    sizes = (1, 64, 256, 257, 1024, 1025, 4096, 4097, 10**7)
    assert {geometry(n)[0] for n in sizes} == {64, 128}
    assert {geometry(n, blockrate=False)[0] for n in sizes} == {16, 32, 64,
                                                                128}


@pytest.mark.parametrize("ln", [16, 32, 64, 128])
def test_every_in_block_length_has_its_instantiations(ln):
    """biquad.cu instantiates K5's tiled scan (kScalar) at every in-block
    length a static section takes and K4's (kBlock) at 64 and 128, as
    lp24.cu does for static K6 and K3; each instantiation allows its
    kernels the tile's shared memory once per device before it launches."""
    for src, entry in (("biquad.cu", "tiled_scan"),
                       ("lp24.cu", "single_tiled")):
        text = _source(src)
        assert f"{entry}<tdf2::kScalar, {ln}>(" in text, (src, ln)
        if ln >= 64:
            assert re.search(rf"{entry}<(tdf2::)?kBlock, {ln}>\(", text), (
                src, ln)
        body = text[text.index(f"int {entry}("):]
        body = body[:body.index("\n}\n")]
        assert "constexpr int kBytes = tiled::smem_bytes(kLn);" in body
        flat = re.sub(r"\s+", " ", body)
        allowed = set(re.findall(r"tiled::allow\((tiled::\w+<[^;]*?>),", flat))
        launched = set(re.findall(r"(tiled::\w+_kernel<[^;]*?>) ?<<<", flat))
        assert launched and launched <= allowed, (src, launched, allowed)
        assert body.index("allowed[dev] = true;") < body.index("<<<")
    assert iir_kernels.tiled_smem_bytes(ln) <= 232448 // 3


@pytest.mark.parametrize("kind,passes", [("K2", 4), ("K3", 2), ("K6", 2),
                                         ("K7", 2), ("K8", 4)])
def test_bound_counts_one_chain_of_a_cascade(kind, passes):
    """chip_smoke's bound for a cascade is the function's dependency chain:
    one chain of n / ln steps (its chains can run as a wavefront) and
    every pass's in-block scans, for a row of one tile and for a long row
    alike, whatever the kernel's segments."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", build.CSRC.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for n in (4096, 65536, 441024, 7938048):
        ln = (64 if kind in ("K7", "K8")
              else geometry(n, blockrate=kind != "K6")[0])
        _, flops, chain = smoke.iir_work(kind, 2, n, 0.0)
        assert chain == 2 * ln * passes + 3 * -(-n // ln)
        assert flops > 2 * n * 36
    assert smoke.iir_work("K4", 2, 65536, 0.0)[2] == 2 * 128 + 3 * 512


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
                       ("lp24.cu", "lp24_refined_tiled"),
                       ("lp24.cu", "lp24_tiled")):
        assert entry in build.SIGNATURES
        assert f'extern "C" int {entry}(' in _source(src)
        assert '#include "tiled.cuh"' in _source(src)
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    first = build.library_path()
    for name in ("tiled.cuh", "biquad.cu", "drums.cu"):
        with open(copy / name, "a") as f:
            f.write("// changed\n")
        assert build.library_path() != first
        first = build.library_path()
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
    # the combine's and refine_kernel's slots count twice (kNext)
    assert len(sc.TILED_STAGES) == 19
    plain = re.sub(r" TSTAMP\([^;]*\);", "",
                   tiled.replace(sc._TILED_DECL, "")).replace(
        "\n  long long last = clock64();", "")
    assert re.sub(r"\n\s*\n", "\n", plain) == re.sub(
        r"\n\s*\n", "\n", _source("tiled.cuh"))
    for name in ("biquad_tiled", "lp24_refined_tiled", "lp24_tiled"):
        assert name in build.SIGNATURES
