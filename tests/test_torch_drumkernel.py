"""K1's tiled CUDA kernel (groove_tpu_torch/csrc/drums.cu) as far as a host
without a card can hold it: a numpy model of what each thread block does
equals the plain twin (ops/drums.accumulate_hits_plain) bit for bit. The
model takes the tile size and the list's capacity from the source and
walks its steps: the tile's bounds, the candidate chunks (from the one
holding tile_start - row_len - 128 to the one holding the tile's last
frame), the cull of those chunks' hits in rounds of one hit per thread
into an ordered list that is accumulated and emptied when a round would
overflow it, and each thread's 4-frame groups, read as one aligned row
load and masked at the hit's end. The cases: the hit layouts of
tests/test_torch_drums.py, rows longer than a chunk (a hit two chunks
before its tile), hits on chunk edges with the 64-frame shift, gates
below the row's length, n a multiple neither of the tile nor of 4, empty
chunks, and hits every 64 frames that overflow the list several times.
The wrapper's one allocation is counted through a fake library. The
kernel itself is held to the twin on a card by tests/test_torch_cuda.py
and chip_smoke.py."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import drums

CHUNK = drums.CHUNK


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       (build.CSRC / "drums.cu").read_text())
    assert len(found) == 1, name
    return int(found[0])


THREADS = _constant("kThreads")
GROUPS = _constant("kGroups")
CAPACITY = _constant("kList")
TILE = GROUPS * 4 * THREADS


def test_the_source_derives_its_tile_so():
    text = (build.CSRC / "drums.cu").read_text()
    assert "constexpr int kGroupStride = 4 * kThreads;" in text
    assert "constexpr int kTile = kGroups * kGroupStride;" in text
    assert f"static_assert(kTile == {TILE}," in text
    assert CAPACITY >= THREADS  # a round always fits an emptied list


# --------------------------------------------------------------------------
# The model


def model(table, counts, slots, starts, shifts, limits, vels, n: int,
          tile: int = TILE, capacity: int = CAPACITY,
          threads: int = THREADS, stats: dict | None = None) -> np.ndarray:
    """What drums_kernel computes, block by block, in numpy float32.
    `stats` counts the batches a tile accumulated and its candidates."""
    table = np.asarray(table, np.float32)
    row_len = table.shape[-1]
    flat = table.reshape(-1)
    counts = np.asarray(counts)
    nchunks, M = np.asarray(slots).shape
    y = np.empty((2, n), np.float32)
    groups = tile // (4 * threads)
    # the first frame of each thread's groups, in tile-local frames
    group_first = (np.arange(groups)[:, None] * 4 * threads
                   + 4 * np.arange(threads)[None, :]).reshape(-1)
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        lo = t0 - row_len - 128
        c_lo = 0 if lo <= 0 else lo // CHUNK
        c_hi = min(nchunks - 1, (t1 - 1) // CHUNK)
        cand = [(c, i) for c in range(c_lo, c_hi + 1)
                for i in range(counts[c])]
        acc = np.zeros((2, groups * threads, 4), np.float32)
        batch: list = []
        batches = 0
        for base in range(0, len(cand), threads):
            passed = []
            for c, i in cand[base:base + threads]:  # one hit per thread
                on = c * CHUNK + int(starts[c, i]) + 64 * int(shifts[c, i])
                limit = min(int(limits[c, i]), row_len)
                if on < t1 and on + limit > t0:
                    passed.append((int(slots[c, i]) * 2 * row_len, on - t0,
                                   limit,
                                   np.float32(vels[c, i]) / np.float32(127)))
            if len(batch) + len(passed) > capacity:
                _accumulate(acc, flat, row_len, batch, group_first)
                batches += 1
                batch = []
            batch += passed  # in layout order
        _accumulate(acc, flat, row_len, batch, group_first)
        batches += 1
        if stats is not None:
            stats.setdefault("batches", []).append(batches)
            stats.setdefault("candidates", []).append(len(cand))
        frames = (group_first[:, None] + np.arange(4)).reshape(-1)
        out = np.empty((2, tile), np.float32)
        out[:, frames] = acc.reshape(2, -1)
        y[:, t0:t1] = out[:, :t1 - t0]
    return y


def _accumulate(acc, flat, row_len, batch, group_first) -> None:
    """Every thread over the batch in order: for each 4-frame group whose
    first frame k = t - on lies in [0, limit), one aligned 4-sample row
    read per channel, acc + row * scale on the frames before the limit;
    a masked frame is left as it is."""
    for off, rel, limit, scale in batch:
        k = group_first - rel
        live = (k >= 0) & (k < limit)
        if not live.any():
            continue
        kk = k[live]
        assert np.all(kk % 4 == 0) and np.all(kk + 4 <= row_len)
        lanes = (kk[:, None] + np.arange(4)) < limit
        for ch in range(2):
            r = flat[off + ch * row_len + kk[:, None] + np.arange(4)]
            a = acc[ch, live]
            acc[ch, live] = np.where(lanes, a + r * scale, a)


# --------------------------------------------------------------------------
# Cases


def _table(lengths, rows: int | None = None, seed: int = 11):
    rng = np.random.default_rng(seed)
    longest = max(lengths)
    data = (rng.standard_normal((len(lengths), 2, longest)) * 0.5).astype(
        np.float32)
    for s, ln in enumerate(lengths):
        data[s, :, ln:] = 0.0
    # some exact zeros of both signs inside the rows
    data[0, 0, 1:9:2] = -0.0
    data[0, 1, 2:10:2] = 0.0
    return data, np.asarray(lengths, np.int64)


SHORT = [700, 650, 300, 120]
LONG = [70000, 140500, 3000, 66000]
LAYOUTS = {
    # tests/test_torch_drums.py's
    "single-chunk": (SHORT, [0, 1, 2, 3, -1, 0],
                     [0, 128, 192, 1024, 2048, 4096], None, 8192),
    "chunk-edges": (SHORT, [0, 1, 0, 1, 2, 3, 2, 0],
                    [CHUNK - 256, CHUNK - 64, 2 * CHUNK - 128,
                     3 * CHUNK - 192, 512, CHUNK + 960, 2 * CHUNK + 64,
                     3 * CHUNK + 4096], None, CHUNK * 3 + 5000),
    "past-end": (SHORT, [0, 1], [128, 8192], None, 4096),
    "stacked": (SHORT, [0, 1, 2, 3, 0, 1, 2, 3, 0],
                [0, 0, 64, 64, 64, 128, 128, 640, 704], None, 2048),
    # a hit in chunk 0 reaching tiles of chunk 2 (rows longer than a chunk)
    "two-chunks-before": (LONG, [1, 0, 3, 2],
                          [CHUNK - 128 + 64, 6400, CHUNK + 64,
                           2 * CHUNK + 4096], None, 3 * CHUNK + 777),
    # on chunk and tile edges, with and without the 64-frame shift
    "edges-shifted": (SHORT + [5000], [4, 0, 1, 4, 2, 3, 0, 4],
                      [CHUNK - 64, CHUNK, CHUNK + 64, 2 * CHUNK - 64,
                       TILE - 64, TILE, 2 * CHUNK + TILE + 64,
                       3 * CHUNK - 64], None, 3 * CHUNK + 64),
    # gates below the rows' lengths, some not a multiple of 4
    "gated": (LONG, [0, 1, 2, 3, 0, 1], [0, 64, 4096, CHUNK - 64, CHUNK,
                                         CHUNK + 2048],
              [13, 70001, 1, 4097, 66001, 2050], 2 * CHUNK + 100),
    # n a multiple neither of the tile nor of 4
    "ragged-end": (SHORT, [0, 1, 2, 3, 0], [0, 2048, 9664, 9728, 9984],
                   None, 10001),
    # chunks 1 and 2 hold no hit; the last tile no candidate either
    "empty-chunks": (SHORT, [0, 1, 2], [64, 3 * CHUNK + 128,
                                        3 * CHUNK + 192], None, 5 * CHUNK),
    "no-hits": (SHORT, [], [], None, 3000),
}


def _prepared(name: str, seed: int = 0):
    lengths, slots, on, gate, n = LAYOUTS[name]
    data, lengths = _table(lengths)
    slots = np.asarray(slots, np.int32)
    on = np.asarray(on, np.int64)
    vels = np.random.default_rng(len(on) + seed).integers(
        1, 128, len(on)).astype(np.float32)
    gate = np.full(len(on), 2**30, np.int64) if gate is None \
        else np.asarray(gate, np.int64)
    meta = drums.prepare_hits(slots, on, gate, vels, lengths, n)
    return drums.prepare_table(data), meta, n


def _dense(n: int, every: int = 64, seed: int = 5):
    """Hits every `every` frames over rows longer than a chunk, velocities
    and gates from the seed (some gates short)."""
    data, lengths = _table([66100, 30000, 700], seed=seed)
    rng = np.random.default_rng(seed)
    on = np.arange(0, n, every, dtype=np.int64)
    slots = rng.integers(0, 3, len(on)).astype(np.int32)
    vels = rng.integers(1, 128, len(on)).astype(np.float32)
    gate = np.where(rng.random(len(on)) < 0.2, rng.integers(1, 5000, len(on)),
                    2**30)
    meta = drums.prepare_hits(slots, on, gate, vels, lengths, n)
    return drums.prepare_table(data), meta, n


def _twin(ptable, meta, n) -> np.ndarray:
    return drums.accumulate_hits_plain(
        torch.from_numpy(ptable), *[torch.from_numpy(m) for m in meta],
        n_frames=n).numpy()


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_model_equals_twin(name):
    ptable, meta, n = _prepared(name)
    y = model(ptable, *meta, n)
    assert _same_bits(y, _twin(ptable, meta, n))
    assert _same_bits(y, drums.accumulate_hits(
        torch.from_numpy(ptable), *[torch.from_numpy(m) for m in meta],
        n_frames=n).numpy())
    if meta[0].sum():
        assert float(np.abs(y).max()) > 0.0


def test_layouts_reach_what_they_name():
    """The cases do cover what the test names claim."""
    ptable, meta, n = _prepared("two-chunks-before")
    row_len = ptable.shape[-1]
    assert row_len > CHUNK
    counts, _, starts, shifts, limits, _ = meta
    on0 = 0 * CHUNK + starts[0, 0] + 64 * shifts[0, 0]
    assert on0 + limits[0, 0] > 2 * CHUNK  # reaches chunk 2 from chunk 0
    ptable, meta, n = _prepared("gated")
    assert (meta[4][meta[4] > 0] < ptable.shape[-1] - 128).all()
    assert (meta[4][meta[4] > 0] % 4 != 0).any()
    assert _prepared("ragged-end")[2] % 4 and _prepared("ragged-end")[2] % TILE
    assert list(_prepared("empty-chunks")[1][0][:3]) == [1, 0, 0]
    assert set(_prepared("edges-shifted")[1][3].ravel()) == {0, 1}


def test_dense_hits_overflow_the_list_and_stay_exact():
    """Hits every 64 frames over rows longer than a chunk: a tile's
    covering hits fill the list several times over; the batches keep
    layout order and every bit."""
    ptable, meta, n = _dense(CHUNK + 2 * TILE + 64)
    stats: dict = {}
    y = model(ptable, *meta, n, stats=stats)
    assert _same_bits(y, _twin(ptable, meta, n))
    assert max(stats["batches"]) >= 3  # overflowed more than once
    assert max(stats["candidates"]) > THREADS  # more than one round


@pytest.mark.parametrize("tile,capacity,threads", [(128, 32, 16),
                                                   (256, 8, 8),
                                                   (64, 4, 4)])
def test_model_does_not_depend_on_the_tile_or_the_list(tile, capacity,
                                                       threads):
    """Smaller tiles, lists and rounds (batches at every round): the same
    bits."""
    ptable, meta, n = _dense(6000, every=64, seed=7)
    stats: dict = {}
    y = model(ptable, *meta, n, tile=tile, capacity=capacity,
              threads=threads, stats=stats)
    assert _same_bits(y, _twin(ptable, meta, n))
    assert max(stats["batches"]) > 2


def test_rows_must_cover_their_limits():
    """The host layout keeps every limit inside its row, which the row's
    4-sample loads rely on (prepare_table pads 128 frames past the
    longest sample)."""
    for name in LAYOUTS:
        ptable, meta, _ = _prepared(name)
        assert ptable.shape[-1] % 128 == 0
        assert (meta[4] <= ptable.shape[-1] - 128).all()
        starts, shifts = meta[2], meta[3]
        assert ((starts + 64 * shifts) % 64 == 0).all()


# --------------------------------------------------------------------------
# The wrapper


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_card_wrapper_allocates_y_and_nothing_else(monkeypatch):
    """The card route (_launch) with a fake library: one torch operation,
    the allocation of y, and the library's drums_accumulate called with
    the arguments its signature binds on the current stream."""
    from groove_tpu_torch.ops import iir_kernels

    calls = []

    class Library:
        def drums_accumulate(self, *args):
            assert len(args) == len(build.SIGNATURES["drums_accumulate"])
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "library", Library)
    monkeypatch.setattr(iir_kernels, "raw_stream", lambda device: 7)
    ptable, meta, n = _prepared("chunk-edges")
    table = torch.from_numpy(ptable)
    hits = [torch.from_numpy(m) for m in meta]
    with _Count() as mode:
        y = drums._launch(table, *hits, n)
    assert len(mode.ops) == 1 and "empty" in mode.ops[0], mode.ops
    (args,) = calls
    assert args[0] == table.data_ptr() and args[1] == ptable.shape[-1]
    assert list(args[2:8]) == [t.data_ptr() for t in hits]
    assert args[8:11] == (meta[1].shape[0], meta[1].shape[1], CHUNK)
    assert args[11] == y.data_ptr() and args[12:] == (n, 7)
    assert tuple(y.shape) == (2, n) and y.dtype == torch.float32


def test_card_wrapper_keeps_its_checks(monkeypatch):
    """Inputs the kernel cannot take are refused before any launch: wrong
    dtype or device of a hit array, too few chunks, a table whose rows
    break the 4-frame alignment; a meta tensor is no CPU and no card."""

    class Library:
        def drums_accumulate(self, *args):
            raise AssertionError("launched")

    monkeypatch.setattr(build, "library", Library)
    ptable, meta, n = _prepared("single-chunk")
    table = torch.from_numpy(ptable)
    hits = [torch.from_numpy(m) for m in meta]
    bad = list(hits)
    bad[1] = hits[1].long()
    with pytest.raises(ValueError, match="slots"):
        drums._launch(table, *bad, n)
    with pytest.raises(ValueError, match="fewer hit chunks"):
        drums._launch(table, *hits, 2 * CHUNK)
    with pytest.raises(ValueError, match="multiple of 4"):
        drums._launch(table[..., :-1].contiguous(), *hits, n)
    with pytest.raises(RuntimeError, match="unsupported device"):
        drums.accumulate_hits(table.to("meta"), *hits, n_frames=n)
    before = dict(drums.LAUNCHES)
    drums.accumulate_hits(table, *hits, n_frames=n)  # the CPU: the twin
    assert drums.LAUNCHES == before
