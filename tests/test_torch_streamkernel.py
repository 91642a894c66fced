"""The stream kernels K7/K8 around their one-launch CUDA kernel
(groove_tpu_torch/csrc/lp24_stream.cu), as far as a host without a card
can hold them: the property the kernel's tile walk rests on (chaining
tiles through the state is bitwise one call, from a non-zero state, for
every tile size the kernel could use), the wrappers' argument preparation
(strided and broadcast coefficient views, positive denominators, the
number of torch operations it makes), the shared-memory budget the loader
hands to the library, and the build's cover of the new source. The kernel
itself is held to the twins on a card by tests/test_torch_cuda.py."""

from __future__ import annotations

import re
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from groove_tpu_torch.kernels import build
from groove_tpu_torch.models import welsh
from groove_tpu_torch.ops import iir, iir_kernels

SR = 44100.0
TILE = iir_kernels.STREAM_TILE
WRAPPERS = {"K7": (iir_kernels.lp24_blockrate_stream, "lp24_stream",
                   iir_kernels.lp24_blockrate_stream_plain),
            "K8": (iir_kernels.lp24_refined_blockrate_stream,
                   "lp24_refined_stream",
                   iir_kernels.lp24_refined_blockrate_stream_plain)}


def _inputs(name: str, rows: int, n: int, seed: int):
    """A cascade input [rows, n] and block-rate sections [rows, n / 64]:
    a sweep that rests near the corner for K8 (q 2), a bright one for K7;
    every row has its own cutoff curve."""
    rng = np.random.default_rng(seed)
    nb = n // 64
    lo, hi, q = (0.05, 0.5, 2.0) if name == "K8" else (0.4, 0.9, 0.707)
    t = np.linspace(lo, hi, nb)[None, :] + 0.02 * np.arange(rows)[:, None]
    cut = (25.0 * 800.0 ** t).astype(np.float32)
    gain, secs = iir.lp24_sections(cut, np.float32(q), SR)
    x = (rng.standard_normal((rows, n)) * 0.3
         * np.repeat(gain, 64, axis=1)).astype(np.float32)
    secs = [tuple(torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.asarray(c, np.float32), (rows, nb)))) for c in s) for s in secs]
    return torch.from_numpy(x), secs


def _cut(secs, a: int, b: int):
    return [tuple(c[:, a // 64:b // 64] for c in s) for s in secs]


def _carried(name: str, rows: int, seed: int):
    """A non-zero state: what 256 frames from rest leave behind."""
    fn, key, _ = WRAPPERS[name]
    x, secs = _inputs(name, rows, 256, seed)
    _, st = fn(x, secs, torch.zeros(rows, iir_kernels.STATE_ROWS[key]))
    assert float(st.abs().min(dim=0).values.max()) > 0.0
    return st


@pytest.mark.parametrize("n", [TILE, 2 * TILE + 192, 64])
@pytest.mark.parametrize("tile", [64, 1024, TILE])
@pytest.mark.parametrize("name", ["K7", "K8"])
def test_tile_walk_is_one_call(name, tile, n):
    """The kernel walks a row in tiles, each a chained call that never
    leaves the SM. Chaining the twins over tiles of `tile` frames (the
    last one short) from a carried state gives the bits of one call, y
    and state."""
    fn = WRAPPERS[name][0]
    rows = 2
    x, secs = _inputs(name, rows, n, seed=11)
    st0 = _carried(name, rows, seed=12)
    y, st = fn(x, secs, st0)
    parts, carry = [], st0
    for a in range(0, n, tile):
        b = min(a + tile, n)
        ya, carry = fn(x[:, a:b], _cut(secs, a, b), carry)
        parts.append(ya)
    assert torch.equal(torch.cat(parts, 1), y)
    assert torch.equal(carry, st)
    assert not torch.equal(st, st0)


@pytest.mark.parametrize("name", ["K7", "K8"])
def test_wrapper_takes_strided_and_positive_denominators(name):
    """Row-broadcast (stride 0) and column-sliced coefficient views give
    the bits of their contiguous copies, and the wrapper, which hands the
    kernel the positive a1, a2, equals the twin called on the negated
    contiguous arrays (the earlier wrapper's path)."""
    fn, _, plain = WRAPPERS[name]
    rows, n = 3, 512
    x, secs = _inputs(name, rows, n, seed=13)
    st = _carried(name, rows, seed=14)
    y, st2 = fn(x, secs, st)
    neg = [(-s[i]).contiguous() for s in secs for i in (3, 4)]
    y_n, st_n = plain(x, *neg, st)
    assert torch.equal(y, y_n) and torch.equal(st2, st_n)
    shared = [tuple(c[0] for c in s) for s in secs]
    views = [tuple(c.expand(rows, -1) for c in s) for s in shared]
    assert views[0][3].stride() == (0, 1)
    y_b, st_b = fn(x, views, st)
    y_c, st_c = fn(x, [tuple(c.contiguous() for c in s) for s in views], st)
    assert torch.equal(y_b, y_c) and torch.equal(st_b, st_c)
    wide = [tuple(torch.cat([c, c], 1) for c in s) for s in secs]
    y_s, st_s = fn(x, _cut(wide, n, 2 * n), st)
    assert torch.equal(y_s, y) and torch.equal(st_s, st2)
    # leading dimensions fold into rows and unfold again
    y3, st3 = fn(x.reshape(3, 1, n), [tuple(c.reshape(3, 1, -1) for c in s)
                                      for s in secs], st.reshape(3, 1, -1))
    assert y3.shape == (3, 1, n) and st3.shape == (3, 1, st.shape[1])
    assert torch.equal(y3.reshape(3, n), y)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# torch operations stream_args may make: none for what the sliced render
# passes (contiguous float32 [n, S] rows, [n, S / 64] coefficients and an
# [n, rows] state on one device); for arguments that need every repair
# (float64 1-D coefficients to cast and expand, a transposed x, a float64
# state of another shape) a cast, an expand and a view per coefficient,
# and a copy, a cast and a view for x and the state.
RENDER_ARG_OPS = 0
WORST_ARG_OPS = 20


@pytest.mark.parametrize("name", ["K7", "K8"])
def test_argument_preparation_makes_no_torch_operation(name):
    key = WRAPPERS[name][1]
    rows = iir_kernels.STATE_ROWS[key]
    x, secs = _inputs(name, 4, 256, seed=15)
    st = _carried(name, 4, seed=16)
    with _Count() as mode:
        x2, den, st2 = iir_kernels.stream_args(x, secs, st, rows)
    assert len(mode.ops) == RENDER_ARG_OPS, mode.ops
    assert x2 is x and st2 is st
    assert [d.data_ptr() for d in den] == [s[i].data_ptr() for s in secs
                                           for i in (3, 4)]
    # every repair at once stays a handful, and changes no bit
    odd = [tuple(c[0].double() for c in s) for s in
           [tuple(c[:1].expand(4, -1) for c in s) for s in secs]]
    xt = x.t().contiguous().t()
    assert not xt.is_contiguous()
    with _Count() as mode:
        x3, den3, st3 = iir_kernels.stream_args(
            xt, odd, st.double().reshape(2, 2 * rows), rows)
    assert 0 < len(mode.ops) <= WORST_ARG_OPS, mode.ops
    assert x3.is_contiguous() and torch.equal(x3, x)
    assert st3.dtype == torch.float32 and torch.equal(st3, st)
    for d, s in zip(den3, [s[i] for s in secs for i in (3, 4)]):
        assert d.dtype == torch.float32 and d.shape == (4, 4)
        assert torch.equal(d, s[:1].expand(4, -1))


def test_cascade_slices_hands_the_sections_on_untouched(monkeypatch):
    """models/welsh.cascade_slices passes what render_notes_slice_pre made
    (float32 [n, S / 64] on the device) straight to the wrappers."""
    seen = {}

    def fake(key):
        def call(y, secs, state):
            seen[key] = (y, secs, state)
            return y, state
        return call

    monkeypatch.setattr(iir_kernels, "lp24_blockrate_stream", fake("p4"))
    monkeypatch.setattr(iir_kernels, "lp24_refined_blockrate_stream",
                        fake("p20"))
    x, secs = _inputs("K7", 2, 128, seed=17)
    for key, width in (("p4", 4), ("p20", 20)):
        st = {key: torch.zeros(2, width)}
        with _Count() as mode:
            y, new = welsh.cascade_slices(x, secs, st, None)
        assert mode.ops == []
        assert seen[key][0] is x and seen[key][1] is secs
        assert seen[key][2] is st[key] and new[key] is st[key] and y is x
    with pytest.raises(ValueError, match="unknown sliced cascade state"):
        welsh.cascade_slices(x, secs, {"p8": None}, None)


def test_streamed_segment_torch_operation_count(monkeypatch):
    """What the host dispatches for one 4096-frame segment of the Welsh
    analogue (two buckets) outside the two kernel calls: 622 torch
    operations (measured here; the stream's time on a card is these, at
    some 13 microseconds each). The kernel calls add none."""
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.stream import StreamingRenderer
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.testing import synth

    calls = []

    def fake(key):
        def call(y, secs, state):
            with _Count() as mode:
                iir_kernels.stream_args(y, secs, state,
                                        iir_kernels.STATE_ROWS[key])
            calls.append((key, len(mode.ops)))
            return y, state
        return call

    monkeypatch.setattr(iir_kernels, "lp24_blockrate_stream",
                        fake("lp24_stream"))
    monkeypatch.setattr(iir_kernels, "lp24_refined_blockrate_stream",
                        fake("lp24_refined_stream"))
    compiled = compile_song(SongSettings.from_json(
        synth.welsh_project(2, 120.0)), Paths(roots=[]))
    sliced = type("Sliced", (StreamingRenderer,), {"WELSH_SLICED": True})
    r = sliced(compiled, "cpu", segment_frames=4096)
    state = r.init_state()
    with _Count() as mode:
        r.step(state, r._seg_xs(3 * r.S, r.S), r.S)
    assert sorted(calls) == [("lp24_refined_stream", 0), ("lp24_stream", 0)]
    assert 500 <= len(mode.ops) <= 640, len(mode.ops)


def _source() -> str:
    return (build.CSRC / "lp24_stream.cu").read_text()


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", _source())
    assert len(found) == 1, name
    return int(found[0])


@pytest.mark.parametrize("refined,constant", [(False, "kSmemBytesK7"),
                                              (True, "kSmemBytesK8")],
                         ids=["K7", "K8"])
def test_shared_memory_budget_matches_the_source(refined, constant):
    """The bytes the loader hands to lp24_stream_init are the source's
    constant (which the source holds to its own layout by static_assert),
    at the source's tile, under a block's 227 KB."""
    assert _constant("kTile") == TILE and TILE % 64 == 0
    got = iir_kernels.stream_smem_bytes(refined)
    assert got == _constant(constant)
    assert got < 232448
    padded_tile = 4 * (TILE + TILE // 64)
    assert got > (7 if refined else 5) * padded_tile
    assert f"static_assert(smem_bytes({str(refined).lower()}) == {constant}" \
        in _source()


def test_build_covers_the_stream_source(tmp_path, monkeypatch):
    """csrc/lp24_stream.cu is one of the library's sources: its text is in
    the library's hash, its entry points are bound, and the loader sets
    the shared-memory attribute when it loads the library."""
    assert "lp24_stream.cu" in [p.name for p in build.sources()]
    for entry in ("lp24_stream_init", "lp24_stream", "launch_floor"):
        assert entry in build.SIGNATURES
        assert f'extern "C" int {entry}(' in _source()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    first = build.library_path()
    with open(copy / "lp24_stream.cu", "a") as f:
        f.write("// changed\n")
    assert build.library_path() != first
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in _source()
    assert '#include "tdf2.cuh"' in _source()
    # the recurrences and the defect are tdf2.cuh's device functions, the
    # ones K2-K6 run: no second copy of that arithmetic in the new source
    for shared in ("tdf2::step_p(", "tdf2::step_q(", "tdf2::corr_step(",
                   "tdf2::lp24_defect("):
        assert shared in _source(), shared
    assert "__fmaf_rn" not in re.sub(r"//.*", "", _source())


def test_stage_cycles_instruments_the_current_source():
    """kernels/stage_cycles.py finds its anchors in the kernel source: a
    stamp after each of the eight barriers its stage names stand for, two
    around the next tile's fetch, the reader, and nothing else changed."""
    from groove_tpu_torch.kernels import stage_cycles

    text = stage_cycles.instrument(_source())
    assert len(re.findall(r"STAMP\(\d+\);", text)) == len(stage_cycles.STAGES)
    assert sorted(set(re.findall(r"STAMP\((\d+)\);", text)), key=int) == [
        str(i) for i in range(len(stage_cycles.STAGES))]
    assert 'extern "C" int prof_read(' in text
    plain = re.sub(r" STAMP\(\d+\);", "", text)
    for piece in (stage_cycles._STAMP, stage_cycles._READ,
                  stage_cycles._BEGIN, stage_cycles._END):
        assert plain.count(piece) == 1
        plain = plain.replace(piece, "")
    assert plain == _source()


@pytest.mark.parametrize("name", ["K7", "K8"])
def test_stream_wrappers_refuse_other_devices_and_types(name):
    """No fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, as are other dtypes and unaligned lengths; the
    launch counts move only on a launch."""
    fn, key, _ = WRAPPERS[name]
    rows = iir_kernels.STATE_ROWS[key]
    x, secs = _inputs(name, 2, 128, seed=18)
    before = dict(iir_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="unsupported device"):
        fn(x.to("meta"), [tuple(c.to("meta") for c in s) for s in secs],
           torch.zeros(2, rows, device="meta"))
    with pytest.raises(TypeError, match="float32"):
        fn(x.double(), secs, torch.zeros(2, rows))
    with pytest.raises(ValueError, match="n % 64"):
        fn(x[:, :100], secs, torch.zeros(2, rows))
    fn(x, secs, torch.zeros(2, rows))  # the CPU twin: no launch
    assert iir_kernels.LAUNCHES == before
    assert set(iir_kernels.LAUNCHES) == {
        "lp24", "lp24_refined", "lp24_cascade", "lp24_stream",
        "lp24_refined_stream"}
