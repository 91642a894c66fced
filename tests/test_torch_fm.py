"""groove_tpu_torch's FM voice (models/fm.py) and its branch of the offline
Renderer on the CPU, against groove_tpu's on the same inputs (made with
numpy) and against the f64 reference renderer
(tools/f64_reference.render_f64).

The three routes of the modulator phase: host phase tables (fm.host_phases,
a bucket within fm.HOST_PHASE_MAX_ELEMS), traced closed-form phases (a
bucket past it: the test lowers the cap in both packages) and a `ratio`
curve, whose phase the port integrates on scan1 with a = 1 (each
64-sample block's inclusive sum, an exclusive prefix over blocks that
carries its rounding, reduced mod 1, an exclusive prefix within each
block) where the reference runs XLA's cumsum and sum.

Bars, each about 8 dB above the value measured here (in brackets):
  - host_phases, _note_curve and the Renderer's host inputs: bit for bit;
  - the modulator phase against the reference's, as max |diff| mod 1
    over the exact phase's peak (1969 and 1922 cycles): -126 dB [-137.4]
    at a span of 64-sample blocks, -129 [-137.2] flat; against an exact
    float64 sum of the same increments -154 [-162.7 and -162.5], and at
    least as close as the reference [-137.3 and -137.1];
  - render_notes against the reference's and against a float64 model
    (dBFS of the peak, at least 1): in ROUTES, measured values in
    test_render_notes_against_reference_and_f64's docstring;
  - the FM analogue (testing/synth.fm_project, 2 measures, 4 s) against
    groove_tpu's Renderer -85 [-93.3: the ratio voice's phase sums group
    differently, each a few float32 ulps of a phase of up to 2000 cycles
    apart, and beta multiplies them into the carrier; the pad -143.5,
    the lead -147.0], and against f64 at the BASELINE -80 [-93.3; the
    reference -102.7: the f64 renderer evaluates the reference's own
    float32 modulator phase, so it shares the reference's grouping];
  - the same song with a small element cap in both packages: -85
    [-93.3], and the port chunked equal to the port whole bit for bit
    (measured: each chunk's scatter adds to the running timeline the
    windows the whole bucket's scatter adds, in the same order)."""

from __future__ import annotations

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.models import fm as jfm
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.patches import FmSynthParams as JaxFm
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.models import fm as tfm
from groove_tpu_torch.ops import scan_kernels
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.patches import FmSynthParams as TorchFm
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

SR = 44100.0
MEASURES = 2  # 4 s at 120 bpm


def _db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    peak = max(1.0, float(np.abs(ref).max()))
    return 20.0 * np.log10(float(np.abs(got - ref).max()) / peak + 1e-30)


def _phase_db(got, ref, peak) -> float:
    """max |got - ref| in cycles, taken mod 1 (a phase feeds a
    1-periodic sine), over a phase's peak, in dB."""
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    return 20.0 * np.log10(float(np.abs((d + 0.5) % 1.0 - 0.5).max())
                           / peak + 1e-30)


def _voices(voice: dict):
    return JaxFm.from_json(voice), TorchFm.from_json(voice)


def _notes(count: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(40, 90, count).astype(np.int32),
            rng.integers(40, 127, count).astype(np.float32),
            rng.integers(2000, 30000, count).astype(np.int32),
            rng.integers(0, 40000, count).astype(np.int32))


def _curve(lo: float, hi: float, seed: int, nb: int = 1300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(nb)).astype(np.float32)


# ---- host functions, bit for bit ------------------------------------------

@pytest.mark.parametrize("ratio,span", [(2.0, 4096), (3.7, 30080),
                                        (0.5, 128)])
def test_host_phases_bitwise(ratio, span):
    jv, tv = _voices({"ratio": ratio})
    keys = _notes(5)[0]
    want = jfm.host_phases(jv, keys, span, SR)
    got = tfm.host_phases(tv, keys, span, SR)
    assert got.keys() == want.keys() == {"phm", "phc"}
    for k in want:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], want[k]), k
    assert tfm.HOST_PHASE_MAX_ELEMS == jfm.HOST_PHASE_MAX_ELEMS
    assert tfm.host_phases(tv, keys, span, SR, max_elems=5 * span - 1) \
        is None
    assert tfm.host_phases(tv, keys[:0], span, SR) is None


def test_note_curve_and_tail_bitwise():
    curve = _curve(0.5, 3.0, 1)
    on = _notes()[3]
    want = np.asarray(jfm._note_curve(jnp.asarray(curve), on, 5000))
    got = tfm._note_curve(torch.from_numpy(curve), on, 5000).numpy()
    assert np.array_equal(got, want)
    for voice in (synth.FM_PAD, synth.FM_LEAD, {}):
        jv, tv = _voices(voice)
        assert tfm.tail_seconds(tv) == jfm.tail_seconds(jv)


# ---- the modulator phase ---------------------------------------------------

@pytest.mark.parametrize("span,bar_ref", [(40960, -126.0), (40000, -129.0)])
def test_modulator_phase_on_scan1(monkeypatch, span, bar_ref):
    """The integrated phase against the reference's (eager) and against
    an exact float64 sum of the same float32 increments; scan1 makes the
    sums (three calls at a span of 64-sample blocks, two flat), and no
    torch.cumsum or torch.sum runs. The port's phase is reduced mod 1, so
    the phases are compared mod 1, over the exact phase's peak."""
    jv, tv = _voices(synth.FM_RATIO)
    keys, _, _, on = _notes()
    f_c = np.asarray(tfm.note_freqs(keys), np.float32)[:, None]
    t = np.arange(span, dtype=np.float32)[None, :] / np.float32(SR)
    ratio = tfm._note_curve(torch.from_numpy(_curve(1.0, 3.5, 2)), on,
                            span).numpy()
    want = np.asarray(jfm.modulator_phase(
        jv, jnp.asarray(f_c), jnp.asarray(t), jnp.asarray(ratio), SR))
    calls = []
    plain = scan_kernels._plain
    monkeypatch.setattr(scan_kernels, "_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    for name in ("cumsum", "sum"):
        monkeypatch.setattr(torch, name, None)
        monkeypatch.setattr(torch.Tensor, name, None)
    got = tfm.modulator_phase(tv, torch.from_numpy(f_c), torch.from_numpy(t),
                              torch.from_numpy(ratio), SR).numpy()
    monkeypatch.undo()
    assert len(calls) == (3 if span % 64 == 0 else 2)
    assert got.shape == want.shape and got.dtype == np.float32
    assert got[:, 0].tolist() == [0.0] * len(keys)
    assert 0.0 <= got.min() and got.max() < 8.0
    inc = (ratio * f_c).astype(np.float32) / np.float32(SR)
    exact = np.concatenate([np.zeros((len(keys), 1)), np.cumsum(
        inc.astype(np.float64), -1)[:, :-1]], 1)
    peak = float(exact.max())
    assert _phase_db(got, want, peak) <= bar_ref
    assert _phase_db(got, exact, peak) <= -154.0
    assert _phase_db(got, exact, peak) <= _phase_db(want, exact, peak)


# ---- render_notes ----------------------------------------------------------

ROUTES = {
    # name: (span, host tables?, automation curves, beta, bar vs groove_tpu,
    #        bar vs the float64 model)
    "host-tables": (30080, True, (), 4.0, -119.0, -106.0),
    "traced": (30080, False, (), 4.0, -119.0, -58.0),
    "host-tables, depth and beta curves": (30080, True, ("depth", "beta"),
                                           4.0, -113.0, -101.0),
    "host-tables, beta 100": (30080, True, (), 100.0, -95.0, -79.0),
    "ratio curve": (30080, False, ("ratio", "depth", "beta"), 4.0, -49.0,
                    -63.0),
    "ratio curve, flat": (30000, False, ("ratio",), 4.0, -54.0, -74.0),
}
CURVES = {"ratio": (1.0, 3.5), "depth": (0.2, 1.5), "beta": (0.0, 8.0)}


def _adsr64(t, t_off, env):
    eps = 1e-9
    a, d, s, r = env.attack, env.decay, env.sustain, env.release

    def held(tv):
        return np.where(tv < a, tv / max(a, eps), np.where(
            tv < a + d, 1.0 - (1.0 - s) * (tv - a) / max(d, eps), s))

    rel = held(t_off) * (1.0 - (t - t_off) / max(r, eps))
    return np.clip(np.where(t < t_off, held(t), rel), 0.0, 1.0)


def _render_f64(params, keys, vels, gate, span, on, curves) -> np.ndarray:
    """render_notes in float64 from the same float32 data: exact
    modulator and carrier phases, envelopes and sines."""
    f_c = np.asarray(tfm.note_freqs(keys), np.float64)[:, None]
    t = np.arange(span)[None, :] / SR
    cur = {k: tfm._note_curve(torch.from_numpy(v), on, span).numpy()
           .astype(np.float64) for k, v in curves.items()}
    if "ratio" in cur:
        ph = np.concatenate([np.zeros((len(keys), 1)), np.cumsum(
            cur["ratio"] * f_c / SR, -1)[:, :-1]], 1)
    else:
        ph = params.ratio * f_c * t
    gs = np.asarray(gate, np.float64)[:, None] / SR
    mod = np.sin(2.0 * np.pi * ph) \
        * _adsr64(t, gs, params.modulator_envelope) \
        * cur.get("depth", params.depth)
    car = np.sin(2.0 * np.pi * f_c * t + cur.get("beta", params.beta) * mod)
    return car * _adsr64(t, gs, params.carrier_envelope) \
        * (np.asarray(vels, np.float64)[:, None] / 127.0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_render_notes_against_reference_and_f64(route):
    """Measured (port against groove_tpu; port and groove_tpu against the
    float64 model): host tables -127.6; -114.3 and -114.3. Traced -127.3;
    -66.5 and -66.5 (the float32 carrier phase f_c t of up to 1000 cycles,
    in both). Depth and beta curves -121.9; -109.6 and -109.6. Beta 100
    -103.6; -87.5 and -87.5 (the tables' float32 resolution times beta).
    Ratio curve -57.2; -71.6 and -56.5; flat -62.4; -82.1 and -62.6: the
    curves jump at random every block (depth to 1.5, beta to 8), the
    phase reaches 3500 cycles, where a float32 ulp is 2.4e-4 cycles and
    beta multiplies it into the carrier; the reference holds the whole
    phase in float32, the port carries the block prefix's rounding and
    reduces it mod 1 (fm.exclusive_mod1), so on the ratio routes the port
    is the closer to the float64 model, and the port against groove_tpu
    reads the reference's own error (the song-level bars below stay at
    -93 dBFS: the f64 renderer evaluates the reference's float32
    phase)."""
    span, tables, curves, beta, bar, bar_f64 = ROUTES[route]
    jv, tv = _voices(dict(synth.FM_PAD, beta=beta))
    keys, vels, gate, on = _notes()
    gate = np.minimum(gate, span - 2000)
    kw = {name: _curve(*CURVES[name], seed=i + 3)
          for i, name in enumerate(curves)}
    freqs = np.asarray(tfm.note_freqs(keys), np.float32)
    phases = tfm.host_phases(tv, keys, span, SR) if tables else None
    want = np.asarray(jfm.render_notes(
        jv, keys, vels, gate, span, SR, on_frames=on, freqs=freqs,
        phases=phases, **{f"{k}_b": jnp.asarray(v) for k, v in kw.items()}))
    got = tfm.render_notes(
        tv, torch.from_numpy(keys), torch.from_numpy(vels),
        torch.from_numpy(gate), span, SR, on_frames=on, freqs=freqs,
        phases=phases,
        **{f"{k}_b": torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (len(keys), span) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    assert _db(got, want) <= bar, _db(got, want)
    exact = _render_f64(tv, keys, vels, gate, span, on, kw)
    assert _db(got, exact) <= bar_f64, (_db(got, exact), _db(want, exact))
    if "ratio" in curves:  # the port's phase carries its rounding
        assert _db(got, exact) <= _db(want, exact)


# ---- the Renderer ----------------------------------------------------------

@pytest.fixture(scope="module")
def song():
    text = json.dumps(synth.fm_project(MEASURES))
    jc = jax_compile(JaxSongSettings.from_json5_str(text), JaxPaths(roots=[]))
    tc = compile_song(SongSettings.from_json5_str(text), Paths(roots=[]))
    jr = JaxRenderer(jc)
    tr = Renderer(tc, "cpu")
    return jc, tc, jr, np.asarray(jr.render()), tr, tr.render()


def _assert_inputs_equal(jr, tr):
    want = {k: np.asarray(v) for k, v in jr.inputs.items()}
    assert set(tr.host_inputs) == set(want)
    for k, v in want.items():
        got = np.asarray(tr.host_inputs[k])
        assert got.dtype == v.dtype and np.array_equal(got, v), k


def test_fm_inputs_are_the_references(song):
    """Each bucket's note columns, ids, host carrier Hz and per-bucket
    phase tables (none for the ratio voice), and the trips' curves."""
    jc, tc, jr, _, tr, _ = song
    _assert_inputs_equal(jr, tr)
    assert tr._buckets == jr._buckets
    hc = {k for k in tr.host_inputs if "/hc/" in k}
    assert hc == {"pad/b0/hc/f1", "pad/b0/hc/phm", "pad/b0/hc/phc",
                  "lead/b0/hc/f1", "lead/b0/hc/phm", "lead/b0/hc/phc",
                  "ratio-voice/b0/hc/f1"}


def test_fm_inputs_past_the_table_cap(monkeypatch):
    """A bucket past the host-table cap ships no tables (both packages);
    the render takes the traced phases."""
    for mod in (jfm, tfm):
        monkeypatch.setattr(mod, "host_phases", functools.partial(
            mod.host_phases, max_elems=20 * 15488))
    text = json.dumps(synth.fm_project(MEASURES))
    jr = JaxRenderer(jax_compile(JaxSongSettings.from_json5_str(text),
                                 JaxPaths(roots=[])))
    tr = Renderer(compile_song(SongSettings.from_json5_str(text),
                               Paths(roots=[])), "cpu")
    _assert_inputs_equal(jr, tr)
    hc = {k for k in tr.host_inputs if "/hc/" in k}
    assert hc == {"pad/b0/hc/f1", "lead/b0/hc/f1", "lead/b0/hc/phm",
                  "lead/b0/hc/phc", "ratio-voice/b0/hc/f1"}
    ref = np.asarray(jr.render())
    assert _db(tr.render(), ref) <= -85.0


def test_fm_song_against_reference_and_f64(song):
    from tools.f64_reference import render_f64

    jc, _, _, ref, _, got = song
    assert got.shape == ref.shape == (jc.n_frames, 2)
    assert 0.05 < np.abs(got).max() < 1.0
    assert _db(got, ref) <= -85.0
    f64 = render_f64(jc)
    port_db, jax_db = _db(got, f64), _db(ref, f64)
    assert port_db <= -80.0, (port_db, jax_db)


def test_fm_song_with_a_small_cap(song):
    """A cap of 200k elements chunks every bucket in both packages (the
    reference pads its last chunk with silent rows, the port's is
    short)."""
    cap = 200_000
    jc, tc, _, _, _, whole = song
    jr = type("JaxFm", (JaxRenderer,), {"NOTE_CHUNK_ELEMS": cap})(jc)
    assert jr._note_chunk_elems == cap
    tr = Renderer(tc, "cpu", note_chunk_elems=cap)
    # the ratio voice's 8 rows x 35328: chunks of 5 and 3 rows, three
    # scan1 calls each
    assert tr.fm_launches() == {"scan1": 6}
    got = tr.render()
    assert _db(got, np.asarray(jr.render())) <= -85.0
    assert np.array_equal(got, whole)


def test_fm_song_from_the_references_inputs(song):
    """groove_tpu's Renderer.inputs through engine/params.inputs_from_numpy
    render the same song bit for bit."""
    _, tc, jr, _, _, got = song
    theirs = {k: np.asarray(v) for k, v in jr.inputs.items()}
    r = Renderer(tc, "cpu", inputs=theirs)
    assert set(r.inputs) == set(inputs_from_numpy(theirs, "cpu"))
    assert np.array_equal(r.render(), got)


@pytest.mark.parametrize("cap", [None, 200_000])
def test_fm_launches_are_the_scan_calls(song, monkeypatch, cap):
    """fm_launches() counts, from the plan, the scan1 calls a render makes:
    three a chunk of the ratio voice's bucket."""
    _, tc, *_ = song
    calls = []
    plain = scan_kernels._plain
    monkeypatch.setattr(scan_kernels, "_plain",
                        lambda *a: calls.append(1) or plain(*a))
    r = Renderer(tc, "cpu", note_chunk_elems=cap)
    r.render()
    assert len(calls) == r.fm_launches()["scan1"] >= 2


def test_stream_plan_counts_the_phase_scans(song, monkeypatch):
    """StreamingRenderer.planned_launches() counts the scan1 calls the
    ratio voice's modulator phase makes in a streamed render, as
    fm_launches() counts them offline: fm.phase_scans a bucket and
    segment."""
    from groove_tpu_torch.engine.stream import StreamingRenderer

    _, tc, *_ = song
    calls = []
    plain = scan_kernels._plain
    monkeypatch.setattr(scan_kernels, "_plain",
                        lambda *a: calls.append(1) or plain(*a))
    r = StreamingRenderer(tc, "cpu", segment_frames=65536)
    r.render()
    assert len(calls) == r.planned_launches()["scan1"] > 0
    assert r.planned_launches()["scan1"] % tfm.phase_scans(64) == 0
