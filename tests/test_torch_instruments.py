"""groove_tpu_torch's sampler, calculator, resampled drumkit, oscillator,
envelope and toy instruments (models/sampler.py, models/simple.py and
their branches of the offline Renderer) on the CPU, against groove_tpu's
on the same inputs (made with numpy) and against the f64 reference
renderer (tools/f64_reference.render_f64).

Bars. Bit for bit (measured so): sampler.render_notes (against the
reference run eagerly: its jitted program multiplies by the reciprocal of
the sample rate and reads 1 float32 ulp apart, -144.5 dBFS), every
oscillator waveform but the sine (square, sawtooth, triangle, pulse-width
on the host time base and on the automated host phase, none, the debug
constants, and the noise: jax.random's threefry bits), the automated
oscillator's host phase, the toy instrument, and the Renderer's host
inputs. The sine (oscillator, envelope) takes sin in float64 rounded once
where the reference takes XLA's float32 sin: -136 dBFS [-144.5 measured].

The instruments analogue (testing/synth.instruments_project, 2 measures,
4 s: the 707 kit written at 48 kHz, a sampler on a 48 kHz WAV, the
calculator, sine, sawtooth with a frequency trip, pulse-width and noise
oscillators, the envelope instrument and the toy) against groove_tpu's
Renderer: -136 [-144.5]; every device but the sine oscillator and the
envelope equal bit for bit. Against f64 (without the calculator): -80
(BASELINE) [-139.7, groove_tpu -139.7]. The
calculator is held to f64 apart: groove_tpu's resampled playback
(`valid = i0 + 1 < length`) drops each sample's last frame, which the
f64 renderer's raw-row path for the calculator plays; the port keeps the
reference's semantics, so both packages read -18.0 dBFS against f64 on
this bank, whose beeps end above zero, and agree bit for bit with that
frame dropped from the f64 rows too (bar -138)."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.models import sampler as jsampler
from groove_tpu.models import simple as jsimple
from groove_tpu.ops import oscillator as josc
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.models import sampler as tsampler
from groove_tpu_torch.models import simple as tsimple
from groove_tpu_torch.models.voices import note_freqs, time_base
from groove_tpu_torch.ops import oscillator as tosc
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
SR = 44100.0
MEASURES = 2  # 4 s at 120 bpm
SINE_BAR = -136.0  # float64 sin rounded once vs XLA's float32 sin


def _db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    peak = max(1.0, float(np.abs(ref).max()))
    return 20.0 * np.log10(float(np.abs(got - ref).max()) / peak + 1e-30)


# ---- functions -------------------------------------------------------------

@pytest.mark.parametrize("span", [6016, 9088])
def test_sampler_render_notes_bitwise(span):
    """Three slots at 44.1, 48 and 22.05 kHz (so the rate correction
    steps faster and slower), a silent slot -1, ratios 0.5-2, gates
    shorter and longer than the samples."""
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, (3, 2, 5001)).astype(np.float32)
    lengths = np.array([5000, 3000, 4200], np.int32)
    rates = np.array([44100, 48000, 22050], np.int32)
    slots = np.array([0, 1, 2, -1, 1, 2, 0], np.int32)
    ratios = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    gate = rng.integers(100, 9000, 7).astype(np.int32)
    vels = rng.integers(1, 127, 7).astype(np.float32)
    want = np.asarray(jsampler.render_notes(
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(rates), slots,
        ratios, gate, vels, span, SR))
    got = tsampler.render_notes(
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(rates), slots, ratios, gate, vels, span, SR)
    assert got.shape == (7, 2, span)
    assert np.array_equal(got.numpy(), want)
    assert not got[3].any()


def test_sampler_ratios_bitwise():
    keys = np.arange(0, 128, 7)
    for root in (440.0, 69, 587.33, 86):
        got = tsampler.sampler_ratios(keys, root)
        want = jsampler.sampler_ratios(keys, root)
        assert got.dtype == want.dtype and np.array_equal(got, want)


KINDS = ["sine", "square", "sawtooth", "triangle", "triangle-sine", "none",
         "debug-max", "debug-min", "noise"]


@pytest.mark.parametrize("kind", KINDS)
def test_oscillator_static(kind):
    n = 30000
    want = np.asarray(jsimple.oscillator_instrument(kind, 220.0, n, SR))
    got = tsimple.oscillator_instrument(kind, 220.0, n, SR).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    if kind in ("sine", "triangle-sine"):
        assert _db(got, want) <= SINE_BAR
    else:
        assert np.array_equal(got, want)


def test_oscillator_pulse_width_host_time_base():
    n = 30000
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    want = np.asarray(josc.pulse_width(330.0 * jnp.asarray(t), 0.3))
    got = tosc.pulse_width(330.0 * time_base(n, SR, "cpu"), 0.3)
    assert np.array_equal(time_base(n, SR, "cpu").numpy(), t)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["sine", "sawtooth", "square", "triangle",
                                  "pulse-width"])
def test_oscillator_automated(kind):
    """The host float64 phase equals the reference's; each waveform on it
    (a curve shorter than the song holds its last value)."""
    n = 30000
    rng = np.random.default_rng(1)
    curve = rng.uniform(100, 800, -(-n // 64) - 10).astype(np.float32)
    want_ph = np.asarray(jsimple.oscillator_phase_automated(curve, n, SR))
    got_ph = tsimple.oscillator_phase_automated(curve, n, SR)
    assert got_ph.dtype == np.float32 and np.array_equal(got_ph, want_ph)
    if kind == "pulse-width":
        want = np.asarray(josc.pulse_width(jnp.asarray(want_ph), 0.3))
        got = tosc.pulse_width(torch.from_numpy(got_ph), 0.3).numpy()
    else:
        want = np.asarray(josc.evaluate(kind, jnp.asarray(want_ph)))
        got = tosc.evaluate(kind, torch.from_numpy(got_ph)).numpy()
    if kind == "sine":
        assert _db(got, want) <= SINE_BAR
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("adsr", [(0.05, 0.2, 0.6, 0.4), (0.0, 0.0, 1.0,
                                                          0.0)])
def test_envelope_instrument(adsr):
    rng = np.random.default_rng(2)
    keys = rng.integers(40, 90, 5).astype(np.int32)
    vels = rng.integers(1, 127, 5).astype(np.float32)
    gate = rng.integers(1000, 20000, 5).astype(np.int32)
    freqs = np.asarray(note_freqs(keys), np.float32)
    want = np.asarray(jsimple.envelope_instrument(adsr, keys, vels, gate,
                                                  38400, SR, freqs=freqs))
    got = tsimple.envelope_instrument(adsr, torch.from_numpy(keys), vels,
                                      gate, 38400, SR, freqs=freqs).numpy()
    assert got.shape == (5, 38400)
    assert _db(got, want) <= SINE_BAR


def test_toy_instrument_bitwise():
    want = np.asarray(jsimple.toy_instrument(0.23498239, 100))
    assert np.array_equal(tsimple.toy_instrument(0.23498239, 100).numpy(),
                          want)


# ---- the instruments analogue ------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return synth.write_instrument_assets(tmp_path_factory.mktemp("assets"))


def _compile(assets, project: dict):
    text = json.dumps(project)
    return (jax_compile(JaxSongSettings.from_json5_str(text),
                        JaxPaths(roots=[assets])),
            compile_song(SongSettings.from_json5_str(text),
                         Paths(roots=[assets])))


@pytest.fixture(scope="module")
def song(assets):
    jc, tc = _compile(assets, synth.instruments_project(MEASURES))
    jr, tr = JaxRenderer(jc), Renderer(tc, "cpu")
    return jc, tc, jr, np.asarray(jr.render()), tr, tr.render()


def test_analogue_takes_every_kind(song):
    jc, tc, *_ = song
    kinds = {d.kind for d in tc.devices.values()
             if d.role == "instrument" or d.kind == "calculator"}
    assert kinds == {"drumkit", "sampler", "calculator", "oscillator",
                     "envelope", "toy-instrument"}
    kit = tc.devices["kit48"].sample_table.rates
    assert set(kit.tolist()) == {48000}
    assert set(tc.devices["sampler"].sample_table.rates.tolist()) == {48000}
    assert "frequency" in tc.devices["osc-saw"].automation
    assert all(tc.devices[u].notes.count for u in
               ("kit48", "sampler", "calculator", "envelope",
                synth.UNKNOWN_UVID))


def test_instrument_inputs_are_the_references(song):
    """Note columns, spans, sample tables, slots, the sampler's ratios,
    the envelope's host Hz; no K1 layout for the kit at 48 kHz, and no
    input for the oscillator's frequency trip (a host phase)."""
    _, _, jr, _, tr, _ = song
    want = {k: np.asarray(v) for k, v in jr.inputs.items()}
    assert set(tr.host_inputs) == set(want)
    for k, v in want.items():
        got = np.asarray(tr.host_inputs[k])
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    assert tr._spans == jr._spans
    assert not any(k.startswith("kit48/h") or k == "kit48/ptable"
                   for k in tr.host_inputs)
    assert "osc-saw/auto/frequency" not in tr.host_inputs
    assert "sampler/ratios" in tr.host_inputs


def test_analogue_against_reference(song):
    jc, tc, jr, ref, tr, got = song
    assert got.shape == ref.shape == (jc.n_frames, 2)
    assert 0.05 < np.abs(got).max() < 1.0
    assert _db(got, ref) <= SINE_BAR
    n = jc.n_frames
    welsh = {}
    for u in tc.order:
        d = tc.devices[u]
        if not (d.role == "instrument" or d.kind == "calculator"):
            continue
        mine = tr._render_instrument(tr.inputs, d, n, welsh).numpy()
        theirs = np.asarray(jr._render_instrument(jr.inputs, jc.devices[u],
                                                  n, {}))
        if u in ("osc-sine", "envelope"):
            assert _db(mine, theirs) <= SINE_BAR, u
        else:
            assert np.array_equal(mine, theirs), u


def test_analogue_against_f64(assets):
    """The analogue without the calculator (held apart below)."""
    from tools.f64_reference import render_f64

    p = synth.instruments_project(MEASURES)
    p["devices"] = [d for d in p["devices"]
                    if "calculator" not in json.dumps(d)]
    p["patch-cables"] = [c for c in p["patch-cables"]
                         if c[0] != "calculator"]
    jc, tc = _compile(assets, p)
    got = Renderer(tc, "cpu").render()
    f64 = render_f64(jc)
    assert _db(got, f64) <= -80.0
    assert _db(got, f64) <= _db(np.asarray(JaxRenderer(jc).render()),
                                f64) + 3.0


def test_calculator_against_f64(song):
    """Both packages drop each sample's last frame where the f64 renderer
    plays it: with that frame dropped from its rows too, f64 agrees."""
    import tools.f64_reference as f64ref

    jc, tc, jr, _, tr, _ = song
    n = jc.n_frames
    dev = jc.devices["calculator"]
    got = tr._render_instrument(tr.inputs, tc.devices["calculator"], n,
                                {}).numpy()
    theirs = np.asarray(jr._render_instrument(jr.inputs, dev, n, {}))
    assert np.array_equal(got, theirs)
    assert _db(got, f64ref._render_instrument(dev, n, SR)) > -40.0
    short = dataclasses.replace(dev.sample_table,
                                lengths=dev.sample_table.lengths - 1)
    dropped = f64ref._render_instrument(
        dataclasses.replace(dev, sample_table=short), n, SR)
    assert _db(got, dropped) <= -138.0


def test_unknown_instrument_warns_and_renders_silence(assets, capsys):
    """groove_tpu and the port: a warning, and the song the toy with no
    kind would give (its fake-value is 0)."""
    jc, tc = _compile(assets, synth.instruments_project(1))
    base = Renderer(tc, "cpu").render()
    capsys.readouterr()
    synth.unknown_instrument(jc)
    synth.unknown_instrument(tc)
    got = Renderer(tc, "cpu").render()
    err = capsys.readouterr().err
    assert "unknown instrument kind mystery-instrument; silent" in err
    ref = np.asarray(JaxRenderer(jc).render())
    assert "unknown instrument kind mystery-instrument; silent" in \
        capsys.readouterr().err
    assert np.array_equal(got, base)
    assert _db(got, ref) <= SINE_BAR


def test_analogue_from_the_references_inputs(song):
    _, tc, jr, _, _, got = song
    theirs = {k: np.asarray(v) for k, v in jr.inputs.items()}
    r = Renderer(tc, "cpu", inputs=theirs)
    assert set(r.inputs) == set(inputs_from_numpy(theirs, "cpu"))
    assert np.array_equal(r.render(), got)


def test_instruments_render_without_jax(assets, tmp_path):
    """A process that refuses jax and groove_tpu renders the analogue
    through the CLI to a WAV equal to the Renderer's."""
    project = synth.write_project(tmp_path / "instruments.json",
                                  synth.instruments_project(1))
    code = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
import numpy as np
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
song = SongSettings.from_project_file({str(project)!r})
q = Renderer(compile_song(song, Paths()), "cpu").render_quantized()
assert cli.main([{str(project)!r}, "--wav", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "out")!r}]) == 0
x, rate = read_wav({str(tmp_path / "out" / "instruments.wav")!r})
assert x.shape == q.shape and np.abs(q).max() > 1000
assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "groove_tpu")]
print("JAX-FREE OK", q.shape)
"""
    env = dict(os.environ, GROOVE_ASSETS=str(assets), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
