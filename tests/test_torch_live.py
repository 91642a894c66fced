"""The live voice paths of groove_tpu_torch against groove_tpu's, on the
CPU: models/welsh.live_window_block (every LFO routing, the sample-and-hold
bank, glide, hard sync with a fixed osc2, noise oscillators, voices whose
notes restart: the fresh-voice reset) and live_render_block (through
engine/live.LiveSynth), the window renders fm.render_window,
sampler.render_window and simple.envelope_window, LiveSynth's voice
choice, the FIFO transport of LiveMidiService, and the native ring-buffer
service through the port's copy of io/native.py.

The same note pools (made with numpy from fixed seeds) go through both
packages. Every bar is set from a measurement on the CPU, about 8 dB
above it (the measured value beside each): the port integrates phases in
64-frame blocks on scan1 and runs the cascade on S3's twin, where the
reference takes XLA's cumsum and one n-step block, so the two round
differently."""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.engine import live as jlive
from groove_tpu.models import fm as jfm
from groove_tpu.models import sampler as jsampler
from groove_tpu.models import simple as jsimple
from groove_tpu.models import welsh as jwelsh
from groove_tpu.project.patches import FmSynthParams as JFm
from groove_tpu.project.patches import WelshPatchSettings as JPatch
from groove_tpu.project.paths import Paths as JPaths
from groove_tpu_torch.engine import live as tlive
from groove_tpu_torch.io import native
from groove_tpu_torch.io.wav import read_wav, write_wav_16bit_stereo
from groove_tpu_torch.models import fm as tfm
from groove_tpu_torch.models import sampler as tsampler
from groove_tpu_torch.models import simple as tsimple
from groove_tpu_torch.models import welsh as twelsh
from groove_tpu_torch.project.patches import FmSynthParams as TFm
from groove_tpu_torch.project.patches import WelshPatchSettings as TPatch
from groove_tpu_torch.project.paths import Paths as TPaths
from groove_tpu_torch.testing import synth

SR = 44100.0
FAR = 2**30
V = 8


def _db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(20.0 * np.log10(np.abs(ref - got).max()
                                 / np.abs(ref).max()))


def _voices(raw: dict):
    text = json.dumps(raw)
    return (JPatch.from_json_str(text).derive_welsh_voice_params(),
            TPatch.from_json_str(text).derive_welsh_voice_params())


# note events a block: (block, "on"/"off", voice); a voice restarts at
# block 9 (its state resets), others are released and taken again
_PLAN = {0: [("on", 0), ("on", 1), ("on", 2)], 3: [("on", 3)],
         6: [("off", 0)], 9: [("on", 0)], 12: [("off", 1), ("on", 4)],
         15: [("off", 2), ("off", 3)], 18: [("on", 1)]}


def _pools(blocks: int, n: int, seed: int = 0):
    """Per block the pool mirrors (keys, vels, on, off, prev) and t0, as
    engine/livesong pins note events to block starts."""
    rng = np.random.default_rng(seed)
    keys = np.zeros(V, np.int32)
    vels = np.zeros(V, np.float32)
    on = np.full(V, FAR, np.int32)
    off = np.full(V, FAR, np.int32)
    prev = np.zeros(V, np.float32)
    last = None
    out = []
    for b in range(blocks):
        t0 = b * n
        for kind, v in _PLAN.get(b, []):
            if kind == "on":
                k = int(rng.integers(45, 80))
                keys[v], vels[v] = k, float(rng.integers(40, 127))
                on[v], off[v] = t0, FAR
                prev[v] = k if last is None else last
                last = float(k)
            else:
                off[v] = max(t0, on[v] + 1)
        out.append((keys.copy(), vels.copy(), on.copy(), off.copy(),
                    prev.copy(), t0))
    return out


def _welsh_both(raw: dict, n: int, blocks: int):
    jp, tp = _voices(raw)
    jst = jwelsh.live_window_state_init(V)
    tst = twelsh.live_window_state_init(V, "cpu")
    # one program a block, as the reference's live step runs it
    step = jax.jit(lambda st, keys, vels, on, off, t0, prev:
                   jwelsh.live_window_block(jp, st, keys, vels, on, off, t0,
                                            n, SR, prev_keys=prev))
    ja, ta = [], []
    for keys, vels, on, off, prev, t0 in _pools(blocks, n):
        m, jst = step(jst, keys, vels, on, off, np.int32(t0), prev)
        ja.append(np.asarray(m))
        tt = torch.from_numpy
        m2, tst = twelsh.live_window_block(
            tp, tst, tt(keys), tt(vels), tt(on), tt(off), t0, n, SR,
            prev_keys=tt(prev))
        ta.append(m2.numpy())
    return np.concatenate(ja), np.concatenate(ta)


def _sine_lfo(routing: str) -> dict:
    return {"lfo": {"routing": routing, "waveform": "sine",
                    "frequency": 5.0, "depth": {"pct": 0.3}}}


_PULSES = {"oscillator-1": {"waveform": {"pulse-width": 0.3},
                            "tune": {"float": 1.0}, "mix-pct": 1.0},
           "oscillator-2": {"waveform": {"pulse-width": 0.6},
                            "tune": {"float": 1.0}, "mix-pct": 0.6}}

# case -> (patch changes over synth.WELSH_LEAD, bar dB at 64 frames):
# measured -117 to -142 dB, the pad (noise osc2, S&H cutoff LFO, glide,
# resonance) -90.5
WELSH_CASES = {
    "lead": ({}, -110.0),
    "none": (_sine_lfo("none"), -110.0),
    "amplitude": (_sine_lfo("amplitude"), -110.0),
    "pitch": (_sine_lfo("pitch"), -110.0),
    "pitch-osc2": (_sine_lfo("pitch-osc2"), -110.0),
    "filter-cutoff": (_sine_lfo("filter-cutoff"), -110.0),
    "resonance": (_sine_lfo("resonance"), -110.0),
    "cutoff-amp": (_sine_lfo("cutoff-amp"), -110.0),
    "pulse-width": ({**_PULSES, **_sine_lfo("pulse-width")}, -110.0),
    "pw-osc1": ({**_PULSES, **_sine_lfo("pw-osc1")}, -110.0),
    "pw-osc2": ({**_PULSES, **_sine_lfo("pw-osc2")}, -110.0),
    "sample-hold": ({"lfo": {"routing": "filter-cutoff", "waveform": "noise",
                             "frequency": 9.0, "depth": {"pct": 0.3}}},
                    -109.0),
    "glide": ({"glide": 0.05}, -110.0),
    "sync": ({"oscillator-2-sync": True}, -109.0),
    "sync-fixed-glide": ({"oscillator-2-sync": True,
                          "oscillator-2-track": False, "glide": 0.05,
                          "oscillator-2": {"waveform": "sawtooth",
                                           "tune": {"note": 57},
                                           "mix-pct": 0.6}}, -110.0),
    "noise-osc": ({"oscillator-2": {"waveform": "noise",
                                    "tune": {"float": 1.0},
                                    "mix-pct": 0.6}}, -110.0),
    "live-pad": (dict(synth.LIVE_PAD), -82.0),
}


@pytest.mark.parametrize("case", list(WELSH_CASES))
def test_live_window_block_vs_reference(case):
    """24 blocks of 64 frames through both packages' live_window_block,
    the carried state chained block to block."""
    changes, bar = WELSH_CASES[case]
    ref, got = _welsh_both({**synth.WELSH_LEAD, **changes}, 64, 24)
    assert np.abs(ref).max() > 0.1
    assert _db(ref, got) < bar, _db(ref, got)


@pytest.mark.parametrize("case", ["lead", "live-pad"])
def test_live_window_block_lookahead_vs_reference(case):
    """At 256 frames a block the reference integrates one 256-step block
    (phases and cascade) where the port runs four 64-frame blocks:
    measured -107 dB (lead) and -91 (pad)."""
    changes, _ = WELSH_CASES[case]
    ref, got = _welsh_both({**synth.WELSH_LEAD, **changes}, 256, 6)
    assert _db(ref, got) < {"lead": -99.0, "live-pad": -83.0}[case]


def test_live_window_block_is_block_size_invariant():
    """Phases integrate per 64-frame block and the cascade runs on S3's
    64-frame grid, so a noise-free voice rendered as one 256-frame block
    gives the bits of four 64-frame blocks (the voices start at frame 0,
    where both reset)."""
    _, tp = _voices({**synth.WELSH_LEAD, "noise": 0.0, **_sine_lfo("pitch"),
                     "glide": 0.05})
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(40, 80, V).astype(np.int32))
    vels = torch.from_numpy(rng.uniform(30, 127, V).astype(np.float32))
    on = torch.zeros(V, dtype=torch.int32)
    off = torch.full((V,), FAR, dtype=torch.int32)
    off[:3] = 100
    prev = keys.to(torch.float32) + 3.0
    one, _ = twelsh.live_window_block(
        tp, twelsh.live_window_state_init(V, "cpu"), keys, vels, on, off, 0,
        256, SR, prev_keys=prev)
    st = twelsh.live_window_state_init(V, "cpu")
    parts = []
    for b in range(4):
        m, st = twelsh.live_window_block(tp, st, keys, vels, on, off, 64 * b,
                                         64, SR, prev_keys=prev)
        parts.append(m)
    assert torch.equal(one, torch.cat(parts))


def test_live_phases_are_the_reference_formula_per_block():
    """live_phases: (origin + inclusive sums) - increment within a block,
    the next origin (last phase + last increment) mod 1, against a
    float64 sum; the integral needs no torch.cumsum."""
    rng = np.random.default_rng(4)
    inc = torch.from_numpy(rng.uniform(0.001, 0.05, (5, 192))
                           .astype(np.float32))
    ph0 = torch.from_numpy(rng.uniform(0, 1, 5).astype(np.float32))
    ph, nxt = twelsh.live_phases(ph0, inc)
    exact = ph0.double()[:, None] + torch.cumsum(inc.double(), 1) \
        - inc.double()

    def cycles(d):  # distance in cycles, mod 1
        return float(((d + 0.5) % 1.0 - 0.5).abs().max())

    assert cycles(ph.double() - exact) < 1e-5
    # each block starts from an origin in [0, 1)
    assert float(ph[:, ::64].min()) >= 0.0
    assert float(ph[:, ::64].max()) < 1.0
    total = ph0.double() + inc.double().sum(1)
    assert cycles(nxt.double() - total) < 1e-5


def test_live_window_block_resets_a_fresh_voice():
    """A voice whose note starts at this block renders as if its state
    were zero, whatever it carried."""
    _, tp = _voices(synth.WELSH_LEAD)
    keys = torch.full((V,), 60, dtype=torch.int32)
    vels = torch.full((V,), 100.0)
    on = torch.full((V,), 640, dtype=torch.int32)
    off = torch.full((V,), FAR, dtype=torch.int32)
    noisy = {k: torch.rand(V) for k in twelsh.live_window_state_init(V,
                                                                     "cpu")}
    a, _ = twelsh.live_window_block(tp, noisy, keys, vels, on, off, 640, 64,
                                    SR)
    b, _ = twelsh.live_window_block(
        tp, twelsh.live_window_state_init(V, "cpu"), keys, vels, on, off,
        640, 64, SR)
    assert torch.equal(a, b)


def _fm_params():
    text = json.dumps(synth.FM_LEAD)
    return JFm.from_json(json.loads(text)), TFm.from_json(json.loads(text))


def _windows(kind: str, n: int = 64, blocks: int = 20):
    ja, ta = [], []
    jfm_p, tfm_p = _fm_params()
    rng = np.random.default_rng(8)
    table = rng.standard_normal((3, 2, 5000)).astype(np.float32) * 0.3
    lengths = np.array([5000, 3000, 1200], np.int32)
    rates = np.array([48000, 44100, 44100], np.int32)
    slots = np.array([0, 1, 2, -1, 0, 1, 2, 0], np.int32)
    ratios = rng.uniform(0.5, 2.0, V).astype(np.float32)
    adsr = (0.01, 0.2, 0.5, 0.3)
    tt = torch.from_numpy
    for keys, vels, on, off, _, t0 in _pools(blocks, n, seed=5):
        if kind == "fm":
            ja.append(np.asarray(jfm.render_window(jfm_p, keys, vels, on, off,
                                                   t0, n, SR)))
            ta.append(tfm.render_window(tfm_p, tt(keys), tt(vels), tt(on),
                                        tt(off), t0, n, SR).numpy())
        elif kind == "sampler":
            ja.append(np.asarray(jsampler.render_window(
                jnp.asarray(table), jnp.asarray(lengths),
                jnp.asarray(rates), slots, ratios, on, off, vels, t0, n,
                SR)))
            ta.append(tsampler.render_window(
                tt(table), tt(lengths), tt(rates), tt(slots), tt(ratios),
                tt(on), tt(off), tt(vels), t0, n, SR).numpy())
        else:
            ja.append(np.asarray(jsimple.envelope_window(
                adsr, keys, vels, on, off, t0, n, SR)))
            ta.append(tsimple.envelope_window(adsr, tt(keys), tt(vels),
                                              tt(on), tt(off), t0, n,
                                              SR).numpy())
    return np.concatenate(ja, -1), np.concatenate(ta, -1)


# kind -> bar dB (measured: fm -89.2, sampler bit for bit, envelope
# -106.7; the carrier Hz is float64 rounded once here, the reference's a
# float32 exp2)
WINDOW_BARS = {"fm": -81.0, "sampler": None, "envelope": -98.0}


@pytest.mark.parametrize("kind", list(WINDOW_BARS))
def test_window_render_vs_reference(kind):
    """The closed-form live voices over 20 blocks of a pool whose voices
    start, stop and restart, unused voices at FAR."""
    ref, got = _windows(kind)
    assert ref.shape == got.shape and np.abs(ref).max() > 0.05
    bar = WINDOW_BARS[kind]
    if bar is None:
        np.testing.assert_array_equal(got, ref)
    else:
        assert _db(ref, got) < bar, _db(ref, got)


def test_window_renders_are_offset_invariant():
    """A window render at block size 64 and 256 over the same frames:
    closed forms of the integer age, bit for bit."""
    _, tfm_p = _fm_params()
    keys = torch.tensor([60, 64, 67, 0, 0, 0, 0, 0], dtype=torch.int32)
    vels = torch.tensor([100.0, 90, 80, 0, 0, 0, 0, 0])
    on = torch.tensor([0, 64, 128] + [FAR] * 5, dtype=torch.int32)
    off = torch.tensor([300, FAR, FAR] + [FAR] * 5, dtype=torch.int32)
    one = tfm.render_window(tfm_p, keys, vels, on, off, 0, 512, SR)
    parts = torch.cat([tfm.render_window(tfm_p, keys, vels, on, off,
                                         64 * b, 64, SR) for b in range(8)],
                      -1)
    assert torch.equal(one, parts)


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    root = tmp_path_factory.mktemp("patches")
    synth.write_welsh_patches(root, {"piano": synth.WELSH_PAD,
                                     "cello": synth.WELSH_LEAD,
                                     "short": synth.PERF1_PAD})
    return root


def test_live_synth_vs_reference(patches):
    """The same performance through both LiveSynths (live_render_block,
    voice choice on the host): measured -118.6 dB."""
    ref = jlive.LiveSynth(patch="cello", n_voices=4,
                          paths=JPaths([patches]))
    port = tlive.LiveSynth(patch="cello", n_voices=4,
                           paths=TPaths([patches]), device="cpu")
    outs = ([], [])
    script = {0: [(60, 100), (64, 90)], 5: [(67, 110)], 9: [-60],
              12: [(72, 80), (76, 70)], 16: [-64, -67]}
    for b in range(24):
        for ev in script.get(b, []):
            for s in (ref, port):
                if isinstance(ev, tuple):
                    s.note_on(*ev)
                else:
                    s.note_off(-ev)
        outs[0].append(ref.render_block())
        outs[1].append(port.render_block())
    a, b = np.concatenate(outs[0]), np.concatenate(outs[1])
    assert np.abs(a).max() > 1e-3
    assert _db(a, b) < -110.0, _db(a, b)


@pytest.fixture
def synth_cpu(patches):
    return tlive.LiveSynth(patch="piano", n_voices=4,
                           paths=TPaths([patches]), device="cpu")


def test_streaming_blocks_are_continuous(synth_cpu):
    """A held note rendered in 64-frame blocks does not glitch at block
    boundaries (carried phase and filter state)."""
    synth_cpu.note_on(69, 127)
    audio = np.concatenate([synth_cpu.render_block()[:, 0]
                            for _ in range(20)])
    assert np.max(np.abs(audio)) > 1e-3
    d = np.abs(np.diff(audio))
    boundary = d[tlive.BLOCK - 1::tlive.BLOCK]
    assert boundary.max() < 10 * np.quantile(d, 0.99) + 1e-6


def test_note_off_releases(synth_cpu):
    synth_cpu.note_on(60, 127)
    for _ in range(4):
        synth_cpu.render_block()
    synth_cpu.note_off(60)
    early = np.abs(synth_cpu.render_block()).max()
    for _ in range(60):
        last = synth_cpu.render_block()
    assert np.abs(last).max() <= early + 1e-6


def test_voice_stealing_oldest(patches):
    s = tlive.LiveSynth(patch="piano", n_voices=2, paths=TPaths([patches]),
                        device="cpu")
    s.note_on(60, 100)
    s.render_block()
    s.note_on(64, 100)
    s.render_block()
    s.note_on(67, 100)  # steals the voice holding 60 (the oldest)
    keys = set(s.state.keys.numpy()[s.state.vels.numpy() > 0])
    assert keys == {64.0, 67.0}


def test_steal_prefers_released_over_held_pad(patches):
    """A held voice is never stolen while released voices exist (a patch
    of 0.05 s release, so the pool frees within a few blocks)."""
    s = tlive.LiveSynth(patch="short", n_voices=4, paths=TPaths([patches]),
                        device="cpu")
    for k in (60, 62, 64, 65):
        s.note_on(k, 100)
        s.render_block()
    for k in (60, 62, 64, 65):
        s.note_off(k)
    for _ in range(int(s._release_samples / tlive.BLOCK) + 2):
        s.render_block()
    s.note_on(48, 127)  # the pad
    s.render_block()
    for k in (72, 74, 76):
        s.note_on(k, 90)
        s.render_block()
        s.note_off(k)
    s.note_on(79, 90)
    held = set(s._keys[s._held])
    assert 48.0 in held and 79.0 in held


def test_steal_prefers_longest_released_ring_out(patches):
    s = tlive.LiveSynth(patch="piano", n_voices=2, paths=TPaths([patches]),
                        device="cpu")
    s.note_on(60, 100)
    s.render_block()
    s.note_on(64, 100)
    s.render_block()
    s.note_off(64)
    s.render_block()
    s.note_on(67, 100)  # steals the released 64, not the held 60
    assert set(s._keys[s._held]) == {60.0, 67.0}


def test_fifo_bytes_to_audio_with_bounded_latency(patches):
    """MIDI bytes through a pipe reach the voice pool, and the next
    lead_blocks blocks carry audio; a note-off reaches the device state."""
    r_fd, w_fd = os.pipe()
    reader = os.fdopen(r_fd, "rb", buffering=0)
    s = tlive.LiveSynth(patch="cello", n_voices=4, paths=TPaths([patches]),
                        device="cpu")
    got: list = []
    svc = tlive.LiveMidiService(s, midi_source=reader, sink=got.append,
                                lead_blocks=4)
    try:
        svc.pump(2)
        assert all(np.max(np.abs(b)) < 1e-7 for b in got)
        os.write(w_fd, bytes([0x90, 69, 120]))
        deadline = time.time() + 5.0
        while time.time() < deadline and float(s.state.vels.max()) == 0:
            time.sleep(0.005)
        assert float(s.state.vels.max()) > 0, "note-on never arrived"
        n0 = len(got)
        svc.pump(svc.lead_blocks)
        assert any(np.max(np.abs(b)) > 1e-4 for b in got[n0:])
        os.write(w_fd, bytes([0x80, 69, 0]))
        deadline = time.time() + 5.0
        while time.time() < deadline \
                and int(s.state.release_age[0]) >= FAR:
            time.sleep(0.005)
        assert int(s.state.release_age[0]) < FAR
    finally:
        os.close(w_fd)
        svc.stop()


# ---- the native runtime through the port's copy of io/native.py ------------

def _native():
    if not native.available():
        pytest.skip("native library not built (sh native/build.sh)")


def test_native_ring_buffer_roundtrip():
    _native()
    rb = native.RingBuffer(1024)
    x = np.random.default_rng(0).standard_normal((300, 2)).astype(np.float32)
    assert rb.write(x) == 300 and rb.readable() == 300
    assert np.array_equal(rb.read(300), x)
    assert rb.write(np.zeros((5000, 2), np.float32)) == 1024
    rb.close()


def test_native_underrun_reads_silence():
    _native()
    rb = native.RingBuffer(64)
    rb.write(np.ones((10, 2), np.float32))
    out = rb.read(20)
    assert np.all(out[:10] == 1.0) and np.all(out[10:] == 0.0)
    rb.close()


def test_native_audio_service_paces_realtime(tmp_path):
    _native()
    sink = tmp_path / "stream.f32"
    svc = native.AudioService(sample_rate=44100, buffer_frames=64,
                              sink_path=str(sink))
    try:
        t0 = time.time()
        while time.time() - t0 < 0.25:
            need = svc.needs_frames()
            if need > 0:
                svc.write(np.full((need, 2), 0.25, np.float32))
            time.sleep(0.001)
        consumed = svc.frames_consumed()
    finally:
        svc.stop()
    assert 0.15 * 44100 < consumed < 0.5 * 44100
    assert len(np.fromfile(sink, np.float32)) == consumed * 2


def test_native_wav_matches_python_writer(tmp_path):
    _native()
    s = (np.random.default_rng(1).standard_normal((5000, 2)) * 0.8
         ).astype(np.float32)
    write_wav_16bit_stereo(tmp_path / "py.wav", s, 44100)
    assert native.wav_write_fast(tmp_path / "nat.wav", s, 44100)
    a, ra = read_wav(tmp_path / "py.wav")
    b, rb = read_wav(tmp_path / "nat.wav")
    assert ra == rb == 44100 and np.array_equal(a, b)


def test_native_lead_buffers_and_post_stop_calls():
    _native()
    svc = native.AudioService(sample_rate=44100, buffer_frames=64,
                              lead_buffers=8)
    try:
        assert 64 * 4 < svc.needs_frames() <= 64 * 8
    finally:
        svc.stop()
    assert svc.needs_frames() == 0
    assert svc.write(np.zeros((64, 2), np.float32)) == 0
    svc.stop()
    rb = native.RingBuffer(16)
    with pytest.raises(ValueError):
        rb.write(np.zeros(64, np.float32))
    rb.close()
    assert rb.write(np.zeros((4, 2), np.float32)) == 0
    with pytest.raises(RuntimeError):
        native.AudioService(sample_rate=44100, buffer_frames=64,
                            sink_path="/nonexistent-dir/stream.f32")
