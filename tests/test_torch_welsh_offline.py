"""groove_tpu_torch's whole-timeline Welsh voices in the offline Renderer,
on the CPU twins of K2 and K3, against groove_tpu's Renderer with its
Pallas kernels run through the interpreter (the kernel routing the port
follows), against the f64 reference renderer
(tools/f64_reference.render_f64) and against the port's own sliced
stream.

Songs: the Welsh analogue (testing/synth.welsh_project) at 2 measures and
240 bpm (2 s: a refined pad, K2's twin, and a lead with noise and an
amplitude LFO, K3's twin), and a song of four Welsh devices that takes
the other branches of the voice: a gliding mono lead, a pitch-LFO voice
with hard sync, a unison pad and a voice-less device (silence).

Every bar is set about 8 dB above the value measured on the CPU, which
is written beside it."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.io.wav import quantize_16bit_device
from groove_tpu.models import welsh as jwelsh
from groove_tpu.ops import oscillator as josc
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.patches import WelshPatchSettings as JPatch
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine import render as trender
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.io.wav import quantize_16bit, read_wav
from groove_tpu_torch.models import welsh as twelsh
from groove_tpu_torch.ops import iir_kernels
from groove_tpu_torch.ops import oscillator as tosc
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.patches import WelshPatchSettings as TPatch
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
SR = 44100.0
MEASURES, BPM = 2, 240.0

# ---- voices ----------------------------------------------------------------

GLIDE_LEAD = dict(synth.WELSH_LEAD, glide=0.08, polyphony="mono")
PITCH_SYNC = dict(synth.WELSH_LEAD, **{
    "oscillator-2": {"waveform": "triangle", "tune": {"float": 1.5},
                     "mix-pct": 0.5},
    "oscillator-2-sync": True,
    "lfo": {"routing": "pitch", "waveform": "triangle", "frequency": 4.0,
            "depth": {"pct": 0.1}}})
VOICES = {
    "pad": synth.WELSH_PAD,
    "lead": synth.WELSH_LEAD,
    "glide": GLIDE_LEAD,
    # osc2 holds a fixed pitch under hard sync while osc1 glides
    "glide-sync-fixed": dict(GLIDE_LEAD, **{
        "oscillator-2": {"waveform": "sawtooth", "tune": {"note": 57},
                         "mix-pct": 0.5},
        "oscillator-2-track": False, "oscillator-2-sync": True}),
    "pitch-lfo": PITCH_SYNC,
    "pitch-osc2-glide": dict(GLIDE_LEAD, lfo={
        "routing": "pitch-osc2", "waveform": "sine", "frequency": 3.0,
        "depth": {"pct": 0.2}}),
    "sync": dict(synth.WELSH_LEAD, **{"oscillator-2-sync": True}),
    "unison": dict(synth.WELSH_PAD, unison=True),
    "resonance-lfo": dict(synth.WELSH_PAD, lfo={
        "routing": "resonance", "waveform": "triangle", "frequency": 2.0,
        "depth": {"pct": 0.5}}),
}


def _voices(raw: dict):
    text = json.dumps(raw)
    return (JPatch.from_json_str(text).derive_welsh_voice_params(),
            TPatch.from_json_str(text).derive_welsh_voice_params())


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its renders are
    thousands of small torch calls, and beside other test processes a
    full thread team per call stalls on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_routing(monkeypatch):
    """The reference routes and runs its kernels as on its TPU, through
    the Pallas interpreter."""
    from groove_tpu.ops import iir as jiir
    from groove_tpu.ops import pallas_iir

    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)


# ---- the voice, function by function --------------------------------------


def test_phase_from_freq_matches():
    """A cumulative sum: CPU torch and XLA group it differently. Measured
    at most 1.53e-5 apart over 4096 samples of phases up to 94.6 cycles,
    bar 4e-5."""
    rng = np.random.default_rng(11)
    f = rng.uniform(50.0, 2000.0, (3, 4096)).astype(np.float32)
    got = tosc.phase_from_freq(torch.from_numpy(f), SR).numpy()
    want = np.asarray(josc.phase_from_freq(jnp.asarray(f), SR))
    assert got.dtype == np.float32 and got[:, 0].tolist() == [0.0] * 3
    assert np.max(np.abs(got - want)) <= 4e-5


def test_glide_terms_match():
    """float64 transcendentals rounded once against XLA's float32 ones:
    the factor measured at most 2.4e-7 apart, the phase 9.2e-5 of up to
    736 cycles; bars 6e-7 and 2.3e-4. r = 1 takes the f * t limit
    exactly."""
    t = (np.arange(30000, dtype=np.float32) / np.float32(SR))[None, :]
    r = np.array([[0.5], [1.0], [1.3], [2.2]], np.float32)
    f = np.array([[110.0], [220.0], [440.0], [880.0]], np.float32)
    for T in (0.05, 0.3):
        got_g = twelsh._glide_factor(torch.from_numpy(r), T,
                                     torch.from_numpy(t)).numpy()
        want_g = np.asarray(jwelsh._glide_factor(jnp.asarray(r), T,
                                                 jnp.asarray(t)))
        assert np.max(np.abs(got_g - want_g)) <= 6e-7
        got_p = twelsh._glide_phase(torch.from_numpy(f), torch.from_numpy(r),
                                    T, torch.from_numpy(t)).numpy()
        want_p = np.asarray(jwelsh._glide_phase(jnp.asarray(f),
                                                jnp.asarray(r), T,
                                                jnp.asarray(t)))
        assert np.max(np.abs(got_p - want_p)) <= 2.3e-4
        assert np.array_equal(got_p[1], (f[1] * t[0]).astype(np.float32))


def _batch(name: str):
    """Notes of one voice: keys, vels, gate, ids, prev keys (glide
    voices), unison-tripled for a unison voice; span 8192."""
    keys = np.array([60.0, 64.0, 67.0, 48.0], np.float32)
    vels = np.array([100.0, 90.0, 80.0, 127.0], np.float32)
    gate = np.array([4096, 6144, 2048, 7000], np.int32)
    on = np.zeros(4, np.int32)
    prev = np.array([60.0, 57.0, 72.0, 50.0], np.float32) \
        if VOICES[name].get("glide") else None
    if VOICES[name].get("unison"):
        keys, vels, on, off, prev = twelsh.unison_notes(
            keys, vels, on, on + gate, prev)
        gate = (off - on).astype(np.int32)
    ids = np.arange(len(keys), dtype=np.int32) * 3 + 1
    return keys, vels, gate, ids, prev


def _host_ctl(mod, p, keys, gate, prev, span, with_phases=True) -> dict:
    hc = mod.host_osc_constants(p, keys, prev)
    hc.update(mod.host_gate_seconds(gate, SR))
    hc.update(mod.host_filter_tables(p, gate.astype(np.int64), span, SR))
    hc.update(mod.host_lfo_table(p, span, SR) or {})
    if with_phases:
        hc.update(mod.host_pitch_phases(p, keys, prev, span, SR) or {})
    return hc


# (voice, host constants) -> bars in dBFS of the peak on the cascade
# input (osc), the amp envelope and render_notes' output; None: equal bit
# for bit. Measured on the CPU (osc / amp / out; "=" bitwise):
#   pad               host -144.5 / = / -131.0   traced -87.5 / = / -83.8
#   lead              host = / = / -137.4        traced -107.3 / -140.7 / -113.5
#   glide             host -101.3 / = / -105.5   traced -101.3 / -140.7 / -105.2
#   glide-sync-fixed  host -99.7 / = / -102.6    traced -99.1 / -140.7 / -102.1
#   pitch-lfo         host = / = / -135.2        over-cap -98.8 / = / -100.2
#                     traced -95.2 / = / -97.5
#   pitch-osc2-glide  host = / = / -138.5        over-cap -101.3 / = / -105.4
#                     traced -107.3 / = / -109.9
#   sync              host = / = / -135.4        traced -107.1 / -140.7 / -112.7
#   unison            host -144.5 / = / -133.6   traced -87.5 / = / -86.8
#   resonance-lfo     host -144.5 / = / -132.7   traced -87.5 / = / -82.8
# The sine (osc2 of the pad) and every exp, exp2 and log are float64
# rounded once in the port and XLA's float32 functions in the reference:
# ulps apart, which the glide phases carry over hundreds of cycles and the
# traced design's frequencies and coefficients carry into the phases and
# the near-critical refined cascade. A phase integrated on the device
# (over-cap, traced pitch) is a cumulative sum that groups differently on
# every device.
PARTS_BARS = {
    ("pad", "host"): (-136.0, None, -123.0),
    ("pad", "traced"): (-79.0, None, -75.0),
    ("lead", "host"): (None, None, -129.0),
    ("lead", "traced"): (-99.0, -132.0, -105.0),
    ("glide", "host"): (-93.0, None, -97.0),
    ("glide", "traced"): (-93.0, -132.0, -97.0),
    ("glide-sync-fixed", "host"): (-91.0, None, -94.0),
    ("glide-sync-fixed", "traced"): (-91.0, -132.0, -94.0),
    ("pitch-lfo", "host"): (None, None, -127.0),
    ("pitch-lfo", "over-cap"): (-90.0, None, -92.0),
    ("pitch-lfo", "traced"): (-87.0, None, -89.0),
    ("pitch-osc2-glide", "host"): (None, None, -130.0),
    ("pitch-osc2-glide", "over-cap"): (-93.0, None, -97.0),
    ("pitch-osc2-glide", "traced"): (-99.0, None, -101.0),
    ("sync", "host"): (None, None, -127.0),
    ("sync", "traced"): (-99.0, -132.0, -104.0),
    ("unison", "host"): (-136.0, None, -125.0),
    ("unison", "traced"): (-79.0, None, -78.0),
    ("resonance-lfo", "host"): (-136.0, None, -124.0),
    ("resonance-lfo", "traced"): (-79.0, None, -74.0),
}


@pytest.mark.parametrize("voice,host", list(PARTS_BARS),
                         ids=[f"{v}-{h}" for v, h in PARTS_BARS])
def test_render_notes_parts_matches_reference(voice, host, kernel_routing):
    """render_notes_parts (cascade input, coefficient rows, amp) and
    render_notes against groove_tpu's, with the host constants shipped
    ("host"; "over-cap": all but the pitch-LFO phase tables, as past
    HOST_PHASE_MAX_ELEMS) or none ("traced": designed in the voice)."""
    pj, pt = _voices(VOICES[voice])
    keys, vels, gate, ids, prev = _batch(voice)
    span = 8192
    fid = twelsh.filter_fidelity_mode(pt, SR)
    assert fid == jwelsh.filter_fidelity_mode(pj, SR)
    hcj = hct = None
    if host != "traced":
        hcj = _host_ctl(jwelsh, pj, keys, gate, prev, span,
                        host == "host")
        hct = _host_ctl(twelsh, pt, keys, gate, prev, span, host == "host")
        assert ("ph1" in hct) == (host == "host"
                                  and voice.startswith("pitch"))
    tv = dict(keys=torch.from_numpy(keys), vels=torch.from_numpy(vels),
              gate_frames=torch.from_numpy(gate), span=span,
              sample_rate=SR, note_ids=torch.from_numpy(ids),
              prev_keys=None if prev is None else torch.from_numpy(prev),
              host_ctl=hct)
    jv = dict(keys=keys, vels=vels, gate_frames=gate, span=span,
              sample_rate=SR, note_ids=ids, prev_keys=prev, host_ctl=hcj)
    o_t, f_t, a_t = twelsh.render_notes_parts(pt, **tv)
    o_j, f_j, a_j = jwelsh.render_notes_parts(pj, **jv)
    bar_osc, bar_amp, bar_out = PARTS_BARS[(voice, host)]
    for got, want, bar in ((o_t, o_j, bar_osc), (a_t, a_j, bar_amp)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (len(keys), span)
        assert got.dtype == np.float32
        if bar is None:
            assert np.array_equal(got, want)
        else:
            assert _db(got, want, want) <= bar
    assert f_t[0] == f_j[0] == ("hz" if host == "traced" else "secs")
    if f_t[0] == "secs":
        # gathered rows of the host tables: exact copies
        assert np.array_equal(f_t[1].numpy(), np.asarray(f_j[1]))
        for st, sj in zip(f_t[2], f_j[2]):
            for ct, cj in zip(st, sj):
                assert np.array_equal(ct.numpy(), np.asarray(cj))
    y_t = twelsh.render_notes(pt, refine_filter=fid, **tv).numpy()
    y_j = np.asarray(jwelsh.render_notes(pj, refine_filter=fid, **jv))
    assert np.isfinite(y_t).all() and np.abs(y_j).max() > 0.01
    assert _db(y_t, y_j, y_j) <= bar_out


# ---- the Renderer -------------------------------------------------------


def _project(name: str) -> dict:
    """"analogue": the 2-measure Welsh analogue. "voices": three devices
    on channels 0-2 playing the analogue's lead, lead and pad parts: a
    hard-sync lead, the pitch-LFO voice with hard sync and the unison pad.
    "glide": the gliding mono lead alone. "voiceless": the analogue beside
    a Welsh device without a voice (its notes ship, it renders silence).
    "few-rows": the analogue with one pad chord (4 notes, a span past
    65536 frames: the refined cascade's few-rows case)."""
    p = synth.welsh_project(MEASURES, BPM)
    if name == "analogue":
        return p
    if name == "few-rows":
        p["patterns"].append({"id": "one-chord", "note-value": "half",
                              "notes": [[48, 0], [55, 0], [60, 0],
                                        [64, 0]]})
        p["tracks"][0]["patterns"] = ["one-chord"]
        return p
    if name == "voiceless":
        p["devices"].append({"instrument": ["voiceless", {"welsh-raw": [
            {"midi-in": 0, "gain": 0.5}, {"no-voice": True}]}]})
        p["patch-cables"].append(["voiceless", "main-mixer"])
        return p
    inst = {"voices": [("sync", 0.25, VOICES["sync"], "lead"),
                       ("pitch", 0.2, PITCH_SYNC, "lead"),
                       ("unison", 0.06, VOICES["unison"], "pad")],
            "glide": [("glide", 0.25, GLIDE_LEAD, "lead")]}[name]
    p["devices"] = [{"instrument": [u, {"welsh-raw": [
        {"midi-in": ch, "gain": g}, dict(raw)]}]}
        for ch, (u, g, raw, _) in enumerate(inst)]
    p["patch-cables"] = [[u, "main-mixer"] for u, *_ in inst]
    p["tracks"] = [{"id": f"t-{u}", "midi-channel": ch,
                    "patterns": [f"{part}-{k % 4}" for k in range(MEASURES)]}
                   for ch, (u, _, _, part) in enumerate(inst)]
    return p


SONGS = ("analogue", "voices", "glide", "voiceless", "few-rows")


def _jax_renderer(name: str, cap: int | None = None):
    jc = jax_compile(JaxSongSettings.from_json(_project(name)),
                     JaxPaths(roots=[]))
    attrs = {} if cap is None else {"NOTE_CHUNK_ELEMS": cap}
    return jc, type("JaxWelsh", (JaxRenderer,), attrs)(jc)


def _port(name: str):
    tc = compile_song(SongSettings.from_json(_project(name)),
                      Paths(roots=[]))
    return tc, Renderer


@pytest.fixture(scope="module")
def songs():
    """name -> (port compiled, its Renderer class, JAX compiled, JAX
    Renderer, JAX render, port render), the reference on its kernel
    routing through the Pallas interpreter."""
    from groove_tpu.ops import iir, pallas_iir

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iir, "USE_PALLAS", True)
        mp.setattr(pallas_iir, "FORCE_INTERPRET", True)
        for name in SONGS:
            jc, jr = _jax_renderer(name)
            tc, cls = _port(name)
            out[name] = (tc, cls, jc, jr, np.asarray(jr.render()),
                         cls(tc, "cpu").render())
    return out


@pytest.mark.parametrize("name", list(SONGS))
def test_host_inputs_and_plan_match_reference(songs, name):
    """The port's Welsh collection equals groove_tpu's Renderer.inputs
    bit for bit (keys, dtypes, values), with the same plan and routing;
    carried over as numpy they render the port's render again."""
    tc, cls, _, jr, _, got = songs[name]
    own = cls(tc, "cpu")
    theirs = {k: np.asarray(v) for k, v in jr.inputs.items()}
    assert theirs.keys() == own.host_inputs.keys()
    assert any(k.startswith("wm/") for k in theirs)
    for k, v in theirs.items():
        mine = own.host_inputs[k]
        assert v.dtype == mine.dtype and np.array_equal(v, mine), k
    assert own._wm_plan == jr._wm_plan
    assert all(len(members) == 1 for _, members in own._wm_plan)
    assert own._welsh_refine == jr._welsh_refine
    carried = cls(tc, "cpu", inputs=theirs)
    assert np.array_equal(carried.render(), got)


# name -> (bar vs JAX in dBFS, bar vs JAX in int16 LSB, bar vs f64 in
# dBFS). Measured on the CPU (port vs JAX, LSB; port vs f64 / JAX vs f64):
#   analogue       -135.7, 1; -135.7 / -137.9
#   voices         -135.0, 1; -136.1 / -138.9
#   glide          -24.8, 1890; -108.2 / -24.8
#   voiceless      the analogue's render, bit for bit
#   few-rows       -110.2, 1; -137.8 / -110.2
# glide: the reference's jitted render is itself -24.8 dBFS from the f64
# reference. XLA's fused evaluation of the glide phase lands up to 6.1e-5
# cycles from its own eager one (which the f64 tool and the port follow:
# render_notes_parts above reads -105.5 against it), and that flips
# square and sawtooth edge samples. few-rows: for rows <= 4 at n >= 65536
# the reference leaves the refined pass to its row-packed XLA solve, the
# port runs K2's twin (ops/iir.lp24_apply_blockrate_sections); that XLA
# solve is the one further from f64.
SONG_BARS = {"analogue": (-127.0, 1, -127.0),
             "voices": (-127.0, 1, -128.0),
             "glide": (-16.0, 4700, -100.0),
             "voiceless": (-127.0, 1, None),
             "few-rows": (-102.0, 1, -129.0)}


@pytest.mark.parametrize("name", list(SONGS))
def test_renderer_matches_reference(songs, name):
    """Against groove_tpu's interpreted render, in float and in int16."""
    tc, _, _, _, ref, got = songs[name]
    assert got.shape == ref.shape == (tc.n_frames, 2)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert 0.05 < float(np.abs(got).max()) < 1.0
    assert _db(got, ref, ref) <= SONG_BARS[name][0]
    q = quantize_16bit(torch.from_numpy(got)).numpy().astype(np.int32)
    q_ref = np.asarray(quantize_16bit_device(jnp.asarray(ref)))
    assert np.max(np.abs(q - q_ref)) <= SONG_BARS[name][1]


@pytest.mark.parametrize("name", [s for s in SONGS if s != "voiceless"])
def test_renderer_against_f64_reference(songs, name):
    """Within the bar (at most -80 dBFS) of the f64 reference and within
    3 dB of the reference's own distance to it."""
    from tools.f64_reference import render_f64

    _, _, jc, _, ref_jax, got = songs[name]
    ref = render_f64(jc)
    port_db, jax_db = _db(got, ref, ref), _db(ref_jax, ref, ref)
    assert port_db <= SONG_BARS[name][2] <= -80.0
    assert port_db <= jax_db + 3.0, (port_db, jax_db)


def test_voiceless_device_is_silent(songs):
    tc, cls, *_, got = songs["voiceless"]
    r = cls(tc, "cpu")
    dev = tc.devices["voiceless"]
    assert dev.voice is None and dev.notes.count > 0
    assert "voiceless/keys" in r.host_inputs
    silent = r._render_instrument(r.inputs, dev, tc.n_frames, {})
    assert silent.shape == (2, tc.n_frames) and not silent.any()
    assert set(r._welsh_refine) == {"pad", "lead"}
    assert np.array_equal(got, songs["analogue"][-1])


def test_offline_matches_sliced_stream(songs):
    """The port's offline render against its own sliced stream at
    4096-frame segments: the cascade regroups between the segments' 64-
    frame grid (K7/K8) and the whole window's blocks (K2/K3). Measured
    -136.5 dBFS, bar -128. (The reference's sliced stream reads -94.1
    against its whole render on its CPU route, where the pad's cascade is
    the serial scan.)"""
    tc, _, _, _, _, got = songs["analogue"]
    sliced = type("Sliced", (StreamingRenderer,), {"WELSH_SLICED": True})
    streamed = sliced(tc, "cpu", segment_frames=4096).render()
    assert _db(got, streamed, streamed) <= -128.0


# ---- the element cap --------------------------------------------------------

CAP = 500_000  # pad: 16 x 88320 -> 5-row chunks; lead: 13 x 76160 -> 6


def test_chunked_render_matches_reference_chunked(songs, kernel_routing):
    """With a small cap in both packages every member renders in row
    chunks (the reference's scan pads its last chunk, the port's is
    short). Port chunked vs JAX chunked measured -136.5 dBFS, bar -128;
    port chunked vs port whole measured -138.5 (the timeline's sums
    group per chunk), bar -130; int16 at most 1 LSB apart (measured 1)."""
    tc, cls, _, _, _, whole = songs["analogue"]
    _, jr = _jax_renderer("analogue", cap=CAP)
    assert jr._note_chunk_elems == CAP
    ref = np.asarray(jr.render())
    r = cls(tc, "cpu", note_chunk_elems=CAP)
    assert [j[0] for j in r._welsh_jobs()] == ["chunked", "chunked"]
    assert r.welsh_launches() == {"lp24_refined": 4, "lp24": 3}
    got = r.render()
    assert _db(got, ref, ref) <= -128.0
    assert _db(got, whole, whole) <= -130.0
    q = [quantize_16bit(torch.from_numpy(a)).numpy().astype(np.int32)
         for a in (got, whole)]
    assert np.max(np.abs(q[0] - q[1])) <= 1


@pytest.mark.parametrize("name,cap", [("analogue", None), ("analogue", CAP),
                                      ("voices", None),
                                      ("voices", 1_200_000)])
def test_welsh_launches_are_the_cascade_calls(songs, monkeypatch, name, cap):
    """welsh_launches() counts, from the plan, the cascade calls a render
    makes: one per packet, one per chunk of a chunked member."""
    tc, cls, *_ = songs[name]
    calls = {"lp24_refined": 0, "lp24": 0}
    for key, fn in (("lp24_refined", "lp24_refined_blockrate"),
                    ("lp24", "lp24_blockrate")):
        orig = getattr(iir_kernels, fn)

        def counted(*a, _k=key, _f=orig, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(iir_kernels, fn, counted)
    r = cls(tc, "cpu", note_chunk_elems=cap)
    r.render()
    assert calls == r.welsh_launches()
    assert sum(calls.values()) >= 2


def test_note_chunk_cap(monkeypatch):
    """16M elements on the CPU (the reference's CPU cap); on a card a
    quarter of its memory over NOTE_PEAK_BYTES_PER_ELEM."""
    assert trender.note_chunk_cap("cpu") == 16_000_000
    props = type("Props", (), {"total_memory": 80 * 2**30})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: props)
    assert trender.note_chunk_cap("cuda:0") == \
        80 * 2**30 // 4 // trender.NOTE_PEAK_BYTES_PER_ELEM


def test_cli_renders_welsh_offline(songs, tmp_path):
    tc, *_, got = songs["analogue"]
    path = synth.write_project(tmp_path / "welsh.json",
                               synth.welsh_project(MEASURES, BPM))
    perf = []
    assert cli.main([str(path), "--wav", "--perf", "--device", "cpu",
                     "--out-dir", str(tmp_path / "o")], perf_out=perf) == 0
    x, rate = read_wav(tmp_path / "o" / "welsh.wav")
    q = quantize_16bit(torch.from_numpy(got)).numpy()
    assert rate == 44100 and x.shape == q.shape
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
    assert perf[0]["frames"] == tc.n_frames


def test_warn_static_only_is_the_original():
    def body(path: Path) -> list:
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "warn_static_only":
                return [ast.dump(s) for s in node.body]
        raise AssertionError(path)
    assert body(REPO / "groove_tpu_torch/engine/render.py") == \
        body(REPO / "groove_tpu/engine/render.py")
    assert trender.STATIC_ONLY_PARAMS == {("toy", "my-value")}
