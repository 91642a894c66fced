"""groove_tpu_torch's StreamingRenderer with sliced Welsh voices, on the
CPU twins: bitwise invariant to the segmentation (one segment, many
segments, batched fetches), close to groove_tpu's forced-sliced stream
(its kernels run through the Pallas interpreter) and to its whole-timeline
Renderer, the CLI's --stream --sliced WAV, the routing, the mono fold, and
the parts that are not ported raising. The song is the Welsh analogue
(testing/synth.welsh_project) cut to 2 measures at 240 bpm (2 s): a
refined pad (K8's twin) and a lead with noise and an amplitude LFO (K7's
twin)."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.engine.stream import StreamingRenderer as JaxStreaming
from groove_tpu.io.wav import quantize_16bit_device
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine import stream
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.io.wav import quantize_16bit, read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

MEASURES, BPM = 2, 240.0


class Sliced(StreamingRenderer):
    WELSH_SLICED = True


class Auto(StreamingRenderer):
    WELSH_SLICED = "auto"


def _text(project=None) -> str:
    return json.dumps(project or synth.welsh_project(MEASURES, BPM))


def _compiled(project=None, roots=()):
    return compile_song(SongSettings.from_json5_str(_text(project)),
                        Paths(roots=list(roots)))


def _one_segment(c) -> int:
    return -(-c.n_frames // 64) * 64


@pytest.fixture(scope="module")
def song():
    """(port compiled, port render at 4096-frame segments, JAX compiled)."""
    c = _compiled()
    jc = jax_compile(JaxSongSettings.from_json5_str(_text()),
                     JaxPaths(roots=[]))
    return c, Sliced(c, "cpu", segment_frames=4096).render(), jc


def test_plan(song):
    c, _, _ = song
    r = Sliced(c, "cpu", segment_frames=4096)
    assert r._sliced == {"pad", "lead"}
    assert r._welsh_refine == {"pad": "refine", "lead": None}
    assert set(r.init_state()) == {"pad/b0/wf/p20", "lead/b0/wf/p4"}
    assert r.planned_launches() == {"lp24_stream": r.n_segs,
                                    "lp24_refined_stream": r.n_segs}
    assert r.mono_foldable


def test_segmentation_invariant(song):
    """One segment, 8192-frame segments and 4096-frame segments fetched
    three at a time: the same bits (caps differ: padded rows go to the
    scratch state slot and add exact zeros)."""
    c, many, _ = song
    assert many.shape == (c.n_frames, 2) and many.dtype == np.float32
    assert 0.05 < float(np.abs(many).max()) < 1.0
    one = Sliced(c, "cpu", segment_frames=_one_segment(c)).render()
    assert np.array_equal(one, many)
    assert np.array_equal(
        Sliced(c, "cpu", segment_frames=8192).render(batch_segments=2),
        many)
    r = Sliced(c, "cpu", segment_frames=4096)
    q = r.render(batch_segments=3, quantize=True)
    assert q.dtype == np.int16
    assert np.array_equal(q, quantize_16bit(torch.from_numpy(many)).numpy())


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


def test_matches_reference_stream_and_whole(song, monkeypatch):
    """Against groove_tpu's forced-sliced stream on its kernel path
    (interpreted Pallas) at the same 4096-frame segments: measured -136.5
    dBFS (CPU), bar -128; int16 at most 1 LSB apart. Against its
    whole-timeline Renderer: measured -94.0 dBFS, as its own sliced
    stream reads (-94.1: the cascade regroups between the fixed 64-frame
    grid and the whole window's blocks), bar -86, inside the reference's
    own 1e-3 of the peak."""
    from groove_tpu.ops import iir as jiir
    from groove_tpu.ops import pallas_iir

    c, many, jc = song
    whole = np.asarray(JaxRenderer(jc).render())
    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)
    jr = type("JaxSliced", (JaxStreaming,), {"WELSH_SLICED": True})(
        jc, segment_frames=4096)
    assert any(k.endswith("/p20") for k in jr._state0)
    ref = np.asarray(jr.render())
    assert ref.shape == many.shape
    assert _db(many, ref, ref) <= -128.0
    q = quantize_16bit(torch.from_numpy(many)).numpy().astype(np.int32)
    q_ref = np.asarray(quantize_16bit_device(jnp.asarray(ref)))
    assert np.max(np.abs(q - q_ref)) <= 1
    assert _db(many, whole, whole) <= -86.0
    assert np.max(np.abs(many - whole)) < 1e-3 * max(
        1.0, float(np.abs(whole).max()))


def test_routing_matches_reference(song):
    """_slice_wins routes each device as the reference's does at the same
    cost, for the CPU's 2.0 and the card's 6.0 (the reference's TPU
    calibration), at live-pull and whole-song segment sizes."""
    c, _, jc = song
    JAuto = type("JaxAuto", (JaxStreaming,), {"WELSH_SLICED": "auto"})
    for seg in (4096, 16384, _one_segment(c)):
        mine = Auto(c, "cpu", segment_frames=4096)
        theirs = JAuto(jc, segment_frames=4096)
        mine.S = theirs.S = seg
        for cost in (StreamingRenderer.SLICE_COST_CPU,
                     StreamingRenderer.SLICE_COST_CUDA):
            mine._slice_cost = theirs._slice_cost = lambda v=cost: v
            for u in ("pad", "lead"):
                assert mine._slice_wins(c.devices[u]) == \
                    theirs._slice_wins(jc.devices[u]), (seg, cost, u)
    assert StreamingRenderer.SLICE_COST_CUDA == \
        JaxStreaming.SLICE_COST_TPU
    assert StreamingRenderer.SLICE_COST_CPU == JaxStreaming.SLICE_COST_CPU


def test_cli_stream_sliced_wav(song, tmp_path):
    c, many, _ = song
    path = synth.write_project(tmp_path / "welsh.json",
                               synth.welsh_project(MEASURES, BPM))
    perf = []
    assert cli.main([str(path), "--wav", "--perf", "--stream", "--sliced",
                     "--segment-frames", "4096", "--stream-batch", "3",
                     "--device", "cpu", "--out-dir", str(tmp_path / "o")],
                    perf_out=perf) == 0
    x, rate = read_wav(tmp_path / "o" / "welsh.wav")
    q = quantize_16bit(torch.from_numpy(many)).numpy()
    assert rate == 44100 and x.shape == q.shape
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
    p = perf[0]
    assert p["frames"] == c.n_frames and p["render_s"] > 0 and p["xrt"] > 0
    n_segs = -(-c.n_frames // 4096)
    assert p["stream"] == {
        "segments": n_segs, "segment_frames": 4096, "batch": 3,
        "sliced": ["lead", "pad"],
        "planned_launches": {"lp24_stream": n_segs,
                             "lp24_refined_stream": n_segs}}
    json.dumps(perf)


def test_mono_fold_and_tripwire():
    rng = np.random.default_rng(1)
    mono = torch.from_numpy(rng.uniform(-1, 1, 500).astype(np.float32))
    stereo = torch.stack([mono, mono], 1)
    for fold, want in ((stream._fold_mono_f32, stereo.numpy()),
                       (stream._fold_mono_i16,
                        quantize_16bit(stereo).numpy())):
        assert np.array_equal(stream._unfold_mono(fold(stereo).numpy()),
                              want)
        bad = stereo.clone()
        bad[7, 1] = 0.5
        with pytest.raises(RuntimeError, match="tripwire"):
            stream._unfold_mono(fold(bad).numpy())


def _with(project, devices=None, cables=None, **extra):
    p = dict(project)
    if devices is not None:
        p["devices"] = project["devices"] + devices
    if cables is not None:
        p["patch-cables"] = cables
    p.update(extra)
    return p


def test_unported_stream_cases_raise(tmp_path, capsys):
    """What still refuses: a loop of a sliced device (its carried note
    state cannot follow a seek, as in the reference), through the renderer
    and the CLI, and the CLI's live and multi-device flags."""
    base = synth.welsh_project(1, BPM)
    c = _compiled(base)
    with pytest.raises(NotImplementedError, match="linear-stream only"):
        next(Sliced(c, "cpu", 4096).stream_loop(0, 1))
    path = synth.write_project(tmp_path / "w.json", base)
    for flag in (["--live", "midi.fifo"], ["--multidevice"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            cli.main([str(path), "--device", "cpu", *flag])
    assert cli.main([str(path), "--loop", "0", "1", "--sliced",
                     "--segment-frames", "4096", "--device", "cpu",
                     "--out-dir", str(tmp_path / "o")]) == 1
    assert "linear-stream only" in capsys.readouterr().err


# ---- the unsliced streamed render ------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A 707 kit, the instruments' assets and short-envelope Welsh patches
    (synth.SHORT_PATCHES) under one root."""
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.2)
    synth.write_instrument_assets(root)
    synth.write_welsh_patches(root, synth.SHORT_PATCHES)
    return root


# song -> (project, tolerance against the port's offline Renderer as a
# share of its peak: the reference's own, tests/test_stream.py, 5e-4 where
# a filter sweeps through low cutoffs — the sidechain-driven low-pass —
# else 1e-4)
SONGS = {
    "kitchen-sink": (synth.kitchen_sink_project, 1e-4),
    "instruments": (synth.instruments_project, 1e-4),
    "fm": (synth.fm_project, 1e-4),
    "welsh": (synth.welsh_patch_project, 1e-4),
    "sidechain": (synth.sidechain_project, 5e-4),
}


def _song_text(name: str) -> str:
    return json.dumps(SONGS[name][0](MEASURES, BPM))


@pytest.fixture(scope="module")
def unsliced(assets):
    """name -> (port compiled, JAX compiled, port render at 4096-frame
    segments), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            text = _song_text(name)
            c = compile_song(SongSettings.from_json5_str(text),
                             Paths(roots=[assets]))
            jc = jax_compile(JaxSongSettings.from_json5_str(text),
                             JaxPaths(roots=[assets]))
            cache[name] = (c, jc, StreamingRenderer(
                c, "cpu", segment_frames=4096).render())
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SONGS))
def test_unsliced_segmentation_invariant(name, unsliced):
    """One segment, 4096- and 8192-frame segments: the same bits; the
    one-call render (render_scan) equals the segment loop."""
    c, _, many = unsliced(name)
    assert many.shape == (c.n_frames, 2)
    assert 0.01 < float(np.abs(many).max()) < 1.5
    one = StreamingRenderer(c, "cpu", _one_segment(c)).render()
    assert np.array_equal(one, many)
    r = StreamingRenderer(c, "cpu", segment_frames=8192)
    assert np.array_equal(r.render(batch_segments=2), many)
    assert np.array_equal(r.render_scan(), many)


@pytest.mark.parametrize("name", list(SONGS))
def test_unsliced_inputs_match_reference(name, unsliced):
    """The host inputs are groove_tpu's StreamingRenderer.inputs, key for
    key and value for value, and rendering from groove_tpu's dict gives
    the port's own bits."""
    c, jc, many = unsliced(name)
    mine = StreamingRenderer(c, "cpu", segment_frames=4096)
    theirs = {k: np.asarray(v) for k, v in
              JaxStreaming(jc, segment_frames=4096).inputs.items()}
    assert set(mine.host_inputs) == set(theirs)
    for k, v in theirs.items():
        assert np.array_equal(np.asarray(mine.host_inputs[k]), v), k
    theirs = {k: np.asarray(v) for k, v in JaxStreaming(
        jc, segment_frames=_one_segment(c)).inputs.items()}
    assert np.array_equal(StreamingRenderer(
        c, "cpu", segment_frames=_one_segment(c), inputs=theirs).render(),
        many)


# song -> dBFS bar against groove_tpu's StreamingRenderer at the same
# 4096-frame segments (its Welsh cascades through the Pallas interpreter),
# about 8 dB above the CPU measurement: kitchen-sink -115.0, instruments
# -144.5, FM -94.9 (the modulator's sin of a large phase amplifies one
# rounding, as offline), Welsh -141.0, sidechain -56.8 (its low-pass cutoff
# follows the drums' level; near z = 1 the regrouped scans' last bits move
# the design: groove_tpu's own stream and offline renders of it differ
# more, -44.5 on the filter-bank analogue's sidechain filter)
REFERENCE_BARS = {"kitchen-sink": -107.0, "instruments": -136.0,
                  "fm": -86.0, "welsh": -133.0, "sidechain": -48.0}


@pytest.mark.parametrize("name", list(SONGS))
def test_unsliced_matches_reference_stream(name, unsliced, monkeypatch):
    from groove_tpu.ops import iir as jiir
    from groove_tpu.ops import pallas_iir

    c, jc, many = unsliced(name)
    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)
    ref = np.asarray(JaxStreaming(jc, segment_frames=4096).render())
    assert ref.shape == many.shape
    assert _db(many, ref, ref) <= REFERENCE_BARS[name]


@pytest.mark.parametrize("name", list(SONGS))
def test_unsliced_matches_offline(name, unsliced, assets):
    """Within the reference's own tolerances of the port's whole-timeline
    Renderer. The instruments song routes its calculator nowhere here: its
    aligned row copy plays each sample's last frame, which the offline
    resampler's interpolation leaves out (groove_tpu's engines differ the
    same way)."""
    c, _, many = unsliced(name)
    project, tol = SONGS[name]
    if name == "instruments":
        p = project(MEASURES, BPM)
        p["patch-cables"] = [cab for cab in p["patch-cables"]
                             if cab[0] != "calculator"]
        c = compile_song(SongSettings.from_json5_str(json.dumps(p)),
                         Paths(roots=[assets]))
        many = StreamingRenderer(c, "cpu", segment_frames=4096).render()
    whole = Renderer(c, "cpu").render()
    peak = max(1.0, float(np.abs(whole).max()))
    assert float(np.abs(whole - many).max()) < tol * peak


def test_loop_range_carries_state_across_the_seam(assets):
    """The reference's test: reverb tails ring across the loop's seek, so
    consecutive passes differ at the seam, and the linear prefix equals a
    plain stream bit for bit."""
    c = _compiled({
        "clock": {"bpm": 240},
        "devices": [
            {"instrument": ["i1", {"welsh": [{"midi-in": 0},
                                             {"name": "piano"}]}]},
            {"effect": ["rv", {"reverb": {"attenuation": 1.0,
                                          "seconds": 3.0}}]},
        ],
        "patch-cables": [["i1", "rv", "main-mixer"]],
        "patterns": [{"id": "p", "note-value": "quarter",
                      "notes": [[60, 0, 0, 0]]}],
        "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
    }, roots=[assets])
    r = StreamingRenderer(c, "cpu", segment_frames=16384)
    ls, le = r.loop_frames(0.0, 2.0)
    assert ls % 64 == 0 and le % 64 == 0 and ls < le
    audio = np.concatenate(list(r.stream_loop(0.0, 2.0, iterations=2)))
    L = le - ls
    assert audio.shape[0] == le + 2 * L
    it1 = audio[le:le + L]
    it2 = audio[le + L:le + 2 * L]
    head = slice(0, 4096)
    assert float(np.abs(it1[head] - it2[head]).max()) > 1e-3
    linear = StreamingRenderer(c, "cpu", segment_frames=16384).render()
    assert np.array_equal(audio[:le], linear[:le])


def test_loop_range_stateless_song_repeats_exactly():
    """The reference's test: with no stateful effect every pass is the
    same audio."""
    c = _compiled({
        "clock": {"bpm": 240},
        "devices": [
            {"instrument": ["i1", {"toy-instrument": [
                {"midi-in": 0}, {"fake-value": 0.25}]}]},
            {"effect": ["g1", {"gain": {"ceiling": 0.5}}]},
        ],
        "patch-cables": [["i1", "g1", "main-mixer"]],
        "patterns": [{"id": "p", "notes": [[60]]}],
        "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
    })
    r = StreamingRenderer(c, "cpu", segment_frames=4096)
    ls, le = r.loop_frames(1.0, 3.0)
    L = le - ls
    audio = np.concatenate(list(r.stream_loop(1.0, 3.0, iterations=3)))
    it = [audio[le + k * L: le + (k + 1) * L] for k in range(3)]
    assert np.array_equal(it[0], it[1]) and np.array_equal(it[1], it[2])


def test_cli_stream_unsliced_wav(unsliced, assets, tmp_path, monkeypatch):
    """--stream without --sliced: the WAV is the stream's int16 image."""
    c, _, many = unsliced("kitchen-sink")
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    path = synth.write_project(tmp_path / "ks.json",
                               SONGS["kitchen-sink"][0](MEASURES, BPM))
    perf = []
    assert cli.main([str(path), "--wav", "--perf", "--stream",
                     "--segment-frames", "4096", "--device", "cpu",
                     "--out-dir", str(tmp_path / "o")], perf_out=perf) == 0
    x, _ = read_wav(tmp_path / "o" / "ks.wav")
    q = quantize_16bit(torch.from_numpy(many)).numpy()
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
    n_segs = -(-c.n_frames // 4096)
    assert perf[0]["stream"]["sliced"] == []
    assert perf[0]["stream"]["planned_launches"] == {
        "scan_stream": 4 * n_segs, "comb_stream": 12 * n_segs,
        "biquad_stream": 2 * n_segs}


def test_cli_loop_wav(assets, tmp_path, monkeypatch):
    """--loop 0 2 --loop-iterations 2 writes le + 2 (le - ls) frames, the
    loop stream's int16 image."""
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    project = synth.sidechain_project(1, BPM)
    path = synth.write_project(tmp_path / "sc.json", project)
    perf = []
    assert cli.main([str(path), "--loop", "0", "2", "--loop-iterations",
                     "2", "--segment-frames", "4096", "--device", "cpu",
                     "--out-dir", str(tmp_path / "o")], perf_out=perf) == 0
    ls, le = perf[0]["loop_frames"]
    assert perf[0]["frames"] == perf[0]["expected_frames"] == \
        le + 2 * (le - ls)
    x, _ = read_wav(tmp_path / "o" / "sc.wav")
    c = _compiled(project, roots=[assets])
    want = np.concatenate(list(StreamingRenderer(
        c, "cpu", segment_frames=4096).stream_loop(0, 2, iterations=2)))
    q = quantize_16bit(torch.from_numpy(want)).numpy()
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
