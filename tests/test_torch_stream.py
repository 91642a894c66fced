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
    base = synth.welsh_project(1, BPM)
    c = _compiled(base)
    cases = {
        "unsliced Welsh": lambda: StreamingRenderer(c, "cpu", 4096),
        "auto keeps whole windows": lambda: Auto(c, "cpu",
                                                 _one_segment(c)),
        "loop": lambda: Sliced(c, "cpu", 4096).stream_loop(0, 1),
        "filter effect": lambda: Sliced(_compiled(_with(
            base, [{"effect": ["lp", {"filter-low-pass-12db": {
                "cutoff": 500.0, "q": 0.7}}]}],
            [["pad", "lp", "main-mixer"], ["lead", "main-mixer"]])),
            "cpu", 4096),
        "drumkit": lambda: Sliced(_compiled(_with(
            base, [{"instrument": ["drums", {"drumkit": [
                {"midi-in": 9}, {"name": "707"}]}]}]),
            [synth.write_assets(tmp_path / "kit", max_seconds=0.2)]),
            "cpu", 4096),
    }
    for name, make in cases.items():
        with pytest.raises(NotImplementedError, match="not ported yet"):
            make()
    path = synth.write_project(tmp_path / "w.json", base)
    assert cli.main([str(path), "--stream", "--device", "cpu"]) == 1
    assert "unsliced streamed Welsh voice" in capsys.readouterr().err
