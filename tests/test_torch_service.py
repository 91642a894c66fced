"""groove_tpu_torch's EngineService (engine/service.py) on the CPU: the
reference's behavioural tests of groove_tpu/engine/service.py
(tests/test_service.py) on synthetic projects, and one command script run
through both packages' services side by side.

The script (open, tempo, track and device CRUD, parameters, automation,
control links, pattern edits, a loop range, save) gives the same events
in both packages, and the same saved project file byte for byte; each
package opens the other's file. Before the edits, the kitchen-sink
analogue (synth.kitchen_sink_project(1), 2 s) rendered on each worker is
held to tests/test_torch_effects.py's bar for that song against
groove_tpu run as that test runs it (its Pallas kernels interpreted):
-114 dBFS [measured -122.2]; the loop bounce of beats [1, 3) twice to
tests/test_torch_stream.py's kitchen-sink stream bar, -107 [-122.2]. The
service's WAV (quantized on the host by io.wav) is the CLI's --wav
(quantized on the device by Renderer.render_quantized) byte for byte."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from groove_tpu.engine.service import EngineService as JaxService
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.engine.service import EngineService
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.io.wav import _chunk_to_i2, quantize_16bit, read_wav
from groove_tpu_torch.project.save import save_project, song_to_dict
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its renders are
    thousands of small torch calls, and beside other test processes a
    full thread team per call stalls on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)


@pytest.fixture
def project(tmp_path):
    return synth.write_project(tmp_path / "oscillator.json",
                               synth.oscillator_project())


def _service(events=None, **kw):
    sink = events.append if events is not None else None
    return EngineService(on_event=(lambda k, d: sink((k, d))) if sink
                         else None, use_audio=False, device="cpu", **kw)


def _db(a, b) -> float:
    peak = max(1.0, float(np.abs(b).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


# ---- one command script through both packages ---------------------------

def _script(svc, work: Path):
    """The command script: what the shell, TUI and web GUI send."""
    svc.set_tempo(150.0)
    svc.add_track()
    svc.add_track("lead", 3)
    svc.duplicate_track("drum-track")
    svc.duplicate_track("no-such-track")
    svc.remove_track("lead")
    svc.remove_pattern_from_track("drum-track", "beat")
    svc.add_device("gain")
    svc.add_device("filter-low-pass-12db", uvid="lp", midi_channel=2)
    svc.add_device("arpeggiator", midi_channel=1, midi_out=0)
    svc.add_device("no-such-kind")
    svc.set_device_param("lp", "cutoff", 2000.0)
    svc.set_device_param("ghost", "cutoff", 1.0)
    svc.remove_device("gain-1")
    svc.set_automation("lp", "cutoff", [0.2, 0.8, 0.5])
    svc.set_automation("lp", "q", [0.4])
    svc.set_automation("lp", "q", [])
    svc.add_control_link(synth.SIDECHAIN_UVID, "lp", "cutoff")
    svc.add_control_link(synth.SIDECHAIN_UVID, "lp", "not-a-param")
    svc.remove_control_link(synth.SIDECHAIN_UVID, "lp", "cutoff")
    svc.remove_control_link("nobody", "lp", "cutoff")
    svc.set_pattern_step("beat", 3, [60, 64])
    svc.set_pattern_note_value("beat", "eighth")
    svc.set_pattern_note_value("beat", "no-such-value")
    svc.set_pattern_step("no-such-pattern", 0, [60])
    svc.set_loop(1.0, 3.0)
    svc.set_loop_enabled(False)
    svc.set_loop_enabled(True)
    svc.save(work / "song.json")
    assert svc.sync()


def _plain_events(events, work: Path) -> list:
    """Events with this side's directory taken out of their paths."""
    return [(k, d.replace(str(work), "WORK") if isinstance(d, str) else d)
            for k, d in events]


@pytest.fixture(scope="module")
def both(assets, tmp_path_factory):
    """Each package's service: (events, the kitchen-sink render, the loop
    bounce, the work directory) after the script, groove_tpu's renders on
    its kernel path (the Pallas interpreter)."""
    from groove_tpu.ops import iir, pallas_iir

    song = synth.write_project(
        tmp_path_factory.mktemp("song") / "kitchen-sink.json",
        synth.kitchen_sink_project(1))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GROOVE_ASSETS", str(assets))
        mp.setattr(iir, "USE_PALLAS", True)
        mp.setattr(pallas_iir, "FORCE_INTERPRET", True)
        for name in ("port", "reference"):
            work = tmp_path_factory.mktemp(name)
            events = []
            if name == "port":
                svc = _service(events)
            else:
                svc = JaxService(on_event=lambda k, d: events.append((k, d)),
                                 use_audio=False)
            try:
                svc.open_project(song)
                rendered = np.asarray(svc.rendered_samples())
                svc.set_loop(1.0, 3.0)
                bounced = np.asarray(svc.rendered_samples(loop_iterations=2))
                svc.clear_loop()
                _script(svc, work)
            finally:
                svc.shutdown()
            out[name] = (_plain_events(events, work), rendered, bounced,
                         work)
    return out


def test_script_gives_the_same_events(both):
    events = both["port"][0]
    assert events == both["reference"][0]
    kinds = [k for k, _ in events]
    for kind in ("project-opened", "tempo", "track-added", "track-deleted",
                 "pattern-removed", "device-added", "device-param",
                 "device-removed", "automation-set", "control-link-added",
                 "control-link-removed", "pattern-step",
                 "pattern-note-value", "loop-set", "loop-enabled",
                 "loop-cleared", "saved", "error"):
        assert kind in kinds, kind
    assert kinds.count("error") >= 5


def test_script_saves_the_same_file(both):
    """The saved projects are equal byte for byte, and each package opens
    the other's file (and saves it back to the same bytes)."""
    from groove_tpu.project.save import save_project as jax_save

    port = both["port"][3] / "song.json"
    ref = both["reference"][3] / "song.json"
    assert port.read_bytes() == ref.read_bytes()
    again = port.with_name("again.json")
    save_project(SongSettings.from_project_file(ref), again)
    assert again.read_bytes() == ref.read_bytes()
    jax_save(JaxSongSettings.from_project_file(port), again)
    assert again.read_bytes() == port.read_bytes()


def test_renders_on_the_worker_within_the_songs_bars(both):
    _, got, got_loop, _ = both["port"]
    _, ref, ref_loop, _ = both["reference"]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert 0.05 < np.abs(got).max() < 1.0
    assert _db(got, ref) <= -114.0
    assert got_loop.shape == ref_loop.shape
    assert _db(got_loop, ref_loop) <= -107.0


# ---- the reference's behavioural tests (tests/test_service.py) ----------

def test_save_roundtrip_renders_identically(assets):
    song = SongSettings.from_json(synth.north_star_project(1))
    resaved = SongSettings.from_json(song_to_dict(song))
    from groove_tpu_torch.project.paths import Paths

    a = compile_song(song, Paths(roots=[assets]))
    b = compile_song(resaved, Paths(roots=[assets]))
    assert a.n_frames == b.n_frames
    assert np.array_equal(a.devices[synth.FILTER_UVID].automation["cutoff"],
                          b.devices[synth.FILTER_UVID].automation["cutoff"])
    assert np.array_equal(Renderer(a, "cpu").render(),
                          Renderer(b, "cpu").render())


def test_service_open_render_save(project, tmp_path):
    events = []
    svc = _service(events)
    try:
        svc.open_project(project)
        svc.render_wav(tmp_path / "out.wav")
        svc.save(tmp_path / "resave.json")
        assert svc.sync()
        kinds = {k for k, _ in events}
        assert {"project-opened", "rendered", "saved"} <= kinds, events
        assert (tmp_path / "out.wav").stat().st_size > 44
        SongSettings.from_project_file(tmp_path / "resave.json")
    finally:
        svc.shutdown()


def test_service_wav_is_the_cli_wav(assets, tmp_path, monkeypatch):
    """render-wav quantizes the float render on the host (io.wav); the CLI
    quantizes on the device (render_quantized): the same bytes."""
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    song = synth.write_project(tmp_path / "north-star.json",
                               synth.north_star_project(1))
    svc = _service()
    try:
        svc.open_project(song)
        svc.render_wav(tmp_path / "service.wav")
        assert svc.sync()
    finally:
        svc.shutdown()
    assert cli.main([str(song), "--wav", "--quiet", "--device", "cpu",
                     "--out-dir", str(tmp_path / "cli")]) == 0
    cli_wav = (tmp_path / "cli" / "north-star.wav").read_bytes()
    assert (tmp_path / "service.wav").read_bytes() == cli_wav
    assert len(cli_wav) > 44 + 4 * 44100


def test_host_and_device_quantizers_agree():
    """io/wav._chunk_to_i2 (the host's, the service's and the web GUI's)
    and quantize_16bit (the device's) on the same float samples: the
    rails, values just inside them, rounding edges and noise."""
    edges = np.array([0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 0.99999994,
                      -0.99999994, 1.0 / 32767, -1.0 / 32767,
                      np.nextafter(np.float32(1.0 / 32767), 0),
                      0.5 / 32767, 3.0e-5, -3.0e-5], np.float32)
    noise = np.random.default_rng(0).uniform(-1.2, 1.2, 20000)
    x = np.concatenate([edges, noise.astype(np.float32)]).reshape(-1, 2)
    assert np.array_equal(_chunk_to_i2(x),
                          quantize_16bit(torch.from_numpy(x)).numpy())


def test_service_refuses_a_missing_card(monkeypatch):
    """A CUDA device without a card is refused: the service never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineService(use_audio=False)


def test_service_tempo_change_recompiles(project):
    events = []
    svc = _service(events)
    try:
        svc.open_project(project)
        svc.set_tempo(120.0)
        svc.play()  # renders (no audio device)
        deadline = time.time() + 120
        while time.time() < deadline:
            if ("playback-stopped", None) in events:
                break
            time.sleep(0.05)
        assert ("tempo", 120.0) in events
        # at 120 bpm the one-measure pattern is 2 s
        assert svc.compiled.n_frames == pytest.approx(2 * 44100, abs=64)
        assert ("playback-started", None) in events
    finally:
        svc.shutdown()


def test_service_loop_bounce(assets, tmp_path, monkeypatch):
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    song = synth.write_project(tmp_path / "ks.json",
                               synth.kitchen_sink_project(1))
    events = []
    svc = _service(events)
    try:
        svc.open_project(song)
        svc.set_loop(1.0, 3.0)
        out = tmp_path / "loop.wav"
        svc.render_loop_wav(out, iterations=2)
        assert svc.sync()
        assert ("loop-set", (1.0, 3.0)) in events
        assert any(k == "rendered" for k, _ in events)
        assert svc.is_loop_enabled and svc.loop_range == (1.0, 3.0)
        r = StreamingRenderer(svc.compiled, "cpu")
        ls, le = r.loop_frames(1.0, 3.0)
        audio, rate = read_wav(out)
        assert rate == 44100 and audio.shape[0] == le + 2 * (le - ls)
        want = np.concatenate(list(r.stream_loop(1.0, 3.0, iterations=2)))
        assert np.array_equal(np.asarray(read_wav(out)[0]),
                              np.asarray(_chunk_to_i2(want), np.float32)
                              / np.float32(32768.0))
        svc.clear_loop()
        assert svc.sync()
        assert not svc.is_loop_enabled and svc.loop_range is None
    finally:
        svc.shutdown()


def test_render_loop_wav_without_range_reports_error(project, tmp_path):
    events = []
    svc = _service(events)
    try:
        svc.open_project(project)
        svc.render_loop_wav(tmp_path / "x.wav", iterations=1)
        assert svc.sync()
        assert any(k == "error" and "loop" in str(d) for k, d in events)
        assert not (tmp_path / "x.wav").exists()
    finally:
        svc.shutdown()


def test_control_link_add_remove(tmp_path):
    src = synth.write_project(tmp_path / "link-song.json", {
        "clock": {"bpm": 120},
        "devices": [
            {"instrument": ["i1", {"oscillator": {
                "waveform": "sine", "frequency": 220.0}}]},
            {"instrument": ["i2", {"oscillator": {
                "waveform": "sine", "frequency": 3.0}}]},
            {"effect": ["fx", {"gain": {"ceiling": 1.0}}]},
            {"controller": ["sc", {"signal-passthrough-controller": [{}]}]},
        ],
        "patch-cables": [["i1", "fx", "main-mixer"],
                         ["i2", "sc", "main-mixer"]],
        "patterns": [{"id": "p", "notes": [[60]]}],
        "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
    })
    events = []
    svc = _service(events)
    try:
        svc.open_project(src)
        assert svc.sync()
        base = svc.rendered_samples().copy()
        svc.add_control_link("sc", "fx", "ceiling")
        assert svc.sync()
        assert ("control-link-added", ("sc", "fx", "ceiling")) in events
        linked = svc.rendered_samples()
        assert not np.array_equal(base, linked)
        d = song_to_dict(svc.song)
        assert any(c["source"] == "sc"
                   and c["target"] == {"id": "fx", "param": "ceiling"}
                   for c in d.get("controls", []))
        svc.remove_control_link("sc", "fx", "ceiling")
        assert np.array_equal(base, svc.rendered_samples())
        svc.add_control_link("sc", "nope", "ceiling")
        svc.add_control_link("sc", "fx", "not-a-param")
        assert svc.sync()
        assert len([d for k, d in events if k == "error"]) >= 2
    finally:
        svc.shutdown()


def test_stop_issued_before_playback_still_wins():
    svc = _service()
    try:
        svc.stop()
        assert svc._stop_playback.is_set()
        svc.play()  # a new play request supersedes the old stop
        assert not svc._stop_playback.is_set()
        svc.stop()  # a stop after the play survives the stream's start
        svc.sync()
        assert svc._stop_playback.is_set()
    finally:
        svc.shutdown()


def test_noop_edit_does_not_mark_dirty(project):
    svc = _service()
    try:
        svc.open_project(project)
        svc.sync()
        svc._dirty = False
        svc.remove_control_link("nobody", "nothing", "nope")
        svc.set_device_param("ghost-device", "gain", 1.0)
        svc.sync()
        assert not svc._dirty
        svc.add_device("gain")
        svc.sync()
        assert svc._dirty
    finally:
        svc.shutdown()


def test_set_automation_preserves_shared_path(project):
    from groove_tpu_torch.core.time import BeatValue
    from groove_tpu_torch.project.schema import (ControlPathSettings,
                                                 ControlStepSettings,
                                                 ControlTargetSettings,
                                                 ControlTripSettings)

    svc = _service()
    try:
        svc.open_project(project)
        svc.sync()
        song = svc.song
        dev = song.devices[0].uvid
        pid = f"auto-{dev}-frequency"
        song.paths.append(ControlPathSettings(
            pid, BeatValue.from_name("whole"),
            [ControlStepSettings("flat", 0.5, 0.5)]))
        song.trips.append(ControlTripSettings(
            "foreign-trip", ControlTargetSettings(dev, "waveform"), [pid]))
        svc.set_automation(dev, "frequency", [])
        svc.sync()
        assert any(p.id == pid for p in song.paths)
        svc.set_automation(dev, "frequency", [0.1, 0.9])
        svc.sync()
        ids = [p.id for p in song.paths]
        assert len(ids) == len(set(ids))
    finally:
        svc.shutdown()


def test_rendered_samples_and_ensure_compiled_worker_handshakes(project):
    svc = _service()
    try:
        svc.open_project(project)
        compiled = svc.ensure_compiled()
        assert compiled is not None and compiled.n_frames > 0
        assert compiled is svc.compiled
        got = svc.rendered_samples()
        direct = Renderer(compiled, "cpu").render()
        assert got.shape == direct.shape and np.array_equal(got, direct)
        svc.set_tempo(96.0)
        recompiled = svc.ensure_compiled()
        assert recompiled is not compiled
        assert recompiled.n_frames != compiled.n_frames
        svc.set_loop(0.0, 1.0)
        looped = svc.rendered_samples(loop_iterations=2)
        spb = recompiled.sample_rate * 60.0 / 96.0
        assert abs(len(looped) - 3 * spb) <= 3 * 64
    finally:
        svc.shutdown()


def test_ensure_compiled_returns_none_on_compile_failure(project, tmp_path):
    events = []
    svc = _service(events)
    try:
        svc.open_project(project)
        assert svc.ensure_compiled() is not None
        bad = synth.write_project(tmp_path / "bad.json", {
            "clock": {"bpm": 120},
            "devices": [{"instrument": ["w", {"welsh": {"midi-in": 0}}]}],
            "patch-cables": [["w", "main-mixer"]],
        })
        svc.open_project(bad)
        assert svc.ensure_compiled() is None
        assert any(k == "error" and "welsh" in str(d) for k, d in events), \
            events
    finally:
        svc.shutdown()


def test_rendered_samples_device_isolation_on_worker(assets, tmp_path,
                                                     monkeypatch):
    """rendered_samples(device=...) renders one instrument on the worker,
    the bits it adds to the master (here the kit, before its filter);
    anything else re-raises the worker's ValueError on the caller."""
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    song = synth.write_project(tmp_path / "ns.json",
                               synth.north_star_project(1))
    svc = _service()
    try:
        svc.open_project(song)
        compiled = svc.ensure_compiled()
        iso = svc.rendered_samples(device="drums")
        r = Renderer(compiled, "cpu")
        want = r._render_instrument(r.inputs, compiled.devices["drums"],
                                    compiled.n_frames).T.numpy()
        assert iso.shape == (compiled.n_frames, 2)
        assert np.array_equal(iso, want) and np.abs(iso).max() > 0
        with pytest.raises(ValueError, match="not an instrument"):
            svc.rendered_samples(device=synth.FILTER_UVID)
        with pytest.raises(ValueError, match="not an instrument"):
            svc.rendered_samples(device="nope")
    finally:
        svc.shutdown()


def test_isolated_welsh_device_is_its_share_of_the_song(tmp_path):
    """A Welsh device rendered alone (Renderer._render_instrument without
    the song's merged monos: its own jobs, in the same order) gives the
    bits it gives inside the whole song."""
    c = compile_song(SongSettings.from_json(synth.welsh_project(1, 240.0)))
    r = Renderer(c, "cpu")
    monos = r._render_welsh_merged(r.inputs, c.n_frames)
    for uvid in monos:
        dev = c.devices[uvid]
        alone = r._render_instrument(r.inputs, dev, c.n_frames)
        inside = r._render_instrument(r.inputs, dev, c.n_frames, monos)
        assert torch.equal(alone, inside) and alone.abs().max() > 0
