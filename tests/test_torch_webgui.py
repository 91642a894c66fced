"""groove_tpu_torch's browser GUI (gui/web.py) on the CPU, driven over HTTP
through urllib as the page drives it, on synthetic projects; it mirrors
groove_tpu's tests/test_webgui.py, which reads the reference's tree.
/api/audio's bytes are the CLI's --wav bytes of the same song; the piano
strip's /api/audio/live blocks are the port's LiveSongRenderer's; after
the same commands both packages' WebGui state is the same (the project
browser's roots aside)."""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from groove_tpu.gui.web import WebGui as JaxWebGui
from groove_tpu_torch import cli
from groove_tpu_torch.engine.livesong import LiveSongRenderer
from groove_tpu_torch.gui.web import WebGui, make_server, wav_header
from groove_tpu_torch.io.wav import _chunk_to_i2
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


STEPS = {
    "title": "steps", "clock": {"bpm": 120.0},
    "devices": [{"instrument": ["osc", {"oscillator": {
        "waveform": "sine", "frequency": 330.0}}]},
        {"instrument": ["lead", {"welsh-raw": [{"midi-in": 0},
                                               dict(synth.WELSH_LEAD)]}]}],
    "patch-cables": [["osc", "main-mixer"], ["lead", "main-mixer"]],
    "patterns": [{"id": "p", "note-value": "eighth",
                  "notes": [[60, 62, 64, 65, 67, 69, 71, 72]]}],
    "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
}


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """The kit under an asset root and three songs: the north-star and
    kitchen-sink analogues (1 measure) and STEPS (an oscillator and a
    Welsh lead playing eighths on channel 0)."""
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.2)
    return root, {
        "north-star": synth.write_project(root / "north-star.json",
                                          synth.north_star_project(1)),
        "kitchen-sink": synth.write_project(root / "kitchen-sink.json",
                                            synth.kitchen_sink_project(1)),
        "steps": synth.write_project(root / "steps.json", STEPS)}


@pytest.fixture()
def server(songs, tmp_path, monkeypatch):
    monkeypatch.setenv("GROOVE_ASSETS", str(songs[0]))
    monkeypatch.setenv("GROOVE_TPU_PREFS", str(tmp_path / "prefs.json"))
    gui = WebGui(use_audio=False, device="cpu")
    srv = make_server(gui, 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", gui, songs[1]
    srv.shutdown()
    srv.server_close()
    gui.midi_disconnect()
    gui.model.svc.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=300) as r:
        return json.loads(r.read())


def _cmd(base, cmd, **a):
    a["cmd"] = cmd
    req = urllib.request.Request(base + "/api/cmd",
                                 data=json.dumps(a).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _audio(base, query=""):
    with urllib.request.urlopen(base + "/api/audio" + query,
                                timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        return r.read()


def test_page_and_state(server):
    base, gui, _ = server
    with urllib.request.urlopen(base + "/", timeout=60) as r:
        html = r.read().decode()
    assert "groove" in html and "api/state" in html
    s = _get(base, "/api/state")
    assert "welsh" in s["palette"] and s["title"] is None
    assert gui.model.svc.device == "cpu"


def test_open_edit_save_roundtrip(server, tmp_path):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["kitchen-sink"]))["ok"]
    s = _get(base, "/api/state")
    assert s["title"] and s["tracks"]
    assert _cmd(base, "bpm", value=97)["ok"]
    assert _get(base, "/api/state")["bpm"] == 97
    p = next(p for p in s["params"] if p["cv"] is not None)
    assert _cmd(base, "set_param", uvid=p["uvid"], kind=p["kind"],
                name=p["name"], cv=1.0)["ok"]
    p2 = next(q for q in _get(base, "/api/state")["params"]
              if q["uvid"] == p["uvid"] and q["name"] == p["name"])
    assert p2["cv"] == pytest.approx(1.0, abs=1e-6)
    pid = s["pattern"]["id"]
    assert _cmd(base, "pattern_step", id=pid, row=0, notes=[])["ok"]
    assert _get(base, "/api/state")["pattern"]["rows"][0] == []
    out = tmp_path / "edited.json"
    assert _cmd(base, "save", path=str(out))["ok"]
    gui.model.svc.sync()
    assert _cmd(base, "open", path=str(out))["ok"]
    assert _get(base, "/api/state")["bpm"] == 97
    assert _cmd(base, "frobnicate")["ok"] is False


def test_track_and_device_crud(server):
    base, _, _ = server
    _cmd(base, "new")
    _cmd(base, "add_track")
    s = _get(base, "/api/state")
    assert len(s["tracks"]) == 1
    tid = s["tracks"][0]["id"]
    _cmd(base, "select_track", id=tid)
    _cmd(base, "add_device", kind="welsh")
    s = _get(base, "/api/state")
    assert any("welsh" in d for d in s["tracks"][0]["devices"])
    uvid = s["tracks"][0]["devices"][0].split(" ")[0]
    _cmd(base, "remove_device", uvid=uvid)
    s = _get(base, "/api/state")
    assert not any(uvid in d for d in s["tracks"][0]["devices"])
    _cmd(base, "dup_track", id=tid)
    assert len(_get(base, "/api/state")["tracks"]) == 2
    _cmd(base, "remove_track", id=tid)
    assert len(_get(base, "/api/state")["tracks"]) == 1


def test_automation_curve_draw_apply_clear(server, tmp_path):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["north-star"]))["ok"]
    s = _get(base, "/api/state")
    p = next(q for q in s["params"] if q["name"] == "cutoff")
    w0 = _get(base, "/api/waveform")["peaks"]
    cvs = [0.1, 0.9, 0.1, 0.9, 0.1, 0.9, 0.1, 0.9]
    assert _cmd(base, "set_automation", uvid=p["uvid"], kind=p["kind"],
                name=p["name"], cvs=cvs)["ok"]
    p2 = next(q for q in _get(base, "/api/state")["params"]
              if q["uvid"] == p["uvid"] and q["name"] == p["name"])
    assert p2["curve"] is not None and len(p2["curve"]) == len(cvs)
    assert p2["curve"][:2] == pytest.approx([0.1, 0.9], abs=0.02)
    assert w0 != _get(base, "/api/waveform")["peaks"]
    out = tmp_path / "autod.json"
    assert _cmd(base, "save", path=str(out))["ok"]
    gui.model.svc.sync()
    assert _cmd(base, "open", path=str(out))["ok"]
    p3 = next(q for q in _get(base, "/api/state")["params"]
              if q["uvid"] == p["uvid"] and q["name"] == p["name"])
    assert p3["curve"] is not None and len(p3["curve"]) == len(cvs)
    assert _cmd(base, "set_automation", uvid=p["uvid"], kind=p["kind"],
                name=p["name"], cvs=[])["ok"]
    p4 = next(q for q in _get(base, "/api/state")["params"]
              if q["uvid"] == p["uvid"] and q["name"] == p["name"])
    assert p4["curve"] is None


def test_waveform_and_spectrum_of_the_master_and_one_device(server):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["north-star"]))["ok"]
    w = _get(base, "/api/waveform")
    assert w["frames"] > 0 and max(w["peaks"]) > 0.01
    wd = _get(base, "/api/waveform?device=drums")
    assert wd["frames"] == w["frames"] and max(wd["peaks"]) > 0.01
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    s = _get(base, "/api/spectrum")
    assert len(s["db"]) > 0 and max(s["db"]) > -40.0
    assert s["f_lo"] < 100 < 10000 < s["f_hi"] + 1
    sd = _get(base, "/api/spectrum?device=osc")
    assert len(sd["db"]) > 0 and max(sd["db"]) > -40.0
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/api/spectrum?device=nope")
    assert e.value.code == 500


def test_audio_endpoint_is_the_cli_wav(server, tmp_path):
    """/api/audio: a complete 16-bit stereo WAV whose bytes are the CLI's
    --wav file of the same song (quantized on the host by io.wav there,
    on the device by render_quantized here)."""
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["kitchen-sink"]))["ok"]
    body = _audio(base)
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    fmt, nch, rate, _, _, bits = struct.unpack("<HHIIHH", body[20:36])
    assert (fmt, nch, rate, bits) == (1, 2, 44100, 16)
    samples = gui.model.svc.rendered_samples()
    assert body[44:] == _chunk_to_i2(samples).tobytes() and any(body[44:])
    assert cli.main([str(songs["kitchen-sink"]), "--wav", "--quiet",
                     "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    assert (tmp_path / "kitchen-sink.wav").read_bytes() == body


def test_audio_endpoint_loop_bounce(server):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["kitchen-sink"]))["ok"]
    assert _cmd(base, "loop_range", start=0, end=1)["ok"]
    assert _cmd(base, "loop_toggle")["ok"]
    body = _audio(base, "?loop=2")
    gui.model.svc.sync()
    want = _chunk_to_i2(gui.model.svc._loop_samples(2))
    assert body[44:] == want.tobytes()
    assert body[:44] == wav_header(44100, len(want))


def test_piano_strip_live_audio_is_the_live_renderers(server):
    """note_on through the piano strip, then /api/audio/live: its first
    chunk's PCM is a LiveSongRenderer's 32 blocks of the same note."""
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    gui.live_renderer()
    assert _cmd(base, "note_on", key=60, velocity=110, channel=0)["ok"]
    with urllib.request.urlopen(base + "/api/audio/live",
                                timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers["Transfer-Encoding"] == "chunked"
        head = r.read(44)
        pcm = r.read(4 * 64 * 32)
    assert head[:4] == b"RIFF"
    assert _cmd(base, "note_off", key=60, channel=0)["ok"]
    twin = LiveSongRenderer(gui.model.svc.ensure_compiled(), n_voices=8,
                            device="cpu")
    twin.note_on(0, 60, 110)
    want = np.concatenate([twin.render_block() for _ in range(32)])
    got = np.frombuffer(pcm, "<i2").reshape(-1, 2)
    assert np.array_equal(got, _chunk_to_i2(want)) and np.abs(got).max() > 0


def test_drag_drop_add_device_to_channel(server):
    base, _, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    assert _cmd(base, "add_track")["ok"]
    target = _get(base, "/api/state")["tracks"][-1]
    n_before = len(target["devices"])
    assert _cmd(base, "add_device", kind="welsh",
                channel=target["channel"])["ok"]
    t2 = next(t for t in _get(base, "/api/state")["tracks"]
              if t["id"] == target["id"])
    assert len(t2["devices"]) == n_before + 1
    assert any("welsh" in d for d in t2["devices"])


def test_pattern_note_value_editing(server):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    s = _get(base, "/api/state")
    assert s["pattern"]["note_value"] == "eighth"
    assert "quarter" in s["note_values"]
    frames_before = gui.model.svc.ensure_compiled().n_frames
    assert _cmd(base, "pattern_note_value", id=s["pattern"]["id"],
                value="quarter")["ok"]
    assert _get(base, "/api/state")["pattern"]["note_value"] == "quarter"
    assert gui.model.svc.ensure_compiled().n_frames > frames_before
    assert _cmd(base, "pattern_note_value", id=s["pattern"]["id"],
                value="nope")["ok"]
    assert _get(base, "/api/state")["pattern"]["note_value"] == "quarter"


def test_midi_port_panel_lists_and_connects(server, tmp_path, monkeypatch):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    port = tmp_path / "port-0"
    os.mkfifo(port)
    monkeypatch.setenv("GROOVE_MIDI_DIR", str(tmp_path))
    assert str(port) in _get(base, "/api/state")["midi_ports"]
    gui.live_renderer()
    assert _cmd(base, "midi_connect", port=str(port))["ok"]
    assert _get(base, "/api/state")["midi_connected"] == str(port)
    with open(port, "wb", buffering=0) as w:
        w.write(bytes([0x90, 64, 100]))
        pool = next(iter(gui._live._pools.values()))
        for _ in range(500):
            if (pool["keys"] == 64).any() and (pool["vels"] > 0).any():
                break
            time.sleep(0.01)
        else:
            raise AssertionError("the MIDI note never reached the pool")
    assert _cmd(base, "midi_disconnect")["ok"]
    assert _get(base, "/api/state")["midi_connected"] is None


def test_live_renderer_invalidated_on_project_change(server):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    first = gui.live_renderer()
    assert first.device.type == "cpu"
    assert _cmd(base, "open", path=str(songs["north-star"]))["ok"]
    assert gui._live is None
    assert gui.live_renderer() is not first
    p = next(p for p in _get(base, "/api/state")["params"]
             if p["cv"] is not None)
    assert _cmd(base, "set_param", uvid=p["uvid"], kind=p["kind"],
                name=p["name"], cv=0.25)["ok"]
    assert gui._live is None


def test_live_chunks_single_listener(server):
    base, gui, songs = server
    assert _cmd(base, "open", path=str(songs["steps"]))["ok"]
    g1 = gui.live_chunks(blocks_per_chunk=1)
    next(g1)
    g2 = gui.live_chunks(blocks_per_chunk=1)
    next(g2)
    with pytest.raises(StopIteration):
        next(g1)
    next(g2)
    g2.close()


def test_state_matches_groove_tpu_after_the_same_commands(songs, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("GROOVE_ASSETS", str(songs[0]))
    monkeypatch.setenv("GROOVE_TPU_PREFS", str(tmp_path / "prefs.json"))
    states = []
    for gui in (WebGui(use_audio=False, device="cpu"),
                JaxWebGui(use_audio=False)):
        try:
            for cmd, a in (("open", {"path": str(songs[1]["kitchen-sink"])}),
                           ("bpm", {"value": 101}), ("add_track", {}),
                           ("add_device", {"kind": "gain"}),
                           ("loop_range", {"start": 1, "end": 3}),
                           ("set_param", {"uvid": "st-gain", "kind": "gain",
                                          "name": "ceiling", "cv": 0.3}),
                           ("pattern_step", {"id": "beat", "row": 1,
                                             "notes": [62]})):
                assert gui.command(cmd, a)["ok"], cmd
            s = gui.state()
            s.pop("browser")
            states.append(json.loads(json.dumps(s)))
        finally:
            gui.model.svc.shutdown()
    assert states[0] == states[1]
