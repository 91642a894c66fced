"""groove_tpu_torch's terminal front ends on the CPU, on synthetic
projects: the line shell (shell.py), the TUI's view-model (gui/model.py)
and curses driver (gui/tui.py), the preferences (gui/prefs.py), the entity
factory (engine/factory.py) and project saving (project/save.py). They
mirror groove_tpu's tests/test_shell.py and tests/test_gui.py, which read
the reference's project tree; each front end's service renders on the
device it is given (the CPU here)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from groove_tpu.engine import factory as jfactory
from groove_tpu.gui import prefs as jprefs
from groove_tpu.project.save import song_to_dict as jax_song_to_dict
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import shell
from groove_tpu_torch.engine import factory
from groove_tpu_torch.engine.service import EngineService
from groove_tpu_torch.gui import model as model_mod
from groove_tpu_torch.gui import tui
from groove_tpu_torch.gui.model import TuiModel
from groove_tpu_torch.gui.prefs import Preferences, prefs_file
from groove_tpu_torch.project.save import song_to_dict
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]


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
    """The kit under an asset root, with a projects/ folder for the
    browser: the oscillator song and the kitchen-sink and Welsh
    analogues."""
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.2)
    projects = root / "projects"
    projects.mkdir()
    synth.write_project(projects / "oscillator-sine-a4.json",
                        synth.oscillator_project())
    synth.write_project(projects / "kitchen-sink.json",
                        synth.kitchen_sink_project(1))
    synth.write_project(projects / "welsh.json",
                        synth.welsh_project(1, 240.0))
    return root


@pytest.fixture
def env(assets, tmp_path, monkeypatch):
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    monkeypatch.setenv("GROOVE_TPU_PREFS", str(tmp_path / "prefs.json"))
    return assets / "projects"


@pytest.fixture
def model(env):
    m = TuiModel(use_audio=False, device="cpu")
    yield m
    m.svc.shutdown()


# ---- the line shell --------------------------------------------------------

def test_shell_open_edit_loop_status(env, tmp_path):
    """python -m groove_tpu_torch.shell's main in a process that refuses
    jax and groove_tpu, commands on stdin (the shell's scriptable mode)."""
    script = "\n".join([
        f"open {env / 'welsh.json'}", "tempo 90", "tracks", "loop 2 6",
        "status", "loop off", "status", "palette", "track-new lane-x 5",
        "tracks", f"render {tmp_path / 'out.wav'}",
        f"bounce-loop {tmp_path / 'loop.wav'} 1", "loop 0 2",
        f"bounce-loop {tmp_path / 'loop.wav'} 1",
        f"save {tmp_path / 'resaved.json'}", "frobnicate", "help", "quit",
        ""])
    code = """
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
from groove_tpu_torch import shell
sys.exit(shell.main(["--device", "cpu"]))
"""
    res = subprocess.run([sys.executable, "-c", code], input=script,
                         text=True, capture_output=True, timeout=300,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    for want in ("[project-opened]", "[tempo] 90.0", "[loop-set] (2.0, 6.0)",
                 "loop=(2.0, 6.0)", "[loop-cleared]", "lane-x  ch5",
                 "[saved]", "unknown command 'frobnicate'", "bounce-loop",
                 "[error] no loop range set", "playing=False"):
        assert want in out, want
    assert " ".join(factory.sorted_keys()) in out
    assert out.count("[rendered]") == 2
    assert (tmp_path / "resaved.json").exists()
    from groove_tpu_torch.io.wav import read_wav

    audio, rate = read_wav(tmp_path / "out.wav")
    assert rate == 44100 and np.abs(audio).max() > 0.01


def test_shell_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", open("/dev/null"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shell.main([])


# ---- the TUI's view-model ---------------------------------------------------

def test_open_displays_tracks_and_devices(model, env):
    model.open_project(env / "oscillator-sine-a4.json")
    assert model.song is not None
    lines = "\n".join(model.panel_lines("tracks"))
    assert "ch0" in lines and "oscillator" in lines
    assert "BPM" in model.control_bar()
    assert model.svc.device == "cpu"


def test_tempo_edit_via_keys(model, env):
    model.open_project(env / "oscillator-sine-a4.json")
    bpm0 = model.song.clock.bpm
    model.handle_key("=")
    assert model.song.clock.bpm == bpm0 + 1
    model.handle_key("+")
    assert model.song.clock.bpm == bpm0 + 11
    model.handle_key("-")
    assert model.song.clock.bpm == bpm0 + 10
    model.handle_key("_")
    assert model.song.clock.bpm == bpm0


def test_track_crud_via_keys(model, env):
    model.open_project(env / "oscillator-sine-a4.json")
    n0 = len(model.tracks())
    model.focus = "tracks"
    model.handle_key("n")
    assert len(model.tracks()) == n0 + 1
    new_id = model.selected_track
    model.handle_key("d")
    assert len(model.tracks()) == n0 + 2
    model.handle_key("D")
    assert len(model.tracks()) == n0 + 1
    assert all(t.id != new_id for t in model.tracks())
    model.handle_key("down")
    model.handle_key("tab")
    assert model.focus == "palette"


def test_palette_adds_entity_to_selected_channel(model, env):
    model.open_project(env / "oscillator-sine-a4.json")
    model.focus = "palette"
    keys = factory.sorted_keys()
    model.cursor["palette"] = keys.index("gain")
    model.handle_key("enter")
    assert any("gain" in d for d in model.effect_chain())
    model.cursor["palette"] = keys.index("welsh")
    model.handle_key("enter")
    ch = next(t.midi_channel for t in model.tracks()
              if t.id == model.selected_track)
    assert any("welsh" in d for d in model.devices_for_channel(ch))
    assert "gain" in "\n".join(model.panel_lines("palette"))


def test_browser_lists_the_asset_roots_projects(model, env):
    """_browser_roots: $GROOVE_ASSETS/projects (and ./projects)."""
    assert model_mod._browser_roots()[0] == env
    model.focus = "browser"
    names = [p.name for p in model.browser_files]
    assert {"oscillator-sine-a4.json", "kitchen-sink.json",
            "welsh.json"} <= set(names)
    model.cursor["browser"] = names.index("oscillator-sine-a4.json")
    model.handle_key("enter")
    assert model.song is not None
    assert model.project_path.endswith("oscillator-sine-a4.json")
    assert "oscillator-sine-a4.json" in "\n".join(
        model.panel_lines("browser"))


def test_save_round_trips_edits(model, env, tmp_path):
    model.open_project(env / "oscillator-sine-a4.json")
    model.handle_key("=")
    model.svc.add_track("extra", 5)
    model.svc.sync()
    out = tmp_path / "edited.json"
    model.save_project(out)
    song2 = SongSettings.from_project_file(out)
    assert any(t.id == "extra" and t.midi_channel == 5 for t in song2.tracks)
    assert song2.clock.bpm == model.song.clock.bpm


def test_play_and_stop_and_the_event_log(model, env):
    model.open_project(env / "oscillator-sine-a4.json")
    model.handle_key(" ")  # play: without audio it renders and stops
    model.svc.sync()
    kinds = [k for k, _ in model.events]
    assert "playback-started" in kinds and "playback-stopped" in kinds
    assert "project-opened" in "\n".join(model.panel_lines("log"))
    model.handle_key("q")
    assert model.quit_requested


def test_prefs_last_project_reload(env, tmp_path):
    p = Preferences.load()
    p.should_reload_last_project = True
    p.save()
    song = env / "oscillator-sine-a4.json"
    m1 = TuiModel(use_audio=False, device="cpu")
    m1.open_project(song)
    m1.svc.shutdown()
    m2 = TuiModel(use_audio=False, device="cpu")
    try:
        assert m2.project_path == str(song) and m2.song is not None
    finally:
        m2.svc.shutdown()
    d = json.loads((tmp_path / "prefs.json").read_text())
    assert d["last_project_filename"] == str(song)


def test_prefs_file_is_shared_with_groove_tpu(env, tmp_path):
    """Both packages read and write one preferences file
    ($GROOVE_TPU_PREFS), unknown keys kept as extras."""
    p = Preferences.load()
    p.selected_midi_input = "fifo-in"
    p.extras = {"window": [80, 24]}
    p.note_project("a.json")
    theirs = jprefs.Preferences.load()
    assert theirs.selected_midi_input == "fifo-in"
    assert theirs.last_project_filename == "a.json"
    assert theirs.extras == {"window": [80, 24]}
    theirs.should_reload_last_project = True
    theirs.save()
    assert Preferences.load().should_reload_last_project
    assert jprefs.prefs_file() == prefs_file() == tmp_path / "prefs.json"


def test_loop_toggle_and_range_in_control_bar(env):
    m = TuiModel(use_audio=False, device="cpu")
    try:
        assert "loop off" in m.control_bar()
        m.handle_key("l")
        assert m.svc.is_loop_enabled and m.svc.loop_range == (0.0, 4.0)
        assert "loop 0..4" in m.control_bar()
        m.set_loop_range(2.0, 6.0)
        assert "loop 2..6" in m.control_bar()
        m.handle_key("l")
        assert not m.svc.is_loop_enabled and m.svc.loop_range == (2.0, 6.0)
        m.handle_key("l")
        assert m.svc.is_loop_enabled and m.svc.loop_range == (2.0, 6.0)
    finally:
        m.svc.shutdown()


def test_param_editor_changes_device_and_audio(model, env, tmp_path):
    """Nudge the kitchen-sink analogue's gain ceiling from the params
    panel: the configured value changes, the re-render differs, and the
    saved project carries the edit."""
    model.open_project(env / "kitchen-sink.json")
    before = model.svc.rendered_samples().copy()
    rows = model.param_rows()
    target = next(i for i, (u, k, p, v) in enumerate(rows)
                  if u == "st-gain" and p.name == "ceiling")
    model.focus = "params"
    model.cursor["params"] = target
    uvid, _, p, old = rows[target]
    model.handle_key("left")
    new = next(v for (u, _, pp, v) in model.param_rows()
               if u == uvid and pp.name == "ceiling")
    assert new is not None and new != old
    assert f"{uvid}.ceiling" in "\n".join(model.panel_lines("params"))
    after = model.svc.rendered_samples()
    assert before.shape == after.shape and not np.array_equal(before, after)
    out = tmp_path / "edited.json"
    model.save_project(out)
    assert f"{new:g}" in out.read_text() or str(new) in out.read_text()


def test_pattern_grid_edits_notes_and_audio(model, env):
    model.open_project(env / "kitchen-sink.json")
    before = model.svc.rendered_samples().copy()
    rows = model.pattern_rows()
    step = next(i for i, r in enumerate(rows) if any(r))
    old_row = list(rows[step])
    model.focus = "pattern"
    model.cursor["pattern"] = step
    model.handle_key("right")
    assert model.pattern_rows()[step] == [min(127, k + 1) if k else 0
                                          for k in old_row]
    model.handle_key("x")
    assert model.pattern_rows()[step] == []
    model.handle_key("x")
    assert model.pattern_rows()[step] == [60]
    assert not np.array_equal(before, model.svc.rendered_samples())
    assert "60" in "\n".join(model.panel_lines("pattern"))


def test_service_remove_device_cleans_cables(env):
    svc = EngineService(use_audio=False, device="cpu")
    try:
        svc.new_project()
        svc.add_device("gain")
        svc.sync()
        assert ["gain-1", "main-mixer"] in svc.song.patch_cables
        svc.remove_device("gain-1")
        svc.sync()
        assert all("gain-1" not in c for c in svc.song.patch_cables)
        assert all(d.uvid != "gain-1" for d in svc.song.devices)
    finally:
        svc.shutdown()


# ---- the curses driver ------------------------------------------------------

def test_tui_main_builds_its_model_on_the_device(env, monkeypatch):
    """gui/tui.main opens the project and hands its model (service on
    --device) to curses; run blits the panels and quits on 'q'."""
    seen = {}

    class Screen:
        keys = [ord("\t"), ord("q")]

        def getmaxyx(self):
            return 30, 120

        def getch(self):
            return self.keys.pop(0)

        def addnstr(self, y, x, line, n):
            seen.setdefault("lines", []).append(line[:n])

        def __getattr__(self, name):
            return lambda *a, **k: None

    def wrapper(fn, model):
        seen["device"] = model.svc.device
        seen["title"] = model.song.title
        monkeypatch.setattr(tui.curses, "curs_set", lambda *a: None)
        monkeypatch.setattr(tui.curses, "ACS_HLINE", 0, raising=False)
        fn(Screen(), model)
        seen["quit"] = model.quit_requested

    monkeypatch.setattr(tui.curses, "wrapper", wrapper)
    assert tui.main([str(env / "oscillator-sine-a4.json"), "--device",
                     "cpu"]) == 0
    assert seen["device"] == "cpu" and seen["quit"]
    assert seen["title"] == "oscillator sine a4"
    assert any("BPM" in line for line in seen["lines"])


# ---- factory and save against groove_tpu -----------------------------------

def test_factory_matches_groove_tpu():
    assert factory.sorted_keys() == jfactory.sorted_keys()
    for key in factory.sorted_keys():
        a, b = factory.prototype(key), jfactory.prototype(key)
        assert (a.key, a.role, a.params) == (b.key, b.role, b.params)
    with pytest.raises(KeyError):
        factory.prototype("no-such-kind")


@pytest.mark.parametrize("name", ["kitchen-sink", "welsh", "live", "fm"])
def test_song_to_dict_matches_groove_tpu(name):
    make = {"kitchen-sink": lambda: synth.kitchen_sink_project(1),
            "welsh": lambda: synth.welsh_project(1),
            "live": lambda: synth.live_project(1),
            "fm": lambda: synth.fm_project(1)}[name]
    text = json.dumps(make())
    ours = song_to_dict(SongSettings.from_json5_str(text))
    assert ours == jax_song_to_dict(JaxSongSettings.from_json5_str(text))
    assert song_to_dict(SongSettings.from_json(ours)) == ours
