"""groove_tpu_torch imports nothing of groove_tpu or jax, and its copies of
groove_tpu's host modules (core/, project/, the compiler's events,
automation and params, io/midi_smf, io/wav's reader and writers, and
parallel/'s partition_components, _sub_song and effect_memory_seconds)
are held to their originals: the same code statement for statement (imports renamed, the
documented departures listed below), and the same results on the same
projects, patterns, automation and WAV files.

Departures of the copies, each checked here by behaviour:
  project/paths.py     the default search roots leave out groove_tpu's
                       fixed reference-asset location ($GROOVE_ASSETS,
                       then the working directory);
  compiler/params.py   to_domain_array works on torch tensors (the
                       original on jax arrays);
  gui/model.py         _browser_roots lists the roots Paths searches
                       ($GROOVE_ASSETS/projects, then ./projects);
                       TuiModel builds its service on a torch device.
The front ends over the port's engines (engine/service.py, shell.py,
utils/spectrum.py, gui/tui.py, gui/web.py) are copies but for the names
listed in COPIES, which take a torch device and render on the port's
engines (tests/test_torch_service.py, test_torch_frontends.py,
test_torch_webgui.py and test_torch_spectrum.py hold them by
behaviour)."""

from __future__ import annotations

import ast
import dataclasses
import enum
import importlib
import json
import subprocess
import sys
import wave
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "groove_tpu_torch"

# module -> top-level names whose code departs from the original
COPIES = {
    "core/time.py": (),
    "core/types.py": (),
    "project/json5.py": (),
    "project/schema.py": (),
    "project/paths.py": ("REFERENCE_ASSETS", "REFERENCE_PROJECTS", "Paths"),
    "project/patches.py": (),
    "compiler/events.py": (),
    "compiler/automation.py": (),
    "compiler/params.py": ("to_domain_array",),
    "io/midi_smf.py": (),
    "io/midi_input.py": (),
    "io/midi_output.py": (),
    "io/native.py": (),
    "project/save.py": (),
    "engine/factory.py": (),
    "engine/service.py": ("EngineService",),
    "shell.py": ("main",),
    "utils/spectrum.py": ("_render_project", "main"),
    "gui/__init__.py": (),
    "gui/__main__.py": (),
    "gui/prefs.py": (),
    "gui/model.py": ("_browser_roots", "TuiModel"),
    "gui/tui.py": ("main",),
    "gui/web.py": ("WebGui", "main"),
}
WAV_FUNCTIONS = ("_chunk_to_i2", "write_wav_16bit_stereo",
                 "write_wav_16bit_stereo_stream", "read_wav")
# module -> host functions of parallel/ copied statement for statement
# (imports renamed; no departures)
PARALLEL_FUNCTIONS = {
    "parallel/multidevice.py": ("partition_components", "_sub_song"),
    "parallel/meshrender.py": ("effect_memory_seconds",),
}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module


def test_port_imports_neither_groove_tpu_nor_jax():
    bad = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for line, name in _imported_modules(tree):
            if name.split(".")[0] in ("groove_tpu", "jax", "jaxlib"):
                bad.append(f"{path.relative_to(REPO)}:{line} {name}")
    assert not bad, bad


def test_import_walk_covers_the_effect_layer():
    """The walk above reads the effect layer's modules, the scan kernel's
    wrapper, the live path's and the front ends', as it reads every
    module of the port."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"ops/dynamics.py", "ops/delayfx.py", "ops/scan_kernels.py",
            "models/simple.py", "engine/render.py", "engine/live.py",
            "engine/livesong.py", "io/midi_input.py", "io/midi_output.py",
            "io/native.py", "engine/service.py", "engine/factory.py",
            "project/save.py", "shell.py", "utils/spectrum.py",
            "utils/profiling.py", "gui/model.py", "gui/prefs.py",
            "gui/tui.py", "gui/web.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/multidevice.py",
            "parallel/timeshard.py", "parallel/meshrender.py"} <= files


def _function(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return ast.dump(fn)


def test_effect_host_copies_are_the_originals():
    """The effect layer's host code and constants: chorus_curve_max_voices
    statement for statement, the reverb's delays and all-pass gain, and
    the sidechain's seconds bound."""
    from groove_tpu.engine import render as jrender
    from groove_tpu.ops import delayfx as jdelayfx
    from groove_tpu_torch.engine import render as trender
    from groove_tpu_torch.ops import delayfx as tdelayfx

    assert _function(PORT / "ops/delayfx.py", "chorus_curve_max_voices") \
        == _function(REPO / "groove_tpu/ops/delayfx.py",
                     "chorus_curve_max_voices")
    for name in ("COMB_DELAYS_S", "ALLPASS_DELAYS_S", "ALLPASS_G"):
        assert getattr(tdelayfx, name) == getattr(jdelayfx, name), name
    assert trender.SIDECHAIN_SECONDS_MAX == jrender.SIDECHAIN_SECONDS_MAX
    for curve in ([0.2, 3.6, 2.0], np.array([1.5, 2.5], np.float32), [0.0]):
        assert tdelayfx.chorus_curve_max_voices(curve) \
            == jdelayfx.chorus_curve_max_voices(curve)


class _Rename(ast.NodeTransformer):
    """groove_tpu.x imports -> groove_tpu_torch.x."""

    def visit_ImportFrom(self, node):
        if node.module and node.module.split(".")[0] == "groove_tpu":
            node.module = "groove_tpu_torch" + node.module[len("groove_tpu"):]
        return node


def _body(tree: ast.Module, skip=()) -> list[str]:
    """Top-level statements after the module docstring, as ast dumps,
    leaving out definitions and assignments of the names in `skip`."""
    out = []
    for i, node in enumerate(tree.body):
        if i == 0 and isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Constant):
            continue
        names = set()
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = {node.name}
        elif isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if names & set(skip):
            continue
        out.append(ast.dump(node))
    return out


@pytest.mark.parametrize("module", list(COPIES))
def test_copy_is_the_original(module):
    orig = _Rename().visit(ast.parse((REPO / "groove_tpu" / module)
                                     .read_text()))
    copy = ast.parse((PORT / module).read_text())
    assert _body(copy, COPIES[module]) == _body(orig, COPIES[module])


@pytest.mark.parametrize("module", list(PARALLEL_FUNCTIONS))
def test_parallel_host_functions_are_the_originals(module):
    """partition_components, _sub_song and effect_memory_seconds: the
    originals statement for statement, docstrings included."""
    def defs(tree):
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name in PARALLEL_FUNCTIONS[module]}

    theirs = defs(_Rename().visit(ast.parse(
        (REPO / "groove_tpu" / module).read_text())))
    assert theirs.keys() == set(PARALLEL_FUNCTIONS[module])
    assert defs(ast.parse((PORT / module).read_text())) == theirs


def test_wav_reader_and_writers_are_the_originals():
    def defs(path):
        tree = ast.parse(path.read_text())
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name in WAV_FUNCTIONS}

    theirs = defs(REPO / "groove_tpu" / "io" / "wav.py")
    assert theirs.keys() == set(WAV_FUNCTIONS)
    assert defs(PORT / "io" / "wav.py") == theirs


# ---- the same results ------------------------------------------------------

def _plain(v):
    """Dataclasses, enums and containers of either package as plain data
    (the two packages' classes are distinct, so compare by value)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                {f.name: _plain(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tolist())
    return v


def _modules(name):
    return (importlib.import_module(f"groove_tpu.{name}"),
            importlib.import_module(f"groove_tpu_torch.{name}"))


JSON5_PROJECT = """{
  // a hand-written JSON5 project: comments, trailing commas, bare keys
  title: 'json5 song', clock: {bpm: 128.5, 'time-signature': [3, 4],},
  devices: [
    {instrument: ['drums', {drumkit: [{'midi-in': 9}, {name: '707'}]}]},
    {effect: ['lp', {'filter-low-pass-12db': {cutoff: 900.0, q: 2}}]},
    {controller: ['lfo-1', {lfo: {waveform: 'triangle', frequency: 0.5}}]},
  ],
  'patch-cables': [['drums', 'lp', 'main-mixer']],
  patterns: [{id: 'p', 'note-value': 'eighth', notes: [[35, 0, 38, 0]]}],
  tracks: [{id: 't', 'midi-channel': 9, patterns: ['p', 'p']}],
  controls: [{id: 'c', source: 'lfo-1', target: {id: 'lp', param: 'q'}}],
}"""

PROJECTS = {
    "north-star": lambda: json.dumps(synth.north_star_project(3)),
    "filter-bank": lambda: json.dumps(synth.filter_bank_project(2)),
    "json5": lambda: JSON5_PROJECT,
}


@pytest.mark.parametrize("name", list(PROJECTS))
def test_projects_events_and_automation_match(name):
    (js, ts), (jev, tev), (ja, ta), (jt, tt) = (
        _modules("project.schema"), _modules("compiler.events"),
        _modules("compiler.automation"), _modules("core.time"))
    text = PROJECTS[name]()
    song_j, song_t = js.SongSettings.from_json5_str(text), \
        ts.SongSettings.from_json5_str(text)
    assert _plain(song_t) == _plain(song_j)
    ev_j, end_j = jev.stamp_patterns(song_j)
    ev_t, end_t = tev.stamp_patterns(song_t)
    assert end_t == end_j and _plain(ev_t) == _plain(ev_j)
    sr_j, sr_t = jt.SampleRate(44100), tt.SampleRate(44100)
    assert _plain(tev.quantize_events(ev_t, song_t.clock.tempo, sr_t)) == \
        _plain(jev.quantize_events(ev_j, song_j.clock.tempo, sr_j))
    n_blocks = 2000
    init = {(t.target.id, t.target.param): 0.25 for t in song_j.trips}
    cj = ja.compile_trips(song_j, n_blocks, sr_j, init, {})
    ct = ta.compile_trips(song_t, n_blocks, sr_t, init, {})
    assert cj.keys() == ct.keys()
    for k in cj:
        assert np.array_equal(np.asarray(ct[k]), np.asarray(cj[k])), k
    for wf in ("sine", "square", "triangle", "sawtooth", "pulse-width"):
        assert np.array_equal(
            ta.lfo_curve(wf, 1.5, 0.3, n_blocks, song_t.clock.tempo, sr_t),
            ja.lfo_curve(wf, 1.5, 0.3, n_blocks, song_j.clock.tempo, sr_j))


def test_time_and_value_types_match():
    (jt, tt), (jty, tty) = _modules("core.time"), _modules("core.types")
    for bpm in (60.0, 120.0, 185.0, 97.3):
        for sr in (22050, 44100, 48000):
            args_j = (jt.Tempo(bpm), jt.SampleRate(sr))
            args_t = (tt.Tempo(bpm), tt.SampleRate(sr))
            for beats in (Fraction(0), Fraction(7, 3), Fraction(360)):
                mj, mt = (m.MusicalTime.from_beats(beats) for m in (jt, tt))
                assert tt.render_length_frames(*args_t, mt) == \
                    jt.render_length_frames(*args_j, mj)
                assert tt.beats_to_frames(*args_t, beats) == \
                    jt.beats_to_frames(*args_j, beats)
    for v in (0.0, 0.13, 0.5, 0.999, 1.0):
        for f in ("percent_to_frequency", "denormalize_q",
                  "transform_linear_to_mma_concave",
                  "transform_linear_to_mma_convex"):
            assert getattr(tty, f)(v) == getattr(jty, f)(v)
    for hz in (10.0, 25.0, 440.0, 19999.0, 30000.0):
        assert tty.frequency_to_percent(hz) == jty.frequency_to_percent(hz)


def test_patches_match():
    jp, tp = _modules("project.patches")
    raw = json.dumps({
        "name": "x", "glide": 0.1, "polyphony": "mono",
        "oscillator-1": {"waveform": "sawtooth", "tune": {"float": 1.5},
                         "mix-pct": 0.7},
        "oscillator-2": {"waveform": {"pulse-width": 0.3},
                         "tune": {"note": 62}, "mix-pct": 0.3},
        "oscillator-2-track": False, "noise": 0.2,
        "lfo": {"routing": "pitch", "waveform": "sine", "frequency": 4.0,
                "depth": {"pct": 0.2}},
        "filter-type-24db": {"cutoff-hz": 900.0, "cutoff-pct": 0.5},
        "filter-resonance": 0.3,
        "filter-envelope": {"attack": 0.1, "decay": 0.2, "sustain": 0.5,
                            "release": 0.3},
        "amp-envelope": {"attack": 0.01, "decay": 0.1, "sustain": 0.8,
                         "release": 0.5}})
    vj = jp.WelshPatchSettings.from_json_str(raw).derive_welsh_voice_params()
    vt = tp.WelshPatchSettings.from_json_str(raw).derive_welsh_voice_params()
    assert _plain(vt) == _plain(vj)
    fm = {"ratio": 2.0, "depth": 1.0, "beta": 2.0}
    assert _plain(tp.FmSynthParams.from_json(fm)) == \
        _plain(jp.FmSynthParams.from_json(fm))


def test_params_match_and_to_domain_array_on_tensors():
    jpar, tpar = _modules("compiler.params")
    assert jpar.REGISTRY.keys() == tpar.REGISTRY.keys()
    v = np.linspace(0.0, 1.0, 257).astype(np.float32)
    for kind, params in jpar.REGISTRY.items():
        assert [p.name for p in tpar.REGISTRY[kind]] == \
            [p.name for p in params]
        for p in params:
            pt = tpar.resolve(kind, p.name)
            for x in (0.0, 0.37, 1.0):
                assert pt.to_domain(x) == p.to_domain(x)
            want = np.asarray(jpar.to_domain_array(p, jnp.asarray(v)))
            got = tpar.to_domain_array(pt, torch.from_numpy(v)).numpy()
            if p.to_domain is jpar.FreqFromPct:
                # float64 exponential rounded once vs XLA's float32 one
                assert np.max(np.abs(got - want) / want) < 2.5e-7
            else:
                assert np.array_equal(got, want)
    for (kind, alias), canon in jpar.ALIASES.items():
        assert tpar.resolve(kind, alias).name == canon


def test_paths_search_the_same_roots(tmp_path, monkeypatch):
    jpa, tpa = _modules("project.paths")
    (tmp_path / "samples").mkdir()
    (tmp_path / "samples" / "a.wav").write_bytes(b"")
    for rel in ("samples/a.wav", "samples/b.wav", tmp_path / "samples"):
        assert tpa.Paths([tmp_path]).search(rel) == \
            jpa.Paths([tmp_path]).search(rel)
    monkeypatch.setenv("GROOVE_ASSETS", str(tmp_path))
    theirs = [r for r in jpa.Paths().roots if r != jpa.REFERENCE_ASSETS]
    assert tpa.Paths().roots == theirs
    assert tpa.Paths().build_patch("welsh", "x.json") == \
        jpa.Paths().build_patch("welsh", "x.json")


def _write_pcm(path, data: bytes, channels: int, width: int, rate: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data)


def test_wav_read_and_write_match(tmp_path):
    jw, tw = _modules("io.wav")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.2, 1.2, (3001, 2)).astype(np.float32)
    jw.write_wav_16bit_stereo(tmp_path / "j.wav", x, 44100)
    tw.write_wav_16bit_stereo(tmp_path / "t.wav", x, 44100)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    q = (x * 20000).astype(np.int16)
    tw.write_wav_16bit_stereo(tmp_path / "q.wav", q[:, 0], 22050)
    files = [tmp_path / "t.wav", tmp_path / "q.wav"]
    raw = rng.integers(0, 256, 6 * 500, dtype=np.uint8).tobytes()
    for width, channels in ((1, 1), (3, 2), (4, 1)):
        f = tmp_path / f"pcm{width}.wav"
        _write_pcm(f, raw, channels, width, 48000)
        files.append(f)
    for f in files:
        (xj, rj), (xt, rt) = jw.read_wav(f), tw.read_wav(f)
        assert rt == rj and xt.dtype == xj.dtype and np.array_equal(xt, xj)
    assert tw.read_wav(files[0])[0].shape == x.shape


def test_native_library_path_is_the_repository_native_dir():
    """io/native.py's _LIB_PATH (parents[2] / "native") resolves to the
    repository's native/ from the port's io/ as from groove_tpu's."""
    from groove_tpu.io import native as jnative
    from groove_tpu_torch.io import native as tnative

    assert tnative._LIB_PATH == jnative._LIB_PATH == \
        REPO / "native" / "libgroove_native.so"


def test_midi_io_copies_behave_as_the_originals():
    """The byte parser and encoder of both packages on one stream: the
    same messages, and the encoder's running status the same bytes."""
    from groove_tpu.io import midi_input as jin, midi_output as jout
    from groove_tpu_torch.io import midi_input as tin, midi_output as tout

    events = synth.live_performance(1.5)
    data = synth.running_status(events) + bytes([0xF0, 1, 2, 0xF7, 0xB3,
                                                 7, 90, 0xE1, 0, 64])
    got = {}
    for name, mod in (("j", jin), ("t", tin)):
        out = []
        mod.MidiByteParser(lambda *m, out=out: out.append(m)).feed(data)
        got[name] = out
    assert got["t"] == got["j"] and len(got["t"]) == len(events) + 2
    enc = {name: b"".join(mod.MidiByteEncoder().encode(*m)
                          for m in got["t"][:1])
           for name, mod in (("j", jout), ("t", tout))}
    assert enc["t"] == enc["j"]
    ej, et = jout.MidiByteEncoder(), tout.MidiByteEncoder()
    assert b"".join(et.encode(*m) for m in got["t"]) == \
        b"".join(ej.encode(*m) for m in got["t"])


def test_cli_live_refuses_jax_and_plays_a_midi_file(tmp_path):
    """`cli --live FILE --device cpu --wav --live-seconds S --midi-out
    ECHO` in a process that refuses jax and groove_tpu: the MIDI file's
    bytes play the project through its chain into the WAV sink until the
    CLI stops itself; the echo port receives the same messages."""
    project = synth.write_project(tmp_path / "live.json", {
        "clock": {"bpm": 120},
        "devices": [
            {"instrument": ["w", {"welsh-raw": [{"midi-in": 0},
                                                dict(synth.WELSH_LEAD)]}]},
            {"instrument": ["f", {"fm-synthesizer": [{"midi-in": 1},
                                                     dict(synth.FM_LEAD)]}]},
            {"effect": ["g", {"gain": {"ceiling": 0.5}}]}],
        "patch-cables": [["w", "g", "main-mixer"], ["f", "g", "main-mixer"]]})
    events = [(0, bytes([0x90, 60, 100])), (0, bytes([0x91, 64, 90])),
              (0, bytes([0x91, 67, 90])), (0, bytes([0x80, 60, 0]))]
    midi = synth.write_live_performance(tmp_path / "keys.mid", events)
    echo = tmp_path / "echo.mid"
    code = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
from groove_tpu_torch import cli
perf = []
rc = cli.main([{str(project)!r}, "--live", {str(midi)!r}, "--device", "cpu",
               "--wav", "--out-dir", {str(tmp_path / "out")!r},
               "--live-seconds", "0.4", "--midi-out", {str(echo)!r}],
              perf_out=perf)
assert rc == 0, rc
print(perf[0]["frames"], perf[0]["blocks"])
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    frames, blocks = map(int, res.stdout.split()[-2:])
    from groove_tpu_torch.io.midi_input import MidiByteParser
    from groove_tpu_torch.io.wav import read_wav

    x, rate = read_wav(tmp_path / "out" / "live.wav")
    assert rate == 44100 and len(x) == frames == blocks * 64 > 0
    assert np.abs(x).max() > 1e-3
    parsed = {}
    for name, data in (("in", midi.read_bytes()), ("echo", echo.read_bytes())):
        out = []
        MidiByteParser(lambda *m, out=out: out.append(m)).feed(data)
        parsed[name] = out
    assert parsed["echo"] == parsed["in"] and len(parsed["in"]) == 4
