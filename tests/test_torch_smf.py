"""Standard MIDI File import in groove_tpu_torch (io/midi_smf.py, a copy of
groove_tpu's; compiler/song.compile_midi_file; the CLI on .mid inputs) on
the CPU, against groove_tpu's on the same files.

The files are written here (testing/synth.smf_bytes, midi_song): format 0
and 1, a tempo change, a drum channel (10, 0-based 9) and two GM programs
whose patches (gm_program_to_patch: piano, new-age-lead) are synthetic
Welsh patches under the asset root (synth.write_welsh_patches), with the
synthetic 707 kit beside them.

Bars: the parse, the note events and the compiled song (devices, patches,
note columns, frames) equal groove_tpu's; the render against groove_tpu's
Renderer with its Pallas kernels interpreted: -128 dBFS [-137.5 measured,
both formats]; a format-0 file and the same song in
format 1 render bit for bit alike; the CLI's WAV equals the Renderer's."""

from __future__ import annotations

import dataclasses
import enum
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from groove_tpu.compiler.song import compile_midi_file as jax_compile_midi
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.io import midi_smf as jsmf
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_midi_file
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io import midi_smf as tsmf
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
MEASURES = 4  # 8 s: 2 measures at 120 bpm, 2 at 150


def _db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    peak = max(1.0, float(np.abs(ref).max()))
    return 20.0 * np.log10(float(np.abs(got - ref).max()) / peak + 1e-30)


def _plain(v):
    """Dataclasses, enums and containers of either package as plain data."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                {f.name: _plain(getattr(v, f.name))
                 for f in dataclasses.fields(v)
                 if not f.name.startswith("_")})
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tolist())
    return v


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)
    return synth.write_welsh_patches(root)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("midi")
    out = {}
    for fmt in (0, 1):
        out[fmt] = d / f"song-format{fmt}.mid"
        out[fmt].write_bytes(synth.midi_song(MEASURES, fmt=fmt))
    # running status, a note-on of velocity 0 as note-off, a sysex, a
    # control change and a key re-trigger before its note-off
    events = [(0, b"\x90\x3c\x40"), (0, b"\x40\x50"), (240, b"\x3c\x00"),
              (240, b"\xf0\x03\x7e\x09\xf7"), (240, b"\xb0\x07\x64"),
              (480, b"\x90\x40\x60"), (600, b"\x90\x40\x30"),
              (720, b"\x80\x40\x00"), (960, b"\x80\x40\x00"),
              (960, b"\x80\x40\x00")]
    out["odd"] = d / "odd.mid"
    out["odd"].write_bytes(synth.smf_bytes([events], 480, 0))
    return out


@pytest.mark.parametrize("name", [0, 1, "odd"])
def test_parse_and_events_match(files, name):
    j, t = jsmf.parse_smf(files[name]), tsmf.parse_smf(files[name])
    assert _plain(t) == _plain(j)
    assert t.bpm == j.bpm and t.programs == j.programs
    assert _plain(tsmf.smf_to_note_events(t)) == \
        _plain(jsmf.smf_to_note_events(j))
    assert tsmf.tempo_map(t) == jsmf.tempo_map(j)


def test_midi_song_takes_every_case(files):
    smf = tsmf.parse_smf(files[1])
    assert smf.format == 1 and smf.n_tracks == 4
    assert smf.programs == synth.MIDI_PROGRAMS
    assert len(tsmf.tempo_map(smf)) == 2
    channels = {e.channel for e in tsmf.smf_to_note_events(smf)}
    assert channels == {0, 1, 9}
    assert {tsmf.gm_program_to_patch(p) for p in smf.programs.values()} \
        == set(synth.MIDI_PATCHES)
    assert tsmf.parse_smf(files[0]).format == 0


def test_truncated_file_is_a_value_error(files, tmp_path):
    bad = tmp_path / "bad.mid"
    bad.write_bytes(files[1].read_bytes()[:40])
    for mod in (jsmf, tsmf):
        with pytest.raises(ValueError, match="truncated or corrupt"):
            mod.parse_smf(bad)


@pytest.fixture(scope="module")
def compiled(assets, files):
    return {fmt: (jax_compile_midi(files[fmt], JaxPaths(roots=[assets])),
                  compile_midi_file(files[fmt], Paths(roots=[assets])))
            for fmt in (0, 1)}


@pytest.mark.parametrize("fmt", [0, 1])
def test_compiled_song_matches(compiled, fmt):
    jc, tc = compiled[fmt]
    assert (tc.n_frames, tc.n_blocks, tc.bpm, tc.time_signature) == \
        (jc.n_frames, jc.n_blocks, jc.bpm, jc.time_signature)
    assert tc.order == jc.order and tc.sinks == jc.sinks
    assert set(tc.devices) == set(jc.devices) == {
        "midi-ch-0", "midi-ch-1", "midi-ch-9", "main-mixer"}
    for u, jd in jc.devices.items():
        td = tc.devices[u]
        assert (td.kind, td.role, td.midi_in, td.params) == \
            (jd.kind, jd.role, jd.midi_in, jd.params), u
        assert _plain(td.voice) == _plain(jd.voice), u
        if jd.notes is not None:
            for col in ("keys", "vels", "on_frames", "off_frames"):
                a, b = getattr(td.notes, col), getattr(jd.notes, col)
                assert a.dtype == b.dtype and np.array_equal(a, b), (u, col)
    assert tc.devices["midi-ch-9"].kind == "drumkit"
    assert np.array_equal(tc.devices["midi-ch-9"].slots,
                          jc.devices["midi-ch-9"].slots)


@pytest.fixture(scope="module")
def renders(compiled):
    from groove_tpu.ops import iir, pallas_iir

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iir, "USE_PALLAS", True)
        mp.setattr(pallas_iir, "FORCE_INTERPRET", True)
        for fmt, (jc, tc) in compiled.items():
            out[fmt] = (np.asarray(JaxRenderer(jc).render()),
                        Renderer(tc, "cpu").render())
    return out


@pytest.mark.parametrize("fmt", [0, 1])
def test_render_matches_reference(renders, fmt):
    ref, got = renders[fmt]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert 0.05 < np.abs(got).max() < 1.0
    assert _db(got, ref) <= -128.0, _db(got, ref)


def test_formats_render_alike(renders):
    assert np.array_equal(renders[0][1], renders[1][1])


def test_cli_renders_midi_without_jax(assets, files, renders, tmp_path):
    """A process that refuses jax and groove_tpu renders the .mid through
    the CLI; its WAV is the Renderer's render quantized."""
    from groove_tpu_torch.io.wav import quantize_16bit
    import torch

    code = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
from groove_tpu_torch import cli
assert cli.main([{str(files[1])!r}, "--wav", "--perf", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "out")!r}]) == 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "groove_tpu")]
print("JAX-FREE OK")
"""
    env = dict(os.environ, GROOVE_ASSETS=str(assets), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
    x, rate = read_wav(tmp_path / "out" / "song-format1.wav")
    q = quantize_16bit(torch.from_numpy(renders[1][1])).numpy()
    assert rate == 44100 and x.shape == q.shape
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)


def test_cli_reports_a_bad_midi_file(tmp_path, capsys):
    bad = tmp_path / "bad.mid"
    bad.write_bytes(b"RIFF0000")
    assert cli.main([str(bad), "--device", "cpu"]) == 1
    assert "not an SMF file" in capsys.readouterr().err
