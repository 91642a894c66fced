"""groove_tpu_torch's spectrum tool (utils/spectrum.py) on the CPU:
Spectrum and analyze are copies of groove_tpu's, held here bit for bit
on the same samples; _render_project renders on the port's Renderer on
the torch device --on names. Mirrors groove_tpu's tests/test_spectrum.py,
whose project cases read the reference's tree, on synthetic projects."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from groove_tpu.utils import spectrum as jspectrum
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth
from groove_tpu_torch.utils import spectrum
from groove_tpu_torch.utils.spectrum import analyze


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its renders are
    thousands of small torch calls, and beside other test processes a
    full thread team per call stalls on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _sine(freq, rate=44100, n=8192, amp=1.0):
    t = np.arange(n) / rate
    return amp * np.sin(2 * math.pi * freq * t)


@pytest.fixture(scope="module")
def welsh(tmp_path_factory):
    return synth.write_project(tmp_path_factory.mktemp("song") / "w.json",
                               synth.welsh_project(1, 240.0))


def _noise(seed: int, shape):
    return np.random.default_rng(seed).standard_normal(shape) * 0.3


@pytest.mark.parametrize("samples", [
    _sine(1000.0), _noise(1, (2, 6000)), _noise(2, (5000, 2)),
    _noise(3, 4097).astype(np.float32)], ids=["sine", "stereo-rows",
                                              "stereo-columns", "odd"])
def test_analyze_is_the_references_bit_for_bit(samples):
    got = analyze(samples, 44100)
    want = jspectrum.analyze(samples, 44100)
    assert np.array_equal(got.freqs, want.freqs)
    assert np.array_equal(got.db, want.db)
    assert got.peaks(5) == want.peaks(5)
    cols, *edges = got.columns(64)
    want_cols, *want_edges = want.columns(64)
    assert np.array_equal(cols, want_cols) and edges == want_edges
    assert got.ascii(width=50, height=8) == want.ascii(width=50, height=8)
    assert got.band_db(200, 2000) == want.band_db(200, 2000)
    assert got.level_at(440.0) == want.level_at(440.0)


def test_full_scale_sine_reads_0dbfs():
    for n in (4096, 8192, 16384):
        rate = 44100
        freq = 64 * rate / n
        f, db = analyze(_sine(freq, rate, n), rate).peak()
        assert abs(f - freq) < rate / n and abs(db) < 0.01


def test_peaks_finds_partials_in_order():
    rate, n = 44100, 16384
    f0 = 100 * rate / n
    x = (_sine(f0, rate, n, 1.0) + _sine(2 * f0, rate, n, 0.25)
         + _sine(3 * f0, rate, n, 0.05))
    got = analyze(x, rate).peaks(3)
    assert [round(f / f0) for f, _ in got] == [1, 2, 3]
    assert abs((got[1][1] - got[0][1]) + 12.04) < 0.1
    assert abs((got[2][1] - got[0][1]) + 26.02) < 0.1


def test_cli_on_wav(tmp_path, capsys):
    from groove_tpu_torch.io.wav import write_wav_16bit_stereo

    x = 0.5 * _sine(441.430664, 44100, 8192)
    write_wav_16bit_stereo(str(tmp_path / "t.wav"),
                           np.stack([x, x], axis=1), 44100)
    assert spectrum.main([str(tmp_path / "t.wav"), "--peaks", "1",
                          "--band", "300", "600"]) == 0
    out = capsys.readouterr().out
    assert "peak" in out and "band 300-600 Hz" in out


def test_cli_on_project(welsh, capsys):
    assert spectrum.main([str(welsh), "--peaks", "3", "--on", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "peak" in out and "dBFS" in out


def test_render_project_renders_on_the_port(welsh):
    """The master [2, n] and one instrument alone: the port's Renderer
    on the device asked for, brought to the host."""
    c = compile_song(SongSettings.from_project_file(welsh))
    r = Renderer(c, "cpu")
    master, rate = spectrum._render_project(str(welsh), None, "cpu")
    assert rate == 44100 and np.array_equal(master, r.render().T)
    lead, _ = spectrum._render_project(str(welsh), "lead", "cpu")
    want = r._render_instrument(r.inputs, c.devices["lead"], c.n_frames)
    assert np.array_equal(lead, want.numpy()) and np.abs(lead).max() > 0


def test_device_isolation_rejects_unknown(welsh):
    with pytest.raises(SystemExit, match="must name an instrument"):
        spectrum.main([str(welsh), "--device", "nope", "--on", "cpu"])


def test_a_missing_card_is_refused(welsh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spectrum.main([str(welsh)])
