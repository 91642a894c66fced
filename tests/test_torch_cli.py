"""groove_tpu_torch's CLI flags on the CPU, jax-free: -v/--version,
-q/--quiet, -d/--debug, -m/--mp3 and an input of "-" (skipped, as
groove_tpu's CLI skips it), with the per-file isolation of groove_tpu's
tests/test_cli.py (which reads the reference's tree) on synthetic
projects. --multidevice and --mesh still refuse (tests/test_torch_slice.py
and test_torch_stream.py)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from groove_tpu_torch import __version__, cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
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
def songs(tmp_path_factory):
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.2)
    work = tmp_path_factory.mktemp("songs")
    return root, {
        "north-star": synth.write_project(work / "north-star.json",
                                          synth.north_star_project(1)),
        "kitchen-sink": synth.write_project(work / "kitchen-sink.json",
                                            synth.kitchen_sink_project(1)),
        "welsh": synth.write_project(work / "welsh.json",
                                     synth.welsh_project(1, 240.0))}


@pytest.fixture
def assets(songs, monkeypatch):
    monkeypatch.setenv("GROOVE_ASSETS", str(songs[0]))
    return songs[1]


def test_version(capsys):
    assert cli.main(["--version"]) == 0
    assert cli.main(["-v", "no-such-file.json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"groove-tpu-torch {__version__}"] * 2
    assert __version__ == "0.1.0"


def test_dash_input_is_skipped(assets, tmp_path, capsys):
    """An input of "-" is skipped: rc 0, nothing on stderr, and the other
    files render (the port used to try to open "-", report it and
    return 1)."""
    rc = cli.main(["-", str(assets["north-star"]), "-",
                   str(assets["welsh"]), "--wav", "--device", "cpu",
                   "--out-dir", str(tmp_path)])
    assert rc == 0
    assert capsys.readouterr().err == ""
    for name in ("north-star", "welsh"):
        audio, rate = read_wav(tmp_path / f"{name}.wav")
        assert rate == 44100 and np.abs(audio).max() > 0.01
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "north-star.wav", "welsh.wav"]
    assert cli.main(["-", "--device", "cpu"]) == 0


def test_bad_file_does_not_abort_batch(assets, tmp_path, capsys):
    bad = tmp_path / "invalid-project.json"
    bad.write_text('{"clock": {"bpm": "fast"}}')
    rc = cli.main([str(bad), str(assets["kitchen-sink"]), "--wav",
                   "--quiet", "--device", "cpu", "--out-dir",
                   str(tmp_path)])
    assert rc == 1
    assert "invalid-project" in capsys.readouterr().err
    audio, rate = read_wav(tmp_path / "kitchen-sink.wav")
    assert rate == 44100 and float(np.abs(audio).max()) > 0.0


def test_quiet_suppresses_the_status_lines(assets, tmp_path, capsys):
    args = [str(assets["north-star"]), "--wav", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    assert cli.main(args) == 0
    loud = capsys.readouterr().out
    assert "Performing to queue" in loud and "Rendering queue to" in loud
    assert cli.main([*args, "-q"]) == 0
    assert capsys.readouterr().out == ""
    for extra in (["--stream", "--segment-frames", "4096"],
                  ["--loop", "0", "2", "--loop-iterations", "1",
                   "--segment-frames", "4096"]):
        assert cli.main([*args, *extra]) == 0
        assert capsys.readouterr().out != ""
        assert cli.main([*args, *extra, "--quiet"]) == 0
        assert capsys.readouterr().out == ""
    assert cli.main([*args, "--quiet", "--perf"]) == 0
    assert "Sample count" in capsys.readouterr().out


def test_mp3_says_so_and_renders_on(assets, tmp_path, capsys):
    assert cli.main([str(assets["north-star"]), "--wav", "--mp3", "-q",
                     "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    err = capsys.readouterr().err
    assert err.strip() == "MP3 output is not yet implemented"
    assert (tmp_path / "north-star.wav").stat().st_size > 44


def test_debug_prints_each_devices_time(assets, tmp_path, capsys):
    """--debug: one row a device (instruments, then effects on their
    realised inputs), in render order, in ms; the WAV is plain --wav's."""
    path = assets["kitchen-sink"]
    assert cli.main([str(path), "--wav", "--device", "cpu", "--out-dir",
                     str(tmp_path / "plain")]) == 0
    capsys.readouterr()
    assert cli.main([str(path), "--wav", "--debug", "--quiet", "--mp3",
                     "--device", "cpu", "--out-dir",
                     str(tmp_path / "debug")]) == 0
    rows = capsys.readouterr().out.splitlines()
    c = compile_song(SongSettings.from_project_file(path), Paths())
    want = [u for u in c.order
            if c.devices[u].role in ("instrument", "effect")
            or c.devices[u].kind == "signal-passthrough-controller"]
    assert [r.split()[1] for r in rows] == want
    assert all(r.startswith(("  instrument ", "  effect "))
               and r.endswith(" ms") for r in rows)
    assert (tmp_path / "debug" / "kitchen-sink.wav").read_bytes() == \
        (tmp_path / "plain" / "kitchen-sink.wav").read_bytes()


def test_profile_render_outputs_are_the_render(assets):
    """profile_render's effects run on their realised inputs: the last
    row's output, the main mixer's, is the render's."""
    from groove_tpu_torch.utils import profiling

    c = compile_song(SongSettings.from_project_file(assets["north-star"]),
                     Paths())
    r = Renderer(c, "cpu")
    outs = []
    timed = profiling._timed

    def keep(device, fn, reps=3):
        seconds, out = timed(device, fn, reps)
        outs.append(out)
        return seconds, out

    profiling._timed = keep
    try:
        rows = profiling.profile_render(r)
    finally:
        profiling._timed = timed
    assert [name.split()[1] for name, _ in rows] == list(c.order)
    assert all(s > 0 for _, s in rows)
    assert np.array_equal(outs[-1].T.numpy(), r.render())


def test_flags_in_a_process_that_refuses_jax(assets, tmp_path):
    """python -m groove_tpu_torch.cli with the four flags, in a process
    that refuses jax and groove_tpu."""
    code = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
from groove_tpu_torch import cli
assert cli.main(["--version"]) == 0
sys.exit(cli.main(["-", {str(assets["north-star"])!r}, "--wav", "-q", "-d",
                   "-m", "--device", "cpu", "--out-dir", {str(tmp_path)!r}]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    assert out[0] == f"groove-tpu-torch {__version__}"
    assert [r.split()[:2] for r in out[1:]] == [
        ["instrument", "drums"], ["effect", synth.FILTER_UVID],
        ["effect", "main-mixer"]]
    assert res.stderr.strip() == "MP3 output is not yet implemented"
    assert (tmp_path / "north-star.wav").stat().st_size > 44
