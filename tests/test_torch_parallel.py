"""groove_tpu_torch/parallel/ against groove_tpu/parallel/ on the CPU: the
component partition and sub-songs of the synthetic projects equal the
reference's; MultiDeviceRenderer on eight logical CPU shards equals the
port's single Renderer (1e-6 of the peak) and reads within measured bars
of groove_tpu's on its eight virtual CPU devices (tests/conftest.py);
biquad_timesharded against one carried-state chain and groove_tpu's;
sharded_welsh_mix_step against its plain loop and groove_tpu's; the CLI's
--multidevice and --mesh WAVs; no CUDA device and no devices argument
raise; and every call into the kernel library runs under its tensors'
device guard. Bars are the measured value plus about 8 dB."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.parallel import mesh, multidevice, timeshard
from groove_tpu_torch.parallel.meshrender import MeshRenderer
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "groove_tpu_torch"
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual mesh")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)
    synth.write_instrument_assets(root)
    return root


PROJECTS = {
    "sidechain": lambda: synth.sidechain_project(1),
    "kitchen-sink": lambda: synth.kitchen_sink_project(1),
    "welsh": lambda: synth.welsh_project(1, 240.0),
    "perf-1": lambda: synth.perf1_project(4),
    "instruments": lambda: synth.instruments_project(1, 240.0),
}


def _both(name, assets):
    text = json.dumps(PROJECTS[name]())
    return (compile_song(SongSettings.from_json5_str(text),
                         Paths(roots=[assets])),
            jax_compile(JaxSongSettings.from_json5_str(text),
                        JaxPaths(roots=[assets])))


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


# ---- the partition ----------------------------------------------------------

def _song_fields(c) -> tuple:
    return (sorted(c.devices), c.sinks, c.order, c.sidechain, c.sends,
            c.n_frames)


@pytest.mark.parametrize("name", list(PROJECTS))
def test_components_and_sub_songs_match_reference(name, assets):
    """The same components, in the same order, and the same sub-songs;
    every audio-path device in one; each sidechain's source and target
    in the same one."""
    from groove_tpu.parallel import multidevice as jmulti

    c, jc = _both(name, assets)
    comps = multidevice.partition_components(c)
    assert comps == jmulti.partition_components(jc)
    assert sorted(u for comp in comps for u in comp) == \
        sorted(u for u in c.order if u != "main-mixer")
    where = {u: i for i, comp in enumerate(comps) for u in comp}
    for src, tgt, _ in c.sidechain:
        assert where[src] == where[tgt]
    for comp in comps:
        assert _song_fields(multidevice._sub_song(c, comp)) == \
            _song_fields(jmulti._sub_song(jc, comp))
    if name in ("sidechain", "kitchen-sink"):
        assert len(comps) == 1 and c.sidechain  # welded into one
    if name in ("welsh", "perf-1", "instruments"):
        assert len(comps) >= 2  # these fan out


# the port's MultiDeviceRenderer on eight logical shards against
# groove_tpu's on its eight virtual devices (its CPU route, no Pallas),
# dBFS: measured (CPU) -96.8 (welsh: the Welsh cascades' CPU routes part)
# and -98.4 (perf-1)
MULTI_BARS = {"welsh": -88.0, "perf-1": -90.0}


@pytest.mark.parametrize("name", ["welsh", "perf-1", "instruments"])
def test_multidevice_matches_renderer(name, assets):
    c, jc = _both(name, assets)
    r = multidevice.MultiDeviceRenderer(c, CPU8)
    assert [dev for _, dev, _ in r.assignments] == \
        [CPU8[i % 8] for i in range(len(r.assignments))]
    single = Renderer(c, "cpu").render()
    multi = r.render()
    assert multi.shape == single.shape == (c.n_frames, 2)
    peak = max(1.0, float(np.abs(single).max()))
    assert float(np.abs(single - multi).max()) <= 1e-6 * peak
    assert float(np.abs(multi).max()) > 0.05
    q = r.render_quantized()
    host = np.clip(np.trunc(multi.astype(np.float64) * 32767.0),
                   -32768, 32767).astype(np.int16)
    assert q.dtype == np.int16 and np.array_equal(host, q)
    if name in MULTI_BARS:
        from groove_tpu.parallel.multidevice import MultiDeviceRenderer as J

        ref = J(jc).render()
        db = _db(multi, ref, ref)
        print(f"{name}: port vs groove_tpu multidevice {db:.1f} dBFS")
        assert db <= MULTI_BARS[name], db


def test_no_cuda_device_raises(monkeypatch):
    """Without devices and with no CUDA device visible, every multi-device
    entry point raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = compile_song(SongSettings.from_json5_str(json.dumps(
        synth.oscillator_project())), Paths())
    for make in (lambda: multidevice.MultiDeviceRenderer(c),
                 lambda: MeshRenderer(c), mesh.make_mesh,
                 lambda: timeshard.biquad_timesharded(
                     torch.zeros(128), (1.0, 0.0, 0.0, 0.0, 0.0)),
                 lambda: mesh.render_songs_data_parallel([c])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_render_songs_data_parallel(assets):
    songs = [_both(name, assets)[0] for name in ("welsh", "instruments")]
    outs = mesh.render_songs_data_parallel(songs, CPU8[:2])
    for song, out in zip(songs, outs):
        assert np.array_equal(out, Renderer(song, "cpu").render())


# ---- the time-sharded biquad ------------------------------------------------

def _sweep(n: int):
    from groove_tpu_torch.ops import iir

    rng = np.random.default_rng(3)
    x = rng.standard_normal(n).astype(np.float32)
    cutoff = np.linspace(200.0, 6000.0, n).astype(np.float32)
    return x, cutoff, iir.rbj_low_pass(cutoff, 0.707, 44100.0)


# against groove_tpu's biquad_timesharded on its eight virtual devices:
# measured (CPU) -98.5 dBFS (its 256-sample blocks against S3's 64)
TIMESHARD_VS_REFERENCE_DB = -90.0


def test_timesharded_biquad(monkeypatch):
    """n = 8 x 256 x 4 on eight shards: the bits of one carried-state
    chain (S3) over the whole signal (measured: equal), and within the
    bar of groove_tpu's; two S3 calls a shard."""
    from groove_tpu.ops import iir as jiir
    from groove_tpu.parallel.mesh import make_mesh as jmake_mesh
    from groove_tpu.parallel.timeshard import biquad_timesharded as jts
    from groove_tpu_torch.ops import stream as sops
    from groove_tpu_torch.ops import stream_kernels

    n = 8 * 256 * 4
    x, cutoff, coefs = _sweep(n)
    calls = []
    real = stream_kernels.biquad_state
    monkeypatch.setattr(stream_kernels, "biquad_state",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    y = timeshard.biquad_timesharded(torch.from_numpy(x), coefs, CPU8)
    assert calls == [(3, n // 8)] * 8 + [(1, n // 8)] * 8
    zero = torch.zeros(1)
    chain, _ = sops.biquad_stream(torch.from_numpy(x)[None], coefs,
                                  (zero, zero))
    y, chain = y.numpy(), chain[0].numpy()
    assert np.array_equal(y, chain) and float(np.abs(y).max()) > 1.0
    ref = np.asarray(jts(jnp.asarray(x), jiir.rbj_low_pass(
        jnp.asarray(cutoff), 0.707, 44100.0), jmake_mesh(8, axis="time"),
        axis_name="time"))
    db_ref = _db(y, ref, ref)
    print(f"timeshard: vs groove_tpu {db_ref:.1f} dBFS")
    assert db_ref <= TIMESHARD_VS_REFERENCE_DB, db_ref
    with pytest.raises(ValueError, match="multiple"):
        timeshard.biquad_timesharded(torch.zeros(n + 64), coefs, CPU8)


# ---- the track-sharded Welsh mix --------------------------------------------

# against groove_tpu's step: measured (CPU) -116.5 dBFS
MIX_VS_REFERENCE_DB = -108.0


def test_sharded_welsh_mix_step(assets):
    """8 tracks on 4 shards against the plain loop (as
    tests/test_parallel.py builds it) and groove_tpu's step on its eight
    virtual devices."""
    from groove_tpu.parallel.mesh import make_mesh as jmake_mesh
    from groove_tpu.parallel.mesh import \
        sharded_welsh_mix_step as jstep
    from groove_tpu_torch.models import welsh
    from groove_tpu_torch.models.voices import scatter_notes
    from groove_tpu_torch.ops import iir

    c, jc = _both("welsh", assets)
    n_frames, span, sr = 1024, 512, 44100.0
    n_tracks = 8
    rng = np.random.default_rng(0)
    keys = rng.integers(48, 72, (n_tracks, 2)).astype(np.int32)
    vels = np.full((n_tracks, 2), 127.0, np.float32)
    gates = np.full((n_tracks, 2), 256, np.int32)
    ons = np.tile(np.array([[0, 256]], np.int32), (n_tracks, 1))
    gains = np.linspace(0.2, 0.9, n_tracks).astype(np.float32)
    voice = c.devices["lead"].voice
    step = mesh.sharded_welsh_mix_step(voice, n_frames, span, sr, CPU8[:4])
    sharded = step(keys, vels, gates, ons, gains).numpy()
    mix = np.zeros((2, n_frames), np.float32)
    for t in range(n_tracks):
        mono = welsh.render_notes(
            voice, torch.from_numpy(keys[t]), torch.from_numpy(vels[t]),
            torch.from_numpy(gates[t]), span, sr)
        track = scatter_notes(mono, ons[t], n_frames)
        track = iir.biquad_best(track, iir.rbj_low_pass(8000.0, 0.707, sr))
        mix += torch.stack([track, track]).numpy() * gains[t]
    assert sharded.shape == (2, n_frames)
    assert float(np.abs(mix).max()) > 0.1
    assert np.max(np.abs(sharded - mix)) < 1e-4
    ref = np.asarray(jstep(jc.devices["lead"].voice, n_frames, span, sr,
                           jmake_mesh(8, axis="tracks"))(
        keys, vels, gates, ons, gains))
    db = _db(sharded, ref, ref)
    print(f"welsh mix: vs groove_tpu {db:.1f} dBFS")
    assert db <= MIX_VS_REFERENCE_DB, db


# ---- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--multidevice", "--mesh"])
def test_cli_multi_device_flags(flag, assets, tmp_path, monkeypatch,
                                capsys):
    """On --device cpu the flags render on the one CPU device and write
    the single-device WAV to within 1 LSB; --debug profiles no entity
    there."""
    path = synth.write_project(tmp_path / "perf-1.json", PROJECTS["perf-1"]())
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    assert cli.main([str(path), "--wav", "--quiet", "--device", "cpu",
                     "--out-dir", str(tmp_path / "a")]) == 0
    capsys.readouterr()
    assert cli.main([str(path), "--wav", "--debug", "--device", "cpu",
                     flag, "--out-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert ("Multi-device: 4 components across 1 device(s)"
            if flag == "--multidevice" else "Mesh: timeline sharded 1 ways"
            ) in out
    assert "instrument " not in out and "effect " not in out
    wa, _ = read_wav(tmp_path / "a" / "perf-1.wav")
    wb, _ = read_wav(tmp_path / "b" / "perf-1.wav")
    assert wa.shape == wb.shape and float(np.abs(wa).max()) > 0.05
    assert float(np.abs(wa - wb).max()) <= (1.0 / 32768) + 1e-9


# ---- the kernel layer's device guard ----------------------------------------

def _library_calls(tree: ast.AST):
    """(call node, its enclosing with-items) for every call of a function
    of the kernel library: `library().name(...)` or
    `build.library().name(...)`."""
    def walk(node, withs):
        if isinstance(node, ast.With):
            withs = withs + [item.context_expr for item in node.items]
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Call):
            inner = node.func.value.func
            name = inner.attr if isinstance(inner, ast.Attribute) \
                else getattr(inner, "id", None)
            if name == "library":
                yield node, withs
        for child in ast.iter_child_nodes(node):
            yield from walk(child, withs)

    yield from walk(tree, [])


def _guard(expr) -> bool:
    return isinstance(expr, ast.Call) and (
        getattr(expr.func, "attr", None) == "on_device"
        or getattr(expr.func, "id", None) == "on_device")


def test_every_launch_runs_under_its_device_guard():
    """Every call into the kernel library (outside kernels/, whose tools
    drive their own instrumented builds) sits inside `with
    on_device(...)`, which makes the launch's device current; and
    on_device makes that device current."""
    from groove_tpu_torch.ops import iir_kernels

    found, bad = 0, []
    for path in sorted(PORT.rglob("*.py")):
        if path.parent.name == "kernels":
            continue
        tree = ast.parse(path.read_text(), str(path))
        for call, withs in _library_calls(tree):
            found += 1
            if not any(_guard(w) for w in withs):
                bad.append(f"{path.relative_to(REPO)}:{call.lineno}")
    assert found >= 13 and not bad, (found, bad)
    guard = iir_kernels.on_device(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
    with iir_kernels.on_device(torch.device("cpu")):
        pass


def test_guard_check_sees_an_unguarded_launch():
    """The walk above flags a launch outside the guard."""
    tree = ast.parse("def f(x):\n"
                     "    with on_device(x.device):\n"
                     "        library().a(1)\n"
                     "    return build.library().b(2)\n")
    flags = [(c.func.attr, any(_guard(w) for w in ws))
             for c, ws in _library_calls(tree)]
    assert flags == [("a", True), ("b", False)]
