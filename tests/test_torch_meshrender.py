"""groove_tpu_torch/parallel/meshrender.py against groove_tpu's, and the
merged sliced-Welsh cascade (StreamingRenderer.WELSH_SLICE_MERGE), on the
CPU twins. MeshRenderer on eight, four and two logical CPU shards equals
the port's single-device StreamingRenderer within 2e-4 of the peak, runs
its step exactly (K + 1) x d times in Jacobi rounds, and reads within
measured bars of groove_tpu's MeshRenderer on its eight virtual devices;
the auto iteration count and effect_memory_seconds equal the reference's.
The merged sliced stream equals the unmerged one bit for bit, launches
one stream kernel a layout a segment, and reads within a measured bar of
groove_tpu's merged stream on its kernels (the Pallas interpreter). Bars
are the measured value plus about 8 dB."""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.stream import StreamingRenderer
from groove_tpu_torch.ops import delayfx
from groove_tpu_torch.parallel import meshrender
from groove_tpu_torch.parallel.meshrender import MeshRenderer
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

CPU = torch.device("cpu")

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
    return synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)


# the carried states: reverb, delay, chorus and compressor tails (kitchen
# sink), the refined 24 dB cascade under a sweep (north star), sidechain
# links (sidechain), Welsh notes crossing the seams
FIXTURES = {
    "kitchen-sink": lambda: synth.kitchen_sink_project(1, 240.0),
    "north-star": lambda: synth.north_star_project(2),
    "sidechain": lambda: synth.sidechain_project(1, 240.0),
    "welsh": lambda: synth.welsh_project(1, 240.0),
}


def _text(project) -> str:
    return json.dumps(project)


def _port(project, assets=None):
    return compile_song(SongSettings.from_json5_str(_text(project)),
                        Paths(roots=[assets] if assets else []))


def _jax(project, assets=None):
    return jax_compile(JaxSongSettings.from_json5_str(_text(project)),
                       JaxPaths(roots=[assets] if assets else []))


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


@pytest.fixture(scope="module")
def songs(assets):
    """name -> (port compiled, its single-device stream at 8192-frame
    segments)."""
    out = {}
    for name, make in FIXTURES.items():
        c = _port(make(), assets)
        out[name] = (c, StreamingRenderer(c, CPU, 8192).render())
    return out


def _counted(r: MeshRenderer) -> dict:
    """Count every step of r's streaming renderers."""
    calls = {"n": 0}
    for s in r.streams.values():
        real = s.step

        def step(*a, real=real):
            calls["n"] += 1
            return real(*a)

        s.step = step
    return calls


@pytest.mark.parametrize("name", list(FIXTURES))
def test_mesh_matches_single_device_stream(name, songs):
    """Eight shards, auto iterations: within 2e-4 of the peak of the
    single-device stream, with exactly (K + 1) x 8 steps."""
    c, single = songs[name]
    r = MeshRenderer(c, [CPU] * 8)
    calls = _counted(r)
    out = r.render()
    assert out.shape == single.shape == (c.n_frames, 2)
    assert calls["n"] == (r.iterations + 1) * 8
    peak = max(1.0, float(np.abs(single).max()))
    assert float(np.abs(single).max()) > 0.05
    assert float(np.abs(out - single).max()) < 2e-4 * peak


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_width_sweep(d, songs):
    """Four and two shards, auto iterations: within 2e-4 of the peak."""
    c, single = songs["kitchen-sink"]
    r = MeshRenderer(c, [CPU] * d)
    calls = _counted(r)
    out = r.render()
    assert calls["n"] == (r.iterations + 1) * d
    peak = max(1.0, float(np.abs(single).max()))
    assert float(np.abs(out - single).max()) < 2e-4 * peak


def test_jacobi_rounds():
    """Round r + 1's entry of shard k + 1 is round r's exit of shard k
    (a copy of its own), and shard 0 starts from zeros every round: the
    entry states the step sees, recorded."""
    c = _port(_reverb_song(1, 0.2))
    r = MeshRenderer(c, [CPU] * 3, iterations=2)
    seen = []
    s = r.stream
    real = s.step

    def step(state, xs, n):
        seen.append((xs["t0"], {k: v.clone() for k, v in state.items()},
                     state))
        out = real(state, xs, n)
        return out

    s.step = step
    r.render()
    assert [t0 for t0, _, _ in seen] == [0, r.S, 2 * r.S] * 3
    zero = s.init_state()
    # the reverb's comb (x and y) and all-pass tails
    assert len(zero) == 2 * len(delayfx.COMB_DELAYS_S) + len(
        delayfx.ALLPASS_DELAYS_S)
    for i, (t0, entry, live) in enumerate(seen):
        k, rnd = i % 3, i // 3
        if k == 0 or rnd == 0:
            assert all(torch.equal(entry[key], zero[key]) for key in zero)
        else:
            prev = seen[i - 4][2]  # round rnd - 1, shard k - 1, its exit
            assert all(torch.equal(entry[key], prev[key]) for key in prev)
            assert all(entry[key].data_ptr() != prev[key].data_ptr()
                       for key in prev if prev[key].numel())


def test_past_the_end_shards_render_silence():
    """A song shorter than d - 1 shards: its past-the-end shards step on
    zero-padded oscillator slices and the song is the stream's."""
    c = dataclasses.replace(_port(synth.oscillator_project()),
                            n_frames=150, n_blocks=3)
    r = MeshRenderer(c, [CPU] * 8)
    assert r.S == 64 and r.stream.n_segs == 3
    out = r.render()
    assert out.shape == (150, 2)
    single = StreamingRenderer(c, CPU, 8192).render()
    assert np.array_equal(out, single)


# the port's MeshRenderer against groove_tpu's (its CPU route, no Pallas),
# both on eight shards with one relaxation round (the same computation),
# dBFS: measured (CPU) -123.1 (kitchen sink), -106.4 (north star), -68.3
# (sidechain: its low-pass swept through low cutoffs, as the two packages'
# streams part, tests/test_torch_stream.py) and -96.8 (Welsh)
MESH_BARS = {"kitchen-sink": -115.0, "north-star": -98.0,
             "sidechain": -60.0, "welsh": -88.0}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_mesh_matches_reference(name, songs, assets):
    from groove_tpu.parallel.meshrender import MeshRenderer as JaxMesh

    c, _ = songs[name]
    out = MeshRenderer(c, [CPU] * 8, iterations=1).render()
    ref = np.asarray(JaxMesh(_jax(FIXTURES[name](), assets),
                             iterations=1).render())
    db = _db(out, ref, ref)
    print(f"{name}: port vs groove_tpu mesh {db:.1f} dBFS")
    assert db <= MESH_BARS[name], db


def test_render_quantized_is_the_host_quantization(songs):
    c, _ = songs["kitchen-sink"]
    r = MeshRenderer(c, [CPU] * 4, iterations=1)
    f = r.render()
    q = r.render_quantized()
    host = np.clip(np.trunc(f.astype(np.float64) * 32767.0),
                   -32768, 32767).astype(np.int16)
    assert q.dtype == np.int16 and np.array_equal(host, q)


def _reverb_song(measures: int, seconds: float) -> dict:
    return {
        "clock": {"bpm": 120},
        "devices": [
            {"instrument": ["i1", {"oscillator": {
                "waveform": "sine", "frequency": 220.0}}]},
            {"effect": ["rv", {"reverb": {"attenuation": 0.8,
                                          "seconds": seconds}}]},
        ],
        "patch-cables": [["i1", "rv", "main-mixer"]],
        "patterns": [{"id": "p", "notes": [[60]]}],
        "tracks": [{"id": "t", "midi-channel": 0,
                    "patterns": ["p"] * measures}],
    }


@pytest.mark.parametrize("measures,seconds", [(32, 0.2), (2, 3.0)])
def test_auto_iterations_match_reference(measures, seconds):
    """A long song derives one round, a short song with a long reverb
    more; both as groove_tpu derives them on its eight devices."""
    from groove_tpu.parallel.meshrender import MeshRenderer as JaxMesh

    p = _reverb_song(measures, seconds)
    r = MeshRenderer(_port(p), [CPU] * 8)
    j = JaxMesh(_jax(p))
    assert (r.S, r.iterations) == (j.S, j.iterations)
    assert (r.iterations == 1) == (measures == 32)


def _memory_song(controls=(), trips=False) -> dict:
    d = {
        "clock": {"bpm": 120},
        "devices": [
            {"instrument": ["i1", {"oscillator": {
                "waveform": "sine", "frequency": 220.0}}]},
            {"effect": ["fx", {"delay": {"delay": 0.0}}]},
            {"controller": ["sc", {"signal-passthrough-controller": [{}]}]},
        ],
        "patch-cables": [["i1", "fx", "main-mixer"],
                         ["i1", "sc", "main-mixer"]],
        "patterns": [{"id": "p", "notes": [[60]]}],
        "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
        "controls": list(controls),
    }
    if trips:
        d["paths"] = [{"id": "pa", "note-value": "whole",
                       "steps": [{"slope": {"start": 0.6, "end": 0.6}}]}]
        d["trips"] = [{"id": "tr", "target": {"id": "fx", "param": "delay"},
                       "paths": ["pa"]}]
    return d


MEMORY_CASES = {
    "static": {},
    "trip": {"trips": True},
    "sidechain": {"controls": [{"id": "c", "source": "sc",
                                "target": {"id": "fx", "param": "delay"}}]},
}


@pytest.mark.parametrize("case", [*MEMORY_CASES, "kitchen-sink"])
def test_effect_memory_seconds_matches_reference(case, assets):
    """A delay whose time comes from a trip (static 0.0) or a sidechain
    link (the engine clamp) registers, as in the reference; and the
    kitchen sink's reverbs, delays and compressors."""
    from groove_tpu.engine.render import SIDECHAIN_SECONDS_MAX
    from groove_tpu.parallel.meshrender import effect_memory_seconds

    p = synth.kitchen_sink_project(1) if case == "kitchen-sink" \
        else _memory_song(**MEMORY_CASES[case])
    got = meshrender.effect_memory_seconds(_port(p, assets))
    assert got == effect_memory_seconds(_jax(p, assets))
    want = {"static": 0.0, "trip": 0.6, "sidechain": SIDECHAIN_SECONDS_MAX,
            "kitchen-sink": 1.0}[case]
    assert got >= want and (case != "static" or got == 0.0)


# ---- the merged sliced-Welsh cascade ----------------------------------------

class Sliced(StreamingRenderer):
    WELSH_SLICED = True


class Merged(Sliced):
    WELSH_SLICE_MERGE = True


def _two_leads(measures: int = 1) -> dict:
    """The Welsh analogue with a second single-pass lead on the lead's
    channel: two K7 jobs and one K8 job a segment."""
    p = synth.welsh_project(measures, 240.0)
    lead = p["devices"][1]["instrument"][1]["welsh-raw"]
    p["devices"].append({"instrument": ["lead2", {"welsh-raw": [
        {**lead[0], "gain": 0.15}, {**lead[1], "noise": 0.0}]}]})
    p["patch-cables"].append(["lead2", "main-mixer"])
    return p


def test_merged_equals_unmerged():
    """The merged sliced stream is the unmerged one bit for bit, at 4096-
    and 8192-frame segments; it plans and launches one K7 and one K8 a
    segment where the unmerged stream launches two K7."""
    from groove_tpu_torch.ops import iir_kernels

    c = _port(_two_leads())
    for seg in (4096, 8192):
        plain = Sliced(c, CPU, seg)
        merged = Merged(c, CPU, seg)
        n = plain.n_segs
        assert plain.planned_launches() == {"lp24_stream": 2 * n,
                                            "lp24_refined_stream": n}
        assert merged.planned_launches() == {"lp24_stream": n,
                                             "lp24_refined_stream": n}
        assert merged.segment_launches(notes=False) == {}
        a = plain.render()
        calls = []
        real = iir_kernels._stream
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(iir_kernels, "_stream",
                       lambda *args: calls.append(args[1]) or real(*args))
            b = merged.render()
        assert sorted(calls) == sorted(["lp24_stream",
                                        "lp24_refined_stream"] * n)
        assert np.array_equal(a, b) and float(np.abs(a).max()) > 0.05


# the port's merged stream against groove_tpu's merged stream on its
# kernels (interpreted Pallas) at 4096-frame segments: measured (CPU)
# -135.0 dBFS
MERGED_VS_REFERENCE_DB = -127.0


def test_merged_matches_reference(monkeypatch):
    from groove_tpu.engine.stream import StreamingRenderer as JaxStreaming
    from groove_tpu.ops import iir as jiir
    from groove_tpu.ops import pallas_iir

    p = _two_leads()
    out = Merged(_port(p), CPU, 4096).render()
    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)
    jr = type("JaxMerged", (JaxStreaming,), {
        "WELSH_SLICED": True, "WELSH_SLICE_MERGE": True})(
        _jax(p), segment_frames=4096)
    ref = np.asarray(jr.render())
    db = _db(out, ref, ref)
    print(f"merged: port vs groove_tpu {db:.1f} dBFS")
    assert db <= MERGED_VS_REFERENCE_DB, db
