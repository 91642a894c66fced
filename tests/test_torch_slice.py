"""The port's slices end to end on the CPU: drumkit -> effect filters ->
mix -> int16, through groove_tpu_torch's Renderer, against groove_tpu's
Renderer with its Pallas kernels run through the interpreter (the kernel
routing the port follows), and against the f64 reference renderer
(tools/f64_reference.render_f64).

Measured on the CPU (synthetic kit, numpy seed 0, about 1.3 s of audio):

    project             port vs JAX      port vs f64   JAX vs f64
    north-star          -135.4 (-128)    -129.7        -131.3
    high-sweep          -138.5 (-128)    -141.1        -139.0
    filter-bank         -76.9 (-69)      -68.3         -68.1
    filter-bank w/o sc  -96.2 (-88)      -101.2        -98.1
    sidechain-eq        -123.0 (-115)    -150.9        -123.0
    sidechain-lp24      -133.0 (-125)    -143.3        -132.8

north-star runs K1 + K2, high-sweep K1 + K3; the filter bank every route
of the effect filters (testing/synth.FILTER_BANK): K5, K4, K4 twice,
the serial scan, K6 and, for its sidechain-driven low-pass-24db, K3.
That sidechain filter dominates the filter bank's residuals: its cutoff
follows the drums' level and falls to 25 Hz whenever they are quiet, its
coefficients are designed at run time (torch here, jax.numpy there,
about an ulp apart), and the reference routes such filters to the single
pass, whose error near z = 1 is the largest of any route: the int16
outputs differ by up to 5 LSB there. Both packages read about -68 dBFS
against f64 with it; without that chain the port meets the -80 dBFS bar
with the reference. No floor on that cutoff keeps it well conditioned:
each block's value is |mean(L, R)| of a drum sample, so it drops to
25 Hz whenever the channels cancel, and a state built at a higher cutoff
is then released through poles next to z = 1 (a limiter in front of
the controller, raising every |x| to a floor, does not help: the
channels still cancel, and the transients grow with the floor). The two sidechain slices hold the same device-side designs (tensor
rbj_peaking_eq -> K4, tensor lp24_sections -> K3) on parameters that
the drums move gently: a peaking EQ's db-gain at 1 kHz and a
low-pass-24db's passband-ripple at 8 kHz.

Bars: port vs JAX in parentheses; port vs f64 within 3 dB of JAX vs f64,
and at most -80 dBFS where the reference meets it; int16 output within
1 LSB of JAX's (12 LSB for the whole filter bank)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.engine.render import Renderer as JaxRenderer
from groove_tpu.io.wav import quantize_16bit_device
from groove_tpu.ops import dca as jdca
from groove_tpu.ops import effects as jeffects
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.engine.render import Renderer, compute_filter_fidelity
from groove_tpu_torch.io.wav import quantize_16bit, read_wav
from groove_tpu_torch.ops import dca, effects
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]


def _without_sidechain(measures: int = 1) -> dict:
    """The filter bank less its sidechain-driven chain."""
    p = synth.filter_bank_project(measures)
    p["devices"] = [d for d in p["devices"]
                    if not {"lp24-sc", "sc-level", synth.SIDECHAIN_UVID} & {
                        v[0] for v in d.values()}]
    p["patch-cables"] = [c for c in p["patch-cables"] if "lp24-sc" not in c]
    p["controls"] = []
    return p


def _sidechain_only(kind: str, params: dict, param: str):
    """drums -> passthrough controller -> one filter whose `param` the
    controller drives (coefficients designed on the render's device)."""
    def make(measures: int = 1) -> dict:
        p = synth.filter_bank_project(measures)
        p["devices"] = p["devices"][:2] + [{"effect": ["target", {
            kind: dict(params)}]}]
        p["patch-cables"] = [["drums", synth.SIDECHAIN_UVID, "target",
                              "main-mixer"]]
        p["paths"], p["trips"] = [], []
        p["controls"] = [{"id": "sc-param", "source": synth.SIDECHAIN_UVID,
                          "target": {"id": "target", "param": param}}]
        return p
    return make


BANK_ROUTES = {u: r for u, (_, _, r) in synth.FILTER_BANK.items()
               if r != "plain"}
SLICES = {
    # name: (project, expected fidelity routing, bar vs JAX dBFS, int16
    #        bar vs JAX LSB, bar vs f64 dBFS or None where the reference
    #        misses -80)
    "north-star": (synth.north_star_project, {synth.FILTER_UVID: "refine"},
                   -128.0, 1, -80.0),
    "high-sweep": (synth.high_sweep_project, {}, -128.0, 1, -80.0),
    "filter-bank": (synth.filter_bank_project, BANK_ROUTES, -69.0, 12,
                    None),
    "filter-bank-no-sidechain": (_without_sidechain, BANK_ROUTES, -88.0, 1,
                                 -80.0),
    "sidechain-eq": (_sidechain_only("filter-peaking-eq-12db", {
        "cutoff": 1000.0, "q": 1.5, "db-gain": 6.0}, "db-gain"), {},
        -115.0, 1, -80.0),
    "sidechain-lp24": (_sidechain_only("filter-low-pass-24db", {
        "cutoff": 8000.0, "passband-ripple": 0.707}, "passband-ripple"), {},
        -125.0, 1, -80.0),
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)


@pytest.fixture(scope="module")
def renders(assets):
    """name -> (port compiled, JAX compiled, JAX Renderer, JAX render,
    port render) with the reference on its kernel path (Pallas
    interpreter) and the port on its twins."""
    from groove_tpu.ops import iir, pallas_iir

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iir, "USE_PALLAS", True)
        mp.setattr(pallas_iir, "FORCE_INTERPRET", True)
        for name, (make, *_) in SLICES.items():
            text = json.dumps(make())
            jc = jax_compile(JaxSongSettings.from_json5_str(text),
                             JaxPaths(roots=[assets]))
            jr = JaxRenderer(jc)
            tc = compile_song(SongSettings.from_json5_str(text),
                              Paths(roots=[assets]))
            out[name] = (tc, jc, jr, np.asarray(jr.render()),
                         Renderer(tc, device="cpu").render())
    return out


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


@pytest.mark.parametrize("name", list(SLICES))
def test_fidelity_routing(renders, name):
    """The north star's sweep parks near 25 Hz: refined cascade (K2). The
    high sweep stays at or above 2 kHz: unrouted, single pass (K3)."""
    compiled = renders[name][0]
    assert compute_filter_fidelity(compiled) == SLICES[name][1]


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_matches_reference_kernels(renders, name):
    compiled, _, _, ref, got = renders[name]
    assert got.shape == ref.shape == (compiled.n_frames, 2)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got).max() > 0.05  # drums are audible
    db = _db(got, ref, ref)
    assert db <= SLICES[name][2], f"{name}: {db:.1f} dBFS vs JAX"
    q = quantize_16bit(torch.from_numpy(got)).numpy()
    q_ref = np.asarray(quantize_16bit_device(jnp.asarray(ref)))
    assert q.dtype == np.int16
    assert np.max(np.abs(q.astype(np.int32) - q_ref)) <= SLICES[name][3]


def test_render_quantized_is_the_quantized_render(renders):
    compiled, _, _, _, got = renders["north-star"]
    q = Renderer(compiled, device="cpu").render_quantized()
    assert np.array_equal(q, quantize_16bit(torch.from_numpy(got)).numpy())


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_against_f64_reference(renders, name):
    from tools.f64_reference import render_f64

    _, jc, _, ref_jax, got = renders[name]
    ref = render_f64(jc)
    port_db = _db(got, ref, ref)
    jax_db = _db(ref_jax, ref, ref)
    assert port_db <= jax_db + 3.0, (port_db, jax_db)
    bar = SLICES[name][4]
    if bar is not None:
        assert port_db <= bar


@pytest.mark.parametrize("name", list(SLICES))
def test_inputs_from_reference_renderer(renders, name):
    """The reference Renderer's inputs, carried over as numpy, equal the
    port's own collection bit for bit and render the same song."""
    compiled, _, jr, _, got = renders[name]
    theirs = {k: np.asarray(v) for k, v in jr.inputs.items()}
    own = Renderer(compiled, device="cpu")
    assert theirs.keys() == own.host_inputs.keys()
    for k, v in theirs.items():
        mine = own.host_inputs[k]
        assert v.dtype == mine.dtype and np.array_equal(v, mine), k
    carried = Renderer(compiled, device="cpu",
                       inputs=theirs)
    for k, t in inputs_from_numpy(theirs, "cpu").items():
        assert torch.equal(carried.inputs[k], t)
    assert np.array_equal(carried.render(), got)


def test_port_imports_and_renders_without_jax(assets, tmp_path):
    """A process whose import system refuses jax and groove_tpu imports
    every module of groove_tpu_torch, renders the filter-bank analogue
    (about 1.3 s, every route of the effect filters) on the CPU and runs
    the CLI to a WAV, then streams a 1 s Welsh analogue (sliced, on the
    stream kernels' twins) through the CLI's --stream --sliced and
    renders it offline through the CLI's --wav (whole-timeline Welsh
    voices, on K2's and K3's twins)."""
    project = synth.write_project(tmp_path / "filter-bank.json",
                                  synth.filter_bank_project())
    welsh = synth.write_project(tmp_path / "welsh.json",
                                synth.welsh_project(1, 240.0))
    code = f"""
import importlib, pkgutil, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
import numpy as np
import groove_tpu_torch
for m in pkgutil.walk_packages(groove_tpu_torch.__path__,
                               "groove_tpu_torch."):
    importlib.import_module(m.name)
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
song = SongSettings.from_project_file({str(project)!r})
r = Renderer(compile_song(song, Paths(roots=[{str(assets)!r}])), "cpu")
q = r.render_quantized()
assert cli.main([{str(project)!r}, "--wav", "--perf", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "out")!r}]) == 0
x, rate = read_wav({str(tmp_path / "out" / "filter-bank.wav")!r})
assert rate == 44100 and x.shape == q.shape
assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
from groove_tpu_torch.engine.stream import StreamingRenderer
perf = []
assert cli.main([{str(welsh)!r}, "--wav", "--stream", "--sliced",
                 "--segment-frames", "4096", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "out")!r}], perf_out=perf) == 0
assert perf[0]["stream"]["sliced"] == ["lead", "pad"]
w, rate = read_wav({str(tmp_path / "out" / "welsh.wav")!r})
S = type("S", (StreamingRenderer,), {{"WELSH_SLICED": True}})
c = compile_song(SongSettings.from_project_file({str(welsh)!r}), Paths())
qw = S(c, "cpu", 4096).render(quantize=True)
assert w.shape == qw.shape and np.abs(qw).max() > 1000
assert np.array_equal(np.round(w * 32768).astype(np.int16), qw)
assert cli.main([{str(welsh)!r}, "--wav", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "offline")!r}]) == 0
wo, rate = read_wav({str(tmp_path / "offline" / "welsh.wav")!r})
qo = Renderer(c, "cpu").render_quantized()
assert wo.shape == qw.shape and np.abs(qo).max() > 1000
assert np.array_equal(np.round(wo * 32768).astype(np.int16), qo)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "groove_tpu")]
print("JAX-FREE OK", q.shape)
"""
    env = dict(os.environ, GROOVE_ASSETS=str(assets),
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
    # the block is real: the same process refuses groove_tpu itself
    probe = subprocess.run(
        [sys.executable, "-c", code.split("import numpy")[0]
         + "import groove_tpu.core.time\n"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "is blocked" in probe.stderr


# ---- the rest of the graph walk: gain, limiter, bitcrusher, sends,
# sidechain, against the reference's plain (non-kernel) render -----------

def _graph_project():
    p = synth.north_star_project()
    p["devices"] = p["devices"][:1] + [
        {"controller": ["sc", {"signal-passthrough-controller": [{}]}]},
        {"effect": ["g1", {"gain": {"ceiling": 0.8}}]},
        {"effect": ["crush", {"bitcrusher": {"bits": 4}}]},
        {"effect": ["lim", {"limiter": {"minimum": 0.0, "maximum": 0.6}}]},
        {"effect": ["aux", {"gain": {"ceiling": 0.5}}]},
    ]
    p["patch-cables"] = [["drums", "sc", "g1", "crush", "lim",
                          "main-mixer"], ["aux", "main-mixer"]]
    p["sends"] = [{"source": "drums", "aux": "aux", "amount": 0.3}]
    p["controls"] = [{"id": "c1", "source": "sc",
                      "target": {"id": "g1", "param": "ceiling"}}]
    p["paths"] = [{"id": "up", "note-value": "whole",
                   "steps": [{"slope": {"start": 0.2, "end": 0.9}}]}]
    p["trips"] = [{"id": "t1", "paths": ["up"],
                   "target": {"id": "crush", "param": "bits-to-crush"}}]
    return p


def test_graph_walk_matches_reference(assets):
    """XLA contracts some of the reference's multiply-adds (the send's
    acc + amount * x) into FMAs on the CPU: measured at most 1.2e-7 apart,
    bar 2.4e-7."""
    jc = jax_compile(JaxSongSettings.from_json(_graph_project()),
                     JaxPaths(roots=[assets]))
    ref = np.asarray(JaxRenderer(jc).render())
    got = Renderer(compile_song(SongSettings.from_json(_graph_project()),
                                Paths(roots=[assets])), "cpu").render()
    assert np.abs(ref).max() > 0.01
    assert np.max(np.abs(got - ref)) <= 2.4e-7


@pytest.mark.parametrize("param", ["scalar", "per-sample"])
def test_pointwise_effects_match(param):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4096)) * 0.6).astype(np.float32)
    if param == "scalar":
        args = {"ceiling": 0.7, "lo": 0.1, "hi": 0.5, "bits": 5.0,
                "pan": 0.3}
    else:
        args = {k: rng.uniform(lo, hi, 4096).astype(np.float32)
                for k, lo, hi in (("ceiling", 0.0, 1.0), ("lo", 0.0, 0.2),
                                  ("hi", 0.3, 0.9), ("bits", 0.0, 15.9),
                                  ("pan", -1.0, 1.0))}

    def t(v):
        return torch.from_numpy(v) if isinstance(v, np.ndarray) else v

    xt = torch.from_numpy(x)
    pairs = [
        (effects.gain(xt, t(args["ceiling"])),
         jeffects.gain(x, args["ceiling"])),
        (effects.limiter(xt, t(args["lo"]), t(args["hi"])),
         jeffects.limiter(x, args["lo"], args["hi"])),
        (effects.bitcrusher(xt, t(args["bits"])),
         jeffects.bitcrusher(x, args["bits"])),
    ]
    pairs += list(zip(dca.pan_gains(t(args["pan"])),
                      jdca.pan_gains(args["pan"])))
    for got, ref in pairs:
        assert np.array_equal(got.numpy(), np.asarray(ref))


# ---- what is not ported raises --------------------------------------------

def _with_oscillator(p: dict) -> dict:
    p["devices"].append({"instrument": ["osc", {"oscillator": {
        "waveform": "sine", "frequency": 220.0}}]})
    p["patch-cables"].append(["osc", "main-mixer"])
    return p


@pytest.mark.parametrize("case", ["oscillator", "reverb", "compressor"])
def test_unported_parts_raise(assets, case):
    """An oscillator instrument and the stateful effects beside sliced
    Welsh voices: a streamed render takes them (one segment = 4096-frame
    segments, bit for bit), and what still refuses is a loop of the
    sliced devices, whose carried note state cannot follow a seek."""
    from groove_tpu_torch.engine.stream import StreamingRenderer

    p = synth.welsh_project(1, 240.0)
    p["patch-cables"] = [["pad", "main-mixer"], ["lead", "main-mixer"]]
    if case == "oscillator":
        p = _with_oscillator(p)
    else:
        params = ({"attenuation": 0.5, "seconds": 0.2} if case == "reverb"
                  else {"threshold": 0.5, "ratio": 4.0})
        p["devices"].append({"effect": ["fx", {case: params}]})
        p["patch-cables"][0] = ["pad", "fx", "main-mixer"]
    sliced = type("Sliced", (StreamingRenderer,), {"WELSH_SLICED": True})
    c = compile_song(SongSettings.from_json(p), Paths())
    many = sliced(c, "cpu", 4096).render()
    one = sliced(c, "cpu", -(-c.n_frames // 64) * 64).render()
    assert np.array_equal(one, many) and float(np.abs(many).max()) > 0.01
    with pytest.raises(NotImplementedError, match="linear-stream only"):
        next(sliced(c, "cpu", 4096).stream_loop(0, 1))


@pytest.mark.parametrize("flag", [["--mp3"], ["--multidevice"],
                                  ["-q"], ["--mesh"]])
def test_cli_refuses_unported_flags(flag, assets, tmp_path, monkeypatch,
                                    capsys):
    """No flag of the reference's CLI refuses: --mp3 and -q are taken (on
    an input of "-", which the CLI skips, as the reference does), and
    --multidevice and --mesh render the high sweep on --device cpu to the
    single-device WAV."""
    if flag[0] in ("--multidevice", "--mesh"):
        path = synth.write_project(tmp_path / "hs.json",
                                   synth.high_sweep_project())
        monkeypatch.setenv("GROOVE_ASSETS", str(assets))
        assert cli.main([str(path), "--wav", "--device", "cpu", *flag,
                         "--out-dir", str(tmp_path / "o")]) == 0
        x, _ = read_wav(tmp_path / "o" / "hs.wav")
        q = Renderer(compile_song(SongSettings.from_project_file(path),
                                  Paths(roots=[assets])),
                     "cpu").render_quantized()
        assert np.abs(np.round(x * 32768).astype(np.int32) - q).max() <= 1
        assert np.abs(q).max() > 1000
        return
    assert cli.main(["-", "--device", "cpu", *flag]) == 0
    assert "not ported" not in capsys.readouterr().err


def test_cli_reports_unported_project(assets, tmp_path, monkeypatch,
                                      capsys):
    """A loop of sliced Welsh voices is refused: the CLI reports it and
    goes on (exit 1); the same project streams (its oscillator too) and
    renders offline."""
    p = _with_oscillator(synth.welsh_project(1, 240.0))
    path = synth.write_project(tmp_path / "oscillator.json", p)
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    assert cli.main([str(path), "--loop", "0", "1", "--sliced",
                     "--segment-frames", "4096", "--device", "cpu"]) == 1
    assert "linear-stream only" in capsys.readouterr().err
    assert cli.main([str(path), "--stream", "--sliced", "--segment-frames",
                     "4096", "--device", "cpu"]) == 0
    assert cli.main([str(path), "--device", "cpu"]) == 0


def test_cli_writes_the_render(assets, tmp_path, monkeypatch):
    path = synth.write_project(tmp_path / "ns.json5",
                               synth.high_sweep_project())
    monkeypatch.setenv("GROOVE_ASSETS", str(assets))
    perf = []
    assert cli.main([str(path), "--wav", "--device", "cpu", "--out-dir",
                     str(tmp_path / "o")], perf_out=perf) == 0
    x, rate = read_wav(tmp_path / "o" / "ns.wav")
    song = SongSettings.from_project_file(path)
    q = Renderer(compile_song(song, Paths(roots=[assets])),
                 "cpu").render_quantized()
    assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
    assert perf[0]["frames"] == len(q) and perf[0]["wav"].endswith("ns.wav")
    json.dumps(perf)
