"""The effect layer of groove_tpu_torch (compressor, delay, chorus, reverb,
toy) on the CPU, against groove_tpu's on the same inputs (made with numpy,
seed 0), and the first-order scan's twin (ops/scan_kernels.py) on its
own.

Bars. Bit for bit: delay_signal, delay, delay_automated, compressor,
toy_effect, chorus and chorus_automated (the same sums of the same
gathers, divided truly). The recurrences (one_pole, max_decay and what
runs on them) keep the twin's chunk decomposition where the reference
runs XLA's associative_scan tree, so they are held to a dBFS bar (the
largest difference over max(1, peak), in dB) about 8 dB above the value
measured here (in brackets beside each bar in SCAN_BARS). The follower's
and the reverb's gains take exp in float64, rounded once (the reference:
XLA's float32 exp): at most 1 ulp apart.

The two analogues of testing/synth.py, about 2 s each, end to end:
against groove_tpu's Renderer with its Pallas kernels interpreted, and
against tools/f64_reference.render_f64 at the BASELINE -80 dBFS bar.
Measured: kitchen sink -122.2 dBFS against groove_tpu, -105.7 against f64
(groove_tpu -106.2); perf-1 (held chords) -137.9 and -138.0 (groove_tpu
-139.6). The
compressors' `|x| > threshold` flips a sample under any ulp change (the
knife edge of tests/test_pallas_golden.py): the count of samples more than
1e-4 apart is bounded too (measured 0)."""

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
from groove_tpu.models import simple as jsimple
from groove_tpu.ops import delayfx as jdelayfx
from groove_tpu.ops import dynamics as jdynamics
from groove_tpu.ops import iir as jiir
from groove_tpu.project.paths import Paths as JaxPaths
from groove_tpu.project.schema import SongSettings as JaxSongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.models import simple
from groove_tpu_torch.ops import delayfx, dynamics, iir, scan_kernels
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
SR = 44100.0
N = 20000  # samples per test signal (a few hundred 64-frame blocks)


def _db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    peak = max(1.0, float(np.abs(ref).max()))
    return 20.0 * np.log10(float(np.abs(got - ref).max()) / peak + 1e-30)


def _signal(seed: int = 0, shape=(2, N), level: float = 0.4) -> np.ndarray:
    """Decaying noise bursts: a level that crosses the compressor's
    threshold and falls silent, so that the follower rings out."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    env = np.exp(-((np.arange(shape[-1]) % 4410) / 800.0))
    return (level * x * env).astype(np.float32)


def _curve(lo: float, hi: float, n: int = N, seed: int = 1) -> np.ndarray:
    """A block-rate curve [ceil(n / 64)] wandering in [lo, hi]."""
    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    return (lo + (hi - lo) * rng.random(nb)).astype(np.float32)


def _t(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def _up(curve: np.ndarray, n: int = N) -> np.ndarray:
    return np.repeat(curve, 64)[:n]


# ---- bit for bit -----------------------------------------------------------

@pytest.mark.parametrize("d", [0, 1, 64, 1310, N + 5])
def test_delay_signal_and_delay_bitwise(d):
    x = _signal()
    assert np.array_equal(delayfx.delay_signal(_t(x), d).numpy(),
                          np.asarray(jdelayfx.delay_signal(x, d)))
    s = d / SR
    assert np.array_equal(delayfx.delay(_t(x), s, SR).numpy(),
                          np.asarray(jdelayfx.delay(x, s, SR)))


@pytest.mark.parametrize("lo,hi", [(0.0, 0.05), (0.2, 0.6)])
def test_delay_automated_bitwise(lo, hi):
    """Lengths changing every block; the second range reaches past the
    signal, where the taps read exact zeros."""
    x = _signal()
    c = _curve(lo, hi)
    got = delayfx.delay_automated(_t(x), _t(c), SR).numpy()
    assert np.array_equal(got, np.asarray(jdelayfx.delay_automated(x, c,
                                                                   SR)))


@pytest.mark.parametrize("threshold", ["static", "per-sample"])
def test_compressor_bitwise(threshold):
    x = _signal()
    thr = 0.15 if threshold == "static" else _up(_curve(0.0, 0.4))
    got = dynamics.compressor(_t(x), _t(thr), 0.25).numpy()
    assert np.array_equal(got, np.asarray(jdynamics.compressor(x, thr,
                                                               0.25)))


def test_toy_effect_bitwise():
    x = _signal()
    assert np.array_equal(simple.toy_effect(_t(x)).numpy(),
                          np.asarray(jsimple.toy_effect(jnp.asarray(x))))


@pytest.mark.parametrize("voices,seconds,mix", [(1, 0.02, 1.0),
                                                (3, 0.02, 1.0),
                                                (4, 0.0113, 0.4)])
def test_chorus_bitwise(voices, seconds, mix):
    x = _signal()
    got = delayfx.chorus(_t(x), voices, seconds, SR, mix).numpy()
    assert np.array_equal(got, np.asarray(jdelayfx.chorus(x, voices,
                                                          seconds, SR, mix)))


@pytest.mark.parametrize("case", ["delay", "voices", "both", "mix"])
def test_chorus_automated_bitwise(case):
    x = _signal()
    d = _curve(0.001, 0.03) if case != "voices" else 0.02
    vb = _curve(1.0, 4.0, seed=2) if case in ("voices", "both") else None
    maxv = jdelayfx.chorus_curve_max_voices(vb) if vb is not None else None
    mix = _up(_curve(0.2, 1.0, seed=3)) if case == "mix" else 1.0
    got = delayfx.chorus_automated(
        _t(x), 3, _t(d), SR, wet_dry_mix=_t(mix), voices_b=_t(vb),
        max_voices=maxv).numpy()
    ref = jdelayfx.chorus_automated(x, 3, d, SR, wet_dry_mix=mix,
                                    voices_b=vb, max_voices=maxv)
    assert np.array_equal(got, np.asarray(ref))


# ---- the coefficients: at most 1 ulp apart ----------------------------------

def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_follower_and_comb_coefficients_within_an_ulp():
    secs = _up(_curve(0.0, 1.0))
    secs[:64] = 0.0  # the zero-seconds clamp and the comb's exact 0
    for s in (0.0, 0.01, 0.25, secs):
        got = dynamics._follower_coef(_t(s), SR)
        ref = jdynamics._follower_coef(s, SR)
        assert _ulps(np.asarray(got), ref) <= 1
    for d in (75, 220, 1310, 1927):
        for s in (0.0, 1.5, secs):
            got = delayfx.reverb_comb_g(_t(s), d, SR)
            assert _ulps(np.asarray(got), jdelayfx.reverb_comb_g(s, d, SR)) \
                <= 1


# ---- the recurrences: dBFS bars ------------------------------------------

def _one_pole_case(name):
    x = _signal()
    rng = np.random.default_rng(4)
    if name == "scalar":
        return x, 0.99, 0.01, -1
    if name == "per-element":
        a = rng.uniform(0.9, 0.9999, x.shape).astype(np.float32)
        return x, a, (1.0 - a).astype(np.float32), -1
    if name == "broadcast":
        a = rng.uniform(0.95, 0.999, N).astype(np.float32)
        return x, a, 1.0, -1
    xb = x.reshape(2, -1, 400)  # block space: scan over nb
    if name == "axis-2":
        return xb, 0.8, 1.0, -2
    # per-element coefficients along the scanned axis moved last, as
    # both packages read them: [D, nb]
    a = rng.uniform(0.5, 0.95, (400, 50)).astype(np.float32)
    return xb, a, 1.0, -2


# name -> bar in dBFS [measured]. The peak holds (max_decay, the
# follower) read lowest: a held peak decays through a product of up to
# thousands of r's, rounded in another order on each side; against a
# float64 serial loop the twin's max_decay reads -120.9 dBFS, groove_tpu's
# -110.3.
SCAN_BARS = {
    "one_pole/scalar": -140.0,  # [-148.2]
    "one_pole/per-element": -141.0,  # [-148.6]
    "one_pole/broadcast": -124.0,  # [-131.6]
    "one_pole/axis-2": -131.0,  # [-139.4]
    "one_pole/axis-2-per-element": -133.0,  # [-141.3]
    "max_decay/scalar": -121.0,  # [-129.3]
    "max_decay/per-sample": -102.0,  # [-110.3]
    "envelope_follower/static": -102.0,  # [-110.1]
    "envelope_follower/automated": -98.0,  # [-105.9]
    "compressor_smoothed/static": -128.0,  # [-135.7]
    "compressor_smoothed/automated": -102.0,  # [-110.1]
    "comb_feedback/1310": -130.0,  # [-137.6]
    "comb_feedback/1927": -133.0,  # [-141.3]
    "comb_feedback_automated/1636": -133.0,  # [-141.3]
    "allpass/220": -133.0,  # [-141.0]
    "allpass/75": -131.0,  # [-139.4]
    "reverb/static": -128.0,  # [-136.5]
    "reverb/zero-seconds": -130.0,  # [-138.5]
    "reverb_automated/trip": -127.0,  # [-135.0]
}


def _scan_pair(name):
    """(port result, reference result) of one SCAN_BARS case."""
    fn, case = name.split("/")
    x = _signal()
    if fn == "one_pole":
        xs, a, b, axis = _one_pole_case(case)
        return (iir.one_pole(_t(xs), _t(a), _t(b), axis=axis),
                jiir.one_pole(xs, a, b, axis=axis))
    mag = np.abs(x)
    if fn == "max_decay":
        r = 0.9995 if case == "scalar" else \
            (1.0 - _up(_curve(1e-5, 1e-3))).astype(np.float32)
        return (dynamics.max_decay(_t(mag), _t(r)),
                jdynamics.max_decay(mag, r))
    att, rel = 0.01, 0.25
    if case == "automated":
        att, rel = _up(_curve(0.0, 0.02, seed=5)), _up(_curve(0.0, 0.5))
    if fn == "envelope_follower":
        return (dynamics.envelope_follower(_t(x), _t(att), _t(rel), SR),
                jdynamics.envelope_follower(x, att, rel, SR))
    if fn == "compressor_smoothed":
        return (dynamics.compressor_smoothed(_t(x), 0.1, 0.3, _t(att),
                                             _t(rel), SR),
                jdynamics.compressor_smoothed(x, 0.1, 0.3, att, rel, SR))
    if fn == "comb_feedback":
        d = int(case)
        g = float(0.001 ** (d / (1.5 * SR)))
        return (delayfx.comb_feedback(_t(x), d, g),
                jdelayfx.comb_feedback(x, d, g))
    if fn == "comb_feedback_automated":
        d = int(case)
        g = np.array(jdelayfx.reverb_comb_g(_up(_curve(0.3, 2.0)), d, SR))
        return (delayfx.comb_feedback_automated(_t(x), d, _t(g)),
                jdelayfx.comb_feedback_automated(x, d, g))
    if fn == "allpass":
        d = int(case)
        return delayfx.allpass(_t(x), d), jdelayfx.allpass(x, d)
    if fn == "reverb":
        s = 1.5 if case == "static" else 0.0
        return (delayfx.reverb(_t(x), 0.5, s, SR),
                jdelayfx.reverb(x, 0.5, s, SR))
    c = _curve(0.3, 2.0)
    return (delayfx.reverb_automated(_t(x), 0.5, _t(c), SR),
            jdelayfx.reverb_automated(x, 0.5, c, SR))


@pytest.mark.parametrize("name", list(SCAN_BARS))
def test_scan_based_function_matches_reference(name):
    got, ref = _scan_pair(name)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 1e-3
    db = _db(got, ref)
    assert db <= SCAN_BARS[name], f"{name}: {db:.1f} dBFS"


def test_instantaneous_follower_is_the_magnitude():
    x = _signal()
    assert torch.equal(dynamics.envelope_follower(_t(x), 0.0, 0.0, SR),
                       torch.abs(_t(x)))


# ---- the twin on its own --------------------------------------------------

def _serial64(x, a, b, mode):
    """A serial float64 loop over the last axis."""
    x, a, b = (np.broadcast_to(np.asarray(v, np.float64), x.shape)
               for v in (x, a, b))
    y = np.zeros(x.shape)
    acc = np.zeros(x.shape[:-1])
    for k in range(x.shape[-1]):
        acc = (a[..., k] * acc + b[..., k] * x[..., k] if mode == 0
               else np.maximum(x[..., k], a[..., k] * acc))
        y[..., k] = acc
    return y


@pytest.mark.parametrize("mode", [scan_kernels.LINEAR,
                                  scan_kernels.MAX_DECAY])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 65, 2049, 9000])
def test_twin_against_a_serial_loop(mode, n):
    """Chunk edges (C = 32 up to n = 8192, then 64): the three passes
    against a float64 serial loop, within float32 roundoff of a decaying
    recurrence."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    if mode == scan_kernels.MAX_DECAY:
        x = np.abs(x)
    a = rng.uniform(0.9, 0.999, (3, n)).astype(np.float32)
    got = scan_kernels.scan1(_t(x), _t(a), 0.5, mode=mode).numpy()
    ref = _serial64(x, a, 0.5 if mode == 0 else 0.0, mode)
    assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())


def test_chunk_for():
    assert [scan_kernels.chunk_for(s) for s in
            (1, 8192, 8193, 441000, 7938048, 10**9)] == \
        [32, 32, 64, 256, 1024, 2048]


@pytest.mark.parametrize("mode", [scan_kernels.LINEAR,
                                  scan_kernels.MAX_DECAY])
def test_twin_strides_equal_a_contiguous_copy(mode):
    """Block space [R, nb, D] along -2 (lanes x steps through strides), a
    strided x, and stride-0 coefficients equal the same scan of
    contiguous copies, bit for bit."""
    rng = np.random.default_rng(7)
    x = _t(np.abs(rng.standard_normal((2, 300, 75)).astype(np.float32)))
    a_row = _t(rng.uniform(0.5, 0.99, (300, 75)).astype(np.float32))
    a = a_row.expand(2, -1, -1)  # stride 0 over rows
    got = scan_kernels.scan1(x, a, 1.0, axis=-2, mode=mode)
    flat = scan_kernels.scan1(x.transpose(1, 2).contiguous(),
                              a.transpose(1, 2).contiguous(), 1.0, mode=mode)
    assert torch.equal(got, flat.transpose(1, 2))
    wide = _t(rng.standard_normal((2, 2 * N)).astype(np.float32))
    strided = wide[:, ::2]
    assert not strided.is_contiguous()
    assert torch.equal(scan_kernels.scan1(strided, 0.97, 0.03, mode=mode),
                       scan_kernels.scan1(strided.contiguous(), 0.97, 0.03,
                                          mode=mode))
    per = _t(rng.uniform(0.9, 0.99, N).astype(np.float32))
    assert torch.equal(
        scan_kernels.scan1(strided, per, 1.0, mode=mode),
        scan_kernels.scan1(strided, per.expand(2, -1).contiguous(), 1.0,
                           mode=mode))


def test_wrapper_counts_only_card_launches_and_refuses_other_devices():
    before = dict(scan_kernels.LAUNCHES)
    scan_kernels.scan1(torch.ones(2, 100), 0.5)
    assert scan_kernels.LAUNCHES == before
    with pytest.raises(RuntimeError, match="unsupported device"):
        scan_kernels.scan1(torch.ones(2, 100, device="meta"), 0.5)
    with pytest.raises(TypeError, match="float32"):
        scan_kernels.scan1(torch.ones(2, 100, dtype=torch.float64), 0.5)
    with pytest.raises(ValueError, match="no mode"):
        scan_kernels.scan1(torch.ones(2, 100), 0.5, mode=-1)


# ---- the analogues end to end ---------------------------------------------

ANALOGUES = {
    # name: (project at about 2 s, bar vs groove_tpu dBFS, samples allowed
    #        more than 1e-4 from groove_tpu)
    "kitchen-sink": (lambda: synth.kitchen_sink_project(1), -114.0, 4),
    "perf-1": (lambda: synth.perf1_project(8), -129.0, 4),
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)


@pytest.fixture(scope="module")
def renders(assets):
    """name -> (groove_tpu compiled, its render with the Pallas kernels
    interpreted, the port's CPU render)."""
    from groove_tpu.ops import pallas_iir

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jiir, "USE_PALLAS", True)
        mp.setattr(pallas_iir, "FORCE_INTERPRET", True)
        for name, (make, *_) in ANALOGUES.items():
            text = json.dumps(make())
            jc = jax_compile(JaxSongSettings.from_json5_str(text),
                             JaxPaths(roots=[assets]))
            tc = compile_song(SongSettings.from_json5_str(text),
                              Paths(roots=[assets]))
            out[name] = (jc, np.asarray(JaxRenderer(jc).render()),
                         Renderer(tc, device="cpu").render())
    return out


@pytest.mark.parametrize("name", list(ANALOGUES))
def test_analogue_matches_reference_kernels(renders, name):
    _, ref, got = renders[name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert 0.05 < np.abs(got).max() < 1.0
    db = _db(got, ref)
    assert db <= ANALOGUES[name][1], f"{name}: {db:.1f} dBFS"
    assert int((np.abs(got - ref) > 1e-4).sum()) <= ANALOGUES[name][2]


@pytest.mark.parametrize("name", list(ANALOGUES))
def test_analogue_against_f64_reference(renders, name):
    from tools.f64_reference import render_f64

    jc, ref_jax, got = renders[name]
    ref = render_f64(jc)
    port_db, jax_db = _db(got, ref), _db(ref_jax, ref)
    assert port_db <= -80.0 and port_db <= jax_db + 3.0, (port_db, jax_db)


def test_kitchen_sink_takes_every_route(renders):
    """Every effect kind of the reference's _apply_effect is in the
    kitchen-sink analogue, with its trips and sidechain routes."""
    jc = renders["kitchen-sink"][0]
    kinds = {d.kind for d in jc.devices.values()}
    assert {"compressor", "delay", "chorus", "reverb", "toy", "gain",
            "limiter", "bitcrusher", "filter-low-pass-24db",
            "signal-passthrough-controller"} <= kinds
    automated = {(u, p) for u, d in jc.devices.items() for p in d.automation}
    assert automated == {(u, p) for u, (_, _, trip, _) in
                         synth.KITCHEN_SINK.items() for p in trip}
    assert {(t, p) for _, t, p in jc.sidechain} == {
        ("comp-sc", "threshold"), ("delay-sc", "delay")}


@pytest.mark.parametrize("name", list(ANALOGUES))
def test_scan_launch_plan(assets, monkeypatch, name):
    """A render makes the planned scans: two for each smoothing
    compressor, six for each reverb (kitchen sink: 2 * 2 + 2 * 6; perf-1:
    one reverb)."""
    calls = []
    plain = scan_kernels._plain
    monkeypatch.setattr(scan_kernels, "_plain",
                        lambda *a: calls.append(1) or plain(*a))
    c = compile_song(SongSettings.from_json(ANALOGUES[name][0]()),
                     Paths(roots=[assets]))
    r = Renderer(c, "cpu")
    r.render()
    assert len(calls) == {"kitchen-sink": 16, "perf-1": 6}[name]


def test_unknown_effect_warns_and_passes_through(assets, capsys):
    p = synth.north_star_project()
    p["devices"][1] = {"effect": [synth.FILTER_UVID, {"reverb": {
        "attenuation": 0.5, "seconds": 0.2}}]}
    p["trips"] = []
    c = compile_song(SongSettings.from_json(p), Paths(roots=[assets]))
    c.devices[synth.FILTER_UVID].kind = "no-such-effect"
    r = Renderer(c, "cpu")
    got = r.render()
    c.devices[synth.FILTER_UVID].kind = "mixer"
    assert np.array_equal(got, Renderer(c, "cpu").render())
    assert "unknown effect kind no-such-effect" in capsys.readouterr().err


def test_effects_render_without_jax(assets, tmp_path):
    """A process that refuses jax and groove_tpu renders the kitchen-sink
    analogue through the CLI to a WAV equal to the Renderer's."""
    project = synth.write_project(tmp_path / "kitchen-sink.json",
                                  synth.kitchen_sink_project(1))
    code = f"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "groove_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, _Refuse())
import numpy as np
from groove_tpu_torch import cli
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import SongSettings
song = SongSettings.from_project_file({str(project)!r})
q = Renderer(compile_song(song, Paths()), "cpu").render_quantized()
assert cli.main([{str(project)!r}, "--wav", "--perf", "--device", "cpu",
                 "--out-dir", {str(tmp_path / "out")!r}]) == 0
x, rate = read_wav({str(tmp_path / "out" / "kitchen-sink.wav")!r})
assert x.shape == q.shape and np.abs(q).max() > 1000
assert np.array_equal(np.round(x * 32768).astype(np.int16), q)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "groove_tpu")]
print("JAX-FREE OK", q.shape)
"""
    env = dict(os.environ, GROOVE_ASSETS=str(assets), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
