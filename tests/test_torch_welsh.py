"""The sliced Welsh voice of groove_tpu_torch against groove_tpu's:
oscillators, envelope, the host control constants (copies statement for
statement, and equal results), the stream kernels' twins K7/K8 against the
reference kernels run through the Pallas interpreter, and
render_notes_slice against the reference for both carried-state layouts
('p4' and 'p20'). Inputs are made with numpy from fixed seeds; every bar
is set from a measurement recorded beside it (CPU)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.models import voices as jvoices
from groove_tpu.models import welsh as jwelsh
from groove_tpu.ops import envelope as jenv
from groove_tpu.ops import oscillator as josc
from groove_tpu.ops import pallas_iir
from groove_tpu.project.patches import WelshPatchSettings as JPatch
from groove_tpu_torch.models import voices as tvoices
from groove_tpu_torch.models import welsh as twelsh
from groove_tpu_torch.ops import envelope as tenv
from groove_tpu_torch.ops import iir, iir_kernels
from groove_tpu_torch.ops import oscillator as tosc
from groove_tpu_torch.project.patches import WelshPatchSettings as TPatch
from groove_tpu_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
SR = 44100.0

# (port module, reference module) -> functions copied whole
HOST_COPIES = {
    ("models/welsh.py", "models/welsh.py"): (
        "_sustained_pole_coeffs", "needs_filter_refinement",
        "_crosses_serial", "host_gate_seconds", "host_osc_constants",
        "_host_wave", "host_lfo_table", "host_pitch_phases",
        "host_filter_tables", "unison_notes", "unison_input_notes",
        "tail_seconds", "can_slice", "slice_time_bases", "_sh_cycles"),
    ("models/voices.py", "models/voices.py"): ("bucket_notes",),
    ("engine/stream.py", "engine/stream.py"): ("channel_symmetric",
                                               "_unfold_mono"),
    ("ops/oscillator.py", "ops/oscillator.py"): ("parse_waveform",
                                                 "hard_sync_phase"),
}


def _functions(path: Path) -> dict:
    """Top-level function name -> ast dumps of its arguments and of its
    body less the docstring."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant):
                body = body[1:]
            out[node.name] = [ast.dump(node.args)] + [ast.dump(s)
                                                      for s in body]
    return out


@pytest.mark.parametrize("modules", list(HOST_COPIES), ids=lambda m: m[0])
def test_host_functions_are_the_originals(modules):
    port, ref = modules
    mine = _functions(REPO / "groove_tpu_torch" / port)
    theirs = _functions(REPO / "groove_tpu" / ref)
    for name in HOST_COPIES[modules]:
        assert mine[name] == theirs[name], f"{port}:{name}"


def _voices(raw: dict):
    text = json.dumps(raw)
    return (JPatch.from_json_str(text).derive_welsh_voice_params(),
            TPatch.from_json_str(text).derive_welsh_voice_params())


VOICES = {
    "pad": synth.WELSH_PAD,
    "lead": synth.WELSH_LEAD,
    "sync-pw-noise-lfo": dict(
        synth.WELSH_LEAD, **{
            "oscillator-1": {"waveform": {"pulse-width": 0.3},
                             "tune": {"float": 1.0}, "mix-pct": 1.0},
            "oscillator-2": {"waveform": "triangle", "tune": {"float": 1.5},
                             "mix-pct": 0.5},
            "oscillator-2-sync": True,
            "lfo": {"routing": "filter-cutoff", "waveform": "noise",
                    "frequency": 6.0, "depth": {"pct": 0.2}}}),
    "resonance-lfo": dict(
        synth.WELSH_PAD, lfo={"routing": "resonance", "waveform": "triangle",
                              "frequency": 2.0, "depth": {"pct": 0.5}}),
    "pitch-lfo-sync": dict(
        synth.WELSH_LEAD, **{
            "oscillator-2-sync": True,
            "lfo": {"routing": "pitch", "waveform": "triangle",
                    "frequency": 4.0, "depth": {"pct": 0.1}}}),
    "pw-lfo": dict(
        synth.WELSH_LEAD, **{
            "oscillator-1": {"waveform": {"pulse-width": 0.4},
                             "tune": {"float": 1.0}, "mix-pct": 1.0},
            "lfo": {"routing": "pulse-width", "waveform": "sine",
                    "frequency": 3.0, "depth": {"pct": 0.6}}}),
}


@pytest.fixture
def kernel_routing(monkeypatch):
    """The reference routes as it does with its kernels available."""
    from groove_tpu.ops import iir as jiir

    monkeypatch.setattr(jiir, "USE_PALLAS", True)


@pytest.mark.parametrize("name", list(VOICES))
def test_host_constants_match(name, kernel_routing):
    pj, pt = _voices(VOICES[name])
    rng = np.random.default_rng(3)
    keys = rng.integers(36, 84, 9).astype(np.float32)
    gate = rng.integers(1, 40, 9).astype(np.int64) * 1024
    span = int(gate.max()) + 70_000
    assert twelsh.filter_fidelity_mode(pt, SR) == \
        jwelsh.filter_fidelity_mode(pj, SR) != "serial"
    pairs = [
        (twelsh.host_osc_constants(pt, keys),
         jwelsh.host_osc_constants(pj, keys)),
        (twelsh.host_gate_seconds(gate, SR),
         jwelsh.host_gate_seconds(gate, SR)),
        (twelsh.host_filter_tables(pt, gate, span, SR),
         jwelsh.host_filter_tables(pj, gate, span, SR)),
        (twelsh.host_lfo_table(pt, span, SR) or {},
         jwelsh.host_lfo_table(pj, span, SR) or {}),
        (twelsh.host_pitch_phases(pt, keys, None, 5000, SR) or {},
         jwelsh.host_pitch_phases(pj, keys, None, 5000, SR) or {}),
    ]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    for a, b in zip(twelsh.slice_time_bases(span, SR),
                    jwelsh.slice_time_bases(span, SR)):
        assert np.array_equal(a, b)
    tabs = twelsh.host_filter_tables(pt, gate, span, SR)
    got = twelsh.gather_filter_rows(
        {k: torch.from_numpy(np.asarray(v)) for k, v in tabs.items()})
    want = jwelsh.gather_filter_rows(tabs)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for sec_t, sec_j in zip(got[1], want[1]):
        for c_t, c_j in zip(sec_t, sec_j):
            assert np.array_equal(c_t.numpy(), np.asarray(c_j))


def test_routing_of_the_welsh_analogue(kernel_routing):
    """The pad's resonant low resting cutoff parks its poles next to
    z = 1 (refined cascade, K8); the lead's bright filter does not (K7)."""
    for raw, mode in ((synth.WELSH_PAD, "refine"), (synth.WELSH_LEAD, None)):
        pj, pt = _voices(raw)
        assert twelsh.filter_fidelity_mode(pt, SR) == mode
        assert jwelsh.filter_fidelity_mode(pj, SR) == mode
        assert twelsh.can_slice(pt)


def test_bucket_notes_match():
    rng = np.random.default_rng(4)
    need = rng.integers(100, 300_000, 200)
    for cap in (50_000, 400_000):
        got = tvoices.bucket_notes(need, cap)
        want = jvoices.bucket_notes(need, cap)
        assert [(s, list(i)) for s, i in got] == \
            [(s, list(i)) for s, i in want]


@pytest.mark.parametrize("kind", ["sine", "square", "sawtooth", "triangle",
                                  "triangle-sine", "none", "debug-max",
                                  "debug-min", "pulse-width"])
def test_waveforms_match(kind):
    """Every waveform but the sine is exact float32 arithmetic: equal.
    The sine is float64 rounded once in the port and XLA's float32 sine
    in the reference: measured at most 1 ulp of 1.0 apart (5.96e-8),
    bar 1.2e-7."""
    rng = np.random.default_rng(5)
    phase = (rng.uniform(0.0, 3000.0, (4, 4096))).astype(np.float32)
    got = tosc.evaluate(kind, torch.from_numpy(phase), 0.3).numpy()
    want = np.asarray(josc.evaluate(kind, jnp.asarray(phase), 0.3))
    assert got.dtype == np.float32
    if kind in ("sine", "triangle-sine"):
        assert np.max(np.abs(got - want)) <= 1.2e-7
    else:
        assert np.array_equal(got, want)
    ratio = rng.uniform(0.5, 3.0, (4, 1)).astype(np.float32)
    assert np.array_equal(
        tosc.hard_sync_phase(torch.from_numpy(phase),
                             torch.from_numpy(ratio)).numpy(),
        np.asarray(josc.hard_sync_phase(jnp.asarray(phase),
                                        jnp.asarray(ratio))))
    for params in ({"waveform": "square"}, {"waveform": {"pulse-width": 0.2}},
                   {}):
        assert tosc.parse_waveform(params) == josc.parse_waveform(params)


def test_phase_from_const_freq_matches():
    f = np.array([110.0, 440.0, 1234.5], np.float32)
    got = tosc.phase_from_const_freq(torch.from_numpy(f), 5000, SR).numpy()
    want = np.asarray(josc.phase_from_const_freq(jnp.asarray(f), 5000, SR))
    # a true division in the port; measured equal to the reference
    assert np.array_equal(got, want)


ENVELOPES = [(0.01, 0.1, 0.8, 0.4), (0.3, 1.6, 0.2, 1.6), (0.0, 0.0, 1.0, 0.0),
             (0.05, 0.0, 0.5, 0.2)]


@pytest.mark.parametrize("env", ENVELOPES)
def test_adsr_matches(env):
    """Host (numpy) inputs: the reference's numpy expressions, bit for bit.
    Tensor inputs (true divisions by float32 tensors) against the
    reference's jax evaluation: measured equal."""
    t = (np.arange(0, 200_000, 37, dtype=np.float32)
         / np.float32(SR))[None, :]
    gate = (np.array([1, 500, 44100, 88200], np.float32)
            / np.float32(SR))[:, None]
    got = tenv.adsr(t, gate, *env)
    want = jenv.adsr(t, gate, *env)
    assert type(got) is type(want) and np.array_equal(got, want)
    got_t = tenv.adsr(torch.from_numpy(t), torch.from_numpy(gate),
                      *env).numpy()
    want_j = np.asarray(jenv.adsr(jnp.asarray(t), jnp.asarray(gate), *env))
    assert got_t.dtype == np.float32 and np.array_equal(got_t, want_j)


# ---- the stream kernels' twins against the interpreted reference kernels


def _stream_inputs(refined: bool, rows: int, n: int, seed: int):
    """A cascade input [rows, n] and block-rate sections: a sweep that
    rests near the corner for K8 (q 2), a bright one for K7."""
    rng = np.random.default_rng(seed)
    nb = n // 64
    lo, hi, q = (0.05, 0.5, 2.0) if refined else (0.4, 0.9, 0.707)
    cut = (25.0 * 800.0 ** np.linspace(lo, hi, nb)).astype(np.float32)
    gain, secs = iir.lp24_sections(cut, np.float32(q), SR)
    x = (rng.standard_normal((rows, n)) * 0.3
         * np.repeat(gain, 64)).astype(np.float32)
    secs = [tuple(np.ascontiguousarray(np.broadcast_to(
        np.asarray(c, np.float32), (rows, nb))) for c in s) for s in secs]
    return x, secs


def _cut(secs, a: int, b: int, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return [tuple(conv(np.ascontiguousarray(c[:, a // 64:b // 64]))
                  for c in s) for s in secs]


# name -> (refined, state rows, bar on y in dBFS of the peak, bar on the
# exported state relative to its largest entry). Measured (CPU): K7 y
# -129.1 dBFS, state 9.2e-8; K8 y -134.9 dBFS, state 2.1e-7 (ulps
# apart where XLA contracts what the twins round separately).
STREAM_KERNELS = {"K7": (False, 4, -121.0, 4e-7),
                  "K8": (True, 20, -127.0, 8e-7)}


def _state_err(got, want) -> float:
    """Largest difference of two states relative to the state's largest
    entry (K8's correction pairs hold rounding-level residuals, about
    1e-10, which no two evaluation orders share)."""
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", list(STREAM_KERNELS))
def test_stream_kernel_twins_match_reference(name, monkeypatch):
    from groove_tpu.ops import iir as jiir

    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    refined, rows_st, bar_db, bar_st = STREAM_KERNELS[name]
    f_j = (pallas_iir.lp24_refined_blockrate_stream_pallas if refined
           else pallas_iir.lp24_blockrate_stream_pallas)
    f_t = (iir_kernels.lp24_refined_blockrate_stream if refined
           else iir_kernels.lp24_blockrate_stream)
    B, n = 3, 2048
    h = n // 2
    x, secs = _stream_inputs(refined, B, n, seed=7)
    zero_j = jnp.zeros((B, rows_st), jnp.float32)
    zero_t = torch.zeros((B, rows_st))
    # the whole call from zero state, both packages
    yj, sj = f_j(jnp.asarray(x), _cut(secs, 0, n, "jax"), zero_j,
                 interpret=True)
    yt, st = f_t(torch.from_numpy(x), _cut(secs, 0, n, "torch"), zero_t)
    yj, sj = np.asarray(yj), np.asarray(sj)
    peak = float(np.abs(yj).max())
    assert peak > 0.05
    db = 20 * np.log10(np.max(np.abs(yt.numpy() - yj)) / peak + 1e-30)
    assert db <= bar_db, db
    assert st.shape == (B, rows_st)
    assert _state_err(st.numpy(), sj) <= bar_st
    # chained halves through the state: bitwise the whole call
    ya, sa = f_t(torch.from_numpy(x[:, :h].copy()), _cut(secs, 0, h, "torch"),
                 zero_t)
    yb, sb = f_t(torch.from_numpy(x[:, h:].copy()), _cut(secs, h, n, "torch"),
                 sa)
    assert torch.equal(torch.cat([ya, yb], 1), yt) and torch.equal(sb, st)
    # the reference's exported state carries into the port's second half
    _, sja = f_j(jnp.asarray(x[:, :h]), _cut(secs, 0, h, "jax"), zero_j,
                 interpret=True)
    yb2, sb2 = f_t(torch.from_numpy(x[:, h:].copy()),
                   _cut(secs, h, n, "torch"),
                   torch.from_numpy(np.asarray(sja)))
    db2 = 20 * np.log10(np.max(np.abs(yb2.numpy() - yj[:, h:])) / peak
                        + 1e-30)
    assert db2 <= bar_db, db2
    assert _state_err(sb2.numpy(), sj) <= bar_st


def test_stream_kernels_at_zero_state_are_k2_and_k3():
    """With zero state, K8 is K2 and K7 is K3 wherever those pin ln = 64
    (n <= 4096): bitwise."""
    x, secs = _stream_inputs(True, 2, 2048, seed=8)
    xt, st = torch.from_numpy(x), _cut(secs, 0, 2048, "torch")
    assert iir_kernels.geometry(2048)[0] == 64
    y8, _ = iir_kernels.lp24_refined_blockrate_stream(xt, st,
                                                      torch.zeros(2, 20))
    y7, _ = iir_kernels.lp24_blockrate_stream(xt, st, torch.zeros(2, 4))
    assert torch.equal(y8, iir_kernels.lp24_refined_blockrate(xt, st))
    assert torch.equal(y7, iir_kernels.lp24_blockrate(xt, st))


def test_stream_kernels_refuse_unaligned_length():
    x, secs = _stream_inputs(False, 1, 1024, seed=9)
    with pytest.raises(ValueError, match="n % 64"):
        iir_kernels.lp24_blockrate_stream(
            torch.from_numpy(x[:, :1000].copy()), _cut(secs, 0, 1024, "torch"),
            torch.zeros(1, 4))


# ---- render_notes_slice against the reference --------------------------

# (fidelity, host constants shipped) -> bar in dBFS of the peak. Measured
# (CPU, three 4096-frame slices of three notes of the 'lead' voice with
# its LFO on the amplitude): host constants -138.4 (p4) / -134.9 (p20);
# traced filter design (float64 exp rounded once vs XLA's float32 exp)
# -111.0 / -111.0.
# The 'sync-pw-noise-lfo' voice (hard sync, pulse width, an S&H noise LFO
# on the cutoff): -139.4 with host constants, -101.9 traced.
SLICE_BARS = {("lead", None, True): -130.0, ("lead", "refine", True): -127.0,
              ("lead", None, False): -103.0,
              ("lead", "refine", False): -103.0,
              ("sync-pw-noise-lfo", None, True): -131.0,
              ("sync-pw-noise-lfo", None, False): -93.0}


@pytest.mark.parametrize("voice,fidelity,host", list(SLICE_BARS),
                         ids=["p4-host", "p20-host", "p4-traced",
                              "p20-traced", "sync-host", "sync-traced"])
def test_render_notes_slice_matches_reference(voice, fidelity, host,
                                              monkeypatch):
    from groove_tpu.ops import iir as jiir

    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)
    pj, pt = _voices(VOICES[voice])
    span, S = 8192, 4096
    keys = np.array([60.0, 64.0, 67.0], np.float32)
    vels = np.array([100.0, 90.0, 80.0], np.float32)
    gate = np.array([4096, 6144, 2048], np.int32)
    ids = np.array([0, 5, 9], np.int32)
    tf, tbf = jwelsh.slice_time_bases(span, SR)
    hcj = hct = None
    if host:
        hcj, hct = {}, {}
        for mod, hc in ((jwelsh, hcj), (twelsh, hct)):
            p = pj if mod is jwelsh else pt
            hc.update(mod.host_osc_constants(p, keys))
            hc.update(mod.host_gate_seconds(gate, SR))
            hc.update(mod.host_filter_tables(p, gate.astype(np.int64), span,
                                             SR))
            hc.update(mod.host_lfo_table(p, span, SR) or {})
    stj = jwelsh.slice_state_init(2, fidelity)
    stt = twelsh.slice_state_init(2, fidelity)
    key = "p20" if fidelity else "p4"
    assert set(stj) == set(stt) == {key}
    outj, outt = [], []
    for i in range(3):
        a0 = np.array([-S + i * S, i * S, i * S], np.int32)
        yj, stj = jwelsh.render_notes_slice(
            pj, keys, vels, gate, a0, S, SR, stj, tf, tbf, note_ids=ids,
            fidelity=fidelity, host_ctl=hcj)
        yt, stt = twelsh.render_notes_slice(
            pt, torch.from_numpy(keys), torch.from_numpy(vels),
            torch.from_numpy(gate), torch.from_numpy(a0), S, SR, stt,
            torch.from_numpy(tf), torch.from_numpy(tbf),
            note_ids=torch.from_numpy(ids), fidelity=fidelity,
            host_ctl=hct)
        outj.append(np.asarray(yj))
        outt.append(yt.numpy())
    yj, yt = np.concatenate(outj, 1), np.concatenate(outt, 1)
    peak = float(np.abs(yj).max())
    assert peak > 0.1 and np.array_equal(yj == 0, yt == 0)
    db = 20 * np.log10(np.max(np.abs(yt - yj)) / peak + 1e-30)
    assert db <= SLICE_BARS[(voice, fidelity, host)], db
    assert stt[key].shape == np.asarray(stj[key]).shape
