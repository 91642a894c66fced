"""Welsh dual-oscillator subtractive voice (port of
groove_tpu/models/welsh.py: its host constants, whole-window and sliced
render paths).

    osc1/osc2 (optional hard sync) -> mix (+ noise) -> 24 dB low-pass whose
    cutoff the filter envelope (and optionally the LFO) drives -> amp
    envelope -> DCA

Host half: the HOST-designed control constants (oscillator frequencies,
gate seconds, the per-sample LFO table, pitch-LFO phase tables, the
block-rate cascade coefficient tables deduplicated by gate, the S&H bank)
and the routing predicates, in numpy. They are copies of the reference's
functions, statement for statement where they are whole numpy functions
(tests/test_torch_welsh.py holds them so); the S&H bank draws from
ops/prng.py instead of jax.random, bit for bit, and filter_fidelity_mode
takes the reference's kernel routing ('refine' or None, never 'serial').

Whole-window half (the offline Renderer): render_notes_parts renders
every note's whole window [n, span] up to the cascade, apply_cascade runs
the cascade over all rows in one call of K2 (refined) or K3 (single
pass) of ops/iir_kernels.py, and render_notes does both with the amp
envelope. Phases are closed forms of the note age (glide included); only
pitch-LFO voices integrate, from host phase tables or, past their cap,
through oscillator.phase_from_freq.

Slice half (the streaming renderer): one segment-sized slice [age0,
age0 + S) of every note's window, with the cascade state carried per note
across slices in the stream kernels K7 (plain cascade, state 'p4'
[rows, 4]) and K8 (refined cascade, 'p20' [rows, 20]). Time bases are
gathers of host constants at absolute note ages (slice_rows), so every
slice sees the same values whatever the segmentation; the noise is drawn
at the window's own threefry counters.

Device-independent bits on both paths: quotients are true divisions by
float32 tensors (ops/envelope.py, vels / 127, the time bases), and the
sine waveform and every exp, exp2 and log run in float64 rounded once.
A pitch-LFO phase integrated on the device (phase_from_freq) is the one
exception: its cumulative sum groups differently on every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from groove_tpu_torch.core import types as T
from groove_tpu_torch.ops import envelope as env_ops
from groove_tpu_torch.ops import iir as iir_ops
from groove_tpu_torch.ops import iir_kernels
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops import prng, stream_kernels
from groove_tpu_torch.project.patches import WelshVoiceParams
from groove_tpu_torch.models.fm import in_block_sums
from groove_tpu_torch.models.voices import f32 as _f32, live_freqs, \
    note_freqs, row_sum

LN_BASE = float(np.log(T.FREQUENCY_TO_LINEAR_BASE))
LN_COEF = float(np.log(T.FREQUENCY_TO_LINEAR_COEFFICIENT))


def _sustained_pole_coeffs(params: WelshVoiceParams,
                           sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
    """Pole coefficients (a1, a2) of the voice's 24 dB cascade at every
    SUSTAINED operating point — resting (env = 0) and held (env = sustain)
    cutoffs, widened by the LFO depth when the LFO routes to the cutoff,
    and at q*(1 +/- depth) when it routes to 'resonance'. HOST-only."""
    fe = params.filter_envelope
    sustained_envs = [0.0, float(fe.sustain)]
    pts = [params.filter_cutoff_start
           + (params.filter_cutoff_end - params.filter_cutoff_start) * e
           for e in sustained_envs]
    if params.lfo.routing in ("filter-cutoff", "cutoff-amp"):
        pts = [p + s * params.lfo.depth for p in pts for s in (-1.0, 1.0)]
    pcts = np.clip(np.asarray(pts, np.float64), 0.0, 1.0)
    hz = np.exp(LN_COEF + pcts * LN_BASE).astype(np.float32)
    q0 = max(params.filter_q, 1e-3)
    qs = [q0]
    if params.lfo.routing == "resonance":
        d = abs(params.lfo.depth)
        # runtime: q = max(q*(1 + lfo*depth), 0.1), lfo bipolar in [-1, 1]
        qs += [max(q0 * (1.0 - d), 0.1), q0 * (1.0 + d)]
    a1s, a2s = [], []
    for q in qs:
        _, secs = iir_ops.lp24_sections(hz, np.float32(q), sample_rate)
        a1s.append(np.stack([np.asarray(s[3]) for s in secs]))
        a2s.append(np.stack([np.asarray(s[4]) for s in secs]))
    return np.concatenate(a1s), np.concatenate(a2s)


def needs_filter_refinement(params: WelshVoiceParams,
                            sample_rate: float = 44100.0) -> bool:
    """Host-side fidelity check for the voice's internal 24 dB cascade: a
    SUSTAINED operating point (_sustained_pole_coeffs) near z = 1 takes
    the defect-correction pass."""
    a1, a2 = _sustained_pole_coeffs(params, sample_rate)
    return iir_ops.needs_refinement(a1, a2)


def _crosses_serial(a1: np.ndarray, a2: np.ndarray) -> bool:
    """The static-serial threshold predicate."""
    return bool(((a1 < iir_ops._CRITICAL_A1)
                 & (a2 > iir_ops._CRITICAL_A2)).any())


# host_ctl entries that are PER-NOTE rows (axis 0 is the note batch; the
# stream gathers them by the segment's note indices). Everything else in a
# host-ctl dict (coefficient tables) passes through whole.
HOST_CTL_PER_NOTE = ("f1", "f2", "rsync", "rgl", "fidx", "ph1", "ph2",
                     "phm", "phc", "gs")


def host_gate_seconds(gate_frames, sample_rate: float) -> dict:
    """HOST per-note gate-seconds rows {"gs": [n] f32} — the same f32
    division that builds the host time base t, so at note age j == gate
    the envelope comparison t < gate_s sees exactly equal bits."""
    return {"gs": (np.asarray(gate_frames, np.float32)
                   / np.float32(sample_rate))}


def host_osc_constants(params: WelshVoiceParams, keys,
                       prev_keys=None) -> dict:
    """Per-note oscillator frequency constants, HOST numpy f32: f1/f2 [n]
    post-tune (f2 honors the fixed-Hz override), rsync [n] = f2/f1 when
    the patch syncs, rgl [n] = 2^((prev-key)/12) when gliding."""
    keys = np.asarray(keys, np.float32)
    base = note_freqs(keys)  # numpy path (backend-generic)
    f1 = np.asarray(base * params.oscillator_1.tune_ratio, np.float32)
    if params.oscillator_2_fixed_hz is not None:
        f2 = np.full_like(f1, params.oscillator_2_fixed_hz)
    else:
        f2 = np.asarray(base * params.oscillator_2.tune_ratio, np.float32)
    out = {"f1": f1, "f2": f2}
    if params.oscillator_2_sync \
            and params.oscillator_1.waveform.kind != "none":
        out["rsync"] = np.asarray(f2 / np.maximum(f1, np.float32(1e-6)),
                                  np.float32)
    if params.glide > 0.0 and prev_keys is not None:
        out["rgl"] = np.asarray(
            np.exp2((np.asarray(prev_keys, np.float32) - keys)
                    / np.float32(12.0)), np.float32)
    return out


def _host_wave(kind: str, phase: np.ndarray, width: float) -> np.ndarray:
    """numpy mirror of osc_ops.evaluate for HOST control curves.
    Formula-identical; noise is handled by the caller (threefry bank)."""
    fr = phase - np.floor(phase)
    if kind in ("sine", "triangle-sine"):
        # mod-1-reduced like osc_ops.sine (exact; keeps formula identity)
        return np.sin(np.float32(2.0 * np.pi) * fr)
    if kind == "square":
        return np.where(fr < 0.5, np.float32(1.0), np.float32(-1.0))
    if kind == "pulse-width":
        return np.where(fr < width, np.float32(1.0), np.float32(-1.0))
    if kind == "sawtooth":
        return np.float32(2.0) * fr - np.float32(1.0)
    if kind == "triangle":
        return np.where(fr < 0.5, np.float32(4.0) * fr - np.float32(1.0),
                        np.float32(3.0) - np.float32(4.0) * fr)
    # full osc_ops table mirror (ADVICE r4): debug-max/-min are constants,
    # so a pitch-LFO voice renders identically whether or not the host
    # phase table shipped
    if kind == "debug-max":
        return np.ones_like(phase)
    if kind == "debug-min":
        return -np.ones_like(phase)
    return np.zeros_like(phase)


def sh_bank(n_cycles: int, noise_seed: int = 0,
            device="cpu") -> torch.Tensor:
    """The S&H LFO bank: jax.random.uniform(fold_in(PRNGKey(noise_seed),
    7), (n_cycles,), f32, -1, 1), bit for bit."""
    return prng.uniform(
        prng.fold_in(prng.prng_key(noise_seed, device), 7), (n_cycles,),
        -1.0, 1.0)


def _host_lfo_values(lfo, t, span: int, sample_rate: float,
                     noise_seed: int = 0) -> np.ndarray:
    """HOST numpy-f32 mirror of _make_lfo_value (offline, non-wrapping
    S&H bank) at note-age times t (any shape): the LFO's bipolar value *
    depth."""
    lphase = np.float32(lfo.frequency) * t
    if lfo.waveform.kind == "noise":
        n_cycles = _sh_cycles(lfo, span, sample_rate)
        vals = sh_bank(n_cycles, noise_seed).numpy()
        cyc = np.clip(np.floor(lphase).astype(np.int64), 0, n_cycles - 1)
        return (vals[cyc] * np.float32(lfo.depth)).astype(np.float32)
    return (_host_wave(lfo.waveform.kind, lphase, lfo.waveform.pulse_width)
            * np.float32(lfo.depth)).astype(np.float32)


#: LFO routings whose value feeds PER-SAMPLE terms (the pulse-width edge
#: position and the amp scale) rather than only phases/coefficients
_LFO_SAMPLE_ROUTINGS = ("amplitude", "cutoff-amp", "pulse-width",
                        "pw-osc1", "pw-osc2")


def host_lfo_table(params: WelshVoiceParams, span: int, sample_rate: float,
                   noise_seed: int = 0) -> dict | None:
    """HOST per-sample LFO value table {"lv": [span] f32} for routings
    whose value enters the signal math per sample (amplitude scale,
    pulse-width edge position) — or None when no such routing is active.
    The LFO restarts at note-on, so one row serves every note."""
    lfo = params.lfo
    if not (lfo.routing in _LFO_SAMPLE_ROUTINGS and lfo.frequency > 0.0
            and lfo.depth != 0.0):
        return None
    t = (np.arange(span, dtype=np.float32)
         / np.float32(sample_rate))[None, :]
    lv = _host_lfo_values(lfo, t, span, sample_rate, noise_seed)
    return {"lv": np.broadcast_to(lv, (1, span))[0].copy()}


#: element cap for shipping host pitch-LFO phase tables
HOST_PHASE_MAX_ELEMS = 32_000_000


def host_pitch_phases(params: WelshVoiceParams, keys, prev_keys,
                      span: int, sample_rate: float,
                      noise_seed: int = 0,
                      max_elems: int = HOST_PHASE_MAX_ELEMS) -> dict | None:
    """HOST (numpy f32) oscillator PHASE tables for pitch-LFO patches
    (serial f32 cumsum of the modulated frequency); {"ph1","ph2":
    [n, span]} or None. Rows are computed in chunks."""
    lfo = params.lfo
    routing = lfo.routing
    if not (routing in ("pitch", "pitch-osc2") and lfo.frequency > 0.0
            and lfo.depth != 0.0):
        return None
    keys = np.asarray(keys, np.float32)
    n = len(keys)
    if n == 0 or n * span > max_elems:
        return None
    hc = host_osc_constants(params, keys, prev_keys)
    sr = np.float32(sample_rate)
    t = (np.arange(span, dtype=np.float32) / sr)[None, :]
    lfo_val = _host_lfo_values(lfo, t, span, sample_rate, noise_seed)
    glide_on = params.glide > 0.0 and prev_keys is not None
    rgl = hc.get("rgl")
    o1_active = params.oscillator_1.waveform.kind != "none"
    o2_tracks = params.oscillator_2_fixed_hz is None

    def rows(lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        m = hi - lo
        rglc = None if rgl is None else rgl[lo:hi]

        def gl_factor():
            u = np.maximum(np.float32(1.0) - t / np.float32(params.glide),
                           np.float32(0.0))
            return np.exp(u * np.log(rglc[:, None])).astype(np.float32)

        def freq(name, is_osc2):
            f = hc[name][lo:hi, None]
            if routing == "pitch" or (routing == "pitch-osc2" and is_osc2):
                f = (f * np.exp2(lfo_val)).astype(np.float32)
            return np.broadcast_to(f, (m, span)).astype(np.float32)

        def phase(f, glides=True):
            if glide_on and glides:
                f = (f * gl_factor()).astype(np.float32)
            inc = f / sr
            ph = np.cumsum(inc, axis=-1, dtype=np.float32)
            return np.concatenate(
                [np.zeros_like(ph[:, :1]), ph[:, :-1]], axis=-1)

        f1 = freq("f1", False)
        ph1 = phase(f1)
        if params.oscillator_2_sync and o1_active:
            ratio = np.broadcast_to(hc["rsync"][lo:hi, None],
                                    (m, span)).astype(np.float32)
            if routing == "pitch-osc2":
                ratio = (ratio * np.exp2(lfo_val)).astype(np.float32)
            if glide_on and not o2_tracks:
                ratio = (ratio / gl_factor()).astype(np.float32)
            ph2 = ((ph1 - np.floor(ph1)) * ratio).astype(np.float32)
        else:
            f2 = freq("f2", True)
            ph2 = phase(f2, glides=o2_tracks)
        return ph1.astype(np.float32), ph2.astype(np.float32)

    rows_per = max(1, 2_000_000 // max(span, 1))
    if rows_per >= n:
        ph1, ph2 = rows(0, n)
        return {"ph1": ph1, "ph2": ph2}
    out1 = np.empty((n, span), np.float32)
    out2 = np.empty((n, span), np.float32)
    for lo in range(0, n, rows_per):
        hi = min(n, lo + rows_per)
        out1[lo:hi], out2[lo:hi] = rows(lo, hi)
    return {"ph1": out1, "ph2": out2}


def host_filter_tables(params: WelshVoiceParams, gate_frames, span: int,
                       sample_rate: float, noise_seed: int = 0) -> dict | None:
    """HOST (numpy f32) block-rate cascade coefficient tables for the
    voice's internal 24 dB filter, deduplicated by gate length:
      fidx  [n] int32  — per-note row index into the tables
      fgain [u, nb] f32 — per-block input gain
      fsecs [2, 5, u, nb] f32 — per-section (b0,b1,b2,a1,a2) coefficients
    LFO-driven routings (filter-cutoff / cutoff-amp / resonance) are
    designed here too (the LFO is a function of note age alone)."""
    lfo = params.lfo
    lfo_active = (lfo.routing != "none" and lfo.frequency > 0.0
                  and lfo.depth != 0.0)
    lfo_filter = lfo_active and lfo.routing in ("filter-cutoff",
                                                "cutoff-amp", "resonance")
    gate = np.asarray(gate_frames, np.int64)
    uniq, fidx = np.unique(gate, return_inverse=True)
    cblock = iir_ops.CONTROL_BLOCK
    nb = -(-span // cblock)
    # same construction as render_notes_parts' t_blk / gate_s (numpy ns)
    t_blk = (np.arange(nb, dtype=np.float32) * cblock)[None, :] \
        / np.float32(sample_rate)
    gate_s = (uniq.astype(np.float32) / np.float32(sample_rate))[:, None]
    fe = params.filter_envelope
    f_env = env_ops.adsr(t_blk, gate_s, fe.attack, fe.decay, fe.sustain,
                         fe.release)
    cutoff_pct = params.filter_cutoff_start + (
        params.filter_cutoff_end - params.filter_cutoff_start) * f_env
    lfo_blk = None
    if lfo_filter:
        # block-rate LFO term, host mirror of _filter_controls' formulas
        lfo_blk = _host_lfo_values(lfo, t_blk, span, sample_rate,
                                   noise_seed)                   # [1, nb]
        if lfo.routing in ("filter-cutoff", "cutoff-amp"):
            cutoff_pct = cutoff_pct + lfo_blk
    cutoff_pct = np.clip(cutoff_pct, 0.0, 1.0)
    cutoff_hz = np.exp(np.float32(LN_COEF)
                       + cutoff_pct * np.float32(LN_BASE)).astype(np.float32)
    if lfo_filter and lfo.routing == "resonance":
        # q = max(q * (1 + lfo*depth), 0.1) — _filter_controls' rule
        q = np.maximum(np.float32(params.filter_q)
                       * (np.float32(1.0) + lfo_blk),
                       np.float32(0.1)).astype(np.float32)       # [1, nb]
        q = np.broadcast_to(q, cutoff_hz.shape)
    else:
        q = np.float32(max(params.filter_q, 1e-3))
    gain, secs = iir_ops.lp24_sections(cutoff_hz, q, sample_rate)
    u = len(uniq)
    fsecs = np.empty((2, 5, u, nb), np.float32)
    for i, sec in enumerate(secs):
        for j, c in enumerate(sec):
            fsecs[i, j] = np.broadcast_to(np.asarray(c, np.float32), (u, nb))
    return {"fidx": fidx.astype(np.int32),
            "fgain": np.broadcast_to(
                np.asarray(gain, np.float32), (u, nb)).copy(),
            "fsecs": fsecs}


def filter_fidelity_mode(params: WelshVoiceParams,
                         sample_rate: float = 44100.0) -> str | None:
    """Host routing for the voice's internal cascade, with the reference's
    kernel (Pallas-available) semantics: 'refine' for near-critical
    sustained points (the refined stream kernel K8), else None (K7). The
    reference's 'serial' is its CPU fallback's route; with kernels, the
    fused refined cascade is the accuracy path at the deep corner."""
    a1, a2 = _sustained_pole_coeffs(params, sample_rate)
    if iir_ops.needs_refinement(a1, a2):
        return "refine"
    return None


#: Unison detune: the classic +/-7-cent three-voice stack.
UNISON_CENTS = 7.0


def unison_notes(keys, vels, on_frames, off_frames, prev_keys=None):
    """Host-side unison TRIPLING for the render engines' note inputs:
    -> (keys f32, vels, on, off, prev) with each note replaced by three
    copies at -/0/+ UNISON_CENTS detune and vel/3."""
    n = len(keys)
    rep = np.repeat(np.arange(n), 3)
    det_semi = np.float32(UNISON_CENTS / 100.0)
    det = np.tile(np.array([-det_semi, 0.0, det_semi], np.float32), n)
    keys3 = np.asarray(keys, np.float32)[rep] + det
    vels3 = (np.asarray(vels, np.float32) / 3.0)[rep]
    on3 = np.asarray(on_frames)[rep]
    off3 = np.asarray(off_frames)[rep]
    prev3 = None if prev_keys is None \
        else np.asarray(prev_keys, np.float32)[rep] + det
    return keys3, vels3, on3, off3, prev3


def unison_input_notes(notes, voice):
    """The ONE place engines turn a device's NoteTensors into render
    input arrays -> (keys, vels, on, off, prev): tripled via unison_notes
    when the voice sets unison, verbatim otherwise."""
    k, v, on, off, pv = (notes.keys, notes.vels, notes.on_frames,
                         notes.off_frames, notes.prev_keys)
    if getattr(voice, "unison", False) and len(k):
        return unison_notes(k, v, on, off, pv)
    return k, v, on, off, pv


def tail_seconds(params: WelshVoiceParams) -> float:
    return max(params.amp_envelope.release, 0.0)


def can_slice(params: WelshVoiceParams) -> bool:
    """Pitch-modulated phases integrate a cumsum over the whole window
    and cannot be sliced; glide patches keep the unsliced path too."""
    lfo = params.lfo
    pitch_mod = (lfo.routing in ("pitch", "pitch-osc2")
                 and lfo.frequency > 0.0 and lfo.depth != 0.0)
    return not pitch_mod and params.glide <= 0.0


def slice_time_bases(span: int, sample_rate: float):
    """Host constants the slice path gathers from: t_full [span] note-age
    seconds and tb_full [nb] control-block times."""
    cblock = iir_ops.CONTROL_BLOCK
    nb = -(-span // cblock)
    t_full = np.arange(span, dtype=np.float32) / np.float32(sample_rate)
    tb_full = (np.arange(nb, dtype=np.float32) * cblock
               ) / np.float32(sample_rate)
    return t_full, tb_full


def _sh_cycles(lfo, span: int, sample_rate: float) -> int:
    """Offline S&H bank size: cycles covering the whole note window."""
    return int(np.ceil(span * lfo.frequency / sample_rate)) + 2


# ---------------------------------------------------------------------------
# Shared voice-formula terms (torch, on the render's device)


#: S&H bank size for the LIVE paths' noise LFO: live note ages are
#: unbounded, so the bank wraps (offline banks cover the whole window and
#: clip). threefry is prefix-stable, so the first cycles equal an offline
#: bank drawn from the same key.
_LIVE_SH_CYCLES = 8192

# live S&H banks by (cycles, seed, device): drawn once, not every block
_LIVE_BANKS: dict = {}


def _live_bank(n_cycles: int, noise_seed: int, device) -> torch.Tensor:
    key = (n_cycles, noise_seed, str(torch.device(device)))
    if key not in _LIVE_BANKS:
        _LIVE_BANKS[key] = sh_bank(n_cycles, noise_seed, device)
    return _LIVE_BANKS[key]


def _make_lfo_value(lfo, n_cycles: int, noise_seed: int, device,
                    wrap: bool = False):
    """-> lfo_value(tv): the LFO's bipolar value * depth at times tv
    (seconds since note-on), or [1, 1] zeros when the LFO is inert.
    'noise' is sample-and-hold at the LFO rate from a bank of n_cycles
    values: wrap=True indexes it mod n_cycles (live: a fixed bank, drawn
    once per device), else clipped (offline: the bank covers the
    window)."""
    if not (lfo.routing != "none" and lfo.frequency > 0.0
            and lfo.depth != 0.0):
        return lambda tv: torch.zeros((1, 1), dtype=torch.float32,
                                      device=device)

    def lfo_value(tv):
        lfo_phase = lfo.frequency * tv
        if lfo.waveform.kind == "noise":
            cycle = torch.floor(lfo_phase).to(torch.int64)
            if wrap:
                vals = _live_bank(n_cycles, noise_seed, device)
                idx = torch.remainder(cycle, n_cycles)
            else:
                vals = sh_bank(n_cycles, noise_seed, device)
                idx = torch.clamp(cycle, 0, n_cycles - 1)
            return vals[idx] * lfo.depth
        return osc_ops.evaluate(
            lfo.waveform.kind, lfo_phase, lfo.waveform.pulse_width
        ) * lfo.depth

    return lfo_value


def _osc_mix(params: WelshVoiceParams, phase1, phase2, routing, lfo_val,
             noise_fn, shape):
    """Oscillator signals -> mixed output [shape]: waveform evaluation
    (with the pulse-width LFO routings), the mix-share rule, and the noise
    mix-in. noise_fn(which) supplies white noise shaped [shape] for
    oscillator slot `which` (1/2) or the mix-in (3)."""
    device = phase1.device

    def sig(osc, phase, which):
        kind = osc.waveform.kind
        if kind == "none":
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if kind == "pulse-width":
            width = osc.waveform.pulse_width
            if routing == "pulse-width" or routing == f"pw-osc{which}":
                width = torch.clamp(width + 0.5 * lfo_val, 0.01, 0.99)
            return osc_ops.pulse_width(phase, width)
        if kind == "noise":
            return noise_fn(which)
        return osc_ops.evaluate(kind, phase)

    s1 = sig(params.oscillator_1, phase1, 1)
    s2 = sig(params.oscillator_2, phase2, 2)
    o1_active = params.oscillator_1.waveform.kind != "none"
    o2_active = params.oscillator_2.waveform.kind != "none"
    mix = params.oscillator_mix
    if o1_active and o2_active:
        osc_out = mix * s1 + (1.0 - mix) * s2
    elif o1_active:
        osc_out = s1
    elif o2_active:
        osc_out = s2
    else:
        osc_out = torch.zeros(shape, dtype=torch.float32, device=device)
    if params.noise > 0.0:
        osc_out = osc_out * (1.0 - params.noise) + noise_fn(3) * params.noise
    return osc_out


def _filter_controls(params: WelshVoiceParams, t_blk, gate_s, lfo_value):
    """Block-rate filter controls -> (cutoff_hz, q) at control times t_blk:
    cutoff pct driven by the filter envelope (and the cutoff/resonance LFO
    routings), through the hearing-range map 25*800^pct (exp in float64,
    rounded once)."""
    fe = params.filter_envelope
    f_env = env_ops.adsr(t_blk, gate_s, fe.attack, fe.decay, fe.sustain,
                         fe.release)
    cutoff_pct = params.filter_cutoff_start + (
        params.filter_cutoff_end - params.filter_cutoff_start
    ) * f_env
    routing = params.lfo.routing
    if routing in ("filter-cutoff", "cutoff-amp"):
        cutoff_pct = cutoff_pct + lfo_value(t_blk)
    cutoff_pct = torch.clamp(cutoff_pct, 0.0, 1.0)
    cutoff_hz = torch.exp((LN_COEF + cutoff_pct * LN_BASE).double()).float()
    q = params.filter_q
    if routing == "resonance":
        q = torch.clamp_min(q * (1.0 + lfo_value(t_blk)), 0.1)
    return cutoff_hz, q


def _amp_env(params: WelshVoiceParams, t, gate_s, vels, routing, lfo_val):
    """Amp envelope * velocity (+ the amplitude LFO routings) at times t."""
    ae = params.amp_envelope
    a_env = env_ops.adsr(t, gate_s, ae.attack, ae.decay, ae.sustain,
                         ae.release)
    v = _f32(vels, t.device)[:, None]
    amp = a_env * torch.div(v, _f32(127.0, t.device))
    if routing in ("amplitude", "cutoff-amp"):
        amp = amp * (1.0 + lfo_val)
    return amp


def _exp2(v: torch.Tensor) -> torch.Tensor:
    """2^v in float64, rounded once to float32."""
    return torch.exp2(v.double()).float()


# ---------------------------------------------------------------------------
# WHOLE-WINDOW rendering: every note's whole window [n, span] at once
# (engine/render's offline Renderer).


def _glide_factor(r, T: float, t):
    """Instantaneous glide multiplier g(t) = r^max(1 - t/T, 0): the pitch
    starts at r x the target frequency (r = f_prev/f_target) and slides
    exponentially to 1 over T seconds (constant-time portamento). log and
    exp in float64, rounded once."""
    u = torch.clamp_min(1.0 - torch.div(t, _f32(T, t.device)), 0.0)
    lr = torch.log(r.double()).float()
    return torch.exp((u * lr).double()).float()


def _glide_phase(f, r, T: float, t):
    """Closed-form phase of the exponential glide (integral of
    f * _glide_factor): f*T*(r - r^u)/ln r + f*max(t - T, 0) with
    u = max(1 - t/T, 0) and the r -> 1 limit f*t (guarded |ln r|)."""
    lr = torch.log(r.double()).float()
    small = torch.abs(lr) < 1e-6
    safe = torch.where(small, 1.0, lr)
    u = torch.clamp_min(1.0 - torch.div(t, _f32(T, t.device)), 0.0)
    ph = torch.div(f * T * (r - torch.exp((u * safe).double()).float()),
                   safe) + f * torch.clamp_min(t - T, 0.0)
    return torch.where(small, f * t, ph)


def render_notes_parts(
    params: WelshVoiceParams,
    keys,
    vels,
    gate_frames,
    span: int,
    sample_rate: float,
    noise_seed: int = 0,
    note_ids=None,
    prev_keys=None,
    host_ctl=None,
):
    """Everything but the cascade, on keys' device: (osc_out [n, span],
    filt, amp [n, span]) where filt tags the cascade controls — ("secs",
    gain_rows [n, nb], secs_rows) when host_ctl ships the coefficient
    tables (host_filter_tables), else ("hz", cutoff_b [n, nb], q_b
    [n, nb]) designed here.

    host_ctl: the host control constants of the batch (host_osc_constants,
    host_gate_seconds, host_filter_tables, host_lfo_table,
    host_pitch_phases), numpy or tensors. note_ids: [n] note identities
    for the noise keying (default arange). prev_keys: [n] glide-source
    keys; None (or glide == 0) keeps the glide-free graph. The time base
    is a true division on the device (the host constant's bits)."""
    keys = torch.as_tensor(keys)
    device = keys.device
    keys = keys.to(torch.float32)
    n_notes = keys.shape[0]
    if note_ids is None:
        note_ids = torch.arange(n_notes, dtype=torch.int64, device=device)
    sr = _f32(sample_rate, device)
    t = torch.div(torch.arange(span, dtype=torch.float32, device=device),
                  sr)[None, :]                                  # [1, span]
    hc = {k: torch.as_tensor(v, device=device)
          for k, v in (host_ctl or {}).items()}
    gate_s = _f32(hc["gs"], device)[:, None] if "gs" in hc \
        else torch.div(_f32(torch.as_tensor(gate_frames), device),
                       sr)[:, None]

    lfo = params.lfo
    lfo_value = _make_lfo_value(lfo, _sh_cycles(lfo, span, sample_rate),
                                noise_seed, device)
    routing = lfo.routing
    lfo_val = hc["lv"][None, :] if "lv" in hc else lfo_value(t)  # [1, span]
    pitch_modulated = routing in ("pitch", "pitch-osc2")
    glide_on = params.glide > 0.0 \
        and (prev_keys is not None or "rgl" in hc)
    if glide_on:
        if "rgl" in hc:
            r_gl = _f32(hc["rgl"], device)[:, None]
        else:
            prev = _f32(torch.as_tensor(prev_keys), device)
            r_gl = _exp2((prev.double() - keys.double()) / 12.0)[:, None]

    def osc_freq(osc, fixed_hz, is_osc2):
        name = "f2" if is_osc2 else "f1"
        if name in hc:
            f = _f32(hc[name], device)[:, None]
        elif fixed_hz is not None:
            f = torch.full((n_notes, 1), float(np.float32(fixed_hz)),
                           dtype=torch.float32, device=device)
        else:
            base = (440.0 * torch.exp2((keys.double() - 69.0) / 12.0)
                    ).float()[:, None]
            f = base * osc.tune_ratio
        if routing == "pitch" or (routing == "pitch-osc2" and is_osc2):
            f = f * _exp2(lfo_val)
        return f.expand(n_notes, span)

    def osc_phase(f, glides=True):
        if pitch_modulated:
            if glide_on and glides:
                f = f * _glide_factor(r_gl, params.glide, t)
            return osc_ops.phase_from_freq(f, sample_rate)
        if glide_on and glides:
            return _glide_phase(f, r_gl, params.glide, t)
        # constant per-note frequency: closed-form phase, no cumsum drift
        return f * t

    def noise_fn(which):
        # rows keyed by note identity: a note draws the same noise in any
        # batch
        return osc_ops.noise_rows(
            prng.fold_in(prng.prng_key(noise_seed, device), which),
            note_ids, span)

    shape = (n_notes, span)
    if "ph1" in hc:
        # pitch-LFO phases are host tables (host_pitch_phases)
        osc_out = _osc_mix(params, hc["ph1"], hc["ph2"], routing, lfo_val,
                           noise_fn, shape)
        return _parts_filter_amp(params, hc, osc_out, t, gate_s, vels,
                                 routing, lfo_val, lfo_value, n_notes,
                                 span, sample_rate)
    o1_active = params.oscillator_1.waveform.kind != "none"
    f1 = osc_freq(params.oscillator_1, None, False)
    f2 = osc_freq(params.oscillator_2, params.oscillator_2_fixed_hz, True)
    o2_tracks = params.oscillator_2_fixed_hz is None
    phase1 = osc_phase(f1)
    if params.oscillator_2_sync and o1_active:
        # hard sync: osc2's phase resets at each osc1 wrap (closed form)
        if "rsync" in hc:
            ratio = _f32(hc["rsync"], device)[:, None].expand(shape)
            if routing == "pitch-osc2":
                ratio = ratio * _exp2(lfo_val)
        else:
            ratio = torch.div(f2, torch.clamp_min(f1, 1e-6))
        if glide_on and not o2_tracks:
            # osc2 holds its fixed pitch while osc1 glides underneath
            ratio = torch.div(ratio, _glide_factor(r_gl, params.glide, t))
        phase2 = osc_ops.hard_sync_phase(phase1, ratio)
    else:
        phase2 = osc_phase(f2, glides=o2_tracks)
    osc_out = _osc_mix(params, phase1, phase2, routing, lfo_val, noise_fn,
                       shape)
    return _parts_filter_amp(params, hc, osc_out, t, gate_s, vels, routing,
                             lfo_val, lfo_value, n_notes, span, sample_rate)


def _parts_filter_amp(params, hc, osc_out, t, gate_s, vels, routing,
                      lfo_val, lfo_value, n_notes: int, span: int,
                      sample_rate: float):
    """render_notes_parts' tail (filter controls + amp envelope), shared
    by the traced-phase and host-phase-table paths."""
    if "fgain" in hc:
        gain_rows, secs_rows = gather_filter_rows(hc)
        filt = ("secs", gain_rows, secs_rows)
    else:
        cblock = iir_ops.CONTROL_BLOCK
        nb = -(-span // cblock)
        t_blk = torch.div(
            torch.arange(nb, dtype=torch.float32, device=t.device) * cblock,
            _f32(sample_rate, t.device))[None, :]
        cutoff_hz, q = _filter_controls(params, t_blk, gate_s, lfo_value)
        q_b = _f32(q, t.device).expand(n_notes, nb)
        filt = ("hz", cutoff_hz.expand(n_notes, nb), q_b)
    amp = _amp_env(params, t, gate_s, vels, routing, lfo_val)
    return osc_out, filt, amp


def apply_cascade(osc_out, filt, sample_rate: float, fidelity=None):
    """Run the 24 dB cascade from a render_notes_parts filt value: host
    coefficient tables ("secs") through iir.lp24_apply_blockrate_sections,
    controls designed on the device ("hz") through lp24_apply_blockrate
    (K2 for fidelity 'refine', else K3)."""
    if filt[0] == "secs":
        return iir_ops.lp24_apply_blockrate_sections(
            osc_out, filt[1], filt[2], fidelity=fidelity)
    return iir_ops.lp24_apply_blockrate(
        osc_out, filt[1], filt[2], sample_rate, fidelity=fidelity)


def render_notes(
    params: WelshVoiceParams,
    keys,
    vels,
    gate_frames,
    span: int,
    sample_rate: float,
    noise_seed: int = 0,
    refine_filter=False,
    note_ids=None,
    prev_keys=None,
    host_ctl=None,
) -> torch.Tensor:
    """Render all notes -> mono [n_notes, span]. refine_filter: a fidelity
    mode string (filter_fidelity_mode) or a bool ('refine' when true). See
    render_notes_parts for note_ids, prev_keys and host_ctl."""
    osc_out, filt, amp = render_notes_parts(
        params, keys, vels, gate_frames, span, sample_rate,
        noise_seed=noise_seed, note_ids=note_ids, prev_keys=prev_keys,
        host_ctl=host_ctl)
    fidelity = refine_filter if isinstance(refine_filter, str) \
        else ("refine" if refine_filter else None)
    return apply_cascade(osc_out, filt, sample_rate, fidelity) * amp


# ---------------------------------------------------------------------------
# SLICED rendering: one segment-sized slice of every note's window, with
# the cascade state carried across slices (engine/stream WELSH_SLICED).


def slice_rows(table: torch.Tensor, age0: torch.Tensor, S: int,
               span: int) -> torch.Tensor:
    """Per-row window fetch: row i gets table[age0_i + j] for j in [0, S),
    with ZERO fill outside [0, span) (every consumer masks those)."""
    age = age0.to(torch.int64)[:, None] + torch.arange(
        int(S), dtype=torch.int64, device=age0.device)
    valid = (age >= 0) & (age < span)
    vals = table[age.clamp(0, max(span - 1, 0))]
    return torch.where(valid, vals, torch.zeros((), dtype=table.dtype,
                                                device=table.device))


def slice_state_init(count: int, mode, device="cpu") -> dict:
    """Carried cascade state for `count` note slots plus one SCRATCH slot
    (index `count`) that padded batch rows read and write, so they can
    never corrupt a real note's state: 'p20' [rows, 20] for the refined
    cascade (mode 'refine' or 'serial', K8), else 'p4' [rows, 4] (K7) —
    the reference's layouts with kernels available."""
    rows = count + 1
    if mode in ("refine", "serial"):
        return {"p20": torch.zeros((rows, 20), dtype=torch.float32,
                                   device=device)}
    return {"p4": torch.zeros((rows, 4), dtype=torch.float32, device=device)}


def render_notes_slice(
    params: WelshVoiceParams,
    keys,
    vels,
    gate_frames,
    age0,
    S: int,
    sample_rate: float,
    fstate: dict,
    t_full,
    tb_full,
    noise_seed: int = 0,
    note_ids=None,
    fidelity=None,
    host_ctl=None,
    noise_keys=None,
):
    """Render note-age slice [age0, age0+S) of each note -> (mono [n, S],
    new fstate). age0: [n] int, multiples of 64 (negative while the note
    hasn't started; past span once it has died — both exact zeros).
    fstate: per-ROW state (already gathered to the batch), see
    slice_state_init. noise_keys: optional {which: [n, 2]} per-note noise
    keys (oscillator.noise_keys), precomputed by a caller that renders the
    same notes every segment; derived from note_ids when absent."""
    y, secs_b, ctx = render_notes_slice_pre(
        params, keys, vels, gate_frames, age0, S, sample_rate,
        t_full, tb_full, noise_seed=noise_seed, note_ids=note_ids,
        host_ctl=host_ctl, noise_keys=noise_keys)
    y, new_state = cascade_slices(y, secs_b, fstate, fidelity)
    return finish_slice(params, y, ctx), new_state


def render_notes_slice_pre(
    params: WelshVoiceParams,
    keys,
    vels,
    gate_frames,
    age0,
    S: int,
    sample_rate: float,
    t_full,
    tb_full,
    noise_seed: int = 0,
    note_ids=None,
    host_ctl=None,
    noise_keys=None,
):
    """Everything before the cascade: osc mix + noise + window mask +
    filter-envelope sections + input gain. Returns (y [n, S] gained
    cascade input, secs_b block-rate sections, ctx for finish_slice).
    host_ctl: host control constants on the device (frequency rows, gate
    seconds, the LFO table, the coefficient tables over the FULL window's
    blocks, gathered at the slice's blocks); None designs on the device."""
    t_full = torch.as_tensor(t_full)
    device = t_full.device
    tb_full = torch.as_tensor(tb_full, device=device)
    keys = torch.as_tensor(keys, device=device).to(torch.float32)
    n = keys.shape[0]
    if note_ids is None:
        note_ids = torch.arange(n, dtype=torch.int64, device=device)
    span = t_full.shape[0]
    nb_total = tb_full.shape[0]
    cblock = iir_ops.CONTROL_BLOCK
    nb_seg = S // cblock
    age0 = torch.as_tensor(age0, device=device).to(torch.int64)

    ar = torch.arange(S, dtype=torch.int64, device=device)
    age = age0[:, None] + ar[None, :]                     # [n, S]
    valid = (age >= 0) & (age < span)
    t = slice_rows(t_full, age0, S, span)                 # [n, S] windows
    bk = torch.div(age0, cblock, rounding_mode="floor")[:, None] \
        + torch.arange(nb_seg, dtype=torch.int64, device=device)[None, :]

    hc0 = {k: torch.as_tensor(v, device=device)
           for k, v in (host_ctl or {}).items()}
    # host gate-seconds rows when shipped
    gate_s = _f32(hc0["gs"], device)[:, None] if "gs" in hc0 \
        else torch.div(_f32(torch.as_tensor(gate_frames), device),
                       _f32(sample_rate, device))[:, None]

    lfo = params.lfo
    # S&H bank sized from the WHOLE window (slice-invariant)
    lfo_value = _make_lfo_value(lfo, _sh_cycles(lfo, span, sample_rate),
                                noise_seed, device)
    routing = lfo.routing
    # pitch modulation is excluded by can_slice (cumsum phases)

    hc = hc0
    lfo_val = slice_rows(hc["lv"], age0, S, span) if "lv" in hc \
        else lfo_value(t)

    def osc_freq(osc, fixed_hz, name):
        if name in hc:
            f = _f32(hc[name], device)[:, None]
        elif fixed_hz is not None:
            f = torch.full((n, 1), float(np.float32(fixed_hz)),
                           dtype=torch.float32, device=device)
        else:
            base = (440.0 * torch.exp2((keys.double() - 69.0) / 12.0)
                    ).float()[:, None]
            f = base * osc.tune_ratio
        return f.expand(n, S)

    def noise_fn(which):
        # per-note keys by IDENTITY; the window drawn at its own counters
        # is bitwise the full row sliced (ops/oscillator.noise_window)
        nk = None if noise_keys is None else noise_keys.get(which)
        if nk is None:
            nk = osc_ops.noise_keys(
                prng.fold_in(prng.prng_key(noise_seed, device), which),
                note_ids)
        return osc_ops.noise_window(nk, age0, S, span)

    o1_active = params.oscillator_1.waveform.kind != "none"
    f1 = osc_freq(params.oscillator_1, None, "f1")
    f2 = osc_freq(params.oscillator_2, params.oscillator_2_fixed_hz, "f2")
    phase1 = f1 * t
    if params.oscillator_2_sync and o1_active:
        if "rsync" in hc:
            ratio = _f32(hc["rsync"], device)[:, None].expand(n, S)
        else:
            ratio = torch.div(f2, torch.clamp_min(f1, 1e-6))
        phase2 = osc_ops.hard_sync_phase(phase1, ratio)
    else:
        phase2 = f2 * t

    osc_out = _osc_mix(params, phase1, phase2, routing, lfo_val, noise_fn,
                       (n, S))

    # zero the out-of-window region BEFORE the filter: the cascade state
    # must stay exactly 0 until note-on, and junk past the window end
    # must not enter the recurrence
    osc_out = torch.where(valid, osc_out, 0.0)

    bkc = bk.clamp(0, nb_total - 1)
    if "fgain" in hc:
        # gather the slice's blocks from the host coefficient tables
        fidx = hc["fidx"].to(torch.int64)
        gain_b = torch.gather(hc["fgain"][fidx], 1, bkc)   # [n, nb_seg]
        fs = hc["fsecs"]
        secs_b = [tuple(torch.gather(fs[i, j][fidx], 1, bkc)
                        for j in range(5)) for i in range(2)]
    else:
        t_blk = tb_full[bkc]
        cutoff_hz, q = _filter_controls(params, t_blk, gate_s, lfo_value)
        q_b = _f32(q, device).expand(n, nb_seg)
        gain_b, secs_b = iir_ops.lp24_sections(
            cutoff_hz.expand(n, nb_seg), q_b, sample_rate)
    y = osc_out * iir_ops.upsample_hold(gain_b.expand(n, nb_seg), S, cblock)
    return y, secs_b, (t, gate_s, vels, lfo_val, valid, routing)


def cascade_slices(y, secs_b, fstate: dict, fidelity, cblock: int = 64):
    """The sliced cascade stage over a row batch [n, S] on the stream
    kernels: 'p20' state -> K8 (refined), 'p4' -> K7 (the key set decides,
    per slice_state_init). secs_b goes to the wrappers as it is:
    render_notes_slice_pre made it float32 [n, S / 64] on y's device, and
    the wrappers cast or expand only what is not. Returns (y, new_state)."""
    new_state = dict(fstate)
    if "p20" in fstate:
        y, new_state["p20"] = iir_kernels.lp24_refined_blockrate_stream(
            y, secs_b, fstate["p20"])
    elif "p4" in fstate:
        y, new_state["p4"] = iir_kernels.lp24_blockrate_stream(
            y, secs_b, fstate["p4"])
    else:
        raise ValueError(f"unknown sliced cascade state {sorted(fstate)}")
    return y, new_state


def finish_slice(params: WelshVoiceParams, y, ctx):
    """Post-cascade stage: amp envelope/velocity/LFO/window mask (ctx
    from render_notes_slice_pre)."""
    t, gate_s, vels, lfo_val, valid, routing = ctx
    return _slice_finish(params, y, t, gate_s, vels, lfo_val, valid,
                         routing)


def _slice_finish(params, y, t, gate_s, vels, lfo_val, valid, routing):
    """Amp envelope + velocity + LFO amplitude routing + window mask."""
    amp = _amp_env(params, t, gate_s, vels, routing, lfo_val)
    amp = torch.where(valid, amp, 0.0)
    return y * amp


def gather_filter_rows(host_ctl: dict):
    """A note batch's cascade coefficient rows from shipped host tables ->
    (gain_rows [n, nb], secs_rows 2x5-tuple of [n, nb]). Index copies: the
    table bits pass through exactly."""
    fidx = host_ctl["fidx"].to(torch.int64)
    gain_rows = host_ctl["fgain"][fidx]
    fs = host_ctl["fsecs"]
    secs_rows = [tuple(fs[i, j][fidx] for j in range(5)) for i in range(2)]
    return gain_rows, secs_rows


# ---------------------------------------------------------------------------
# LIVE rendering: a block at a time over a fixed voice pool, oscillator
# phases and the cascade state carried per voice (engine/livesong.py's
# live_window_block, engine/live.py's live_render_block).

LIVE_FAR = 2**30  # the pool's "held" / "unused" frame (engine/livesong.FAR)


def _sr(sample_rate: float, device) -> torch.Tensor:
    return _f32(sample_rate, device)


def live_phases(phase0: torch.Tensor, inc: torch.Tensor):
    """Exclusive phase integral of per-sample increments inc [R, n] (n a
    multiple of 64) from phase0 [R] -> (phase [R, n], next phase0 [R]).

    Each 64-frame block k: its inclusive in-block sums c (one scan1 call
    for every block of every row, fm.in_block_sums), then phase = (o_k +
    c) - inc from the block's origin o_k, and o_{k+1} = (phase at its last
    frame + its increment) mod 1 — the reference's per-block formula
    (ph0 + cumsum(inc) - inc, carried mod 1) applied at every 64 frames.
    The sums run in one fixed order on every device (no torch.cumsum),
    and a block of n frames gives the bits of n / 64 blocks of 64."""
    R, n = inc.shape
    nb = n // 64
    inc3 = inc.reshape(R, nb, 64)
    c = in_block_sums(inc3)
    origin = phase0
    origins = []
    for k in range(nb):
        origins.append(origin)
        last = (origin + c[:, k, 63]) - inc3[:, k, 63]
        origin = osc_ops.frac(last + inc3[:, k, 63])
    o = origins[0][:, None, None] if nb == 1 \
        else torch.stack(origins, 1)[:, :, None]
    return ((o + c) - inc3).reshape(R, n), origin


def _live_noise(which: int, t0: int, shape, device) -> torch.Tensor:
    """White noise keyed per block: fold_in(PRNGKey(which), t0) drawn at
    `shape` (a constant key would repeat one pattern every block)."""
    return osc_ops.noise(prng.fold_in(prng.prng_key(which, device), t0),
                         shape)


def _live_voice(params: WelshVoiceParams, t_abs, gate_s, vels, keys,
                prev_keys, ph1_0, ph2_0, s_a, s_b, t0: int, n: int,
                sample_rate: float, note_mask):
    """The shared body of the two live block renders -> (y [V, n] after
    the cascade, lfo_val, phase1, phase2, (s1a, s2a), (s1b, s2b)). t_abs
    [V, n]: note-age seconds; note_mask [V, n] (or None) gates the phase
    increments; the cascade's two sections run on S3
    (stream_kernels.biquad_state) with their 64-frame block coefficients
    and the carried (s1, s2)."""
    device = keys.device
    V = keys.shape[0]
    sr = _sr(sample_rate, device)
    if n % 64:
        raise ValueError(f"live welsh block must be a 64-multiple, got {n}")
    base_freq = live_freqs(keys)[:, None]
    lfo = params.lfo
    routing = lfo.routing
    # S&H noise LFO included: a fixed wrapping bank (live ages are
    # unbounded)
    lfo_value = _make_lfo_value(lfo, _LIVE_SH_CYCLES, 0, device, wrap=True)
    lfo_val = lfo_value(t_abs)

    def freq_of(osc, fixed_hz, is_osc2):
        if fixed_hz is not None:
            f = torch.full((V, 1), float(np.float32(fixed_hz)),
                           dtype=torch.float32, device=device)
        else:
            f = base_freq * osc.tune_ratio
        if routing == "pitch" or (routing == "pitch-osc2" and is_osc2):
            f = f * _exp2(lfo_val)
        return f.expand(V, n)

    f1 = freq_of(params.oscillator_1, None, False)
    f2 = freq_of(params.oscillator_2, params.oscillator_2_fixed_hz, True)
    if params.glide > 0.0 and prev_keys is not None:
        r_gl = _exp2(torch.div(
            prev_keys.double() - keys.double(),
            torch.full((), 12.0, dtype=torch.float64, device=device)))[:, None]
        gf = _glide_factor(r_gl, params.glide, t_abs)
        f1 = f1 * gf
        if params.oscillator_2_fixed_hz is None:
            f2 = f2 * gf
    inc1 = torch.div(f1, sr)
    inc2 = torch.div(f2, sr)
    if note_mask is not None:
        # samples before note-on do not advance the phase
        inc1 = inc1 * note_mask
        inc2 = inc2 * note_mask
    # both oscillators' integrals in one scan1 call
    ph, new_ph = live_phases(torch.cat([ph1_0, ph2_0]),
                             torch.cat([inc1, inc2]))
    ph1, ph2 = ph[:V], ph[V:]
    if params.oscillator_2_sync \
            and params.oscillator_1.waveform.kind != "none":
        ph2 = osc_ops.hard_sync_phase(
            ph1, torch.div(f2, torch.clamp_min(f1, 1e-6)))

    def noise_fn(which):
        return _live_noise(which, t0, (V, n), device)

    osc_out = _osc_mix(params, ph1, ph2, routing, lfo_val, noise_fn, (V, n))

    # filter controls at the 64-frame control cadence within the block
    nb = n // 64
    t_blk = t_abs[:, ::64][:, :nb]
    cutoff_hz, q = _filter_controls(params, t_blk, gate_s, lfo_value)
    gain_b, sections = iir_ops.lp24_sections(
        cutoff_hz.expand(V, nb), _f32(q, device).expand(V, nb), sample_rate)
    y = osc_out * iir_ops.upsample_hold(gain_b.expand(V, nb), n, 64)
    y, s_a = stream_kernels.biquad_state(
        y, tuple(c.expand(V, nb) for c in sections[0]), s_a)
    y, s_b = stream_kernels.biquad_state(
        y, tuple(c.expand(V, nb) for c in sections[1]), s_b)
    return y, lfo_val, new_ph[:V], new_ph[V:], s_a, s_b


def live_window_state_init(n_voices: int, device="cuda") -> dict:
    """Carried state for live_window_block: oscillator phases and the two
    TDF2 sections' states per voice (note bookkeeping stays on the
    host)."""
    z = torch.zeros((n_voices,), dtype=torch.float32, device=device)
    return {name: z.clone() for name in ("phase1", "phase2", "s1a", "s2a",
                                         "s1b", "s2b")}


def live_window_block(params: WelshVoiceParams, fstate: dict, keys, vels,
                      on_abs, off_abs, t0: int, n: int, sample_rate: float,
                      prev_keys=None):
    """Live full-graph voice block -> (mono [n], next fstate), the
    reference's live_window_block.

    Note data (keys, vels, absolute on/off frames, int32 on/off) arrives
    as tensors each block; a voice whose note starts at this block (on ==
    t0: the host pins note-ons to block boundaries) has its carried phases
    and filter state reset here. Envelopes, LFO and glide are closed forms
    of the integer note age; oscillator phases integrate per 64-frame
    block (live_phases); noise is keyed per block by fold_in(PRNGKey(which),
    t0); the two cascade sections run on S3 with their state carried."""
    device = keys.device
    sr = _sr(sample_rate, device)
    keys = keys.to(torch.float32)
    vels = vels.to(torch.float32)
    on = on_abs.to(torch.int32)[:, None]
    off = off_abs.to(torch.int32)[:, None]
    tj = (int(t0) + torch.arange(n, dtype=torch.int32,
                                 device=device))[None, :]
    age_i = tj - on                                         # [V, n] int32
    t_abs = torch.div(torch.clamp_min(age_i, 0).to(torch.float32), sr)
    gate_s = torch.div((off - on).to(torch.float32), sr)
    fresh = on[:, 0] == int(t0)
    started = age_i >= 0
    active = (vels > 0.0)[:, None]

    def fs(name):
        return torch.where(fresh, 0.0, fstate[name])

    pv = None if prev_keys is None else prev_keys.to(torch.float32)
    y, lfo_val, ph1, ph2, s_a, s_b = _live_voice(
        params, t_abs, gate_s, vels, keys, pv, fs("phase1"), fs("phase2"),
        (fs("s1a"), fs("s2a")), (fs("s1b"), fs("s2b")), t0, n, sample_rate,
        started)
    amp = _amp_env(params, t_abs, gate_s, vels, params.lfo.routing,
                   lfo_val) * active * started
    mono = row_sum(y * amp)
    return mono, {"phase1": ph1, "phase2": ph2, "s1a": s_a[0],
                  "s2a": s_a[1], "s1b": s_b[0], "s2b": s_b[1]}


@dataclass(frozen=True)
class LiveVoiceState:
    """Per-voice carried state of live_render_block ([V] each)."""

    phase1: torch.Tensor     # f32, cycles mod 1
    phase2: torch.Tensor
    s1a: torch.Tensor        # TDF2 state, filter section A
    s2a: torch.Tensor
    s1b: torch.Tensor        # section B
    s2b: torch.Tensor
    age: torch.Tensor        # i32 frames since note-on
    release_age: torch.Tensor  # i32 age at note-off (2**30 while held)
    keys: torch.Tensor       # f32 MIDI key
    vels: torch.Tensor       # f32 0..127 (0 = inactive)
    prev_keys: torch.Tensor  # f32 glide-source key (last played pitch)


def live_init_state(n_voices: int, device="cuda") -> LiveVoiceState:
    def z():
        return torch.zeros((n_voices,), dtype=torch.float32, device=device)

    return LiveVoiceState(
        z(), z(), z(), z(), z(), z(),
        torch.zeros((n_voices,), dtype=torch.int32, device=device),
        torch.full((n_voices,), LIVE_FAR, dtype=torch.int32, device=device),
        z(), z(), z())


def live_render_block(params: WelshVoiceParams, state: LiveVoiceState,
                      block: int, sample_rate: float, t0: int = 0):
    """One streaming block -> (mono [block], next state), the reference's
    live_render_block: note bookkeeping in the state, LFO and envelopes
    from the voice age, phases integrated per 64-frame block, the cascade
    on S3 with its state carried; t0 keys the noise per block."""
    device = state.keys.device
    sr = _sr(sample_rate, device)
    j = torch.arange(block, dtype=torch.float32, device=device)[None, :]
    t_abs = torch.div(state.age[:, None].to(torch.float32) + j, sr)
    gate_s = torch.div(torch.clamp_max(
        state.release_age.to(torch.float32), float(LIVE_FAR))[:, None], sr)
    y, lfo_val, ph1, ph2, s_a, s_b = _live_voice(
        params, t_abs, gate_s, state.vels, state.keys, state.prev_keys,
        state.phase1, state.phase2, (state.s1a, state.s2a),
        (state.s1b, state.s2b), t0, block, sample_rate, None)
    amp = _amp_env(params, t_abs, gate_s, state.vels, params.lfo.routing,
                   lfo_val)
    mono = row_sum(y * amp)
    return mono, LiveVoiceState(
        phase1=ph1, phase2=ph2, s1a=s_a[0], s2a=s_a[1], s1b=s_b[0],
        s2b=s_b[1], age=state.age + block, release_age=state.release_age,
        keys=state.keys, vels=state.vels, prev_keys=state.prev_keys)
