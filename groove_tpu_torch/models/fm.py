"""Single-operator FM voice (port of groove_tpu/models/fm.py, its offline
half):

    modulator freq = ratio * carrier freq
    carrier out    = sin(2 pi phase_c + beta * depth * mod_env * sin(2 pi phase_m))
    out            = carrier_env * velocity / 127 * carrier out

Host half: host_phases, the mod-1-reduced phase tables, is numpy copied
statement for statement (tests/test_torch_fm.py holds its bits to the
reference's). Device half: render_notes renders every note's whole
window [n, span] on the keys' device.

Device-independent bits: the time base is a host literal, the gate
seconds and the modulator's increments are true divisions by float32
tensors, the carrier argument is formed in float32 in the reference's
order (one rounding an operation), and both sines are taken in float64
and rounded once. A `ratio` curve integrates the modulator phase in the
reference's 64-sample blocks (each block's inclusive sum, an exclusive
prefix over blocks, an exclusive prefix within each block), every sum
on the first-order scan kernel with a = 1 (ops/scan_kernels.scan1),
whose card equals its CPU twin bit for bit; the block prefix carries
its rounding and is reduced mod 1 (exclusive_mod1), where the
reference's cumsum holds the whole phase of up to thousands of cycles
in float32, so against groove_tpu it is held to a dBFS bar, not
bitwise."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from groove_tpu_torch.models.voices import (f32, live_ages, live_freqs,
                                            note_freqs, time_base)
from groove_tpu_torch.ops import envelope as env_ops
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops import scan_kernels
from groove_tpu_torch.project.patches import FmSynthParams
from groove_tpu_torch.utils import profiling

TWO_PI = 2.0 * np.pi
CBLOCK = 64  # the reference's control block and phase-sum block


def _sin(arg: torch.Tensor) -> torch.Tensor:
    """sin of a float32 argument in float64, rounded once."""
    return torch.sin(arg.double()).float()


def _voices_at(params: FmSynthParams, vels, gate_s, t, f_c, ratio=None,
               depth=None, beta=None, sample_rate: float | None = None,
               phases=None) -> torch.Tensor:
    """FM voice value at note-relative times t [1, m] (seconds, >= 0) for
    notes of carrier Hz f_c [n, 1] and gate seconds gate_s [n, 1] -> [n, m].
    ratio/depth/beta: optional per-sample [n, m] curves; a ratio curve
    integrates the modulator phase (modulator_phase). phases: the host
    mod-1-reduced tables (host_phases), used when no ratio curve is
    given."""
    if phases is not None:
        mod_phase = phases["phm"]
    else:
        mod_phase = modulator_phase(params, f_c, t, ratio, sample_rate)
    me = params.modulator_envelope
    mod_env = env_ops.adsr(t, gate_s, me.attack, me.decay, me.sustain,
                           me.release)
    ce = params.carrier_envelope
    car_env = env_ops.adsr(t, gate_s, ce.attack, ce.decay, ce.sustain,
                           ce.release)
    depth_v = params.depth if depth is None else depth
    beta_v = params.beta if beta is None else beta
    # osc_ops.sine range-reduces mod 1 (a no-op on the host tables)
    mod = osc_ops.sine(mod_phase) * mod_env * depth_v
    del mod_phase, mod_env
    if phases is not None:
        carrier = _sin(TWO_PI * phases["phc"] + beta_v * mod)
    else:
        carrier = _sin(TWO_PI * osc_ops.frac(f_c * t) + beta_v * mod)
    del mod
    device = t.device
    amp = car_env * torch.div(f32(vels, device)[:, None],
                              f32(127.0, device))
    # the reference's `* (t >= 0.0)` multiplies by exactly 1 here: t is
    # the window's own time base, never negative
    return carrier * amp


def modulator_phase(params: FmSynthParams, f_c, t, ratio,
                    sample_rate: float | None) -> torch.Tensor:
    """Modulator phase [n, m] in cycles: the static closed form, or for a
    per-sample `ratio` curve the exclusive sum of the increments
    ratio * f_c / sample_rate, reduced mod 1 (sin is 1-periodic).

    When m is a multiple of 64 the sum is regrouped per 64-sample block as
    the reference regroups it: each block's inclusive sums (in_block_sums,
    its last column the block sum), the exclusives within a block as
    inclusive - increment, and each block's origin, the exclusive sum of
    the block sums mod 1 (exclusive_mod1); else the whole row is one
    exclusive_mod1. Every sum is a scan1 call with a = 1; no torch.cumsum
    or torch.sum."""
    if ratio is None:
        return (params.ratio * f_c) * t
    f_m = ratio * f_c                                        # [n, m]
    inc = torch.div(f_m, f32(sample_rate, f_m.device)) * (t >= 0.0)
    del f_m
    n, m = inc.shape
    if m % CBLOCK == 0:
        inc3 = inc.reshape(n, m // CBLOCK, CBLOCK)
        incl = in_block_sums(inc3)
        origin = exclusive_mod1(incl[..., -1].contiguous())  # [n, nb]
        within = incl - inc3
        del incl, inc, inc3
        return (origin[..., None] + within).reshape(n, m)
    return exclusive_mod1(inc)


def phase_scans(span: int) -> int:
    """scan1 calls modulator_phase makes for a `ratio` curve over `span`
    samples: the in-block sums and exclusive_mod1's two, or exclusive_mod1
    alone."""
    return 3 if span % CBLOCK == 0 else 2


def exclusive_mod1(x: torch.Tensor) -> torch.Tensor:
    """Exclusive sums of non-negative x [..., m] along the last axis, mod
    1, with the rounding of the running sum carried (two scan1 calls).

    The inclusive sums y (scan1) round at the running sum's magnitude: a
    phase of 3500 cycles has a float32 ulp of 2.4e-4 cycles. Each step's
    increment as y took it, y_t - y_{t-1}, is exact (Sterbenz: the sums
    only grow), and so is what its rounding lost, x_t - (y_t - y_{t-1});
    so the exact exclusive sum is y_{t-1} plus the exclusive sum of those
    losses, a second scan1 of terms a few ulps of y small. y_{t-1} mod 1
    is exact too, and the result, frac(y_{t-1}) + the losses' sum, rounds
    once near 1. The steps and their order are the same on every
    device."""
    y = scan_kernels.scan1(x, 1.0)
    prev = F.pad(y[..., :-1], (1, 0))
    lost = scan_kernels.scan1(x - (y - prev), 1.0)
    return osc_ops.frac(prev) + F.pad(lost[..., :-1], (1, 0))


def in_block_sums(inc3: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along the last axis of [n, nb, 64]: one scan1 call.
    The blocks are handed to scan1 as [n, 64, nb] scanned along axis 1,
    so that neighbouring blocks are the kernel's side-by-side lanes (its
    block-space layout) rather than one 64-step lane a thread block; a
    lane's steps and its chunks are the same either way, and so are the
    bits."""
    return scan_kernels.scan1(inc3.transpose(1, 2), 1.0,
                              axis=1).transpose(1, 2)


#: element cap for shipping host FM phase tables (see welsh's cap)
HOST_PHASE_MAX_ELEMS = 8_000_000


def host_phases(params: FmSynthParams, keys, span: int, sample_rate: float,
                max_elems: int = HOST_PHASE_MAX_ELEMS) -> dict | None:
    """HOST (numpy) modulator/carrier phase tables, REDUCED mod 1 in f64
    then cast to f32 -> {"phm", "phc": [n, span]} or None (too big, or
    ratio automation varies the modulator per sample).

    A raw f32 phase f*t loses resolution as it grows (2^-15 cycles at
    phase ~440), and FM's beta multiplies the modulator's error into the
    carrier: beta=100 measured -42.9 dBFS vs the f64 reference. sin is
    exactly 1-periodic, so host f64 reduction keeps uniform 6e-8-cycle
    resolution for any note length; the engines ship these bits and the
    f64 reference shares them (beta-100 pins at -90 after this)."""
    keys = np.asarray(keys, np.float32)
    n = len(keys)
    if n == 0 or n * span > max_elems:
        return None
    f_c = note_freqs(keys).astype(np.float64)[:, None]       # host f32 bits
    k = np.arange(span, dtype=np.float64)[None, :]
    phc = np.mod(f_c * k / float(sample_rate), 1.0)
    phm = np.mod((float(params.ratio) * f_c) * k / float(sample_rate), 1.0)
    return {"phm": phm.astype(np.float32), "phc": phc.astype(np.float32)}


def _note_curve(curve_b: torch.Tensor, on_frames, span: int,
                cblock: int = CBLOCK) -> torch.Tensor:
    """Slice a song-level block-rate curve [nb] into per-note per-sample
    values [n, span] at each note's absolute position (held per block)."""
    device = curve_b.device
    on = on_frames if torch.is_tensor(on_frames) \
        else torch.from_numpy(np.array(on_frames, np.int64))
    on = on.to(device=device, dtype=torch.int64)[:, None]
    j = torch.arange(span, dtype=torch.int64, device=device)[None, :]
    idx = torch.clamp(torch.div(on + j, cblock, rounding_mode="floor"), 0,
                      curve_b.shape[0] - 1)
    return curve_b.to(torch.float32)[idx]


def render_notes(params: FmSynthParams, keys, vels, gate_frames, span: int,
                 sample_rate: float, on_frames=None, ratio_b=None,
                 depth_b=None, beta_b=None, freqs=None,
                 phases=None) -> torch.Tensor:
    """Render all notes -> mono [n, span] on keys' device.
    ratio_b/depth_b/beta_b: optional song-level block-rate automation
    curves (domain units, tensors); on_frames anchors each note's window on
    the absolute timeline for the slicing. freqs: host carrier Hz [n]
    (default note_freqs of the keys, the same host bits); phases: host
    mod-1-reduced phase tables (host_phases), ignored when a ratio curve
    varies the modulator."""
    keys = torch.as_tensor(keys)
    device = keys.device
    sr = f32(sample_rate, device)
    # the host time-base literal np.arange(span) / np.float32(sr): a true
    # division on the device gives its bits
    t = time_base(span, sample_rate, device)[None, :]
    gate_s = torch.div(f32(torch.as_tensor(gate_frames), device),
                       sr)[:, None]
    if freqs is None:
        freqs = note_freqs(profiling.card_read(keys))
    f_c = f32(freqs, device)[:, None]
    cur = {}
    if on_frames is not None:
        for name, c in (("ratio", ratio_b), ("depth", depth_b),
                        ("beta", beta_b)):
            if c is not None:
                cur[name] = _note_curve(f32(c, device), on_frames, span)
    if cur.get("ratio") is not None or phases is None:
        phases = None
    else:
        phases = {k: f32(phases[k], device) for k in ("phm", "phc")}
    return _voices_at(params, vels, gate_s, t, f_c, ratio=cur.get("ratio"),
                      depth=cur.get("depth"), beta=cur.get("beta"),
                      sample_rate=sample_rate, phases=phases)


def render_window(params: FmSynthParams, keys, vels, on_abs, off_abs,
                  t0: int, n: int, sample_rate: float) -> torch.Tensor:
    """Live window render -> [V, n]: the block [t0, t0 + n) of voices
    whose notes started at absolute frame on_abs (off_abs far while held),
    on keys' device. The voice is a closed form of the note age (the
    static ratio's modulator phase), so a block at any offset needs no
    carried state (engine/livesong.py)."""
    t, gate_s = live_ages(on_abs, off_abs, t0, n, sample_rate)
    vels = vels.to(torch.float32)
    f_c = live_freqs(keys)[:, None]
    active = (vels > 0.0)[:, None]
    return _voices_at(params, vels, gate_s, t, f_c) * (t >= 0.0) * active


def tail_seconds(params: FmSynthParams) -> float:
    return max(params.carrier_envelope.release, 0.0)
