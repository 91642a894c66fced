"""Oscillator waveforms (port of groove_tpu/ops/oscillator.py).

Phase is computed in closed form per note, so waveform evaluation is
elementwise torch over [notes, time] tensors on the phase's device.
Waveforms are bipolar [-1, 1]: sine sin(2 pi phase) (range-reduced mod 1
first, as in the reference), square, pulse-width (+1 while frac(phase) <
width), sawtooth 2 frac - 1, triangle, white noise (jax.random's bits,
ops/prng.py), debug constants. triangle-sine renders as a sine, as in the
reference.

Device-independent bits: the sine is evaluated in float64 and rounded
once to float32, so the CPU and a CUDA device agree; the other waveforms
are exact float32 arithmetic and comparisons. Hard sync: the slave phase
is frac(master) * f2/f1."""

from __future__ import annotations

import math

import torch

from groove_tpu_torch.ops import prng

TWO_PI = 2.0 * math.pi


def frac(phase):
    return phase - torch.floor(phase)


def sine(phase, pulse_width=None):
    return torch.sin((TWO_PI * frac(phase)).double()).float()


def _sign_where(cond) -> torch.Tensor:
    return torch.where(cond, 1.0, -1.0).to(torch.float32)


def square(phase, pulse_width=None):
    return _sign_where(frac(phase) < 0.5)


def pulse_width(phase, width):
    return _sign_where(frac(phase) < width)


def sawtooth(phase, pulse_width=None):
    return 2.0 * frac(phase) - 1.0


def triangle(phase, pulse_width=None):
    f = frac(phase)
    return torch.where(f < 0.5, 4.0 * f - 1.0, 3.0 - 4.0 * f)


def zero(phase, pulse_width=None):
    return torch.zeros_like(phase)


def debug_max(phase, pulse_width=None):
    return torch.ones_like(phase)


def debug_min(phase, pulse_width=None):
    return -torch.ones_like(phase)


_TABLE = {
    "sine": sine,
    "square": square,
    "sawtooth": sawtooth,
    "triangle": triangle,
    "triangle-sine": sine,
    "none": zero,
    "debug-zero": zero,
    "debug-max": debug_max,
    "debug-min": debug_min,
}


def parse_waveform(params: dict) -> tuple[str, float]:
    """Decode a device's `waveform` param -> (kind, pulse_width).

    The schema allows either a plain kind string or the dict form
    {"pulse-width": w} (projects/demos/instruments/oscillator-*.json).
    Single source of truth for the three engines (whole-timeline,
    streamed, live) — they previously each carried a copy."""
    wf = params.get("waveform", "sine")
    pw = 0.5
    if isinstance(wf, dict):
        pw = float(wf.get("pulse-width", 0.5))
        wf = "pulse-width"
    return str(wf), pw


def evaluate(kind: str, phase, width=0.5, noise_key=None):
    """Evaluate a waveform by (static) kind name."""
    if kind == "pulse-width":
        return pulse_width(phase, width)
    if kind == "noise":
        if noise_key is None:
            raise ValueError("noise waveform needs noise_key")
        return noise(noise_key, phase.shape)
    try:
        return _TABLE[kind](phase)
    except KeyError:
        raise ValueError(f"unknown waveform kind {kind!r}") from None


def noise(key: torch.Tensor, shape) -> torch.Tensor:
    """White noise in [-1, 1), deterministic per key (jax.random.uniform's
    bits)."""
    return prng.uniform(key, shape, -1.0, 1.0)


def noise_keys(key: torch.Tensor, row_ids) -> torch.Tensor:
    """Per-row keys [n, 2]: `key` folded with each row's identity (the
    vmapped fold_in of the reference's noise_rows)."""
    ids = torch.as_tensor(row_ids, device=key.device).to(torch.int64)
    return prng.fold_in(key, ids)


def noise_rows(key: torch.Tensor, row_ids, span: int) -> torch.Tensor:
    """White noise [n, span] where row i is keyed by row_ids[i] (its
    identity, not its position in the batch)."""
    keys = noise_keys(key, row_ids)
    counters = torch.arange(span, dtype=torch.int64, device=key.device)
    return prng.uniform_at(keys, counters.expand(keys.shape[0], span),
                           -1.0, 1.0)


def noise_window(keys: torch.Tensor, age0: torch.Tensor, S: int,
                 span: int) -> torch.Tensor:
    """Columns [age0_i, age0_i + S) of noise_rows(key, ids, span) for per-row
    keys [n, 2] (noise_keys), zeros outside [0, span): the threefry
    counters are the sample positions, so only the window is drawn."""
    age = age0.to(torch.int64)[:, None] + torch.arange(
        S, dtype=torch.int64, device=age0.device)
    valid = (age >= 0) & (age < span)
    vals = prng.uniform_at(keys, age.clamp(0, max(span - 1, 0)), -1.0, 1.0)
    return torch.where(valid, vals, 0.0)


def phase_from_const_freq(freq_hz, n: int, sample_rate: float,
                          device=None) -> torch.Tensor:
    """Phase trajectory for a constant frequency: [..., n], f32
    k * (k / sample_rate) with a true division."""
    f = torch.as_tensor(freq_hz, dtype=torch.float32, device=device)
    k = torch.arange(n, dtype=torch.float32, device=f.device)
    sr = torch.full((), float(sample_rate), dtype=torch.float32,
                    device=f.device)
    return f[..., None] * torch.div(k, sr)


def phase_from_freq(freq_hz: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Phase trajectory for a per-sample frequency [..., n]: cumsum(f)/sr,
    a phase accumulator that advances by f[k]/sr after emitting sample k
    (phase[0] == 0). The increment is a true division; the cumulative sum
    groups differently on every device (as the reference's does), so its
    bits are not device-independent."""
    sr = torch.full((), float(sample_rate), dtype=torch.float32,
                    device=freq_hz.device)
    ph = torch.cumsum(torch.div(freq_hz, sr), dim=-1)
    return torch.cat([torch.zeros_like(ph[..., :1]), ph[..., :-1]], dim=-1)


def hard_sync_phase(phase_master, freq_ratio):
    """Slave phase under hard sync: resets at each master wrap.

    synced = frac(master_phase) * (f_slave / f_master); exact for
    piecewise-constant ratios.
    """
    return frac(phase_master) * freq_ratio
