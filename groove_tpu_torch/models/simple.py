"""Simple devices (port of groove_tpu/models/simple.py, its offline half):
the always-on oscillator instrument, the envelope demo instrument, the
toy instrument and the toy effect.

- The oscillator plays its configured frequency for the whole render:
  a closed-form phase on a host time base, or for an automated frequency
  a host float64 integrated phase (oscillator_phase_automated, numpy
  copied statement for statement); noise draws jax.random's threefry
  bits through ops/prng.py.
- The envelope instrument is a sine at note pitch shaped by the
  configured ADSR, one [n, span] window a note.
- ToyInstrument emits its `fake-value`; ToyEffect negates.

Device-independent bits: time bases and gate seconds are true divisions
by float32 tensors (the host literals' bits), the sine is taken in
float64 and rounded once, and the integrated phase is host data."""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.models.voices import (f32, live_ages, live_freqs,
                                            note_freqs, time_base)
from groove_tpu_torch.ops import envelope as env_ops
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops import prng
from groove_tpu_torch.utils import profiling


def oscillator_instrument(kind: str, frequency: float, n_frames: int,
                          sample_rate: float, noise_seed: int = 0,
                          device="cpu") -> torch.Tensor:
    """Always-on oscillator -> mono [n] on `device`."""
    if kind == "noise":
        return osc_ops.noise(prng.prng_key(noise_seed, device), (n_frames,))
    phase = frequency * time_base(n_frames, sample_rate, device)
    return osc_ops.evaluate(kind, phase)


def oscillator_phase_automated(freq_b, n_frames: int, sample_rate: float,
                               cblock: int = 64) -> np.ndarray:
    """HOST-constant integrated phase for an automated-frequency
    oscillator: phase[j] = sum_{i<j} f(i)/sr with f held per 64-sample
    control block. Serial numpy cumsum in FLOAT64, cast to f32: an f32
    cumsum drifts ~0.3 cycles over 2 s at 141 Hz; in f64 the residual is
    one f32 ulp of the total phase. freq_b: block-rate Hz curve (host
    data, dev.automation). Returns the numpy array (the reference wraps
    the same array in a device array)."""
    f = np.asarray(freq_b, np.float32)
    nb = -(-int(n_frames) // cblock)
    if f.shape[0] < nb:
        pad = np.full(nb - f.shape[0], f[-1] if f.size else 0.0,
                      np.float32)
        f = np.concatenate([f, pad])
    f_up = np.repeat(f[:nb], cblock)[:n_frames]
    step = f_up.astype(np.float64) / np.float64(sample_rate)
    ph = np.concatenate([
        np.zeros(1, np.float64),
        np.cumsum(step, dtype=np.float64)[:-1],
    ]).astype(np.float32)
    return ph


def envelope_instrument(adsr_seconds, keys, vels, gate_frames, span: int,
                        sample_rate: float, freqs=None) -> torch.Tensor:
    """Sine at note pitch shaped by the configured ADSR -> [n_notes, span]
    on keys' device. freqs: host Hz [n] (default note_freqs of the keys,
    the same host bits)."""
    a, d, s, r = adsr_seconds
    keys = torch.as_tensor(keys)
    device = keys.device
    if freqs is None:
        freqs = note_freqs(profiling.card_read(keys))
    f = torch.as_tensor(freqs).to(device=device, dtype=torch.float32)
    sr = f32(sample_rate, device)
    t = time_base(span, sample_rate, device)[None, :]
    gate_s = torch.div(torch.as_tensor(gate_frames).to(
        device=device, dtype=torch.float32), sr)[:, None]
    env = env_ops.adsr(t, gate_s, a, d, s, r)
    tone = osc_ops.sine(f[:, None] * t)
    v = torch.as_tensor(vels).to(device=device, dtype=torch.float32)
    return tone * env * torch.div(v, f32(127.0, device))[:, None]


def envelope_window(adsr_seconds, keys, vels, on_abs, off_abs, t0: int,
                    n: int, sample_rate: float) -> torch.Tensor:
    """Live window render of the envelope instrument -> [V, n] on keys'
    device: a closed form of the integer note age, any block offset
    (engine/livesong.py)."""
    a, d, s, r = adsr_seconds
    t, gate_s = live_ages(on_abs, off_abs, t0, n, sample_rate)
    env = env_ops.adsr(t, gate_s, a, d, s, r) * (t >= 0.0)
    tone = osc_ops.sine(live_freqs(keys)[:, None] * t)
    v = vels.to(torch.float32)[:, None]
    active = v > 0.0
    return tone * env * active * torch.div(v, f32(127.0, keys.device))


def toy_instrument(fake_value: float, n_frames: int,
                   device="cpu") -> torch.Tensor:
    return torch.full((n_frames,), float(np.float32(fake_value)),
                      dtype=torch.float32, device=device)


def toy_effect(x: torch.Tensor) -> torch.Tensor:
    """Negator: signal + its toy-effected copy must cancel
    (orchestration/src/util.rs tests :52-78)."""
    return -x
