"""Delay-line effects: delay, chorus, reverb (port of
groove_tpu/ops/delayfx.py).

  Delay {delay: seconds}           y[n] = x[n - D] (100% wet)
  Chorus {voices, delay-seconds}   `voices` taps spaced delay/voices apart
                                   (tap 0 = dry), scaled by 1/voices
  Reverb {attenuation, seconds}    four recirculating combs (29.7, 37.1,
                                   41.1, 43.7 ms) whose feedback gives an
                                   RT60 of `seconds`, then two all-passes
                                   (5.0 and 1.7 ms, g = 0.7), times
                                   `attenuation`

A feedback delay of D samples is a first-order recurrence in block space:
time reshaped to [n/D, D] leaves D independent lanes,
  comb     y[n] = x[n-D] + g y[n-D]   ->  Y[b] = X[b-1] + g Y[b-1]
  allpass  w[n] = x[n] + g w[n-D];  y[n] = -g x[n] + (1 - g^2) w[n-D]
so each comb and all-pass is one iir.one_pole along the block axis (-2)
of [..., nb, D]: one launch of the first-order scan kernel
(ops/scan_kernels.py), six a reverb. Automated delay and chorus times are
block-rate curves held for 64 samples; their taps are gathers on int32
indices, out-of-range taps reading exact zeros.

Device-independent bits: the chorus's divisions by its voice count and
reverb_comb_g's d / (seconds sr) divide truly (torch's tensor / number
multiplies by a reciprocal on a card), and reverb_comb_g's exp runs in
float64, rounded once to float32 (iir._Torch's div and exp). A static reverb's gains are host
float64 arithmetic, rounded to float32 once, as the reference's."""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.ops.iir import _Torch, one_pole, upsample_hold

COMB_DELAYS_S = (0.0297, 0.0371, 0.0411, 0.0437)
ALLPASS_DELAYS_S = (0.005, 0.0017)
ALLPASS_G = 0.7
LN_MILLI = float(np.float32(np.log(0.001)))  # the reference's f32 constant


def delay_signal(x, delay_samples: int):
    """y[n] = x[n - D], zero history. D is a static Python int."""
    if delay_samples <= 0:
        return x
    n = x.shape[-1]
    return torch.nn.functional.pad(x, (delay_samples, 0))[..., :n]


def _block_view(x, d: int):
    """Pad the time axis to a multiple of d and view it as [..., n/d, d]."""
    n = x.shape[-1]
    nb = -(-n // d)
    xp = torch.nn.functional.pad(x, (0, nb * d - n))
    return xp.reshape(*x.shape[:-1], nb, d), n


def _shift_block(xb):
    """[..., nb, d] -> the same one block later, zeros first."""
    return torch.cat([torch.zeros_like(xb[..., :1, :]), xb[..., :-1, :]],
                     dim=-2)


def comb_feedback(x, delay_samples: int, g: float):
    """y[n] = x[n-D] + g*y[n-D] (recirculating delay line), zero history."""
    xb, n = _block_view(x, delay_samples)
    yb = one_pole(_shift_block(xb), g, 1.0, axis=-2)
    return yb.reshape(*x.shape[:-1], -1)[..., :n]


def allpass(x, delay_samples: int, g: float = ALLPASS_G):
    """Schroeder all-pass: H(z) = (-g + z^-D) / (1 - g z^-D).

    One-multiply form: w[n] = x[n] + g*w[n-D]; y = -g*x + (1-g^2)*w[n-D].
    """
    xb, n = _block_view(x, delay_samples)
    wb = one_pole(xb, g, 1.0, axis=-2)
    yb = -g * xb + (1.0 - g * g) * _shift_block(wb)
    return yb.reshape(*x.shape[:-1], -1)[..., :n]


def delay(x, delay_seconds: float, sample_rate: float):
    return delay_signal(x, int(round(delay_seconds * sample_rate)))


def _samples_b(seconds_b, sample_rate: float, device) -> torch.Tensor:
    """round(seconds * sample_rate) as int32, the product in float32."""
    s = torch.as_tensor(seconds_b, dtype=torch.float32, device=device)
    return torch.round(s * sample_rate).to(torch.int32)


def delay_automated(x, delay_seconds_b, sample_rate: float,
                    cblock: int = 64):
    """Automated delay time: the length is a block-rate curve held for 64
    samples and y[n] = x[n - D(block(n))], length changes taking effect at
    block boundaries with no crossfade."""
    n = x.shape[-1]
    d_up = upsample_hold(_samples_b(delay_seconds_b, sample_rate, x.device),
                         n, cblock)
    idx = torch.arange(n, dtype=torch.int32, device=x.device) - d_up
    valid = (idx >= 0).to(x.dtype)
    idx = torch.clamp(idx, 0, n - 1)
    return torch.index_select(x, -1, idx) * valid


def comb_feedback_automated(x, delay_samples: int, g):
    """y[n] = x[n-D] + g[n]*y[n-D] with a per-sample feedback gain g
    (broadcastable to x): the comb's block-space recurrence with
    a[b, lane] = g at that absolute sample."""
    d = delay_samples
    xb, n = _block_view(x, d)
    gb, _ = _block_view(g, d)
    # one_pole reads a along the scanned axis moved last: a [..., d, nb]
    # view of the block-space gains
    yb = one_pole(_shift_block(xb), gb.transpose(-1, -2), 1.0, axis=-2)
    return yb.reshape(*x.shape[:-1], -1)[..., :n]


def reverb_comb_g(seconds, d: int, sample_rate: float):
    """Comb feedback gain for RT60 `seconds` (number or tensor): -60 dB
    after `seconds`, 0.001^(D/(RT60 sr)); exactly 0 where seconds <= 0."""
    if not torch.is_tensor(seconds):
        sec = np.float32(seconds)
        if not sec > 0.0:
            return np.float32(0.0)
        q = np.float32(d) / (sec * np.float32(sample_rate))
        return np.float32(np.exp(np.float64(np.float32(LN_MILLI) * q)))
    sec = seconds.float()
    t = sec * sample_rate
    ns = _Torch(t.device)
    g = ns.exp(ns.div(d, t) * LN_MILLI)
    return torch.where(sec > 0.0, g, 0.0)


def chorus(x, voices: int, delay_seconds: float, sample_rate: float,
           wet_dry_mix=1.0):
    """Multi-tap chorus; wet_dry_mix 1.0 = fully wet (the tap sum), 0.0 =
    dry."""
    voices = max(1, int(voices))
    total_d = int(round(delay_seconds * sample_rate))
    wet = torch.zeros_like(x)
    for v in range(voices):
        wet = wet + delay_signal(x, v * total_d // voices)
    wet = _Torch(x.device).div(wet, voices)
    return x * (1.0 - wet_dry_mix) + wet * wet_dry_mix


def chorus_voice_counts(voices_b, max_voices: int):
    """Block-rate `voices` curve -> int32 tap counts clamped to
    [1, max_voices] (the host curve maximum bounds the tap loop)."""
    v = torch.round(torch.as_tensor(voices_b, dtype=torch.float32))
    return torch.clamp(v.to(torch.int32), 1, max_voices)


def chorus_curve_max_voices(curve) -> int:
    """HOST-side tap-loop bound for an automated `voices` curve (the curve
    is compile-time data). Shared by both engines so the bound can never
    diverge between the whole-timeline and streamed renders."""
    return int(max(1, round(float(np.max(np.asarray(curve))))))


def chorus_tap_curves(delay_seconds_b, voices, voices_b, max_voices,
                      n: int, sample_rate: float, cblock: int = 64,
                      device=None):
    """The automated chorus's per-sample tap curves: (d_up [n] int32
    total-delay samples, v_up [n] int32 tap counts, n_taps the static
    loop bound). delay_seconds_b may be a number (static delay, automated
    voices); device places the curves when no input is a tensor."""
    if device is None:
        device = next((t.device for t in (delay_seconds_b, voices_b)
                       if torch.is_tensor(t)), torch.device("cpu"))
    d_b = _samples_b(delay_seconds_b, sample_rate, device)
    if d_b.dim() == 0:
        d_up = d_b.expand(n)
    else:
        d_up = upsample_hold(d_b, n, cblock)
    if voices_b is not None:
        v_up = upsample_hold(chorus_voice_counts(voices_b, int(max_voices)),
                             n, cblock)
        n_taps = int(max_voices)
    else:
        n_taps = max(1, int(voices))
        v_up = torch.full((n,), n_taps, dtype=torch.int32, device=device)
    return d_up, v_up, n_taps


def chorus_automated(x, voices, delay_seconds_b, sample_rate: float,
                     wet_dry_mix=1.0, cblock: int = 64,
                     voices_b=None, max_voices: int | None = None):
    """Automated chorus (`delay-seconds` and/or `voices` trips): tap v
    reads x[n - v*D(block(n))//V(block(n))], masked by v < V; the sum
    scales by 1/V(n). The tap loop runs to the voices curve's host
    maximum; inactive and out-of-range taps read exact zeros."""
    n = x.shape[-1]
    d_up, v_up, n_taps = chorus_tap_curves(
        delay_seconds_b, voices, voices_b, max_voices, n, sample_rate,
        cblock, device=x.device)
    base = torch.arange(n, dtype=torch.int32, device=x.device)
    wet = torch.zeros_like(x)
    for v in range(n_taps):
        idx = base - torch.div(v * d_up, v_up, rounding_mode="floor")
        valid = ((idx >= 0) & (v < v_up)).to(x.dtype)
        wet = wet + torch.index_select(
            x, -1, torch.clamp(idx, 0, n - 1)) * valid
    wet = _Torch(x.device).div(wet, v_up)
    return x * (1.0 - wet_dry_mix) + wet * wet_dry_mix


def reverb_automated(x, attenuation, seconds_b, sample_rate: float,
                     cblock: int = 64):
    """Automated reverb RT60 (`seconds` trip or sidechain): the comb
    feedback gains follow the curve at the 64-sample control cadence."""
    n = x.shape[-1]
    sec_s = upsample_hold(torch.as_tensor(seconds_b, dtype=torch.float32,
                                          device=x.device), n, cblock)
    combs = torch.zeros_like(x)
    for d_s in COMB_DELAYS_S:
        d = max(1, int(round(d_s * sample_rate)))
        g = reverb_comb_g(sec_s, d, sample_rate)
        combs = combs + comb_feedback_automated(x, d, g)
    y = combs
    for d_s in ALLPASS_DELAYS_S:
        y = allpass(y, max(1, int(round(d_s * sample_rate))))
    return attenuation * y


def reverb(x, attenuation: float, seconds: float, sample_rate: float):
    combs = torch.zeros_like(x)
    for d_s in COMB_DELAYS_S:
        d = max(1, int(round(d_s * sample_rate)))
        if seconds > 0:
            g = 0.001 ** (d / (seconds * sample_rate))
        else:
            g = 0.0
        combs = combs + comb_feedback(x, d, g)
    y = combs
    for d_s in ALLPASS_DELAYS_S:
        y = allpass(y, max(1, int(round(d_s * sample_rate))))
    return attenuation * y
