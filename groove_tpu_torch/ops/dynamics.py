"""Dynamics: the compressor (port of groove_tpu/ops/dynamics.py).

Compressor {threshold, ratio, attack, release}. At attack = release = 0
it is instantaneous:

    |x| >  threshold:  y = sign(x) * (threshold + (|x| - threshold) * ratio)
    |x| <= threshold:  y = x

(`compressor`; threshold may be a per-sample tensor, as a sidechain
drives it). Otherwise `compressor_smoothed` follows a decoupled peak
detector: a release-rate peak hold y[n] = max(|x[n]|, r y[n-1])
(max_decay) then attack-rate one-pole smoothing toward the held peak
(iir.one_pole), both on the first-order scan kernel
(ops/scan_kernels.py). attack and release may be per-sample tensors
(trips, sidechains).

Device-independent bits: the follower's coefficient exp(-1 / (s sr))
divides truly (torch's tensor / number multiplies by a reciprocal on a
card) and takes exp in float64, rounded once to float32 (iir._Torch's
div and exp); a static coefficient is host numpy float32 arithmetic."""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.ops import scan_kernels
from groove_tpu_torch.ops.iir import _Torch, one_pole


def compressor(x, threshold, ratio):
    mag = torch.abs(x)
    compressed = torch.sign(x) * (threshold + (mag - threshold) * ratio)
    return torch.where(mag > threshold, compressed, x)


def _follower_coef(seconds, sample_rate):
    """exp(-1 / (max(seconds, 1e-6) * sample_rate)) in float32: a numpy
    float32 for a number, a tensor for a tensor."""
    if not torch.is_tensor(seconds):
        s = np.maximum(np.float32(seconds), np.float32(1e-6))
        q = np.float32(-1.0) / (s * np.float32(sample_rate))
        return np.float32(np.exp(np.float64(q)))
    s = torch.clamp_min(seconds.float(), 1e-6) * sample_rate
    ns = _Torch(s.device)
    return ns.exp(ns.div(-1.0, s))


def max_decay(x, r):
    """y[n] = max(x[n], r[n] * y[n-1]), zero initial state: the peak-hold
    recurrence (the product term underflows to 0 over long windows,
    which is exactly the decayed-away contribution)."""
    return scan_kernels.scan1(x, r, axis=-1, mode=scan_kernels.MAX_DECAY)


def envelope_follower(x, attack_s, release_s, sample_rate):
    """Release-rate peak hold, then attack-rate one-pole smoothing toward
    the held peak. At 0/0 seconds (numbers) it is |x|."""
    mag = torch.abs(x)
    numbers = (int, float)
    if isinstance(attack_s, numbers) and isinstance(release_s, numbers) \
            and attack_s <= 0.0 and release_s <= 0.0:
        return mag
    peak = max_decay(mag, _follower_coef(release_s, sample_rate))
    a_att = _follower_coef(attack_s, sample_rate)
    one = 1.0 if torch.is_tensor(a_att) else np.float32(1.0)
    return one_pole(peak, a_att, one - a_att)


def compressor_smoothed(x, threshold, ratio, attack_s, release_s, sample_rate):
    env = envelope_follower(x, attack_s, release_s, sample_rate)
    over = env > threshold
    target = threshold + (env - threshold) * ratio
    g = torch.where(over, torch.div(target, torch.clamp_min(env, 1e-9)), 1.0)
    return x * g
