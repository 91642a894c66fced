"""Pointwise effects: gain, limiter, bitcrusher (port of
groove_tpu/ops/effects.py).

Elementwise torch ops over [..., n] (or [2, n] stereo) tensors; params are
floats or per-sample tensors broadcastable against the input
(automation)."""

from __future__ import annotations

import torch

I16_MAX = 32767.0


def gain(x, ceiling):
    return x * ceiling


def limiter(x, minimum, maximum):
    """Clamp |x| into [minimum, maximum], keeping the sign."""
    lo = torch.as_tensor(minimum, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(maximum, dtype=x.dtype, device=x.device)
    return torch.sign(x) * torch.minimum(torch.maximum(torch.abs(x), lo), hi)


def bitcrusher(x, bits):
    """Drop `bits` (floored, clamped to 0..15) low-order bits of the
    16-bit image |x| * 32767 truncated toward zero, sign reapplied."""
    b = torch.clamp(torch.floor(torch.as_tensor(bits, device=x.device)),
                    0, 15).to(torch.int32)
    step = torch.bitwise_left_shift(torch.ones_like(b), b).to(x.dtype)
    mag = torch.trunc(torch.abs(x) * I16_MAX)
    crushed = torch.trunc(mag / step) * step
    return torch.sign(x) * crushed / I16_MAX
