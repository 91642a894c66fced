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


def _on(v, x, dtype=None):
    """A number or tensor as a tensor on x's device; a number is filled
    there (no host-to-device copy, which would wait for the device)."""
    if torch.is_tensor(v):
        return torch.as_tensor(v, dtype=dtype, device=x.device)
    return torch.full((), v, dtype=dtype, device=x.device)


def limiter(x, minimum, maximum):
    """Clamp |x| into [minimum, maximum], keeping the sign."""
    lo = _on(minimum, x, x.dtype)
    hi = _on(maximum, x, x.dtype)
    return torch.sign(x) * torch.minimum(torch.maximum(torch.abs(x), lo), hi)


def bitcrusher(x, bits):
    """Drop `bits` (floored, clamped to 0..15) low-order bits of the
    16-bit image |x| * 32767 truncated toward zero, sign reapplied."""
    b = torch.clamp(torch.floor(_on(bits, x)),
                    0, 15).to(torch.int32)
    step = torch.bitwise_left_shift(torch.ones_like(b), b).to(x.dtype)
    mag = torch.trunc(torch.abs(x) * I16_MAX)
    crushed = torch.trunc(mag / step) * step
    # a true division, as the reference's: a CUDA tensor divided by a
    # number would multiply by its reciprocal instead
    return torch.div(torch.sign(x) * crushed,
                     torch.full((), I16_MAX, dtype=x.dtype, device=x.device))
