"""jax.random's threefry2x32 in torch integer ops: PRNGKey, fold_in and
uniform(key, shape, float32, minval, maxval), bit for bit jax's with
jax_threefry_partitionable on (its default since jax 0.5).

The reference draws its white noise (ops/oscillator.noise_rows) and its
sample-and-hold LFO bank (models/welsh) from jax.random. Threefry is
integer arithmetic, so the same bits come out of any device; uint32 words
are carried in int64 tensors and masked to 32 bits after every add and
shift.

Partitionable counters: element j of a shape-(n,) draw hashes the 64-bit
counter j (high word 0 below 2^32), so any window of a row can be drawn
without the rest (uniform_at), bitwise the full draw sliced."""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash of counter pairs (x1, x2) under the key
    (k1, k2): uint32 values in int64 tensors (k1, k2 may be tensors that
    broadcast against the counters, or Python ints). Returns the two
    output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x = [(x1 + k1) & _M, (x2 + k2) & _M]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a seed in [0, 2**32): the key [0, seed]
    as an int64 tensor of shape (2,)."""
    seed = int(seed)
    if not 0 <= seed <= _M:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    # filled on the device: a host-to-device copy (or an item assignment)
    # would wait for the device's queue
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.full((1,), seed, dtype=torch.int64,
                                 device=device)])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: the key [..., 2] hashed with the counter pair
    (0, data). data: an int or an integer tensor (one fold per element,
    keys [..., 2] broadcast against it) — the vmapped fold_in of
    oscillator.noise_rows."""
    d = (torch.as_tensor(data, dtype=torch.int64, device=key.device)
         if torch.is_tensor(data)
         else torch.full((), int(data), dtype=torch.int64,
                         device=key.device)) & _M
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def _to_uniform(bits: torch.Tensor, minval: float,
                maxval: float) -> torch.Tensor:
    """jax.random.uniform's float32 construction from 32 random bits: the
    top 23 bits as the mantissa of a number in [1, 2), minus 1, scaled.
    For [-1, 1) every step is exact."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform_at(key: torch.Tensor, counters: torch.Tensor,
               minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Elements `counters` (non-negative int64, below 2**32) of a
    partitionable uniform float32 draw under `key` ([2] or [..., 2]
    broadcasting against counters[..., :]): jax.random.uniform(key,
    (n,))[counters] for any n > max(counters)."""
    k1 = key[..., 0:1] if key.dim() > 1 else key[0]
    k2 = key[..., 1:2] if key.dim() > 1 else key[1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counters), counters)
    return _to_uniform(b1 ^ b2, minval, maxval)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n > _M:
        raise ValueError("draws of 2**32 elements or more are not ported")
    counters = torch.arange(n, dtype=torch.int64, device=key.device)
    return uniform_at(key, counters, minval, maxval).reshape(shape)
