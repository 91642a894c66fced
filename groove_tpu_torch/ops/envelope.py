"""ADSR envelopes in closed form (port of groove_tpu/ops/envelope.py).

    held(t)  = t/A                     t < A          (A=0 -> 1)
             = 1 - (1-S)(t-A)/D        t < A+D        (D=0 -> S)
             = S                       otherwise
    env(t)   = held(t)                          t < t_off
             = held(t_off) * (1 - (t-t_off)/R)  t >= t_off, clamped at 0
                                                 (R=0 -> 0)

BACKEND-GENERIC like the reference: host (numpy/Python) inputs evaluate
with numpy, op for op the reference's host expressions (the Welsh filter
cutoff tables are host data); any torch tensor input evaluates in torch on
its device. There every quotient is a true division by a float32 tensor:
torch divides a CUDA tensor by a Python number through a reciprocal,
which the CPU does not, so the card and the CPU would disagree.
"""

from __future__ import annotations

import numpy as np
import torch


class _Numpy:
    maximum, where, clip = np.maximum, np.where, np.clip

    @staticmethod
    def div(a, b):
        return a / b


class _Torch:
    def __init__(self, device):
        self.device = device

    def _t(self, v):
        if torch.is_tensor(v):
            return v.to(torch.float32)
        return torch.full((), float(np.float32(v)), dtype=torch.float32,
                          device=self.device)

    @staticmethod
    def maximum(v, lo):
        return torch.clamp_min(v, lo) if torch.is_tensor(v) else max(v, lo)

    def where(self, cond, a, b):
        return torch.where(cond, self._t(a), self._t(b))

    @staticmethod
    def clip(v, lo, hi):
        return torch.clamp(v, lo, hi)

    def div(self, a, b):
        return torch.div(self._t(a), self._t(b))


def _ns(*vals):
    """numpy for host (numpy/Python) inputs, torch when any is a tensor."""
    for v in vals:
        if torch.is_tensor(v):
            return _Torch(v.device)
    return _Numpy


def _held(t, attack, decay, sustain, ns):
    eps = 1e-9
    a = ns.maximum(attack, eps)
    d = ns.maximum(decay, eps)
    in_attack = t < attack
    in_decay = t < attack + decay
    v_attack = ns.div(t, a)
    v_decay = 1.0 - ns.div((1.0 - sustain) * (t - attack), d)
    return ns.where(in_attack, v_attack, ns.where(in_decay, v_decay, sustain))


def adsr(t, t_off, attack, decay, sustain, release):
    """Envelope value at time t (seconds since note-on).

    All arguments broadcast; typically t is [..., n] and the rest are
    [..., 1] per-note parameters. t_off is the gate length in seconds.
    """
    ns = _ns(t, t_off, attack, decay, sustain, release)
    eps = 1e-9
    r = ns.maximum(release, eps)
    v_off = _held(t_off, attack, decay, sustain, ns)
    rel = v_off * (1.0 - ns.div(t - t_off, r))
    env = ns.where(t < t_off, _held(t, attack, decay, sustain, ns), rel)
    return ns.clip(env, 0.0, 1.0)


def release_tail_seconds(release: float) -> float:
    """How long a voice keeps sounding after note-off."""
    return float(release)
