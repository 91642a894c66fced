"""Time-sharded IIR filtering over devices (port of
groove_tpu/parallel/timeshard.py).

Each device filters its own contiguous shard of the timeline; the only
data that crosses devices is the two-value filter state at the seams,
composed EXACTLY from each shard's affine transition (M, C), exit = M
entry + C:

  pass 1: every shard runs the carried-state biquad (S3,
          ops/stream.biquad_stream) once on three rows: its input from
          the zero state, and zero input from the unit states e1 and e2.
          The filter is linear in (input, state), so the rows' exit
          states are C and M's two columns, each from the kernel's own
          chain over the shard; no product of 2x2 maps is formed, so no
          associative doubling of near-critical maps amplifies their
          rounding;
  composition: a d-step loop on the first device folds shards 0..k-1
          into shard k's entry state, in groove_tpu's order of
          operations;
  pass 2: every shard runs S3 again from its exact entry state.

Cost: about twice the single-device filter's work spread over d
devices; each sample's recurrence runs in the single chain's order.
"""

from __future__ import annotations

import torch

from groove_tpu_torch.ops import stream as sops
from groove_tpu_torch.parallel import resolve_devices

BLOCK = sops.STREAM_BLOCK  # S3's block: every shard a multiple of it


def _shard_coefs(coefs, lo: int, hi: int, device) -> tuple:
    """The five coefficients over samples [lo, hi) on `device`: numbers
    stay numbers, per-sample arrays are sliced."""
    out = []
    for c in coefs:
        if isinstance(c, (int, float)) or torch.as_tensor(c).dim() == 0:
            out.append(float(c))
        else:
            out.append(torch.as_tensor(c, dtype=torch.float32)[lo:hi]
                       .to(device))
    return tuple(out)


def biquad_timesharded(x, coefs, devices=None) -> torch.Tensor:
    """Filter a 1-D signal x [n] sharded over `devices` (one contiguous
    shard each, repeats allowed); n a multiple of len(devices) * 64.
    coefs: (b0, b1, b2, a1, a2), each a number or per-sample [n]. Returns
    y [n] on the first device."""
    devices = resolve_devices(devices)
    x = torch.as_tensor(x, dtype=torch.float32)
    n, d = x.shape[-1], len(devices)
    if x.dim() != 1 or n % (d * BLOCK):
        raise ValueError(f"biquad_timesharded: x [n] with n a multiple of "
                         f"{d} x {BLOCK}, got {tuple(x.shape)}")
    S = n // d
    parts = []
    # pass 1: rows [x; 0; 0] from the states [0; e1; e2]
    for k, dev in enumerate(devices):
        xk = x[k * S:(k + 1) * S].to(dev)
        ck = _shard_coefs(coefs, k * S, (k + 1) * S, dev)
        rows = torch.zeros((3, S), dtype=torch.float32, device=dev)
        rows[0] = xk
        e = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=dev)
        _, (s1, s2) = sops.biquad_stream(rows, ck, (e[0], e[1]))
        parts.append((xk, ck, s1, s2))
    # the entry states: shard k folds shards 0..k-1 (M, C) in order
    d0 = devices[0]
    seg = [torch.stack([s1[1], s1[2], s2[1], s2[2], s1[0], s2[0]]).to(d0)
           for _, _, s1, s2 in parts]
    e1 = e2 = torch.zeros((), dtype=torch.float32, device=d0)
    entries = []
    for k in range(d):
        entries.append((e1, e2))
        m = seg[k]
        e1, e2 = (m[0] * e1 + m[1] * e2 + m[4],
                  m[2] * e1 + m[3] * e2 + m[5])
    # pass 2: every shard from its exact entry state
    out = []
    for (xk, ck, _, _), (a, b), dev in zip(parts, entries, devices):
        y, _ = sops.biquad_stream(xk[None], ck, (a.to(dev)[None],
                                                 b.to(dev)[None]))
        out.append(y[0].to(d0))
    return torch.cat(out)
