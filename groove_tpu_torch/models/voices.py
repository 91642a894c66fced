"""Shared voice-batch utilities (port of groove_tpu/models/voices.py).

The host helpers compile_song needs are numpy and copy the reference's
arithmetic exactly; scatter_notes is the torch form of the timeline
scatter; f32 and time_base give the voices their true divisors and host
time bases on the device."""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.utils import profiling


def f32(v, device) -> torch.Tensor:
    """A float32 tensor on `device` (a Python number becomes a 0-dim
    tensor: a true divisor on every device)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    if np.ndim(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


def time_base(n: int, sample_rate: float, device) -> torch.Tensor:
    """[n] seconds: the host literal np.arange(n) / np.float32(sr), as a
    true division on the device (its bits)."""
    return torch.div(torch.arange(n, dtype=torch.float32, device=device),
                     f32(sample_rate, device))


def note_freqs(keys):
    """MIDI keys [n] -> Hz [n] (A4 = 440), host numpy f32 — the same bits
    as groove_tpu's numpy path."""
    keys = np.asarray(keys, np.float32)
    return np.float32(440.0) * np.exp2((keys - np.float32(69.0))
                                       / np.float32(12.0))


def span_for(max_gate_frames: int, tail_seconds: float, sample_rate: int,
             minimum: int = 256, multiple: int = 128) -> int:
    """Static per-instrument note window length."""
    span = int(max_gate_frames) + int(np.ceil(tail_seconds * sample_rate)) + 1
    span = max(span, minimum)
    return -(-span // multiple) * multiple


def live_ages(on_abs, off_abs, t0: int, n: int, sample_rate: float):
    """A live block's time bases from integer note frames: (t [V, n] note
    age in seconds, negative before note-on; gate_s [V, 1]). Ages are
    int32 differences (t0 + j) - on before the true division, so they stay
    exact however long the session (float32 frame counts lose the sample
    past 2**24)."""
    device = on_abs.device
    sr = f32(sample_rate, device)
    on = on_abs.to(torch.int32)[:, None]
    off = off_abs.to(torch.int32)[:, None]
    tj = (int(t0) + torch.arange(n, dtype=torch.int32,
                                 device=device))[None, :]
    t = torch.div((tj - on).to(torch.float32), sr)
    gate_s = torch.div((off - on).to(torch.float32), sr)
    return t, gate_s


def live_freqs(keys: torch.Tensor) -> torch.Tensor:
    """Hz [V] of a live pool's integer keys on their device:
    440 * 2^((k - 69) / 12) in float64, rounded once (the same bits on
    every device)."""
    twelve = torch.full((), 12.0, dtype=torch.float64, device=keys.device)
    return (440.0 * torch.exp2(torch.div(keys.double() - 69.0, twelve))
            ).float()


def row_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum of [m, ...] rows in row order, one add after another: a padded
    (exact-zero) row never regroups the others, so the sum is the same
    whatever the batch's padding, on every device (a reduction regroups
    rows per device and per padding)."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def scatter_notes(note_audio: torch.Tensor, on_frames,
                  n_frames: int) -> torch.Tensor:
    """Sum per-note windows into the song timeline, in note order.

    note_audio: [n_notes, span] (mono) or [n_notes, 2, span] (stereo);
    on_frames: [n_notes] start frames, best a host array (a device tensor
    costs a synchronisation). Returns [n] or [2, n]. Windows running past
    the timeline are cropped. One in-place add per note: the reference's
    read-add-write loop, never index_add_ (not deterministic on a card)."""
    span = note_audio.shape[-1]
    mono = note_audio.dim() == 2
    shape = (n_frames + span,) if mono else (2, n_frames + span)
    out = torch.zeros(shape, dtype=note_audio.dtype, device=note_audio.device)
    starts = profiling.card_read(on_frames, torch.Tensor.tolist) \
        if torch.is_tensor(on_frames) else np.asarray(on_frames).tolist()
    for i, start in enumerate(starts):
        start = min(max(int(start), 0), n_frames)
        out[..., start:start + span].add_(note_audio[i])
    return out[..., :n_frames]


def bucket_notes(need_frames: np.ndarray, cap: int, max_buckets: int = 3,
                 minimum: int = 256, launch_rows: int = 16):
    """Partition notes into span buckets to bound wasted render work (a
    copy of the reference's host function).

    A single per-instrument span is the MAX over notes, so one whole-note
    drone would make every short note render a drone-length window.
    Buckets group notes by their own need = gate + tail rounded up to 128
    frames; unique needs partition into <= max_buckets contiguous
    segments by an exact minimum-cost DP where cost(bucket) = span x (rows
    + launch_rows). Extending a note's window past its own need appends
    exact zeros, so bucket spans never change audio.

    need_frames: [n] per-note required window (gate + tail + 1).
    cap: upper clamp (timeline length, rounded up).
    Returns list of (span, indices) with every need <= its bucket span.
    """
    cap128 = -(-cap // 128) * 128
    need = np.minimum(np.maximum(need_frames.astype(np.int64), minimum),
                      cap128)
    need = np.minimum(-(-need // 128) * 128, cap128)  # 128-aligned spans
    spans = np.unique(need)                       # [m] ascending
    groups = [np.nonzero(need == v)[0] for v in spans]
    m = len(spans)
    # O(k m^2) DP, vectorized over the split point (cost of segment
    # (a..b-1] = span_{b-1} * (count(a..b) + launch_rows)).
    cnt = np.array([len(g) for g in groups], np.int64)
    C = np.concatenate([[0], np.cumsum(cnt)])            # [m+1]
    INF = np.int64(2**62)
    f = np.full((max_buckets + 1, m + 1), INF)
    arg = np.zeros((max_buckets + 1, m + 1), np.int64)
    f[0][0] = 0
    for k in range(1, max_buckets + 1):
        for b in range(1, m + 1):
            a = np.arange(b)
            cand = f[k - 1][a] + spans[b - 1] * (C[b] - C[a] + launch_rows)
            i = int(np.argmin(cand))
            f[k][b], arg[k][b] = cand[i], a[i]
    k = int(np.argmin(f[:, m]))
    cuts = []
    b = m
    while b > 0:
        a = int(arg[k][b])
        cuts.append((a, b))
        b, k = a, k - 1
    out = []
    for a, b in reversed(cuts):
        idx = np.concatenate(groups[a:b])
        out.append((int(spans[b - 1]), np.sort(idx)))
    return out


def glide_prev_keys(keys: np.ndarray, on: np.ndarray) -> np.ndarray:
    """Per-note glide-source keys: the key of the latest STRICTLY-earlier
    onset on the same device; notes sharing an onset glide from the same
    predecessor, and the first onset group keeps its own keys."""
    keys = np.asarray(keys, np.float32)
    on = np.asarray(on)
    prev = keys.copy()
    order = np.argsort(on, kind="stable")
    j, last_key = 0, None
    while j < len(order):
        k = j
        while k < len(order) and on[order[k]] == on[order[j]]:
            k += 1
        if last_key is not None:
            prev[order[j:k]] = last_key
        last_key = keys[order[k - 1]]
        j = k
    return prev


def apply_mono_policy(on: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Monophonic voice policy: a new note-on gates off the previous note.
    Events must be sorted by on frame. Returns adjusted off frames."""
    off = off.copy()
    for i in range(len(on) - 1):
        if off[i] > on[i + 1]:
            off[i] = on[i + 1]
    return off


def apply_multilimit_policy(on: np.ndarray, off: np.ndarray,
                            limit: int) -> np.ndarray:
    """MultiLimit(N) voice stealing: at most N simultaneous voices; a note
    beyond the limit gates off the OLDEST sounding voice at its note-on.
    Events must be sorted by on frame. Returns adjusted off frames."""
    off = off.copy()
    active: list[int] = []
    for i in range(len(on)):
        active = [j for j in active if off[j] > on[i]]
        if len(active) >= limit > 0:
            oldest = min(active, key=lambda j: (on[j], j))
            active.remove(oldest)
            off[oldest] = on[i]
        active.append(i)
    return off
