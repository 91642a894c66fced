"""Shared voice-batch utilities (port of groove_tpu/models/voices.py).

The host helpers compile_song needs are numpy and copy the reference's
arithmetic exactly; scatter_notes is the torch form of the timeline
scatter."""

from __future__ import annotations

import numpy as np
import torch


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


def scatter_notes(note_audio: torch.Tensor, on_frames,
                  n_frames: int) -> torch.Tensor:
    """Sum per-note windows into the song timeline, in note order.

    note_audio: [n_notes, span] (mono) or [n_notes, 2, span] (stereo);
    on_frames: [n_notes] start frames. Returns [n] or [2, n]. Windows
    running past the timeline are cropped."""
    span = note_audio.shape[-1]
    mono = note_audio.dim() == 2
    shape = (n_frames + span,) if mono else (2, n_frames + span)
    out = torch.zeros(shape, dtype=note_audio.dtype, device=note_audio.device)
    for i, start in enumerate(torch.as_tensor(on_frames).tolist()):
        start = min(max(int(start), 0), n_frames)
        win = out[..., start:start + span]
        win.copy_(win + note_audio[i])
    return out[..., :n_frames]


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
