"""Sampler and drumkit: pitched and one-shot sample playback (port of
groove_tpu/models/sampler.py).

A kit's samples live in one [slots, 2, max_len] f32 table. A drumkit at
the song's rate plays each hit's row from its note-on frame, masked at
the sample's length and scaled by velocity / 127: accumulate_oneshots is
the plain torch timeline sum, and the render path takes the hand kernel
instead (ops/drums.py); the segment-streamed render copies each hit's
row into its window (render_notes_aligned). The sampler, the calculator
and a drumkit at another rate resample: render_notes gathers every note's table row and
reads it at pos = j * ratio * rate / sample_rate with linear
interpolation -> [notes, 2, span] windows, as the reference does. The
loaders and sampler_ratios are numpy (host data for compile_song and the
Renderer's inputs).

Device-independent bits: the rate correction is a true division by a
float32 tensor and the velocity scale divides the same way; the rest is
float32 multiplies, adds and integer gathers."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from groove_tpu_torch.core.types import note_to_frequency
from groove_tpu_torch.io.wav import read_wav
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import warn
from groove_tpu_torch.utils import profiling

# GM percussion note -> 707 sample base name (the same map as groove_tpu)
GM_707_MAP = {
    35: "Kick 1", 36: "Kick 2", 37: "Rim", 38: "Snare 1", 39: "Clap",
    40: "Snare 2", 41: "Tom 3", 42: "Hat Closed", 43: "Tom 3",
    44: "Hat Closed", 45: "Tom 2", 46: "Hat Open", 47: "Tom 2",
    48: "Tom 1", 49: "Crash", 50: "Tom 1", 51: "Ride", 52: "Crash",
    53: "Ride", 54: "Tambourine", 55: "Crash", 56: "Cowbell",
    57: "Crash", 59: "Ride",
}
ROUND_ROBINS = 4


@dataclass
class SampleTable:
    """Host-loaded sample bank."""

    data: np.ndarray     # [slots, 2, max_len] float32
    lengths: np.ndarray  # [slots] int32
    rates: np.ndarray    # [slots] int32 (source sample rates)
    slot_names: list

    @classmethod
    def from_files(cls, files: list) -> "SampleTable":
        waves = []
        rates = []
        for f in files:
            x, rate = read_wav(f)
            if x.shape[1] == 1:
                x = np.repeat(x, 2, axis=1)
            waves.append(x[:, :2].T.astype(np.float32))  # [2, len]
            rates.append(rate)
        max_len = max((w.shape[1] for w in waves), default=1) + 1
        data = np.zeros((len(waves), 2, max_len), np.float32)
        lengths = np.zeros(len(waves), np.int32)
        for i, w in enumerate(waves):
            data[i, :, : w.shape[1]] = w
            lengths[i] = w.shape[1]
        return cls(data, lengths, np.asarray(rates, np.int32), list(files))


def load_drumkit(paths: Paths, name: str) -> tuple[SampleTable, dict]:
    """Returns (table, {midi_note: [slot indices for round robins]})."""
    base = paths.search(Path("samples") / "elphnt.io" / name)
    if base is None:
        raise FileNotFoundError(f"drumkit {name!r} not found under samples/")
    files = []
    note_slots: dict[int, list[int]] = {}
    for note, inst in GM_707_MAP.items():
        slots = []
        for r in range(1, ROUND_ROBINS + 1):
            f = Path(base) / f"{inst} R{r}.wav"
            if f.exists():
                slots.append(len(files))
                files.append(f)
        if slots:
            note_slots[note] = slots
    if not files:
        raise FileNotFoundError(f"no samples found for drumkit {name!r}")
    return SampleTable.from_files(files), note_slots


def load_calculator_kit(paths: Paths) -> SampleTable:
    """The "Pocket Calculator" sample bank: files sorted by name; MIDI key
    k plays slot k mod n."""
    base = paths.search(Path("samples") / "pocket-calculator-24")
    if base is None:
        raise FileNotFoundError("pocket-calculator-24 samples not found")
    files = sorted(Path(base).glob("*.wav"))
    if not files:
        raise FileNotFoundError("pocket-calculator-24 directory is empty")
    return SampleTable.from_files(files)


def load_sample(paths: Paths, filename: str) -> SampleTable:
    found = paths.search(Path("samples") / filename) or paths.search(filename)
    if found is None:
        raise FileNotFoundError(f"sample {filename!r} not found")
    return SampleTable.from_files([found])


def root_frequency(root: float) -> float:
    """root < 128 is a MIDI note number, otherwise Hz."""
    if root < 128.0:
        return note_to_frequency(root)
    return float(root)


def assign_drum_slots(keys: np.ndarray, note_slots: dict) -> np.ndarray:
    """Per-hit slot assignment with per-instrument round-robin cycling."""
    counters: dict[int, int] = {}
    slots = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        k = int(k)
        rr = note_slots.get(k)
        if rr is None:
            warn(f"drumkit has no sample for MIDI note {k}; skipping hit")
            slots[i] = -1
            continue
        c = counters.get(k, 0)
        slots[i] = rr[c % len(rr)]
        counters[k] = c + 1
    return slots


def render_notes(table_data: torch.Tensor, table_lengths: torch.Tensor,
                 table_rates: torch.Tensor, slots, ratios, gate_frames, vels,
                 span: int, sample_rate: float) -> torch.Tensor:
    """Resampled playback -> stereo [n_notes, 2, span] on table_data's
    device. slots [n] (-1 is silent), ratios [n] playback-rate ratios,
    gate_frames [n] (a one-shot passes span), vels [n]. Each note gathers
    its table row [2, max_len], then its window at the interpolation
    positions."""
    device = table_data.device
    slots = torch.as_tensor(slots).to(device=device, dtype=torch.int64)
    safe = torch.clamp_min(slots, 0)
    ratios = torch.as_tensor(ratios).to(device=device, dtype=torch.float32)
    sr = torch.full((), float(np.float32(sample_rate)), dtype=torch.float32,
                    device=device)
    # source-rate correction: a sample recorded at 48k played in a 44.1k
    # render steps faster through the table
    rate_fix = torch.div(table_rates[safe].to(torch.float32), sr)
    step = (ratios * rate_fix)[:, None]                         # [n, 1]
    t_idx = torch.arange(span, dtype=torch.float32, device=device)[None, :]
    pos = t_idx * step                                          # [n, span]
    i0 = torch.floor(pos).to(torch.int64)
    frac = (pos - i0.to(torch.float32))[:, None, :]             # [n, 1, span]
    del pos
    length = table_lengths[safe].to(torch.int64)[:, None]       # [n, 1]
    valid = (i0 + 1 < length) & (slots[:, None] >= 0)           # [n, span]
    gate = t_idx < torch.as_tensor(gate_frames).to(
        device=device, dtype=torch.float32)[:, None]
    mask = (valid & gate)[:, None, :]                           # [n, 1, span]
    del valid, gate
    i0c = torch.clamp(i0, 0, table_data.shape[-1] - 2)
    del i0
    per_note = table_data[safe]                                 # [n, 2, max_len]
    idx = i0c[:, None, :].expand(slots.shape[0], 2, span)       # [n, 2, span]
    a = torch.gather(per_note, -1, idx)
    b = torch.gather(per_note, -1, idx + 1)
    del per_note, idx, i0c
    out = a * (1.0 - frac) + b * frac
    del a, b, frac
    out = out * mask
    v = torch.as_tensor(vels).to(device=device, dtype=torch.float32)
    return out * torch.div(v, torch.full((), 127.0, dtype=torch.float32,
                                         device=device))[:, None, None]


def render_notes_aligned(table_data: torch.Tensor,
                         table_lengths: torch.Tensor, slots, gate_frames,
                         vels, span: int) -> torch.Tensor:
    """Unity-ratio playback (a drumkit or the calculator at the song's
    rate) in the segment-streamed render: a row copy instead of a
    fractional gather -> stereo [n_notes, 2, span]. Each note's table row
    [2, max_len], cut or zero-padded to span, masked past the sample's
    length and the gate, times vel / 127 (slot -1 is silent)."""
    device = table_data.device
    slots = torch.as_tensor(slots).to(device=device, dtype=torch.int64)
    safe = torch.clamp_min(slots, 0)
    max_len = table_data.shape[-1]
    per_note = table_data[safe]                                 # [n, 2, max_len]
    if max_len >= span:
        out = per_note[:, :, :span]
    else:
        out = torch.nn.functional.pad(per_note, (0, span - max_len))
    j = torch.arange(span, dtype=torch.float32, device=device)[None, :]
    length = table_lengths[safe].to(torch.float32)[:, None]
    gate = torch.as_tensor(gate_frames).to(device=device,
                                           dtype=torch.float32)[:, None]
    mask = (j < length) & (j < gate) & (slots[:, None] >= 0)
    out = out * mask[:, None, :]
    v = torch.as_tensor(vels).to(device=device, dtype=torch.float32)
    return out * torch.div(v, torch.full((), 127.0, dtype=torch.float32,
                                         device=device))[:, None, None]


def sampler_ratios(keys, root: float) -> np.ndarray:
    """Playback-rate ratios [n] f32 of MIDI keys against the root (Hz, or
    a MIDI note below 128), host numpy float64 rounded once: the
    reference's arithmetic exactly."""
    keys = np.asarray(keys, np.float64)
    freqs = 440.0 * np.exp2((keys - 69.0) / 12.0)  # voices.note_freqs
    return (freqs / root_frequency(root)).astype(np.float32)


def accumulate_oneshots(table_data: torch.Tensor, table_lengths, slots,
                        on_frames, gate_frames, vels,
                        n_frames: int) -> torch.Tensor:
    """Unity-ratio hits summed straight into the timeline -> [2, n], in
    hit order: each hit adds row * (j < min(length, gate)) * (vel / 127)
    at its note-on frame (slot -1 is silent)."""
    dev = table_data.device
    max_len = table_data.shape[-1]
    out = torch.zeros((2, n_frames + max_len), dtype=table_data.dtype,
                      device=dev)
    j = torch.arange(max_len, dtype=torch.float32, device=dev)[None, :]
    lengths = profiling.card_read(torch.as_tensor(table_lengths),
                                  torch.Tensor.tolist)
    gate = torch.as_tensor(gate_frames, dtype=torch.float32)
    vel = torch.as_tensor(vels, dtype=torch.float32, device=dev)
    slots = profiling.card_read(torch.as_tensor(slots), torch.Tensor.tolist)
    ons = profiling.card_read(torch.as_tensor(on_frames),
                              torch.Tensor.tolist)
    for i, (slot, on) in enumerate(zip(slots, ons)):
        if slot < 0:
            continue
        limit = min(float(lengths[slot]), float(gate[i]))
        row = table_data[slot] * (j < limit) * (vel[i] / 127.0)
        on = min(max(int(on), 0), n_frames)
        win = out[:, on:on + max_len]
        win.copy_(win + row)
    return out[:, :n_frames]


def render_window(table_data: torch.Tensor, table_lengths: torch.Tensor,
                  table_rates: torch.Tensor, slots, ratios, on_abs, off_abs,
                  vels, t0: int, n: int, sample_rate: float) -> torch.Tensor:
    """Live window render -> stereo [V, 2, n]: the block [t0, t0 + n) of
    sample-playback voices (slot -1 silent, off_abs far while held). The
    playback position is a closed form of the integer note age (pos = age
    * step), so any block offset renders without carried state
    (engine/livesong.py)."""
    device = table_data.device
    slots = slots.to(torch.int64)
    safe = torch.clamp_min(slots, 0)
    ratios = ratios.to(torch.float32)
    sr = torch.full((), float(np.float32(sample_rate)), dtype=torch.float32,
                    device=device)
    rate_fix = torch.div(table_rates[safe].to(torch.float32), sr)
    step = (ratios * rate_fix)[:, None]                         # [V, 1]
    on = on_abs.to(torch.int32)[:, None]
    off = off_abs.to(torch.int32)[:, None]
    tj = (int(t0) + torch.arange(n, dtype=torch.int32,
                                 device=device))[None, :]
    age = (tj - on).to(torch.float32)                           # frames
    pos = age * step
    i0 = torch.floor(pos).to(torch.int64)
    frac = (pos - i0.to(torch.float32))[:, None, :]
    length = table_lengths[safe].to(torch.int64)[:, None]
    valid = (i0 + 1 < length) & (slots[:, None] >= 0) & (age >= 0)
    gated = age < (off - on).to(torch.float32)                  # note open
    mask = (valid & gated)[:, None, :]
    i0c = torch.clamp(i0, 0, table_data.shape[-1] - 2)
    per_note = table_data[safe]
    idx = i0c[:, None, :].expand(slots.shape[0], 2, n)
    a = torch.gather(per_note, -1, idx)
    b = torch.gather(per_note, -1, idx + 1)
    out = (a * (1.0 - frac) + b * frac) * mask
    v = vels.to(torch.float32)
    return out * torch.div(v, torch.full((), 127.0, dtype=torch.float32,
                                         device=device))[:, None, None]
