"""The song's timeline, worked out from the project dict alone: the
render's length, each note's first frame, and each automation trip's
value at every 64-frame control block.

Musical time is counted in units, 65,536 to a beat. A frame's time is
floor(frame * bpm / 60 * 65536 / sample_rate), in exact integers. Events
and control values act on the 64-frame block whose time range holds them:
a note sounds from the first frame of the block that contains its
note-on, and a trip is read once at each block's start and held for the
block. The render stops at the first block whose start has reached the
last measure the sequencer stamped.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

BLOCK = 64
UNITS_IN_BEAT = 65536
VELOCITY = 127
NOTE_DIVISOR = {"whole": 1, "half": 2, "quarter": 4, "eighth": 8,
                "sixteenth": 16, "thirty-second": 32, "sixty-fourth": 64}


class Clock:
    """bpm, time signature and sample rate, with exact conversions."""

    def __init__(self, project: dict, sample_rate: int):
        clock = project.get("clock", {})
        self.bpm = Fraction(clock.get("bpm", 128.0)).limit_denominator(
            10**12)
        self.beats_per_measure, self.beat_divisor = clock.get(
            "time-signature", [4, 4])
        self.rate = int(sample_rate)
        # units a frame lasts
        self.k = self.bpm * UNITS_IN_BEAT / (60 * self.rate)

    def units(self, frame: int) -> int:
        return math.floor(frame * self.k)

    def beats_per(self, note_value: str | None) -> Fraction:
        """Beats a slot of `note_value` lasts (the beat when None)."""
        if note_value is None:
            return Fraction(1)
        return Fraction(self.beat_divisor, NOTE_DIVISOR[note_value])

    def block_of(self, beats: Fraction) -> int:
        """The block whose time range holds `beats`: the last b with
        units(64 b) <= units of beats."""
        t = int(beats * UNITS_IN_BEAT)
        return math.ceil(Fraction(t + 1) / (BLOCK * self.k)) - 1

    def length_frames(self, end_beats: Fraction) -> int:
        end = int(end_beats * UNITS_IN_BEAT)
        if end <= 0:
            return 0
        return BLOCK * math.ceil(Fraction(end) / (BLOCK * self.k))

    def block_beats(self, n_blocks: int) -> np.ndarray:
        """Beats at each block's start, float64."""
        num, den = self.k.numerator, self.k.denominator
        if BLOCK * num * max(n_blocks, 1) < 2**62:
            frames = BLOCK * np.arange(n_blocks, dtype=np.int64)
            return (frames * num // den) / UNITS_IN_BEAT
        return np.array([self.units(BLOCK * b) / UNITS_IN_BEAT
                         for b in range(n_blocks)], np.float64)


def notes(project: dict, clock: Clock) -> tuple[list, Fraction]:
    """([(on_frame, channel, key, velocity)] in time order, the
    sequencer's end in beats). A pattern's rows are laid out at its
    note value from the track's cursor (key 0 is a rest, every note has
    velocity 127); the cursor then moves on by whole measures, at least
    one."""
    patterns = {}
    for p in project.get("patterns", []):
        patterns.setdefault(p["id"], p)
    out, end = [], Fraction(0)
    measure = Fraction(clock.beats_per_measure)
    for track in project.get("tracks", []):
        cursor = Fraction(0)
        channel = int(track.get("midi-channel", 0))
        for pid in track.get("patterns", []):
            p = patterns[pid]
            step = clock.beats_per(p.get("note-value"))
            width = max((len(r) for r in p["notes"]), default=0)
            for row in p["notes"]:
                for i, key in enumerate(row):
                    if key:
                        on = clock.block_of(cursor + i * step) * BLOCK
                        out.append((on, channel, int(key), VELOCITY))
            cursor += max(1, math.ceil(width * step / measure)) * measure
        end = max(end, cursor)
    out.sort()
    return out, end


def concave(f):
    """The slow-start curve an exponential step follows, f in [0, 1]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        g = -(5.0 / 12.0) * np.log10(1.0 - f)
    return np.where(f > 1.0 - 10.0 ** (-12.0 / 5.0), 1.0, g)


def trips(project: dict, clock: Clock, n_blocks: int,
          configured) -> dict:
    """{(device, param): float32 value per block} for every trip. A
    path's steps follow one another, each lasting one slot of the path's
    note value and rising from its start to its end value along the
    concave curve; before the first the target keeps `configured(device,
    param)`, after the last its end value holds."""
    paths = {p["id"]: p for p in project.get("paths", [])}
    beats = clock.block_beats(n_blocks)
    curves = {}
    for trip in project.get("trips", []):
        steps, cursor = [], Fraction(0)
        for pid in trip["paths"]:
            path = paths[pid]
            span = clock.beats_per(path.get("note-value"))
            for s in path["steps"]:
                (shape, v), = s.items()
                steps.append((float(cursor), float(cursor + span), shape,
                              float(v.get("start", 0.0)),
                              float(v.get("end", v.get("start", 0.0)))))
                cursor += span
        target = trip["target"]
        key = (target["id"], target["param"])
        out = np.full(n_blocks, configured(*key), np.float64)
        if steps:
            s0, s1, shape, a, z = zip(*steps)
            s0, s1, a, z = (np.asarray(v, np.float64)
                            for v in (s0, s1, a, z))
            inside = (beats >= s0[0]) & (beats < s1[-1])
            i = np.minimum(np.searchsorted(s1, beats, side="right"),
                           len(steps) - 1)
            f = np.clip((beats - s0[i]) / (s1[i] - s0[i]), 0.0, 1.0)
            if set(shape) != {"exponential"}:
                raise NotImplementedError(f"reference: steps {set(shape)}")
            value = a[i] + (z[i] - a[i]) * concave(f)
            out = np.where(inside, value, out)
            out[beats >= s1[-1]] = z[-1]
        curves[key] = out.astype(np.float32)
    return curves
