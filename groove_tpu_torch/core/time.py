"""Musical time, tempo, and sample-rate conversions.

Reconstructed contracts from the reference (all in the reference source tree):
  - MusicalTime is an integer count of "units": 1 beat = 16 parts x 4096
    units = 65,536 units/beat; bars are virtual (doc/designs/time.md:92-115,
    confirmed by the transport invariant test src/mini/transport.rs:157-188
    which requires exactly UNITS_IN_BEAT units per second at 60 BPM for
    sample rates including primes).
  - frames -> units conversion happens per render buffer
    (orchestration/src/orchestrator.rs:633-649).
  - BeatValue divisors: a quarter note divides a whole note by 4, etc.
    (settings/src/lib.rs:121-157 enumerates Octuple..FiveHundredTwelfth).
  - SampleRate::DEFAULT = 44100 (src/lib.rs:30); render buffer size = 64
    frames (src/bin/groove-cli.rs:11).

This module is host-side Python (used at song-compile time only); nothing
here runs per-sample on the TPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from fractions import Fraction

# 1 beat = 16 parts x 4096 units (doc/designs/time.md:9-13).
PARTS_IN_BEAT = 16
UNITS_IN_PART = 4096
UNITS_IN_BEAT = PARTS_IN_BEAT * UNITS_IN_PART  # 65_536

DEFAULT_SAMPLE_RATE = 44_100
DEFAULT_BPM = 128.0
DEFAULT_MIDI_TICKS_PER_SECOND = 960
SAMPLE_BUFFER_SIZE = 64  # reference render/control granularity


@dataclass(frozen=True)
class Tempo:
    """Beats per minute (reference Tempo newtype over f64)."""

    bpm: float = DEFAULT_BPM

    @property
    def beats_per_second(self) -> float:
        return self.bpm / 60.0


@dataclass(frozen=True)
class SampleRate:
    value: int = DEFAULT_SAMPLE_RATE


@dataclass(frozen=True)
class TimeSignature:
    """top/bottom, e.g. 4/4. `bottom` names the beat value (4 = quarter)."""

    top: int = 4
    bottom: int = 4

    def beat_value(self) -> "BeatValue":
        return BeatValue.from_divisor(self.bottom)

    @property
    def beats_per_measure(self) -> int:
        return self.top


class BeatValue(Enum):
    """Note duration as a divisor of a whole note.

    Values mirror settings/src/lib.rs:121-157 (kebab-case serde names).
    ``divisor`` is notes-per-whole-note: whole=1, quarter=4, double=0.5...
    """

    OCTUPLE = ("octuple", Fraction(1, 8))
    QUADRUPLE = ("quadruple", Fraction(1, 4))
    DOUBLE = ("double", Fraction(1, 2))
    WHOLE = ("whole", Fraction(1))
    HALF = ("half", Fraction(2))
    QUARTER = ("quarter", Fraction(4))
    EIGHTH = ("eighth", Fraction(8))
    SIXTEENTH = ("sixteenth", Fraction(16))
    THIRTY_SECOND = ("thirty-second", Fraction(32))
    SIXTY_FOURTH = ("sixty-fourth", Fraction(64))
    ONE_HUNDRED_TWENTY_EIGHTH = ("one-hundred-twenty-eighth", Fraction(128))
    TWO_HUNDRED_FIFTY_SIXTH = ("two-hundred-fifty-sixth", Fraction(256))
    FIVE_HUNDRED_TWELFTH = ("five-hundred-twelfth", Fraction(512))

    def __init__(self, serde_name: str, divisor: Fraction):
        self.serde_name = serde_name
        self.divisor = divisor

    @classmethod
    def from_name(cls, name: str) -> "BeatValue":
        for v in cls:
            if v.serde_name == name:
                return v
        raise ValueError(f"unknown beat value {name!r}")

    @classmethod
    def from_divisor(cls, divisor: int | Fraction) -> "BeatValue":
        d = Fraction(divisor)
        for v in cls:
            if v.divisor == d:
                return v
        raise ValueError(f"no beat value with divisor {divisor}")

    def beats(self, ts: TimeSignature) -> Fraction:
        """Length of one such note, measured in `ts` beats.

        Mirrors the reference's path multiplier
        (entities/src/controllers/control_trip.rs:100-113):
        multiplier = divisor(ts.beat_value) / divisor(self).
        """
        return ts.beat_value().divisor / self.divisor


@dataclass(frozen=True, order=True)
class MusicalTime:
    """Integer musical time in units (65,536 per beat)."""

    units: int = 0

    @classmethod
    def from_beats(cls, beats: float | Fraction) -> "MusicalTime":
        if isinstance(beats, Fraction):
            return cls(int(beats * UNITS_IN_BEAT))
        return cls(int(beats * UNITS_IN_BEAT))

    @classmethod
    def from_frames(cls, tempo: Tempo, sample_rate: SampleRate, frames: int) -> "MusicalTime":
        """frames -> units, flooring (reference MusicalTime::frames_to_units,
        used at orchestration/src/orchestrator.rs:633-649)."""
        return cls(frames_to_units(tempo, sample_rate, frames))

    @property
    def total_beats(self) -> float:
        return self.units / UNITS_IN_BEAT

    def __add__(self, other: "MusicalTime") -> "MusicalTime":
        return MusicalTime(self.units + other.units)

    def __sub__(self, other: "MusicalTime") -> "MusicalTime":
        return MusicalTime(self.units - other.units)


def frames_to_units(tempo: Tempo, sample_rate: SampleRate, frames: int) -> int:
    """Exact integer conversion: floor(frames * bpm/60 * 65536 / rate).

    Done in exact rational arithmetic so the transport invariant holds for
    prime sample rates (src/mini/transport.rs:157-188): summing the deltas of
    per-frame conversions over one second at 60 BPM covers exactly
    UNITS_IN_BEAT units.
    """
    num = Fraction(tempo.bpm).limit_denominator(10**12) * frames * UNITS_IN_BEAT
    return int(num / (60 * sample_rate.value))


def units_to_frames(tempo: Tempo, sample_rate: SampleRate, units: int) -> int:
    """Smallest frame count whose musical time is >= `units`."""
    # frames >= units * 60 * rate / (bpm * UNITS_IN_BEAT)
    denom = Fraction(tempo.bpm).limit_denominator(10**12) * UNITS_IN_BEAT
    frames = Fraction(units) * 60 * sample_rate.value / denom
    return math.ceil(frames)


def beats_to_frames(tempo: Tempo, sample_rate: SampleRate, beats: Fraction | float) -> float:
    """Beats -> (possibly fractional) frame position."""
    return float(beats) * 60.0 / tempo.bpm * sample_rate.value


def render_length_frames(
    tempo: Tempo,
    sample_rate: SampleRate,
    end: MusicalTime,
    buffer_size: int = SAMPLE_BUFFER_SIZE,
) -> int:
    """Total frames a reference render produces for a song ending at `end`.

    The reference advances in `buffer_size`-frame buffers and stops at the
    first buffer whose *start* musical time has reached the end of all
    controllers (orchestration/src/orchestrator.rs:631-708 handle_work
    returning 0 ticks; run loop at :803-846). So the total is
    buffer_size * min{b : frames_to_units(b*buffer_size) >= end_units}.

    Matches the sample-count accounting tests: Timer(4 beats) at 240 BPM /
    24 kHz -> exactly 24,000 samples (orchestrator.rs:1722-1737); a 4-beat
    pattern at 128 BPM / 44.1 kHz -> ceil(82687.5) = 82,688
    (orchestrator.rs:1820-1830).
    """
    if end.units <= 0:
        return 0
    b = 0
    # Closed form first, then correct for floor effects at the boundary.
    approx_frames = units_to_frames(tempo, sample_rate, end.units)
    b = max(0, (approx_frames - 1)) // buffer_size
    while frames_to_units(tempo, sample_rate, b * buffer_size) < end.units:
        b += 1
    while b > 0 and frames_to_units(tempo, sample_rate, (b - 1) * buffer_size) >= end.units:
        b -= 1
    return b * buffer_size
