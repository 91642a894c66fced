"""Scalar value types and pitch/frequency/curve math.

Reconstruction sources in the reference source tree:
  - note_to_frequency: standard MIDI tuning 440 * 2^((n-69)/12)
    (used at settings/src/patches.rs:96; standard).
  - semis_and_cents tuning ratio: 2^((semis*100+cents)/1200)
    (settings/src/patches.rs:255-258, validated by tests :754-796).
  - FrequencyHz percent<->Hz mapping: f = 25 * 800^pct, covering the human
    hearing range 25..20000 Hz. The reference calls
    FrequencyHz::frequency_to_percent (settings/src/patches.rs:150) whose
    body lives in the missing ensnare-core crate; the 25*800^p form is the
    published ensnare mapping and round-trips the patch data
    (cutoff-hz/cutoff-pct pairs in assets/patches/welsh/*.json).
  - denormalize_q: missing code (BiQuadFilter::denormalize_q, used at
    settings/src/patches.rs:148). Reconstructed as q = v^2*10 + 0.707:
    0 -> Butterworth 0.707, 1 -> strongly resonant; matches the
    filters004.txt guidance that Q ranges ~0.707..1000 and the patch corpus
    where filter_resonance is almost always 0.
  - MMA DLS concave/convex transforms: orchestration/src/util.rs:4-21, with
    spreadsheet-validated test values at :286-318.
"""

from __future__ import annotations

import math


def clamp01(x: float) -> float:
    return 0.0 if x < 0.0 else 1.0 if x > 1.0 else x


def note_to_frequency(note: int | float) -> float:
    """MIDI note number -> Hz (A4=69=440)."""
    return 440.0 * 2.0 ** ((float(note) - 69.0) / 12.0)


def semis_and_cents(semitones: float, cents: float = 0.0) -> float:
    """Tuning ratio from semitones+cents (patches.rs:255-258)."""
    return 2.0 ** ((semitones * 100.0 + cents) / 1200.0)


def octaves(num: float) -> float:
    return semis_and_cents(num * 12.0, 0.0)


# Human hearing range mapping used for filter-cutoff automation percentages.
FREQUENCY_TO_LINEAR_BASE = 800.0
FREQUENCY_TO_LINEAR_COEFFICIENT = 25.0


def percent_to_frequency(pct: float) -> float:
    """Normal [0,1] -> Hz: 25 * 800^pct (25 Hz .. 20 kHz)."""
    return FREQUENCY_TO_LINEAR_COEFFICIENT * FREQUENCY_TO_LINEAR_BASE ** float(pct)


def frequency_to_percent(freq: float) -> float:
    """Hz -> Normal [0,1]; clamps below 25 Hz to 0."""
    if freq < FREQUENCY_TO_LINEAR_COEFFICIENT:
        return 0.0
    return clamp01(
        math.log(freq / FREQUENCY_TO_LINEAR_COEFFICIENT, FREQUENCY_TO_LINEAR_BASE)
    )


def denormalize_q(value: float) -> float:
    """Normal [0,1] resonance -> filter Q (reconstruction; see module doc)."""
    v = float(value)
    return v * v * 10.0 + 0.707


def transform_linear_to_mma_concave(linear_value: float) -> float:
    """DLS concave curve (orchestration/src/util.rs:4-11). Slow start."""
    max_value = 1.0
    if linear_value > (1.0 - 10.0 ** (-12.0 / 5.0) * max_value):
        return max_value
    return -(5.0 / 12.0) * math.log10(1.0 - linear_value / max_value)


def transform_linear_to_mma_convex(linear_value: float) -> float:
    """DLS convex curve (orchestration/src/util.rs:13-21). Fast start."""
    max_value = 1.0
    if linear_value < 10.0 ** (-12.0 / 5.0) * max_value:
        return 0.0
    return 1.0 + (5.0 / 12.0) * math.log10(linear_value / max_value)
