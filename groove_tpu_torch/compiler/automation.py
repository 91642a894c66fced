"""Automation compilation: trips/paths and LFO controllers -> per-block
control-value curves.

Reference semantics (entities/src/controllers/control_trip.rs):
  - a trip is a SteppedEnvelope of steps stamped from paths; each step
    spans `path_multiplier` beats where path_multiplier =
    divisor(ts.beat_value)/divisor(path.note_value or ts.beat_value)
    (control_trip.rs:99-113);
  - step value functions: Flat, Slope (linear), Logarithmic ("starts
    quickly, ends slowly"), Exponential ("starts slowly, ends quickly")
    (settings/src/controllers.rs:22-30). The curve bodies live in the
    missing SteppedEnvelope; we use the DLS/MMA convex (fast-start) and
    concave (slow-start) transforms that ship in the same codebase for
    exactly this purpose (orchestration/src/util.rs:4-21):
        logarithmic -> start + (end-start) * convex(f)
        exponential -> start + (end-start) * concave(f)
  - controllers run once per 64-frame buffer with the buffer's start time
    (orchestrator.rs:631-683), so curves are sampled at block starts;
  - before the trip begins the target keeps its configured value; after
    the trip's last step the final value holds (the commented work() holds
    current_value once out of range, control_trip.rs:189-219);
  - `start-measure` appears in project data but not in the settings struct
    at this snapshot — the reference silently drops it, and so do we
    (SongSettings docstring, SURVEY §2.2 ControlTrip row).

Control values are ControlValue/Normal in [0,1]; mapping to the target
parameter's domain (e.g. percent->Hz for `cutoff`) happens in the param
registry (compiler/params.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from groove_tpu_torch.core.time import (
    SAMPLE_BUFFER_SIZE,
    SampleRate,
    Tempo,
    TimeSignature,
    UNITS_IN_BEAT,
    frames_to_units,
)
from groove_tpu_torch.core.types import (
    transform_linear_to_mma_concave,
    transform_linear_to_mma_convex,
)
from groove_tpu_torch.project.schema import (
    ControlPathSettings,
    ControlTripSettings,
    SongSettings,
    warn,
)


@dataclass(frozen=True)
class EnvelopeStep:
    start_beats: Fraction
    end_beats: Fraction
    start_value: float
    end_value: float
    function: str  # flat|slope|logarithmic|exponential


def build_trip_steps(
    trip: ControlTripSettings,
    paths: dict[str, ControlPathSettings],
    ts: TimeSignature,
) -> list[EnvelopeStep]:
    steps: list[EnvelopeStep] = []
    cursor = Fraction(0)
    for pid in trip.path_ids:
        path = paths.get(pid)
        if path is None:
            warn(f"trip {trip.id} refers to nonexistent path {pid}")
            continue
        note_value = path.note_value or ts.beat_value()
        mult = note_value.beats(ts)
        for s in path.steps:
            # `triggered` (settings/src/controllers.rs:34-38) is a fieldless
            # event-driven step the reference never implemented
            # (control_trip.rs:126 todo!()); its schema comment says
            # implementing it makes ControlTrips themselves controllable.
            # RECONSTRUCTION: the step occupies its beat slot holding the
            # value it entered with; when a Trigger controller targeting
            # the TRIP fires (controls: source=trigger, target.id=trip id),
            # the step jumps to the fired value (see sample_trip_curve).
            steps.append(
                EnvelopeStep(cursor, cursor + mult, s.start, s.end, s.kind)
            )
            cursor += mult
    return steps


def _step_value(step: EnvelopeStep, t_beats: float) -> float:
    span = float(step.end_beats - step.start_beats)
    if span <= 0:
        return step.end_value
    f = (t_beats - float(step.start_beats)) / span
    f = min(max(f, 0.0), 1.0)
    if step.function == "flat":
        return step.start_value
    if step.function == "slope":
        g = f
    elif step.function == "logarithmic":
        g = transform_linear_to_mma_convex(f)
    elif step.function == "exponential":
        g = transform_linear_to_mma_concave(f)
    else:
        g = f
    return step.start_value + (step.end_value - step.start_value) * g


def block_start_beats(
    n_blocks: int, tempo: Tempo, sr: SampleRate, buffer: int = SAMPLE_BUFFER_SIZE
) -> np.ndarray:
    """Musical time (beats, f64) at each block start, via the reference's
    integer frames->units conversion."""
    out = np.empty(n_blocks, np.float64)
    for b in range(n_blocks):
        out[b] = frames_to_units(tempo, sr, b * buffer) / UNITS_IN_BEAT
    return out


def _resolve_entering_values(
    steps: list[EnvelopeStep],
    initial_value: float,
    triggers: list[tuple[float, float]],
) -> list[float]:
    """Value each step ENTERS with — the previous step's resolved end
    value (initial_value for the first step). A triggered step's end
    value is the latest trigger fired before its end, else its entering
    value (it held)."""
    enters: list[float] = []
    prev_end = initial_value
    for step in steps:
        enters.append(prev_end)
        if step.function == "triggered":
            fired = [v for (ft, v) in triggers if ft < float(step.end_beats)]
            prev_end = fired[-1] if fired else prev_end
        else:
            prev_end = step.end_value
    return enters


def sample_trip_curve(
    steps: list[EnvelopeStep],
    beats_at_block: np.ndarray,
    initial_value: float,
    triggers: list[tuple[float, float]] = (),
) -> np.ndarray:
    """ControlValue per block. Blocks before the first step keep
    `initial_value` (the target's configured value); after the end the
    last value holds. `triggers` are (fire_beats, value) events from
    Trigger controllers targeting this trip — consumed by `triggered`
    steps (see build_trip_steps)."""
    triggers = sorted(triggers)
    n = len(beats_at_block)
    out = np.full(n, initial_value, np.float64)
    if not steps:
        return out.astype(np.float32)
    enters = _resolve_entering_values(steps, initial_value, triggers)
    first = float(steps[0].start_beats)
    last_end = float(steps[-1].end_beats)
    last = steps[-1]
    if last.function == "triggered":
        fired = [v for (ft, v) in triggers if ft < last_end]
        hold_after = fired[-1] if fired else enters[-1]
    else:
        hold_after = last.end_value
    si = 0
    for b in range(n):
        t = beats_at_block[b]
        if t < first:
            continue
        if t >= last_end:
            out[b] = hold_after
            continue
        while si + 1 < len(steps) and t >= float(steps[si].end_beats):
            si += 1
        step = steps[si]
        if step.function == "triggered":
            # a trigger strictly inside the block fires IN that block
            # (containing-block semantics, matching note quantization —
            # `ft <= block start` latched one block late otherwise)
            t_end = beats_at_block[b + 1] if b + 1 < n else np.inf
            fired = [v for (ft, v) in triggers if ft < t_end]
            out[b] = fired[-1] if fired else enters[si]
        else:
            out[b] = _step_value(step, t)
    return out.astype(np.float32)


def lfo_curve(
    waveform_kind: str,
    frequency_hz: float,
    pulse_width: float,
    n_blocks: int,
    tempo: Tempo,
    sr: SampleRate,
    buffer: int = SAMPLE_BUFFER_SIZE,
) -> np.ndarray:
    """LfoController output per block: bipolar oscillator at the block's
    start time mapped to ControlValue (v+1)/2 (controllers.rs:109;
    stereo-automation.json drives `pan`)."""
    t = np.arange(n_blocks, dtype=np.float64) * buffer / sr.value
    phase = frequency_hz * t
    frac = phase - np.floor(phase)
    if waveform_kind == "sine":
        v = np.sin(2 * np.pi * phase)
    elif waveform_kind == "triangle":
        v = np.where(frac < 0.5, 4 * frac - 1.0, 3.0 - 4 * frac)
    elif waveform_kind == "sawtooth":
        v = 2 * frac - 1.0
    elif waveform_kind == "square":
        v = np.where(frac < 0.5, 1.0, -1.0)
    elif waveform_kind == "pulse-width":
        v = np.where(frac < pulse_width, 1.0, -1.0)
    else:
        v = np.zeros_like(frac)
    return ((v + 1.0) / 2.0).astype(np.float32)


def compile_trips(
    song: SongSettings,
    n_blocks: int,
    sr: SampleRate,
    initial_values: dict[tuple[str, str], float],
    trip_triggers: dict[str, list[tuple[float, float]]] | None = None,
) -> dict[tuple[str, str], np.ndarray]:
    """All trips -> {(target_uvid, param): ControlValue[n_blocks]}.
    trip_triggers: {trip_id: [(fire_beats, value)]} from Trigger
    controllers targeting the trip (consumed by `triggered` steps)."""
    ts = song.clock.time_signature
    tempo = song.clock.tempo
    paths = {p.id: p for p in song.paths}
    beats = block_start_beats(n_blocks, tempo, sr)
    curves: dict[tuple[str, str], np.ndarray] = {}
    for trip in song.trips:
        steps = build_trip_steps(trip, paths, ts)
        key = (trip.target.id, trip.target.param)
        init = initial_values.get(key, 0.0)
        curves[key] = sample_trip_curve(
            steps, beats, init,
            (trip_triggers or {}).get(trip.id, ()))
    return curves
