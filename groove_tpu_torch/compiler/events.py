"""Sequencer/pattern event compilation and MIDI routing.

Reference semantics reproduced:

  - Pattern stamping (PatternProgrammer::insert_pattern_at_cursor, missing
    crate; behavior pinned by orchestrator tests): each pattern's note rows
    are laid out at `note-value` spacing from the track cursor; key 0 is a
    rest (empty_pattern test: a key-0 note produces no events,
    orchestrator.rs:1875-1910); each note's duration is 1.0 x note-value
    (settings/src/lib.rs:66-72 builds Note{velocity: 127, duration: 1.0};
    the random_access test treats duration as multiples of the note value,
    orchestrator.rs:1749-1830); the cursor advances to the next whole
    measure after each pattern (empty_pattern: cursor == 1 measure).

  - Event-to-frame quantization: the reference delivers MIDI during
    handle_work for the 64-frame buffer whose musical-time range contains
    the event (orchestrator.rs:631-683), so a note becomes audible at that
    buffer's first frame. We quantize on/off times to the containing
    buffer start.

  - Render end: performance stops at the first buffer where every
    controller is finished; the beat sequencer is finished at the last
    stamped measure boundary (run loop orchestrator.rs:803-846).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from groove_tpu_torch.core.time import (
    SAMPLE_BUFFER_SIZE,
    MusicalTime,
    SampleRate,
    Tempo,
    UNITS_IN_BEAT,
    frames_to_units,
    render_length_frames,
)
from groove_tpu_torch.project.schema import PatternSettings, SongSettings, warn


@dataclass(frozen=True)
class NoteEvent:
    channel: int
    key: int
    velocity: int
    on_beats: Fraction   # absolute song position of note-on
    off_beats: Fraction  # gate end


def stamp_patterns(
    song: SongSettings,
) -> tuple[list[NoteEvent], Fraction]:
    """All tracks' patterns -> note events + sequencer end (beats)."""
    ts = song.clock.time_signature
    # first-wins dedup (the reference warns and keeps one)
    patterns: dict[str, PatternSettings] = {}
    for p in song.patterns:
        if p.id in patterns:
            warn(f"duplicate pattern ID {p.id}. Skipping all but one!")
            continue
        patterns[p.id] = p

    events: list[NoteEvent] = []
    end_beats = Fraction(0)
    beats_per_measure = Fraction(ts.beats_per_measure)
    for track in song.tracks:
        cursor = Fraction(0)  # reset per track (songs.rs:239 reset_cursor)
        for pid in track.pattern_ids:
            pattern = patterns.get(pid)
            if pattern is None:
                warn(f"track {track.id} refers to nonexistent pattern {pid}")
                continue
            note_value = pattern.note_value or ts.beat_value()
            mult = note_value.beats(ts)  # beats per slot
            max_len = max((len(row) for row in pattern.notes), default=0)
            for row in pattern.notes:
                for i, key in enumerate(row):
                    if key == 0:
                        continue  # rest
                    on = cursor + i * mult
                    events.append(
                        NoteEvent(
                            channel=track.midi_channel,
                            key=int(key),
                            velocity=127,
                            on_beats=on,
                            off_beats=on + mult,
                        )
                    )
            # advance cursor to the next whole measure (>= 1 measure)
            pattern_beats = max_len * mult
            measures = -(-pattern_beats // beats_per_measure)  # ceil
            measures = max(measures, 1)
            cursor += measures * beats_per_measure
        end_beats = max(end_beats, cursor)
    return events, end_beats


def beats_to_buffer_start_frame(
    beats: Fraction, tempo: Tempo, sr: SampleRate, buffer: int = SAMPLE_BUFFER_SIZE
) -> int:
    """First frame of the buffer whose musical-time range contains `beats`."""
    target_units = int(beats * UNITS_IN_BEAT)
    # approximate buffer index, then correct using exact integer conversion
    approx_frames = float(beats) * 60.0 / tempo.bpm * sr.value
    b = max(0, int(approx_frames) // buffer)
    while frames_to_units(tempo, sr, (b + 1) * buffer) <= target_units:
        b += 1
    while b > 0 and frames_to_units(tempo, sr, b * buffer) > target_units:
        b -= 1
    return b * buffer


@dataclass(frozen=True)
class FrameNote:
    channel: int
    key: int
    velocity: int
    on_frame: int
    off_frame: int


def quantize_events(
    events: list[NoteEvent], tempo: Tempo, sr: SampleRate
) -> list[FrameNote]:
    out = []
    for e in events:
        on = beats_to_buffer_start_frame(e.on_beats, tempo, sr)
        off = beats_to_buffer_start_frame(e.off_beats, tempo, sr)
        out.append(FrameNote(e.channel, e.key, e.velocity, on, max(off, on)))
    out.sort(key=lambda n: (n.on_frame, n.channel, n.key))
    return out


def song_render_frames(song: SongSettings, sr: SampleRate) -> int:
    _, end_beats = stamp_patterns(song)
    return render_length_frames(
        song.clock.tempo, sr, MusicalTime.from_beats(end_beats)
    )


# --------------------------------------------------------------------------
# Arpeggiator (host-side MIDI -> MIDI transform)


def calculator_pattern(
    out_channel: int,
    calc_bpm: float,
    song_tempo: Tempo,
    n_sounds: int = 16,
) -> list[NoteEvent]:
    """The Pocket Calculator toy's self-played demo jingle.

    RECONSTRUCTION (Calculator body missing at HEAD; entities.rs:88-89
    declares a controller+instrument hybrid with its own Clock, and
    projects/calculator.json contains NO patterns — so any sound must come
    from the device itself): one 4/4 measure of sixteenth steps at the
    calculator's own BPM, stepping through its sample bank in file order
    ("by pressing down a special key, it plays a little melody")."""
    if calc_bpm <= 0:
        calc_bpm = song_tempo.bpm
    step = (
        Fraction(1, 4)
        * Fraction(song_tempo.bpm).limit_denominator(10**9)
        / Fraction(calc_bpm).limit_denominator(10**9)
    )
    return [
        NoteEvent(out_channel, k, 127, k * step, (k + 1) * step)
        for k in range(n_sounds)
    ]


ARP_STEP_NOTE_VALUE_BEATS = Fraction(1, 4)  # sixteenth notes in 4/4
# extension pattern applied when only ONE note is held: root, +4, +7, +12
# (an arpeggiator with a single held note still arpeggiates — the ascending
# major pattern keeps kitchen-sink's single-note arp audible and moving)
ARP_SINGLE_NOTE_SEMIS = (0, 4, 7, 12)


def arpeggiate(
    notes_in: list[NoteEvent],
    arp_bpm: float,
    song_tempo: Tempo,
    out_channel: int,
) -> list[NoteEvent]:
    """Transform held input notes into an arpeggiated stream.

    RECONSTRUCTION: the reference Arpeggiator's body is missing at HEAD
    (declared at orchestration/src/entities.rs:61-62; params {bpm} +
    midi-in/midi-out at settings/src/controllers.rs:101-175). Chosen
    semantics, documented for parity review: the arp CYCLES THE HELD-NOTE
    SET — at each sixteenth-note step (at the arp's own BPM), exactly one
    note sounds: the next ascending member of the currently-held set. A
    held chord therefore produces a one-note-at-a-time ascending cycle,
    not parallel per-note streams. The cycle position advances every step
    and resets when the held set empties. When a single note is held, the
    ascending major extension (root, +4, +7, +12) is cycled so a lone
    note still arpeggiates. Velocity follows the sounding note.
    """
    out: list[NoteEvent] = []
    if not notes_in:
        return out
    if arp_bpm <= 0:
        arp_bpm = song_tempo.bpm
    # step length in *song* beats: one sixteenth at arp bpm
    step = (
        ARP_STEP_NOTE_VALUE_BEATS
        * Fraction(song_tempo.bpm).limit_denominator(10**9)
        / Fraction(arp_bpm).limit_denominator(10**9)
    )
    first = min(n.on_beats for n in notes_in)
    last = max(n.off_beats for n in notes_in)
    t = first
    i = 0
    while t < last:
        held = sorted(
            ((n.key, n.velocity) for n in notes_in
             if n.on_beats <= t < n.off_beats),
        )
        if not held:
            i = 0
            t += step
            continue
        if len(held) == 1:
            key0, vel = held[0]
            key = key0 + ARP_SINGLE_NOTE_SEMIS[i % len(ARP_SINGLE_NOTE_SEMIS)]
        else:
            key, vel = held[i % len(held)]
        if 0 < key < 128:
            out.append(NoteEvent(out_channel, key, vel, t, t + step))
        t += step
        i += 1
    return out
