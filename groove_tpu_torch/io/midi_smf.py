"""Standard MIDI File (SMF) import.

The reference CLI accepts MIDI files among its inputs
(src/bin/groove-cli.rs:27 "Can be JSON, JSON5, MIDI, or scripts") and ships
SMF fixtures with authoritative text dumps (test-data/midi/*.mid.txt,
produced by test-data/midi/generate_dumps) that pin the expected parse:
ticks, tempo meta (microseconds per quarter), note on/off per channel
(note-on velocity 0 == note-off).

Parser output is a flat, tick-ordered event list plus a tempo map;
`smf_to_note_events` converts to the compiler's NoteEvents in beats.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from fractions import Fraction
from pathlib import Path
from groove_tpu_torch.compiler.events import NoteEvent
from groove_tpu_torch.project.schema import warn


@dataclass
class SmfEvent:
    ticks: int
    channel: int
    kind: str          # note-on|note-off|program|tempo|time-signature|other
    data: tuple


@dataclass
class SmfFile:
    format: int
    division: int      # ticks per quarter note (PPQ; SMPTE unsupported)
    n_tracks: int
    events: list       # [SmfEvent], merged across tracks, tick-ordered
    tempo_us_per_qn: int = 500_000  # first tempo meta (default 120 bpm)
    time_signature: tuple = (4, 4)
    programs: dict = field(default_factory=dict)  # channel -> GM program

    @property
    def bpm(self) -> float:
        return 60_000_000.0 / self.tempo_us_per_qn


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def parse_smf(path) -> SmfFile:
    data = Path(path).read_bytes()
    try:
        return _parse_smf_bytes(path, data)
    except (IndexError, struct.error) as e:
        # reads past the end of a truncated/corrupt file surface as
        # IndexError (byte indexing, _read_varint) or struct.error
        # (short header/track-length fields) — the loader policy is
        # TYPED errors (test_midi fuzz), same as the JSON5 side
        raise ValueError(f"{path}: truncated or corrupt SMF ({e})") from e


def _parse_smf_bytes(path, data: bytes) -> SmfFile:
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not an SMF file")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError(f"{path}: SMPTE division unsupported")
    pos = 8 + hlen

    smf = SmfFile(format=fmt, division=division, n_tracks=ntrks, events=[])
    for _ in range(ntrks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError(f"{path}: expected MTrk at {pos}")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tpos = pos + 8
        tend = tpos + tlen
        pos = tend
        ticks = 0
        running_status = 0
        while tpos < tend:
            delta, tpos = _read_varint(data, tpos)
            ticks += delta
            status = data[tpos]
            if status & 0x80:
                tpos += 1
                if status < 0xF0:
                    running_status = status
                else:
                    # System/meta events cancel running status (SMF spec).
                    running_status = 0
            else:
                status = running_status
                if status == 0:
                    raise ValueError(
                        f"{path}: data byte 0x{data[tpos]:02x} at offset "
                        f"{tpos} with no running status"
                    )
            if status == 0xFF:  # meta
                meta = data[tpos]
                tpos += 1
                length, tpos = _read_varint(data, tpos)
                body = data[tpos:tpos + length]
                tpos += length
                if meta == 0x51 and length == 3:
                    us = (body[0] << 16) | (body[1] << 8) | body[2]
                    smf.events.append(SmfEvent(ticks, -1, "tempo", (us,)))
                elif meta == 0x58 and length >= 2:
                    smf.time_signature = (body[0], 2 ** body[1])
                    smf.events.append(
                        SmfEvent(ticks, -1, "time-signature",
                                 smf.time_signature)
                    )
            elif status in (0xF0, 0xF7):  # sysex
                length, tpos = _read_varint(data, tpos)
                tpos += length
            else:
                kind = status & 0xF0
                channel = status & 0x0F
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = data[tpos], data[tpos + 1]
                    tpos += 2
                    if kind == 0x90 and d2 > 0:
                        smf.events.append(
                            SmfEvent(ticks, channel, "note-on", (d1, d2))
                        )
                    elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                        smf.events.append(
                            SmfEvent(ticks, channel, "note-off", (d1, d2))
                        )
                elif kind in (0xC0, 0xD0):
                    d1 = data[tpos]
                    tpos += 1
                    if kind == 0xC0:
                        prior = smf.programs.setdefault(channel, d1)
                        if prior != d1:
                            # one instrument per channel by compilation
                            # model — a mid-song switch is silently lost
                            # otherwise, so say so
                            warn(f"channel {channel}: mid-song program "
                                 f"change {prior} -> {d1} ignored (one "
                                 f"instrument per channel)")
                        smf.events.append(
                            SmfEvent(ticks, channel, "program", (d1,))
                        )
                else:
                    raise ValueError(
                        f"{path}: unhandled status byte 0x{status:02x} at "
                        f"offset {tpos}"
                    )
    smf.events.sort(key=lambda e: e.ticks)
    # base tempo: the EARLIEST tempo meta across all tracks (track parse
    # order picked the wrong base for format-1 files whose track 0 carries
    # a LATER tempo than track 1's tick-0 meta)
    for e in smf.events:
        if e.kind == "tempo":
            smf.tempo_us_per_qn = e.data[0]
            break
    return smf


def tempo_map(smf: SmfFile) -> list[tuple[int, int]]:
    """[(ticks, us_per_qn)] sorted, starting at tick 0 (SMF default 120 BPM
    unless the file sets a tempo at tick 0). Every 0x51 meta is honored —
    mid-file tempo changes appear in the fixtures (test-data/midi/*.mid.txt)
    and the reference plays them via its tick clock."""
    changes = [(e.ticks, e.data[0]) for e in smf.events if e.kind == "tempo"]
    changes.sort()
    if not changes or changes[0][0] > 0:
        changes.insert(0, (0, smf.tempo_us_per_qn if changes else 500_000))
    # A file that opens with a tempo meta at tick 0 keeps it; otherwise the
    # prepended entry is the first tempo (pre-first-meta region plays at the
    # first tempo, matching smf.tempo_us_per_qn semantics).
    dedup: list[tuple[int, int]] = []
    for t, us in changes:
        if dedup and dedup[-1][0] == t:
            dedup[-1] = (t, us)
        else:
            dedup.append((t, us))
    return dedup


def _tick_to_seconds_fn(smf: SmfFile):
    """Exact piecewise-linear ticks->seconds via the tempo map (Fractions)."""
    tmap = tempo_map(smf)
    div = smf.division
    # Prefix seconds at each change point.
    prefix: list[tuple[int, Fraction, int]] = []  # (tick, seconds_at, us)
    sec = Fraction(0)
    for i, (t, us) in enumerate(tmap):
        if i > 0:
            t0, us0 = tmap[i - 1]
            sec += Fraction((t - t0) * us0, 1_000_000 * div)
        prefix.append((t, sec, us))

    def seconds(ticks: int) -> Fraction:
        lo, hi = 0, len(prefix) - 1
        while lo < hi:  # last change point <= ticks
            mid = (lo + hi + 1) // 2
            if prefix[mid][0] <= ticks:
                lo = mid
            else:
                hi = mid - 1
        t0, s0, us = prefix[lo]
        return s0 + Fraction((ticks - t0) * us, 1_000_000 * div)

    return seconds


def smf_to_note_events(smf: SmfFile) -> list[NoteEvent]:
    """Pair note-on/off into NoteEvents with beat times.

    Multi-tempo SMFs are honored: each tick is warped through the tempo map
    to wall-clock seconds, then expressed as beats *at the first tempo*
    (beats = seconds * bpm / 60). The downstream compiler converts beats to
    frames at that single bpm, so note frame positions are exact for any
    tempo map. Overlapping re-triggers of the same key close the earlier
    note first (matching the dumps' Note On ... 0 convention).
    """
    open_notes: dict[tuple[int, int], list] = {}
    out: list[NoteEvent] = []
    seconds = _tick_to_seconds_fn(smf)
    beats_per_second = Fraction(60_000_000, smf.tempo_us_per_qn) / 60

    def beats(ticks: int) -> Fraction:
        return seconds(ticks) * beats_per_second

    for e in smf.events:
        if e.kind == "note-on":
            key = (e.channel, e.data[0])
            open_notes.setdefault(key, []).append((e.ticks, e.data[1]))
        elif e.kind == "note-off":
            key = (e.channel, e.data[0])
            stack = open_notes.get(key)
            if stack:
                on_ticks, vel = stack.pop(0)
                out.append(NoteEvent(
                    channel=e.channel, key=e.data[0], velocity=vel,
                    on_beats=beats(on_ticks), off_beats=beats(e.ticks),
                ))
    # close dangling notes at the last event time
    if smf.events:
        end = beats(smf.events[-1].ticks)
        for (channel, key), stack in open_notes.items():
            for on_ticks, vel in stack:
                out.append(NoteEvent(channel, key, vel, beats(on_ticks), end))
    out.sort(key=lambda n: (n.on_beats, n.channel, n.key))
    return out


# ---------------------------------------------------------------------------
# GM program -> Welsh patch mapping (the reference keeps such a table at
# settings/src/patches.rs:336-689; this one is authored against the patch
# corpus that ships in assets/patches/welsh/).

GM_TO_WELSH = {
    0: "piano", 1: "piano", 2: "electric-piano", 3: "piano",
    4: "electric-piano", 5: "electric-piano", 6: "harpsichord",
    7: "clavichord", 8: "celeste", 9: "glockenspiel", 10: "marimba",
    11: "bell", 12: "marimba", 13: "xylophone", 14: "bell", 15: "dulcimer",
    16: "organ", 17: "organ", 18: "organ", 19: "organ", 20: "accordion",
    21: "accordion", 22: "harmonica", 23: "accordion",
    24: "guitar-acoustic", 25: "guitar-acoustic", 26: "guitar-electric",
    27: "guitar-electric", 28: "guitar-electric", 29: "guitar-electric",
    30: "guitar-electric", 31: "guitar-electric",
    32: "standup-bass", 33: "digital-bass", 34: "digital-bass",
    35: "funk-bass", 36: "funk-bass", 37: "funk-bass", 38: "digital-bass",
    39: "digital-bass",
    40: "violin", 41: "viola", 42: "cello", 43: "double-bass",
    44: "strings-pwm", 45: "harp", 46: "harp", 47: "timpani",
    48: "strings-pwm", 49: "strings-pwm", 50: "strings-pwm",
    51: "strings-pwm", 52: "choir", 53: "vocal-female", 54: "choir",
    55: "timpani",
    56: "trumpet", 57: "trombone", 58: "tuba", 59: "trumpet",
    60: "french-horn", 61: "brass-section", 62: "brass-section",
    63: "brass-section",
    64: "saxophone", 65: "saxophone", 66: "saxophone", 67: "saxophone",
    68: "oboe", 69: "english-horn", 70: "bassoon", 71: "clarinet",
    72: "piccolo", 73: "flute", 74: "penny-whistle", 75: "flute",
    76: "conch-shell", 77: "flute", 78: "whistling", 79: "flute",
    80: "mono-solo", 81: "new-age-lead", 82: "new-age-lead",
    83: "mellow-70s-lead", 84: "mellow-70s-lead", 85: "vocal-male",
    86: "trance-5th", 87: "digital-bass",
    88: "angels", 89: "aurora", 90: "celestial-wash", 91: "choir",
    92: "galactic-cathedral", 93: "dark-city", 94: "terra-enceladus",
    95: "galactic-chapel",
    96: "ocean-waves", 97: "wind", 98: "bell", 99: "celestial-wash",
    100: "galactic-chapel", 101: "laser", 102: "space-attack!",
    103: "android-dreams",
    104: "sitar", 105: "banjo", 106: "lute", 107: "kora", 108: "marimba",
    109: "bagpipes", 110: "violin", 111: "hurdy-gurdy",
    112: "bell", 113: "bongos", 114: "positronic-rhythm", 115: "claves",
    116: "conga", 117: "timpani", 118: "snare-drum", 119: "cymbal",
    120: "toad", 121: "motor", 122: "ocean-waves", 123: "cat",
    124: "digital-alarm-clock", 125: "motor", 126: "space-attack!",
    127: "laser",
}


def gm_program_to_patch(program: int) -> str:
    return GM_TO_WELSH.get(int(program), "piano")
