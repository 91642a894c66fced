"""MIDI output service — the engine's MidiToExternal path.

The reference handles MIDI *output* ports alongside input in MidiPanel
(src/panels/midi_panel.rs:94-120: SelectMidiOutput, port refresh) and the
engine emits `GrooveEvent::MidiToExternal(channel, message)` events that
the app pump forwards to the selected hardware port
(orchestration/src/messages.rs:41-56). This container has no MIDI
hardware, so — mirroring io/midi_input.py — the transport is a byte sink:
a named pipe / file object / socket receiving raw MIDI bytes.

The encoder is the exact inverse of io/midi_input.MidiByteParser: standard
status bytes with running-status compression (consecutive messages with
the same status omit the status byte, the wire optimization every MIDI 1.0
sender applies).

(A copy of groove_tpu/io/midi_output.py, statement for
statement; tests/test_torch_hostcopy.py holds it so.)
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Optional

_STATUS = {
    "note-off": 0x80,
    "note-on": 0x90,
    "poly-aftertouch": 0xA0,
    "control-change": 0xB0,
    "program-change": 0xC0,
    "channel-aftertouch": 0xD0,
    "pitch-bend": 0xE0,
}


class MidiByteEncoder:
    """Stateful MIDI byte encoder with running status."""

    def __init__(self):
        self._status = 0

    def encode(self, channel: int, kind: str, data: tuple) -> bytes:
        base = _STATUS.get(kind)
        if base is None:
            raise ValueError(f"unknown MIDI message kind {kind!r}")
        status = base | (channel & 0x0F)
        payload = bytes(b & 0x7F for b in data)
        if status == self._status:
            return payload  # running status: data bytes only
        self._status = status
        return bytes([status]) + payload

    def reset(self) -> None:
        self._status = 0


class MidiOutputService:
    """Writes encoded MIDI messages to a byte sink ('port').

    `sink` is any object with write(bytes) (BytesIO, an opened FIFO, a
    socket file). Pass `flush_each=True` for pipe transports where the
    reader needs bytes promptly (the default; set False for bulk dumps).

    Note-on with velocity 0 is sent as-is — the parser on the other end
    treats it as note-off (MIDI 1.0 equivalence), and under running
    status it is one byte cheaper than switching to 0x8n.
    """

    def __init__(self, sink, flush_each: bool = True):
        self._sink = sink
        self._flush = flush_each and hasattr(sink, "flush")
        self._enc = MidiByteEncoder()
        self._lock = threading.Lock()

    def send(self, channel: int, kind: str, data: tuple) -> None:
        with self._lock:
            self._sink.write(self._enc.encode(channel, kind, data))
            if self._flush:
                self._sink.flush()

    def note_on(self, channel: int, key: int, velocity: int) -> None:
        self.send(channel, "note-on", (key, velocity))

    def note_off(self, channel: int, key: int) -> None:
        # vel-0 note-on: running-status friendly note-off (see class doc)
        self.send(channel, "note-on", (key, 0))

    def close(self) -> None:
        try:
            self._sink.close()
        except Exception:
            pass


def open_port(path: str | os.PathLike) -> MidiOutputService:
    """Open a FIFO/file 'port' for writing (midir output-port analog)."""
    return MidiOutputService(open(path, "wb"))


def list_out_ports(midi_dir: Optional[str] = None) -> list[str]:
    """Enumerate FIFO 'ports' (same namespace as input ports: a FIFO is
    bidirectional-agnostic; the reference lists the same device set for
    in and out, midi_panel.rs:94-120)."""
    d = Path(midi_dir or os.environ.get("GROOVE_MIDI_DIR", "/tmp/groove-midi"))
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir() if p.is_fifo())


def song_midi_events(compiled) -> list[tuple[int, int, str, tuple]]:
    """Flatten a CompiledSong's per-instrument note tensors back into a
    time-sorted MIDI event list [(frame, channel, kind, (key, vel))].

    This is the MidiToExternal stream for the whole performance: every
    note an instrument receives (sequencer patterns, arpeggiator output
    on its midi-out channel, SMF imports) in frame order, note-offs
    before note-ons at the same frame (so retriggers parse correctly).
    Exception: a ZERO-LENGTH note (on == off — buffer quantization and
    the mono steal policy both produce them) emits its own off AFTER its
    on; the frame-sorted off-before-on rule would otherwise send the off
    first and leave the receiver with a hung note.
    """
    events: list[tuple[int, int, int, str, tuple]] = []
    seen_channels: set[int] = set()
    for dev in compiled.devices.values():
        notes = getattr(dev, "notes", None)
        if notes is None or notes.count == 0 or dev.midi_in < 0:
            continue
        if dev.midi_in in seen_channels:
            continue  # two instruments on one channel hear the same notes
        seen_channels.add(dev.midi_in)
        for i in range(notes.count):
            key = int(notes.keys[i])
            vel = int(notes.vels[i])
            on_f = int(notes.on_frames[i])
            off_f = int(notes.off_frames[i])
            events.append((on_f, 1, dev.midi_in, "note-on", (key, vel)))
            off_rank = 2 if off_f <= on_f else 0
            events.append((max(off_f, on_f), off_rank, dev.midi_in,
                           "note-on", (key, 0)))
    events.sort(key=lambda e: (e[0], e[1]))
    return [(f, ch, kind, data) for f, _, ch, kind, data in events]


def stream_song_midi(compiled, service: MidiOutputService,
                     realtime: bool = False) -> int:
    """Send a compiled song's full MIDI stream through an output port.
    With realtime=True, paces events by their frame times (a hardware
    sequencer bounce); otherwise dumps as fast as the sink accepts.
    Returns the number of messages sent."""
    events = song_midi_events(compiled)
    sr = float(compiled.sample_rate)
    t0 = time.monotonic()
    for frame, channel, kind, data in events:
        if realtime:
            due = t0 + frame / sr
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        service.send(channel, kind, data)
    return len(events)
