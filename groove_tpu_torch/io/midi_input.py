"""Live MIDI input service — the MidiPanel/MidiInterfaceService equivalent.

The reference wraps midir hardware ports in a service thread that forwards
incoming messages to the engine as MidiFromExternal events
(src/panels/midi_panel.rs:74-120; orchestrator.rs:599-601 broadcast). This
container has no MIDI hardware, so the transport is a byte stream: a named
pipe / file object / socket file delivering raw MIDI bytes. The parser is
a standard running-status MIDI byte machine; subscribers get
(channel, message) tuples like the reference's MidiPanelEvent::Midi.

Ports: `list_ports` reports stream sources (FIFOs under $GROOVE_MIDI_DIR),
standing in for midir's port enumeration/refresh.

(A copy of groove_tpu/io/midi_input.py, statement for
statement; tests/test_torch_hostcopy.py holds it so.)
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Callable, Optional


class MidiByteParser:
    """Incremental MIDI byte-stream parser with running status."""

    def __init__(self, on_message: Callable[[int, str, tuple], None]):
        self.on_message = on_message
        self._status = 0
        self._buf: list[int] = []

    _LENGTHS = {0x80: 2, 0x90: 2, 0xA0: 2, 0xB0: 2, 0xC0: 1, 0xD0: 1, 0xE0: 2}

    def feed(self, data: bytes) -> None:
        for b in data:
            if b >= 0xF8:
                continue  # realtime messages pass through parsers untouched
            if b & 0x80:
                if b >= 0xF0:
                    # System common (SysEx 0xF0, MTC, song pos/select, tune,
                    # EOX 0xF7): cancels running status per the MIDI spec.
                    # Their data bytes are discarded below (status==0), so a
                    # SysEx bulk dump cannot grow _buf unboundedly.
                    self._status = 0
                else:
                    self._status = b
                self._buf = []
                continue
            if not self._status:
                continue  # data byte with no channel status (e.g. SysEx body)
            self._buf.append(b)
            kind = self._status & 0xF0
            need = self._LENGTHS.get(kind, 0)
            if need and len(self._buf) >= need:
                self._emit(kind, self._status & 0x0F, tuple(self._buf[:need]))
                self._buf = []

    def _emit(self, kind: int, channel: int, data: tuple) -> None:
        if kind == 0x90 and data[1] > 0:
            self.on_message(channel, "note-on", data)
        elif kind == 0x80 or (kind == 0x90 and data[1] == 0):
            self.on_message(channel, "note-off", data)
        elif kind == 0xB0:
            self.on_message(channel, "control-change", data)
        elif kind == 0xC0:
            self.on_message(channel, "program-change", data)
        elif kind == 0xE0:
            self.on_message(channel, "pitch-bend", data)


class MidiInputService:
    """Reads raw MIDI bytes from a file-like source on a service thread."""

    def __init__(self, source, on_message: Callable[[int, str, tuple], None]):
        self._source = source
        self._parser = MidiByteParser(on_message)
        self._running = threading.Event()
        self._running.set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        # fd-backed sources (FIFOs, pipes, sockets) poll with a timeout so
        # stop() can always interrupt — a thread parked in a blocking
        # read() on a FIFO with a silent writer is not unblockable from
        # another thread. os.read also returns as soon as ANY bytes arrive,
        # where a buffered read(64) would hold a 3-byte note-on hostage
        # until 61 more bytes showed up.
        try:
            fd = self._source.fileno()
        except Exception:
            fd = None
        if fd is not None:
            import select
            import stat
            import time

            try:
                is_fifo = stat.S_ISFIFO(os.fstat(fd).st_mode)
            except (OSError, ValueError):
                is_fifo = False
            while self._running.is_set():
                try:
                    ready, _, _ = select.select([fd], [], [], 0.1)
                except (OSError, ValueError):
                    break  # source closed out from under us by stop()
                if not ready:
                    continue
                try:
                    chunk = os.read(fd, 64)
                except (OSError, ValueError):
                    break
                if not chunk:
                    if is_fifo:
                        # FIFO EOF only means the last WRITER closed —
                        # external MIDI programs open/write/close per
                        # session, and the read end stays valid for the
                        # NEXT writer's bytes. Breaking here killed the
                        # port after the first sender disconnected while
                        # the GUI still reported it connected. select()
                        # keeps reporting an EOF'd FIFO readable, so
                        # sleep to avoid a tight spin between writers.
                        time.sleep(0.05)
                        continue
                    break
                self._parser.feed(chunk)
        else:
            # non-fd sources (BytesIO, custom objects): read1 when
            # available returns with whatever is buffered
            read = getattr(self._source, "read1", None) or self._source.read
            while self._running.is_set():
                try:
                    chunk = read(64)
                except (ValueError, OSError):
                    break
                if not chunk:
                    break
                self._parser.feed(chunk)

    @property
    def alive(self) -> bool:
        """True while the reader thread is still pumping — the GUI's
        midi_connected indicator reads this so a dead port can never be
        reported as connected."""
        return self._thread.is_alive()

    def stop(self):
        self._running.clear()
        self._thread.join(timeout=5)
        try:
            self._source.close()
        except Exception:
            pass


def list_ports(midi_dir: Optional[str] = None) -> list[str]:
    """Enumerate FIFO 'ports' (midir port-listing equivalent)."""
    d = Path(midi_dir or os.environ.get("GROOVE_MIDI_DIR", "/tmp/groove-midi"))
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir() if p.is_fifo())
