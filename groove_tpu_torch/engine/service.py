"""Interactive engine service — the OrchestratorPanel equivalent (port of
groove_tpu/engine/service.py over this package's engines).

The reference runs a dedicated service thread taking OrchestratorInput
commands over a channel (ProjectOpen/Play/Stop/Tempo/track CRUD, project
save/load — src/panels/orchestrator_panel.rs:21-56, 104-202) while the
audio callback pulls frames (audio_panel.rs). Here:

  - commands go through a queue to a worker thread;
  - Play renders the compiled song (engine/render.Renderer on the
    service's torch device, "cuda" unless the caller asks for another) and
    streams it through the native ring-buffer audio service at realtime;
    loop playback and the loop bounce run engine/stream.StreamingRenderer
    on the same device;
  - edits (tempo, track add/remove) mutate the SongSettings and trigger a
    recompile — the dynamic counterpart of the offline compiler.

Events are surfaced via a callback (the GrooveEvent/toast path).

Where it departs from the reference: EngineService takes `device` and
refuses a CUDA device when torch sees none (it never drops to the CPU);
renders come back to the host as numpy float32 [n, 2]; render-wav
quantizes them on the host through io.wav, which gives the bytes of the
CLI's --wav (Renderer.render_quantized quantizes on the device, with the
same bits). The reference's worker turns every exception into an "error"
event; so does this one. Every render runs on the worker thread.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.save import save_project
from groove_tpu_torch.project.schema import SongSettings


@dataclass
class Command:
    kind: str   # open|new|play|stop|tempo|save|quit|render-wav|track-*|
                # device-*  (OrchestratorInput parity,
                # src/panels/orchestrator_panel.rs:21-56)
    arg: object = None


class EngineService:
    def __init__(self, on_event: Optional[Callable[[str, object], None]] = None,
                 sample_rate: int = 44100, use_audio: bool = True,
                 device="cuda"):
        if str(device).startswith("cuda"):
            from groove_tpu_torch import require_cuda
            require_cuda()
        self.device = device
        self.sample_rate = sample_rate
        self.on_event = on_event or (lambda kind, data: None)
        self.use_audio = use_audio
        self.song: Optional[SongSettings] = None
        self.compiled = None
        self.renderer: Optional[Renderer] = None
        self.loop_range: Optional[tuple[float, float]] = None  # beats
        self.is_loop_enabled = False
        self._samples: Optional[np.ndarray] = None
        self._dirty = True
        self._q: "queue.Queue[Command]" = queue.Queue()
        self._stop_playback = threading.Event()
        self._playing = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public API (thread-safe) ------------------------------------------

    def open_project(self, path):
        self._q.put(Command("open", path))

    def play(self):
        # clear the stop flag HERE (enqueue time), never at stream start:
        # clearing inside _stream/_stream_chunks erased a stop()/shutdown()
        # issued between play() and the worker dequeuing it — with a loop
        # range enabled, stream_loop(iterations=None) then played forever
        # and 'quit' was never processed
        self._stop_playback.clear()
        self._q.put(Command("play"))

    def stop(self):
        self._stop_playback.set()

    def set_tempo(self, bpm: float):
        self._q.put(Command("tempo", float(bpm)))

    def save(self, path):
        self._q.put(Command("save", path))

    def render_wav(self, path):
        self._q.put(Command("render-wav", path))

    # loop range (orchestrator.rs:983-1000 set_loop/clear_loop/
    # set_loop_enabled; beat-unit fields in the control bar,
    # src/panels/control_panel.rs:143-170)

    def set_loop(self, start_beats: float, end_beats: float):
        self._q.put(Command("set-loop", (float(start_beats),
                                         float(end_beats))))

    def set_loop_enabled(self, enabled: bool):
        self._q.put(Command("loop-enabled", bool(enabled)))

    def clear_loop(self):
        self._q.put(Command("clear-loop"))

    def render_loop_wav(self, path, iterations: int = 4):
        """Bounce the looped performance ([0, end) then `iterations` passes
        of [start, end), state carried across seams) to a WAV."""
        self._q.put(Command("render-loop-wav", (path, int(iterations))))

    # track / entity CRUD (OrchestratorInput::TrackNewMidi /
    # TrackDeleteSelected / TrackDuplicateSelected / TrackAddEntity /
    # TrackPatternRemoveSelected — orchestrator_panel.rs:37-51)

    def new_project(self):
        self._q.put(Command("new"))

    def add_track(self, track_id: Optional[str] = None,
                  midi_channel: Optional[int] = None):
        self._q.put(Command("track-new", (track_id, midi_channel)))

    def remove_track(self, track_id: str):
        self._q.put(Command("track-delete", track_id))

    def duplicate_track(self, track_id: str):
        self._q.put(Command("track-duplicate", track_id))

    def remove_pattern_from_track(self, track_id: str, pattern_id: str):
        self._q.put(Command("track-pattern-remove", (track_id, pattern_id)))

    def add_device(self, kind: str, uvid: Optional[str] = None,
                   midi_channel: int = 0,
                   midi_out: Optional[int] = None):
        """Palette drop: instantiate an entity by factory key and patch it
        to the main mixer (PaletteAction::NewDevice). midi_out applies to
        CONTROLLERS only (the reference's arpeggiator listens on one
        channel and emits on another, demos/controllers/arpeggiator.json:
        in 1 -> out 0); default = midi_channel — note an arpeggiator with
        in == out doubles the channel's notes with its own output."""
        self._q.put(Command("device-add", (kind, uvid, midi_channel,
                                           midi_out)))

    def remove_device(self, uvid: str):
        self._q.put(Command("device-remove", uvid))

    def set_device_param(self, uvid: str, name: str, value):
        """Set a device's configured parameter (domain units) — the
        per-entity parameter widgets' message (the reference's Control
        derive exposes the same names; compiler/params.py registry)."""
        self._q.put(Command("device-param", (uvid, name, value)))

    def set_automation(self, uvid: str, name: str, values,
                       note_value: str = "sixteenth"):
        """Replace the (device, param) automation with a drawn curve:
        N values become a ControlPath of N-1 slope steps on a
        `note_value` grid plus a ControlTrip targeting the param (the
        reference's trips, settings/src/controllers.rs + songs.rs:
        251-306). Empty values clears the automation."""
        self._q.put(Command("device-automation",
                            (str(uvid), str(name),
                             [float(v) for v in values], str(note_value))))

    def add_control_link(self, source: str, target: str, param: str):
        """GrooveInput::AddControlLink (messages.rs:13-38): connect a
        control source (LFO controller / signal-passthrough) to a
        target device's param by registry name. The link lands in the
        song's `controls` section exactly as a project file would write
        it, so save round-trips it."""
        self._q.put(Command("control-link-add",
                            (str(source), str(target), str(param))))

    def remove_control_link(self, source: str, target: str, param: str):
        """GrooveInput::RemoveControlLink: drop the matching link(s)."""
        self._q.put(Command("control-link-remove",
                            (str(source), str(target), str(param))))

    def set_pattern_step(self, pattern_id: str, row: int, notes):
        """Replace one step row of a pattern's note grid
        (PatternSettings.notes: Vec<Vec<u8>>, settings/src/lib.rs:48-78).
        `notes` is the new list of MIDI keys for that row ([] = rest)."""
        self._q.put(Command("pattern-step", (pattern_id, int(row),
                                             list(notes))))

    def set_pattern_note_value(self, pattern_id: str, note_value: str):
        """Set a pattern's step duration (PatternSettings.note_value,
        settings/src/lib.rs:48-78 — the per-pattern grid unit; the GUI's
        note-duration editor)."""
        self._q.put(Command("pattern-note-value",
                            (pattern_id, str(note_value))))

    def sync(self, timeout: float = 600.0) -> bool:
        """Block until every previously queued command has been processed
        (used by interactive front ends to refresh views after edits)."""
        done = threading.Event()
        self._q.put(Command("sync", done))
        return done.wait(timeout)

    def ensure_compiled(self, timeout: float = 600.0):
        """Recompile (if dirty) on the WORKER thread and return the
        CompiledSong — the front-end handshake for building live
        renderers against the current song without racing queued edits.

        Returns None when there is nothing VALID to hand out: no song,
        a compile failure (the error surfaced as an 'error' event —
        returning the previous project's CompiledSong here would
        silently resurrect the stale-live-renderer bug), or timeout."""
        box: dict = {}
        done = threading.Event()
        self._q.put(Command("ensure-compiled", (box, done)))
        if not done.wait(timeout) or not box.get("ok"):
            return None
        # the worker's snapshot, NOT self.compiled: a queued open/load
        # processed after done.set() could have swapped it (ADVICE r4)
        return box.get("compiled")

    def rendered_samples(self, loop_iterations: Optional[int] = None,
                         device: Optional[str] = None,
                         timeout: float = 600.0):
        """Render on the WORKER thread and return the [n, 2] samples (or
        None on timeout/empty). Front-end threads (GUI audio endpoints)
        must come through here rather than calling _ensure_rendered
        directly: the worker owns self.renderer/_samples, and a direct
        call races any queued edit/playback command mid-recompile. Also
        keeps GUI locks out of the (potentially minutes-long cold-
        compile) render — state polls stay responsive while this waits.

        device isolates ONE instrument's output (the spectrum tool's
        --device path) — also on the worker, because the isolated render
        reads self.renderer/compiled as a pair (a front-end read can see
        one fresh and one stale mid-recompile). A render error (e.g. an
        unknown/non-instrument device) re-raises HERE on the caller's
        thread."""
        box: dict = {}
        done = threading.Event()
        self._q.put(Command("render-out", (box, done, loop_iterations,
                                           device)))
        if not done.wait(timeout):
            return None
        if "error" in box:
            raise box["error"]
        return box.get("samples")

    def shutdown(self, timeout: float = 600.0):
        """Stops playback, drains pending commands, joins the worker.

        The join must outlast an in-flight compile+render: tearing down the
        interpreter while XLA compiles on the worker thread aborts the
        process."""
        self._stop_playback.set()
        self._q.put(Command("quit"))
        self._thread.join(timeout=timeout)

    def is_playing(self) -> bool:
        return self._playing.is_set()

    # -- worker --------------------------------------------------------------

    def _recompile(self):
        self.compiled = compile_song(self.song, Paths(),
                                     sample_rate=self.sample_rate)
        self.renderer = Renderer(self.compiled, self.device)
        self._samples = None
        self._dirty = False

    def _ensure_rendered(self):
        if self._dirty or self.renderer is None:
            self._recompile()
        if self._samples is None:
            self._samples = self.renderer.render()
        return self._samples

    def _isolated_samples(self, device: str):
        """One instrument's isolated [n, 2] output (utils/spectrum's
        --device path) — worker-only, like everything touching
        self.renderer."""
        import numpy as np

        from groove_tpu_torch.utils import profiling

        if self._ensure_rendered() is None:
            return None
        dev = self.compiled.devices.get(device)
        if dev is None or dev.role != "instrument":
            raise ValueError(f"{device!r} is not an instrument")
        r = self.renderer
        audio = r._render_instrument(r.inputs, dev, self.compiled.n_frames)
        return profiling.host_sync(audio).T  # [n, 2]

    def _loop(self):
        while True:
            cmd = self._q.get()
            try:
                if cmd.kind == "quit":
                    return
                if cmd.kind == "sync":
                    cmd.arg.set()
                    continue
                if cmd.kind == "open":
                    self.song = SongSettings.from_project_file(Path(cmd.arg))
                    self._dirty = True
                    self.on_event("project-opened", self.song.title)
                elif cmd.kind == "new":
                    self.song = SongSettings.from_json(
                        {"title": "Untitled", "clock": {"bpm": 128.0}})
                    self._dirty = True
                    self.on_event("project-new", None)
                elif cmd.kind == "tempo":
                    if self.song:
                        self.song.clock.bpm = cmd.arg
                        self._dirty = True
                        self.on_event("tempo", cmd.arg)
                elif cmd.kind.startswith(("track-", "device-", "pattern-",
                                          "control-link-")):
                    if self.song is not None and self._edit(cmd):
                        self._dirty = True
                elif cmd.kind == "save":
                    if self.song:
                        save_project(self.song, cmd.arg)
                        self.on_event("saved", str(cmd.arg))
                elif cmd.kind == "render-wav":
                    samples = self._ensure_rendered()
                    from groove_tpu_torch.io.wav import write_wav_16bit_stereo
                    write_wav_16bit_stereo(cmd.arg, samples, self.sample_rate)
                    self.on_event("rendered", str(cmd.arg))
                elif cmd.kind == "set-loop":
                    self.loop_range = cmd.arg
                    self.is_loop_enabled = True
                    self.on_event("loop-set", cmd.arg)
                elif cmd.kind == "loop-enabled":
                    self.is_loop_enabled = bool(cmd.arg)
                    self.on_event("loop-enabled", self.is_loop_enabled)
                elif cmd.kind == "clear-loop":
                    self.loop_range = None
                    self.is_loop_enabled = False
                    self.on_event("loop-cleared", None)
                elif cmd.kind == "ensure-compiled":
                    box, done = cmd.arg
                    try:
                        if self._dirty or self.renderer is None:
                            self._recompile()
                        # "ok" only when a VALID current compile exists —
                        # a raise above leaves it unset and the caller
                        # gets None instead of a stale CompiledSong
                        box["ok"] = self.compiled is not None
                        # SNAPSHOT on the worker (ADVICE r4): a queued
                        # open/load processed between done.set() and the
                        # caller's read could swap self.compiled under it
                        box["compiled"] = self.compiled
                    finally:
                        done.set()
                elif cmd.kind == "render-out":
                    box, done, iterations, device = cmd.arg
                    try:
                        if iterations:
                            box["samples"] = self._loop_samples(
                                int(iterations))
                        elif device:
                            box["samples"] = self._isolated_samples(device)
                        else:
                            box["samples"] = self._ensure_rendered()
                    except Exception as e:
                        box["error"] = e  # re-raised on the caller thread
                    finally:
                        done.set()
                elif cmd.kind == "render-loop-wav":
                    path, iterations = cmd.arg
                    samples = self._loop_samples(iterations)
                    if samples is not None:
                        from groove_tpu_torch.io.wav import (
                            write_wav_16bit_stereo)
                        write_wav_16bit_stereo(path, samples,
                                               self.sample_rate)
                        self.on_event("rendered", str(path))
                elif cmd.kind == "play":
                    if self.is_loop_enabled and self.loop_range is not None:
                        # seek-looped playback: infinite like the reference's
                        # tick loop (orchestrator.rs:868-874), until stop
                        if self._dirty or self.renderer is None:
                            self._recompile()
                        from groove_tpu_torch.engine.stream import (
                            StreamingRenderer)
                        sr_ = StreamingRenderer(self.compiled, self.device)
                        chunks = sr_.stream_loop(*self.loop_range,
                                                 iterations=None)
                        self.on_event("playback-started", None)
                        self._playing.set()
                        self._stream_chunks(chunks)
                        self._playing.clear()
                        self.on_event("playback-stopped", None)
                        continue
                    samples = self._ensure_rendered()
                    self.on_event("playback-started", None)
                    self._playing.set()
                    self._stream(samples)
                    self._playing.clear()
                    self.on_event("playback-stopped", None)
            except Exception as e:  # surfaced like the reference's toasts
                self.on_event("error", f"{type(e).__name__}: {e}")

    def _edit(self, cmd: Command) -> bool:
        """Track/device mutations on the settings tree (the reference edits
        its Orchestrator in place; the settings layer is our live model).
        Returns True when the song actually changed — a failed or no-op
        edit must not set _dirty (a spurious recompile costs ~2 min cold
        on this machine's remote compile service)."""
        from groove_tpu_torch.engine import factory
        from groove_tpu_torch.project.schema import (
            ControllerSettings,
            DeviceSettings,
            EffectSettings,
            InstrumentSettings,
            TrackSettings,
        )
        song = self.song
        if cmd.kind == "track-new":
            track_id, channel = cmd.arg
            used = {t.midi_channel for t in song.tracks}
            if channel is None:
                channel = next(c for c in range(16) if c not in used)
            if track_id is None:
                ids = {t.id for t in song.tracks}
                k = len(song.tracks) + 1
                while f"track-{k}" in ids:
                    k += 1
                track_id = f"track-{k}"
            song.tracks.append(TrackSettings(track_id, int(channel), []))
            self.on_event("track-added", track_id)
        elif cmd.kind == "track-delete":
            song.tracks = [t for t in song.tracks if t.id != cmd.arg]
            self.on_event("track-deleted", cmd.arg)
        elif cmd.kind == "track-duplicate":
            src = next((t for t in song.tracks if t.id == cmd.arg), None)
            if src is None:
                self.on_event("error", f"no track {cmd.arg!r}")
                return False
            ids = {t.id for t in song.tracks}
            k = 2
            while f"{src.id}-{k}" in ids:
                k += 1
            dup = TrackSettings(f"{src.id}-{k}", src.midi_channel,
                                list(src.pattern_ids))
            song.tracks.insert(song.tracks.index(src) + 1, dup)
            self.on_event("track-added", dup.id)
        elif cmd.kind == "track-pattern-remove":
            track_id, pattern_id = cmd.arg
            hit = False
            for t in song.tracks:
                if t.id == track_id and pattern_id in t.pattern_ids:
                    t.pattern_ids.remove(pattern_id)
                    hit = True
                    self.on_event("pattern-removed",
                                  (track_id, pattern_id))
            if not hit:
                return False
        elif cmd.kind == "device-add":
            kind, uvid, channel, midi_out = (cmd.arg if len(cmd.arg) == 4
                                             else (*cmd.arg, None))
            if midi_out is None:
                midi_out = channel
            try:
                proto = factory.prototype(kind)
            except KeyError:
                self.on_event("error", f"unknown entity kind {kind!r}")
                return False
            if uvid is None:
                existing = {d.uvid for d in song.devices}
                k = 1
                while f"{kind}-{k}" in existing:
                    k += 1
                uvid = f"{kind}-{k}"
            params = dict(proto.params)
            if proto.role == "instrument":
                dev = DeviceSettings(
                    "instrument", uvid,
                    instrument=InstrumentSettings(kind, int(channel), params))
            elif proto.role == "controller":
                dev = DeviceSettings(
                    "controller", uvid,
                    controller=ControllerSettings(kind, int(channel),
                                                  int(midi_out), params))
            else:
                dev = DeviceSettings("effect", uvid,
                                     effect=EffectSettings(kind, params))
            song.devices.append(dev)
            if proto.role != "controller" or \
                    kind in ("signal-passthrough-controller", "calculator"):
                song.patch_cables.append([uvid, "main-mixer"])
            self.on_event("device-added", uvid)
        elif cmd.kind == "device-automation":
            from groove_tpu_torch.core.time import BeatValue
            from groove_tpu_torch.project.schema import (
                ControlPathSettings,
                ControlStepSettings,
                ControlTargetSettings,
                ControlTripSettings,
            )
            uvid, name, values, nv = cmd.arg
            pid = f"auto-{uvid}-{name}"
            tid = f"trip-{uvid}-{name}"
            # REPLACE any trip on this target (editor semantics), then
            # drop only the paths those trips orphaned
            removed = [t for t in song.trips
                       if t.id == tid or (t.target.id == uvid
                                          and t.target.param == name)]
            song.trips = [t for t in song.trips if t not in removed]
            dead = {p for t in removed for p in t.path_ids}
            live = {p for t in song.trips for p in t.path_ids}
            # drop the editor path and any orphaned ones — but never a
            # path some SURVIVING trip still references (incl. pid
            # itself, if a foreign trip shares the editor's path id)
            drop = ({pid} | dead) - live
            song.paths = [p for p in song.paths if p.id not in drop]
            if values:
                if len(values) == 1:
                    steps = [ControlStepSettings("flat", values[0],
                                                 values[0])]
                else:
                    steps = [ControlStepSettings("slope", a, b)
                             for a, b in zip(values, values[1:])]
                existing_ids = {p.id for p in song.paths}
                new_pid, k = pid, 2
                while new_pid in existing_ids:  # pid kept alive above
                    new_pid = f"{pid}-{k}"
                    k += 1
                song.paths.append(ControlPathSettings(
                    new_pid, BeatValue.from_name(nv), steps))
                song.trips.append(ControlTripSettings(
                    tid, ControlTargetSettings(uvid, name), [new_pid]))
            self.on_event("automation-set", (uvid, name, len(values)))
        elif cmd.kind == "device-param":
            uvid, name, value = cmd.arg
            dev = next((d for d in song.devices if d.uvid == uvid), None)
            if dev is None:
                self.on_event("error", f"no device {uvid!r}")
                return False
            settings = dev.instrument or dev.controller or dev.effect
            settings.params[name] = value
            self.on_event("device-param", (uvid, name, value))
        elif cmd.kind == "pattern-step":
            pattern_id, row, notes = cmd.arg
            pat = next((p for p in song.patterns if p.id == pattern_id), None)
            if pat is None:
                self.on_event("error", f"no pattern {pattern_id!r}")
                return False
            while len(pat.notes) <= row:
                pat.notes.append([])
            pat.notes[row] = [int(n) for n in notes]
            self.on_event("pattern-step", (pattern_id, row, notes))
        elif cmd.kind == "pattern-note-value":
            from groove_tpu_torch.core.time import BeatValue

            pattern_id, name = cmd.arg
            pat = next((p for p in song.patterns if p.id == pattern_id), None)
            if pat is None:
                self.on_event("error", f"no pattern {pattern_id!r}")
                return False
            try:
                pat.note_value = BeatValue.from_name(name)
            except (KeyError, ValueError):
                self.on_event("error", f"unknown note value {name!r}")
                return False
            self.on_event("pattern-note-value", (pattern_id, name))
        elif cmd.kind == "control-link-add":
            from groove_tpu_torch.compiler.params import resolve
            from groove_tpu_torch.project.schema import (
                ControlSettings,
                ControlTargetSettings,
            )
            source, target, param = cmd.arg
            uvids = {d.uvid for d in song.devices}
            if source not in uvids or target not in uvids:
                self.on_event("error",
                              f"control link {source}->{target}: "
                              f"unknown device")
                return False
            tgt = next(d for d in song.devices if d.uvid == target)
            kind = (tgt.instrument or tgt.controller or tgt.effect).kind
            if resolve(kind, param) is None:
                self.on_event("error",
                              f"{kind} has no controllable param "
                              f"{param!r}")
                return False
            ids = {c.id for c in song.controls}
            lid = f"link-{source}-{target}-{param}"
            k = 2
            while lid in ids:
                lid = f"link-{source}-{target}-{param}-{k}"
                k += 1
            song.controls.append(ControlSettings(
                lid, source, ControlTargetSettings(target, param)))
            self.on_event("control-link-added", (source, target, param))
        elif cmd.kind == "control-link-remove":
            source, target, param = cmd.arg
            before = len(song.controls)
            song.controls = [
                c for c in song.controls
                if not (c.source == source and c.target.id == target
                        and c.target.param == param)
            ]
            self.on_event("control-link-removed",
                          (source, target, param, before - len(song.controls)))
            if len(song.controls) == before:
                return False  # nothing matched; song unchanged
        elif cmd.kind == "device-remove":
            uvid = cmd.arg
            song.devices = [d for d in song.devices if d.uvid != uvid]
            song.patch_cables = [
                [u for u in cable if u != uvid]
                for cable in song.patch_cables
            ]
            song.patch_cables = [c for c in song.patch_cables if len(c) >= 2]
            self.on_event("device-removed", uvid)
        return True

    def _loop_samples(self, iterations: int) -> Optional[np.ndarray]:
        """Bounded loop bounce: [0, end) + `iterations` x [start, end)."""
        if self.loop_range is None:
            self.on_event("error", "no loop range set")
            return None
        if self._dirty or self.renderer is None:
            self._recompile()
        from groove_tpu_torch.engine.stream import StreamingRenderer
        sr_ = StreamingRenderer(self.compiled, self.device)
        chunks = list(sr_.stream_loop(*self.loop_range,
                                      iterations=iterations))
        return np.concatenate(chunks, axis=0)

    def _stream_chunks(self, chunk_iter):
        """Stream an (possibly unbounded) iterator of [n, 2] chunks to the
        audio service, stopping on the stop event (cleared by play(), so a
        stop request issued before playback starts still wins)."""
        if not self.use_audio:
            return
        try:
            from groove_tpu_torch.io import native
        except Exception:
            return
        if not native.available():
            return
        svc = native.AudioService(sample_rate=self.sample_rate,
                                  buffer_frames=64)
        try:
            import time as _time
            for chunk in chunk_iter:
                pos, n = 0, len(chunk)
                while pos < n:
                    if self._stop_playback.is_set():
                        return
                    need = svc.needs_frames()
                    if need > 0:
                        part = chunk[pos:pos + min(need, n - pos)]
                        svc.write(np.asarray(part, np.float32))
                        pos += len(part)
                    else:
                        _time.sleep(0.001)
        finally:
            svc.stop()

    def _stream(self, samples: np.ndarray):
        if not self.use_audio:
            return
        try:
            from groove_tpu_torch.io import native
        except Exception:
            return
        if not native.available():
            return
        svc = native.AudioService(sample_rate=self.sample_rate,
                                  buffer_frames=64)
        try:
            pos, n = 0, len(samples)
            import time as _time
            while pos < n and not self._stop_playback.is_set():
                need = svc.needs_frames()
                if need > 0:
                    chunk = samples[pos:pos + need]
                    svc.write(np.asarray(chunk, np.float32))
                    pos += len(chunk)
                else:
                    _time.sleep(0.001)
            while (svc.frames_consumed() < pos
                   and not self._stop_playback.is_set()):
                _time.sleep(0.005)
        finally:
            svc.stop()
