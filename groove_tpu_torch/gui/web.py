"""Windowed (pixel) GUI: the groove-egui analog served to a browser.

The reference ships an eframe/egui windowed DAW (src/bin/groove-egui.rs:
96-159) — this image has no desktop GUI toolkit, so the windowed surface
is rendered by the browser instead: a stdlib HTTP server exposes the
same panel set the TUI mirrors, as a single dark-theme page with real
pixel widgets (canvas waveform, sliders, a clickable pattern grid):

  top    — ControlBar: title, BPM spinner, transport, loop checkbox +
           range (src/panels/control_panel.rs:80-173)
  left   — PalettePanel: entity factory keys, click-to-add
           (palette_panel.rs:30-46)
  right  — EntityBrowser: project tree, click-to-open
           (legacy/thing_browser.rs:14-50)
  center — OrchestratorPanel: track lanes with channel devices
           (orchestrator_panel.rs), the generated per-entity parameter
           sliders (Control-derive registry, compiler/params.py), the
           pattern note grid (settings/src/lib.rs:48-78), and a master
           waveform canvas
  bottom — toasts / event log (groove-egui.rs:386-392)

All mutations go through EngineService (the OrchestratorInput analog),
so the web page, the TUI, and the tests drive the same engine surface.
No external dependencies: http.server + hand-written HTML/JS.

Usage: python -m groove_tpu_torch.gui.web [project] [--port 8177]
    [--no-audio] [--device cuda]

(A copy of groove_tpu/gui/web.py, statement for statement, held so by
tests/test_torch_hostcopy.py, but for two names: WebGui builds its model's
service and the piano strip's LiveSongRenderer on the torch device it is
given ("cuda" unless the caller asks for another), and main takes
--device. The service renders on its worker thread and the live renderer
on a request thread; both may launch at once, each on its thread's
current CUDA stream.)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import struct

from groove_tpu_torch.compiler import params as param_mod
from groove_tpu_torch.engine import factory
from groove_tpu_torch.gui.model import TuiModel


def wav_header(sample_rate: int, n_frames: int | None) -> bytes:
    """RIFF/WAVE header for 16-bit stereo PCM. n_frames=None emits the
    streaming convention (0xFFFFFFFF sizes — players treat the data chunk
    as unbounded; the reference's audio panel similarly feeds an open-
    ended stream, src/panels/audio_panel.rs:75-142)."""
    if n_frames is None:
        data_len = 0xFFFFFFFF - 36
        riff_len = 0xFFFFFFFF
    else:
        data_len = n_frames * 4
        riff_len = 36 + data_len
    return (b"RIFF" + struct.pack("<I", riff_len) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2,
                                    int(sample_rate),
                                    int(sample_rate) * 4, 4, 16)
            + b"data" + struct.pack("<I", data_len))


class WebGui:
    """State/actions facade over the shared view-model + service."""

    def __init__(self, use_audio: bool = False, device="cuda"):
        self.device = device
        self.model = TuiModel(use_audio=use_audio, device=device)
        self.lock = threading.RLock()
        self._live = None          # lazy LiveSongRenderer (piano strip)
        self._live_lock = threading.RLock()
        self._live_token = 0       # /api/audio/live single-listener token
        self._midi_svc = None      # MidiInputService (MIDI ports panel)
        self._midi_port = None

    # -- state ----------------------------------------------------------

    def state(self) -> dict:
        with self.lock:
            m = self.model
            song = m.song
            tracks = []
            for t in m.tracks():
                tracks.append({
                    "id": t.id,
                    "channel": t.midi_channel,
                    "patterns": list(t.pattern_ids),
                    "devices": m.devices_for_channel(t.midi_channel),
                    "selected": t.id == m.selected_track,
                })
            params = []
            for uvid, kind, p, value in m.param_rows():
                cv = None
                if isinstance(value, (int, float)):
                    try:
                        cv = float(p.from_domain(float(value)))
                    except Exception:
                        cv = None
                params.append({"uvid": uvid, "kind": kind, "name": p.name,
                               "value": value, "cv": cv,
                               "curve": self._curve_cv(uvid, p)})
            pat = m._sel_pattern()
            from groove_tpu_torch.core.time import BeatValue
            from groove_tpu_torch.io.midi_input import list_ports
            return {
                "note_values": [bv.serde_name for bv in BeatValue],
                "midi_ports": list_ports(),
                "midi_connected": (
                    self._midi_port
                    if self._midi_svc is not None and self._midi_svc.alive
                    else None),
                "title": song.title if song else None,
                "bpm": song.clock.bpm if song else None,
                "playing": m.svc.is_playing(),
                "loop_enabled": m.svc.is_loop_enabled,
                "loop_range": m.svc.loop_range,
                "project_path": m.project_path,
                "tracks": tracks,
                "effects": m.effect_chain(),
                "palette": factory.sorted_keys(),
                "browser": [str(p) for p in m.browser_files],
                "params": params,
                "pattern": None if pat is None else {
                    "id": pat.id,
                    "rows": [list(r) for r in pat.notes],
                    "note_value": (pat.note_value.serde_name
                                   if pat.note_value else None),
                },
                "events": [[k, str(d) if d is not None else ""]
                           for k, d in m.events[-10:]],
            }

    def _curve_cv(self, uvid: str, p) -> list | None:
        """ControlValue (0..1) samples of any trip targeting
        (uvid, p.name) — the drawable automation lane's current shape.
        Trip step values already ARE ControlValues (the compiler maps
        them through to_domain), so no conversion here."""
        song = self.model.song
        if song is None:
            return None
        trip = next((t for t in song.trips
                     if t.target.id == uvid and t.target.param == p.name),
                    None)
        if trip is None:
            return None
        paths = {pa.id: pa for pa in song.paths}
        vals: list[float] = []
        last = None
        for pid in trip.path_ids:
            pa = paths.get(pid)
            if pa is None:
                continue
            for st in pa.steps:
                vals.append(st.start)
            last = pa
        if vals and last is not None and last.steps \
                and last.steps[-1].kind != "flat":
            vals.append(last.steps[-1].end)
        return [max(0.0, min(1.0, float(v))) for v in vals] or None

    def _audio(self, device: str | None):
        """[n(, 2)] float audio of the master, or one instrument isolated
        (the spectrum tool's --device path, utils/spectrum.py). Renders on
        the service WORKER thread (svc.rendered_samples) — callers must
        NOT hold self.lock around this: a cold compile takes ~2 min on
        this machine and would freeze every /api/state poll."""
        import numpy as np
        svc = self.model.svc
        # device-isolated renders also go through the worker: the
        # isolated path reads (renderer, compiled) as a PAIR, which a
        # front-end read can see half-updated mid-recompile
        samples = svc.rendered_samples(device=device)
        if samples is None or not len(samples):
            return None
        return np.asarray(samples)

    def waveform(self, bins: int = 600, device: str | None = None) -> dict:
        """Per-bin |peak| of the rendered master — or of one instrument's
        isolated output (the per-track waveform lane)."""
        import numpy as np
        svc = self.model.svc
        audio = self._audio(device)  # worker-thread render, lock-free
        with self.lock:
            if audio is None:
                return {"peaks": [], "frames": 0, "rate": svc.sample_rate}
            mono = np.abs(audio).max(axis=1)
            n = len(mono)
            edge = np.linspace(0, n, bins + 1).astype(int)
            peaks = [float(mono[a:b].max()) if b > a else 0.0
                     for a, b in zip(edge[:-1], edge[1:])]
            return {"peaks": peaks, "frames": n, "rate": svc.sample_rate}

    def spectrum(self, cols: int = 240, device: str | None = None) -> dict:
        """Log-frequency spectrum columns (Spectrum.columns — the same
        binning the terminal plot uses; the browser draws the bars).
        The reference carries a spectrum-analyzer dependency + plotters
        `visualization` feature (Cargo.toml:38,42)."""
        from groove_tpu_torch.utils.spectrum import Spectrum, analyze
        svc = self.model.svc
        audio = self._audio(device)  # worker-thread render, lock-free
        with self.lock:
            if audio is None:
                return {"db": [], "f_lo": 20.0, "f_hi": 20000.0,
                        "floor": Spectrum.FLOOR}
            sp = analyze(audio.T, svc.sample_rate)
            out, f_lo, f_hi = sp.columns(cols)
            return {"db": [float(v) for v in out], "f_lo": f_lo,
                    "f_hi": f_hi, "floor": Spectrum.FLOOR}

    # -- audio ----------------------------------------------------------

    def audio_wav(self, device: str | None = None,
                  loop: int | None = None) -> bytes | None:
        """Complete 16-bit stereo WAV of the current render — the whole
        song, one instrument isolated (?device=), or a bounded loop
        bounce (?loop=N iterations). PCM bytes are the ONE quantization
        spec (io.wav._chunk_to_i2), so they byte-match the CLI's --wav
        output / the quantized stream segments for the same samples.
        This is what makes Play in the browser audible: the reference
        pumps rendered buffers to the sound card (audio_panel.rs:75-142);
        the environment-legitimate sound card here is the browser's
        <audio> element."""
        from groove_tpu_torch.io.wav import _chunk_to_i2

        # No GUI lock here: the render runs on the service worker thread
        # (rendered_samples posts a command and waits), so /api/state and
        # Stop stay responsive during a cold compile instead of blocking
        # behind a minutes-long render inside self.lock.
        svc = self.model.svc
        if loop:
            samples = svc.rendered_samples(loop_iterations=int(loop))
        else:
            samples = self._audio(device)
        sr = svc.sample_rate
        if samples is None:
            return None
        pcm = _chunk_to_i2(samples).tobytes()
        return wav_header(sr, len(samples)) + pcm

    def live_renderer(self):
        """The lazy live-voice renderer behind the piano strip (the
        LiveSongService path: engine/livesong.LiveSongRenderer voice
        pools + per-block streaming)."""
        from groove_tpu_torch.engine.livesong import LiveSongRenderer

        # double-checked: the (up to minutes-long, cold-cache) compile
        # runs OUTSIDE _live_lock so _invalidate_live — and through it
        # command() holding self.lock — never blocks behind a live
        # listener's rebuild
        with self._live_lock:
            if self._live is not None:
                return self._live
        compiled = self.model.svc.ensure_compiled()
        if compiled is None:
            raise RuntimeError("no compiled song — open a project, or see "
                               "the event log for the compile error")
        with self._live_lock:
            if self._live is None:
                self._live = LiveSongRenderer(compiled, n_voices=8,
                                              device=self.device)
            return self._live

    def _invalidate_live(self) -> None:
        """Drop the lazily-built live renderer so the next live event
        compiles against the CURRENT song: an open/new/device edit
        otherwise leaves the piano strip and any connected MIDI port
        playing the PREVIOUS project's instruments. Purely a drop —
        NO eager rebuild (callers hold self.lock; a rebuild means a
        compile): the MIDI callback and live_chunks both resolve the
        renderer lazily per event/chunk, so the next note or chunk
        rebuilds against the current song on its own thread."""
        with self._live_lock:
            self._live = None

    def live_note(self, kind: str, key: int, velocity: int = 96,
                  channel: int = 0) -> None:
        lr = self.live_renderer()
        if kind == "on":
            lr.note_on(int(channel), int(key), int(velocity))
        else:
            lr.note_off(int(channel), int(key))

    def midi_connect(self, port: str) -> None:
        """Connect a FIFO MIDI port (io.midi_input.list_ports — the midir
        port-listing analog, src/panels/midi_panel.rs:94-120) to the
        live-voice renderer: hardware/external events play the song's
        instruments exactly like the piano strip."""
        import os

        from groove_tpu_torch.io.midi_input import MidiInputService

        self.midi_disconnect()
        fd = os.open(port, os.O_RDONLY | os.O_NONBLOCK)
        src = os.fdopen(fd, "rb", buffering=0)

        def on_midi(ch, kind, data):
            # resolve the renderer PER EVENT (not pinned at connect
            # time) so project edits take effect without reconnecting;
            # the first event after an invalidation pays the rebuild on
            # the reader thread. Exceptions stay on this thread as
            # error events — they must not kill the reader.
            try:
                self.live_renderer().handle_midi(ch, kind, data)
            except Exception as e:
                self.model._on_event("error", f"midi: {e}")

        self._midi_svc = MidiInputService(src, on_midi)
        self._midi_port = port
        self.model._on_event("midi-connect", port)

    def midi_disconnect(self) -> None:
        if self._midi_svc is not None:
            try:
                self._midi_svc.stop()
            except Exception:
                pass
            self.model._on_event("midi-disconnect", self._midi_port)
        self._midi_svc = None
        self._midi_port = None

    def live_chunks(self, blocks_per_chunk: int = 32):
        """Unbounded generator of [n, 2] float chunks from the live
        renderer (~46 ms per chunk at 64-frame blocks) — the /api/audio/
        live chunked-WAV body.

        Single listener: each new generator takes the live token; the
        previous one stops at its next chunk boundary. ThreadingHTTPServer
        otherwise leaves a browser reload's ZOMBIE connection alternately
        stealing blocks from the shared renderer (each listener hears
        every other chunk and the live clock runs double-speed). The
        renderer is re-fetched per chunk so a project edit's
        _invalidate_live takes effect mid-stream."""
        import numpy as np

        with self._live_lock:
            self._live_token += 1
            token = self._live_token
        while True:
            with self._live_lock:
                if token != self._live_token:
                    return  # superseded by a newer listener
            lr = self.live_renderer()
            parts = [lr.render_block() for _ in range(blocks_per_chunk)]
            yield np.concatenate(parts, axis=0)

    # -- commands -------------------------------------------------------

    def command(self, cmd: str, a: dict) -> dict:
        with self.lock:
            m, svc = self.model, self.model.svc
            if cmd == "open":
                m.open_project(a["path"])
            elif cmd == "new":
                svc.new_project()
                svc.sync()
                m.project_path = None
            elif cmd == "save":
                m.save_project(a.get("path"))
            elif cmd == "play":
                svc.play()
            elif cmd == "stop":
                svc.stop()
            elif cmd == "bpm":
                svc.set_tempo(max(1.0, float(a["value"])))
                svc.sync()
            elif cmd == "loop_toggle":
                m.toggle_loop()
            elif cmd == "loop_range":
                m.set_loop_range(float(a["start"]), float(a["end"]))
            elif cmd == "add_track":
                svc.add_track()
                svc.sync()
            elif cmd == "remove_track":
                svc.remove_track(a["id"])
                svc.sync()
            elif cmd == "dup_track":
                svc.duplicate_track(a["id"])
                svc.sync()
            elif cmd == "select_track":
                m.selected_track = a["id"]
            elif cmd == "add_device":
                if "channel" in a:  # drag-and-drop onto a specific track
                    ch = int(a["channel"])
                else:
                    t = m._sel_track()
                    ch = t.midi_channel if t else 0
                svc.add_device(a["kind"], midi_channel=ch)
                svc.sync()
            elif cmd == "remove_device":
                svc.remove_device(a["uvid"])
                svc.sync()
            elif cmd == "set_param":
                # slider sends ControlValue 0..1; convert through the
                # registry's domain mapping (the reference's widget range)
                p = next((p for p in param_mod.REGISTRY.get(a["kind"], [])
                          if p.name == a["name"]), None)
                if p is None:
                    return {"ok": False, "error": "unknown param"}
                svc.set_device_param(
                    a["uvid"], a["name"],
                    p.to_domain(min(1.0, max(0.0, float(a["cv"])))))
                svc.sync()
            elif cmd == "set_automation":
                # trip step values ARE ControlValues 0..1 (the compiler
                # applies the registry's to_domain when it evaluates the
                # curve, compiler/song.py) — pass the canvas samples
                # through unconverted
                p = next((p for p in param_mod.REGISTRY.get(a["kind"], [])
                          if p.name == a["name"]), None)
                if p is None:
                    return {"ok": False, "error": "unknown param"}
                vals = [min(1.0, max(0.0, float(v)))
                        for v in a.get("cvs", [])]
                svc.set_automation(a["uvid"], a["name"], vals,
                                   a.get("note_value", "sixteenth"))
                svc.sync()
            elif cmd == "pattern_step":
                svc.set_pattern_step(a["id"], int(a["row"]),
                                     [int(k) for k in a["notes"]])
                svc.sync()
            elif cmd in ("note_on", "note_off"):
                # piano strip: events route through the live-voice path
                # (engine/livesong) — the GUI's play-along surface
                self.live_note(cmd[5:], a["key"],
                               a.get("velocity", 96), a.get("channel", 0))
            elif cmd == "pattern_note_value":
                svc.set_pattern_note_value(a["id"], a["value"])
                svc.sync()
            elif cmd == "midi_connect":
                self.midi_connect(a["port"])
            elif cmd == "midi_disconnect":
                self.midi_disconnect()
            else:
                return {"ok": False, "error": f"unknown command {cmd}"}
            if cmd in self._SONG_MUTATORS:
                self._invalidate_live()
            return {"ok": True}

    # commands after which the live renderer's compiled song is stale
    # (anything that edits the project the piano strip / MIDI port plays)
    _SONG_MUTATORS = frozenset({
        "open", "new", "bpm", "add_track", "remove_track", "dup_track",
        "add_device", "remove_device", "set_param", "set_automation",
        "pattern_step", "pattern_note_value",
    })


def make_server(gui: WebGui, port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked live-audio streaming

        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_live_audio(self):
            """Chunked-transfer WAV of the live renderer — plays in an
            <audio> element for as long as the connection stays open."""
            from groove_tpu_torch.io.wav import _chunk_to_i2

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(b"%x\r\n" % len(data))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            sr = gui.model.svc.sample_rate
            try:
                chunk(wav_header(sr, None))
                for part in gui.live_chunks():
                    chunk(_chunk_to_i2(part).tobytes())
            except (BrokenPipeError, ConnectionResetError):
                pass  # listener closed the <audio> element
            except Exception as e:  # noqa: BLE001
                # the 200 + chunked headers are already on the wire: a
                # second response head (do_GET's 500 handler) would be
                # malformed HTTP on this connection. Log and terminate
                # the chunked body instead (ADVICE r4).
                gui.model._on_event("error", f"live stream: {e}")
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        def do_GET(self):
            try:
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                q = parse_qs(u.query)
                device = (q.get("device") or [None])[0]
                if u.path in ("/", "/index.html"):
                    self._send(200, PAGE, "text/html; charset=utf-8")
                elif u.path == "/api/state":
                    self._send(200, json.dumps(gui.state()))
                elif u.path == "/api/waveform":
                    self._send(200, json.dumps(gui.waveform(device=device)))
                elif u.path == "/api/spectrum":
                    self._send(200, json.dumps(gui.spectrum(device=device)))
                elif u.path == "/api/audio/live":
                    self._send_live_audio()
                elif u.path == "/api/audio":
                    loop = (q.get("loop") or [None])[0]
                    body = gui.audio_wav(device=device,
                                         loop=int(loop) if loop else None)
                    if body is None:
                        self._send(404, '{"error": "nothing rendered"}')
                    else:
                        self._send(200, body, "audio/wav")
                else:
                    self._send(404, '{"error": "not found"}')
            except Exception as e:
                self._send(500, json.dumps({"error": str(e)}))

        def do_POST(self):
            try:
                if self.path != "/api/cmd":
                    self._send(404, '{"error": "not found"}')
                    return
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                cmd = body.pop("cmd", "")
                self._send(200, json.dumps(gui.command(cmd, body)))
            except Exception as e:
                self._send(500, json.dumps({"error": str(e)}))

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>groove</title><style>
:root{--bg:#191b1f;--panel:#22252b;--edge:#33373f;--fg:#d6d9de;
--dim:#8a8f98;--acc:#6aa1ff;--warm:#e0a050}
*{box-sizing:border-box;margin:0}
body{background:var(--bg);color:var(--fg);
font:13px/1.45 system-ui,"Segoe UI",sans-serif;height:100vh;
display:grid;grid-template-rows:auto 1fr auto;
grid-template-columns:220px 1fr 260px;
grid-template-areas:"bar bar bar" "pal mid bro" "log log log";gap:8px;
padding:8px}
.panel{background:var(--panel);border:1px solid var(--edge);
border-radius:6px;padding:8px;overflow:auto}
#bar{grid-area:bar;display:flex;gap:14px;align-items:center}
#pal{grid-area:pal}#bro{grid-area:bro}#mid{grid-area:mid;display:flex;
flex-direction:column;gap:8px;overflow:auto}
#log{grid-area:log;height:92px;font-family:ui-monospace,monospace;
font-size:12px;color:var(--dim)}
h3{font-size:11px;text-transform:uppercase;letter-spacing:.08em;
color:var(--dim);margin-bottom:6px}
.item{padding:2px 6px;border-radius:4px;cursor:pointer;
white-space:nowrap;overflow:hidden;text-overflow:ellipsis}
.item:hover{background:#2b2f37}.item.sel{background:#2e3c55}
button{background:#2b2f37;color:var(--fg);border:1px solid var(--edge);
border-radius:4px;padding:4px 12px;cursor:pointer}
button:hover{border-color:var(--acc)}
button.on{background:var(--acc);color:#10131a}
input[type=number]{width:72px;background:#14161a;color:var(--fg);
border:1px solid var(--edge);border-radius:4px;padding:3px 6px}
input[type=range]{width:160px;accent-color:var(--acc)}
#wave{width:100%;height:64px;background:#14161a;border-radius:4px}
#spec{width:100%;height:80px;background:#14161a;border-radius:4px;
margin-top:4px}
table{border-collapse:collapse}
td.cell{width:26px;height:20px;border:1px solid var(--edge);
text-align:center;font-size:11px;cursor:pointer;user-select:none}
td.cell.onn{background:var(--acc);color:#10131a}
.dev{color:var(--dim);font-size:12px;padding-left:16px}
.track{border-left:3px solid transparent;padding:4px 6px;margin:2px 0;
cursor:pointer}.track.sel{border-left-color:var(--warm);
background:#262a32}
.prow{display:flex;gap:8px;align-items:center;margin:2px 0}
.prow .nm{width:260px;color:var(--dim);overflow:hidden;
white-space:nowrap;text-overflow:ellipsis}
.prow .vv{width:70px;text-align:right;font-family:ui-monospace,monospace}
</style></head><body>
<div id="bar" class="panel">
 <b id="title">groove</b>
 <span>BPM <input id="bpm" type="number" step="1" min="1"></span>
 <button id="play">Play</button><button id="stop">Stop</button>
 <button id="loop">Loop</button>
 <span>range <input id="ls" type="number" step="1" style="width:56px">
 .. <input id="le" type="number" step="1" style="width:56px"></span>
 <button id="render">Render</button>
 <button id="save">Save</button>
 <audio id="player" controls preload="none"
  style="height:26px;vertical-align:middle"></audio>
 <span id="state" style="color:var(--warm)"></span>
</div>
<div id="pal" class="panel"><h3>palette — click to add</h3>
 <div id="palette"></div>
 <h3 style="margin-top:10px">tracks</h3>
 <button id="ntrk" style="width:100%">+ track</button></div>
<div id="mid">
 <div class="panel"><h3 style="cursor:pointer"
  onclick="focusDev=null;drawWave()">master / focus
  <span id="focus" style="color:var(--warm)"></span></h3>
  <canvas id="wave"></canvas><canvas id="spec"></canvas></div>
 <div class="panel"><h3>tracks</h3><div id="tracks"></div>
  <div id="effects" class="dev"></div></div>
 <div class="panel"><h3>pattern</h3><div id="pattern"></div></div>
 <div class="panel"><h3>piano — click/hold to play live
  <span style="color:var(--dim);text-transform:none">(selected track's
  channel)</span></h3><div id="piano"></div>
  <audio id="liveaudio" style="display:none"></audio></div>
 <div class="panel"><h3>params</h3><div id="params"></div></div>
</div>
<div id="bro" class="panel"><h3>projects — click to open</h3>
 <div id="browser"></div>
 <h3 style="margin-top:10px">midi ports
  <span style="cursor:pointer;color:var(--acc)" title="refresh"
   onclick="refresh()">⟳</span></h3>
 <div id="midi"></div></div>
<div id="log" class="panel"></div>
<script>
const $=id=>document.getElementById(id);
let S=null, bpmFocused=false;
async function cmd(c,a={}){a.cmd=c;
 await fetch('/api/cmd',{method:'POST',body:JSON.stringify(a)});
 await refresh();}
async function refresh(){
 S=await (await fetch('/api/state')).json();
 $('title').textContent=S.title||'(no project)';
 if(!bpmFocused)$('bpm').value=S.bpm?S.bpm.toFixed(0):'';
 $('play').classList.toggle('on',S.playing);
 $('loop').classList.toggle('on',S.loop_enabled);
 if(S.loop_range){$('ls').value=S.loop_range[0];
  $('le').value=S.loop_range[1];}
 $('state').textContent=S.playing?'PLAYING':'';
 $('palette').innerHTML=S.palette.map(k=>
  `<div class="item" draggable="true" `+
  `ondragstart="event.dataTransfer.setData('text/plain','${k}')" `+
  `onclick="cmd('add_device',{kind:'${k}'})">${k}</div>`
 ).join('');
 $('midi').innerHTML=(S.midi_ports||[]).map(p=>{
  const nm=p.split('/').pop(), on=(S.midi_connected===p);
  return `<div class="item${on?' sel':''}" title="${p}" `+
   `onclick="cmd(${on?`'midi_disconnect',{}`:
    `'midi_connect',{port:'${p}'}`})">${on?'● ':''}${nm}</div>`;
 }).join('')||'<div style="color:var(--dim)">(none — set '+
  'GROOVE_MIDI_DIR)</div>';
 $('browser').innerHTML=S.browser.map(p=>{
  const nm=p.split('/').pop();
  return `<div class="item" title="${p}" `+
   `onclick="cmd('open',{path:'${p}'})">${nm}</div>`;}).join('');
 $('tracks').innerHTML=S.tracks.map(t=>
  `<div class="track${t.selected?' sel':''}" `+
  `ondragover="event.preventDefault()" `+
  `ondrop="event.preventDefault();cmd('add_device',`+
  `{kind:event.dataTransfer.getData('text/plain'),`+
  `channel:${t.channel}})" `+
  `onclick="cmd('select_track',{id:'${t.id}'})">`+
  `<b>${t.id}</b> ch${t.channel} [${t.patterns.join(',')||'-'}] `+
  `<button onclick="event.stopPropagation();`+
  `cmd('dup_track',{id:'${t.id}'})">dup</button> `+
  `<button onclick="event.stopPropagation();`+
  `cmd('remove_track',{id:'${t.id}'})">del</button>`+
  t.devices.map(d=>{const u=d.split(' ')[0];
   return `<div class="dev">${d} <span title="waveform+spectrum" `+
    `style="cursor:pointer;color:var(--acc)" `+
    `onclick="event.stopPropagation();focusDev='${u}';drawWave()">`+
    `~</span> <span style="cursor:pointer;`+
    `color:var(--warm)" onclick="event.stopPropagation();`+
    `cmd('remove_device',{uvid:'${u}'})">✕</span></div>`;}).join('')+
  `</div>`).join('');
 $('effects').textContent=S.effects.length?
  'effects: '+S.effects.join('  '):'';
 renderPattern();renderParams();
 $('log').innerHTML=S.events.map(e=>
  `[${e[0]}] ${e[1]}`).join('<br>');
}
function renderPattern(){
 const el=$('pattern');
 if(!S.pattern){el.textContent='(select a track with a pattern)';return;}
 const nv=S.pattern.note_value||'';
 let html=`<div style="color:var(--dim)">${S.pattern.id} — step `+
  `<select onchange="cmd('pattern_note_value',`+
  `{id:'${S.pattern.id}',value:this.value})">`+
  (S.note_values||[]).map(v=>
   `<option${v===nv?' selected':''}>${v}</option>`).join('')+
  `</select> — click: `+
  `rest/note · shift-click: +1 semitone · alt-click: −1</div><table>`;
 S.pattern.rows.forEach((row,i)=>{
  const keys=row.filter(k=>k);
  html+=`<tr><td style="color:var(--dim);padding-right:6px">${i}</td>`+
   `<td class="cell${keys.length?' onn':''}" `+
   `onclick="stepClick(event,${i})">${keys.join(' ')||'·'}</td></tr>`;});
 el.innerHTML=html+'</table>';
}
function stepClick(ev,row){
 const r=S.pattern.rows[row], keys=r.filter(k=>k);
 let notes;
 if(ev.shiftKey)notes=keys.map(k=>Math.min(127,k+1));
 else if(ev.altKey)notes=keys.map(k=>Math.max(1,k-1));
 else notes=keys.length?[]:[60];
 cmd('pattern_step',{id:S.pattern.id,row:row,notes:notes});
}
let autoKey=null, autoVals=[], laneDown=false;
window.addEventListener('mouseup',()=>{laneDown=false;});
function pkey(p){return p.uvid+'|'+p.name;}
function renderParams(){
 // an open lane is an edit session: don't destroy its canvas (and the
 // in-progress drag) on the periodic state refresh
 if(autoKey!==null&&$('acv'))return;
 $('params').innerHTML=S.params.map(p=>
  `<div class="prow"><span class="nm">${p.uvid}.${p.name}</span>`+
  `<input type="range" min="0" max="1" step="0.01" `+
  `value="${p.cv==null?0.5:p.cv}" onchange="cmd('set_param',`+
  `{uvid:'${p.uvid}',kind:'${p.kind}',name:'${p.name}',`+
  `cv:this.value})">`+
  `<span class="vv">${p.value==null?'(default)':
   (typeof p.value=='number'?p.value.toPrecision(4):p.value)}</span>`+
  `<button class="${p.curve?'on':''}" title="automation" `+
  `onclick="autoToggle('${pkey(p)}')">A</button></div>`+
  (autoKey===pkey(p)?autoLane():'')).join('');
 if(autoKey!==null)bindLane();
}
function autoLane(){
 return `<div><canvas id="acv" width="512" height="64" `+
  `style="background:#14161a;border-radius:4px;cursor:crosshair">`+
  `</canvas><div><button onclick="autoApply()">apply</button> `+
  `<button onclick="autoClear()">clear</button>`+
  `<span style="color:var(--dim)"> drag to draw — 32 sixteenth-note `+
  `steps, bottom=min top=max</span></div></div>`;
}
function resampleCv(v,n){const out=[];for(let k=0;k<n;k++){
 const x=v.length==1?0:(k*(v.length-1)/(n-1));const a=Math.floor(x);
 const f=x-a;
 out.push(v[a]*(1-f)+v[Math.min(a+1,v.length-1)]*f);}return out;}
function autoParam(){return S.params.find(p=>pkey(p)===autoKey);}
function autoToggle(k){
 if(autoKey===k){autoKey=null;}
 else{autoKey=k;const p=S.params.find(q=>pkey(q)===k);
  autoVals=resampleCv(p.curve&&p.curve.length?p.curve:
   [p.cv==null?0.5:p.cv],32);}
 renderParams();
}
function drawLane(c){const g=c.getContext('2d');
 g.fillStyle='#14161a';g.fillRect(0,0,c.width,c.height);
 g.fillStyle='#e0a050';const bw=c.width/autoVals.length;
 autoVals.forEach((v,k)=>{const h=v*(c.height-4)+2;
  g.fillRect(k*bw+1,c.height-h,bw-2,h);});}
function bindLane(){
 const c=$('acv');if(!c)return;drawLane(c);
 const paint=e=>{const r=c.getBoundingClientRect();
  const n=autoVals.length;
  const k=Math.max(0,Math.min(n-1,
   Math.floor((e.clientX-r.left)/r.width*n)));
  autoVals[k]=Math.max(0,Math.min(1,1-(e.clientY-r.top)/r.height));
  drawLane(c);};
 c.onmousedown=e=>{laneDown=true;paint(e);};
 c.onmousemove=e=>{if(laneDown)paint(e);};
}
async function autoApply(){const p=autoParam();if(!p)return;
 autoKey=null;
 await cmd('set_automation',{uvid:p.uvid,kind:p.kind,name:p.name,
  cvs:autoVals});}
async function autoClear(){const p=autoParam();if(!p)return;
 autoKey=null;
 await cmd('set_automation',{uvid:p.uvid,kind:p.kind,name:p.name,
  cvs:[]});}
let focusDev=null;
async function drawWave(){
 const q=focusDev?('?device='+encodeURIComponent(focusDev)):'';
 $('focus').textContent=focusDev?('— '+focusDev):'';
 const w=await (await fetch('/api/waveform'+q)).json();
 const c=$('wave');c.width=c.clientWidth;c.height=c.clientHeight;
 const g=c.getContext('2d');g.fillStyle='#14161a';
 g.fillRect(0,0,c.width,c.height);
 g.fillStyle='#6aa1ff';
 const n=w.peaks.length;
 if(n){
  const bw=c.width/n, mid=c.height/2;
  const mx=Math.max(1,...w.peaks);
  w.peaks.forEach((p,i)=>{const h=Math.max(1,(p/mx)*mid);
   g.fillRect(i*bw,mid-h,Math.max(1,bw-0.5),2*h);});
 }
 const s=await (await fetch('/api/spectrum'+q)).json();
 drawSpec(s);
}
function drawSpec(s){
 const c=$('spec');c.width=c.clientWidth;c.height=c.clientHeight;
 const g=c.getContext('2d');g.fillStyle='#14161a';
 g.fillRect(0,0,c.width,c.height);
 const n=s.db.length;if(!n)return;
 const bw=c.width/n, lo=-96, hi=6;
 g.fillStyle='#7fc66a';
 s.db.forEach((v,i)=>{const h=Math.max(0,(v-lo)/(hi-lo))*c.height;
  g.fillRect(i*bw,c.height-h,Math.max(1,bw-0.4),h);});
 g.fillStyle='#8a8f98';g.font='10px monospace';
 [100,1000,10000].forEach(t=>{if(t>s.f_lo&&t<s.f_hi){
  const x=(Math.log(t)-Math.log(s.f_lo))/
   (Math.log(s.f_hi)-Math.log(s.f_lo))*c.width;
  g.fillText(t>=1000?(t/1000+'k'):''+t,x,10);}});
}
$('play').onclick=()=>{
 // audible playback: the <audio> element pulls the rendered WAV
 // (/api/audio — loop bounces honor the loop range); cmd('play') keeps
 // the service transport in step (events, is_playing)
 const p=$('player');
 p.src='/api/audio?t='+Date.now()+
  (S&&S.loop_enabled?'&loop=4':'');
 p.play();
 cmd('play');};
$('stop').onclick=()=>{const p=$('player');p.pause();
 p.removeAttribute('src');cmd('stop');};
function pianoInit(){
 const el=$('piano');if(el.childElementCount)return;
 let html='<div style="display:flex;gap:1px">';
 for(let k=48;k<=83;k++){
  const blk=[1,3,6,8,10].includes(k%12);
  html+=`<div class="pkey" data-k="${k}" style="width:18px;height:${
   blk?38:56}px;border-radius:0 0 3px 3px;cursor:pointer;background:${
   blk?'#10131a':'#d6d9de'};border:1px solid #33373f"></div>`;}
 el.innerHTML=html+'</div>';
 const ch=()=>{const t=(S&&S.tracks||[]).find(t=>t.selected);
  return t?t.channel:0;};
 const post=(c,k)=>fetch('/api/cmd',{method:'POST',
  body:JSON.stringify({cmd:c,key:k,channel:ch()})});
 el.querySelectorAll('.pkey').forEach(d=>{
  const k=+d.dataset.k;let down=false;
  d.onmousedown=()=>{liveStart();down=true;post('note_on',k);
   d.style.outline='2px solid var(--acc)';};
  const up=()=>{if(!down)return;down=false;post('note_off',k);
   d.style.outline='';};
  d.onmouseup=up;d.onmouseleave=up;});
}
function liveStart(){
 const a=$('liveaudio');
 if(!a.src){a.src='/api/audio/live';a.play();}
}
$('loop').onclick=()=>cmd('loop_toggle');
$('save').onclick=()=>cmd('save');
$('ntrk').onclick=()=>cmd('add_track');
$('render').onclick=drawWave;
$('bpm').onfocus=()=>bpmFocused=true;
$('bpm').onblur=()=>bpmFocused=false;
$('bpm').onchange=e=>cmd('bpm',{value:e.target.value});
$('ls').onchange=$('le').onchange=()=>cmd('loop_range',
 {start:$('ls').value||0,end:$('le').value||4});
refresh().then(pianoInit);setInterval(refresh,2000);
</script></body></html>
"""


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="groove_tpu_torch.gui.web")
    ap.add_argument("project", nargs="?", help="project file to open")
    ap.add_argument("--port", type=int, default=8177)
    ap.add_argument("--no-audio", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    gui = WebGui(use_audio=not args.no_audio, device=args.device)
    if args.project:
        gui.command("open", {"path": str(Path(args.project))})
    srv = make_server(gui, args.port)
    host, port = srv.server_address
    print(f"groove web GUI: http://{host}:{port}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        gui.model.svc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
