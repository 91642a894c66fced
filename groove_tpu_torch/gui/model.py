"""UI-toolkit-free view-model for the groove TUI.

Panel-for-panel mirror of the reference's eframe layout
(src/bin/groove-egui.rs:96-159):

  top    — ControlBar: title, BPM (editable), transport state, clock
           (src/panels/control_panel.rs:80-173)
  left   — PalettePanel: entity factory keys; Enter adds to the selected
           track's channel (palette_panel.rs:30-46)
  right  — EntityBrowser: project-file tree; Enter opens
           (legacy/thing_browser.rs:14-50)
  center — OrchestratorPanel: tracks with channels/patterns + the devices
           routed on each channel (orchestrator_panel.rs)
  bottom — toasts / event log (groove-egui.rs:386-392)

All state transitions go through handle_key(); rendering is `panel_lines`
returning plain strings — so the whole surface tests headless and the
curses driver (tui.py) stays a dumb blitter.

(A copy of groove_tpu/gui/model.py, statement for statement, held so by
tests/test_torch_hostcopy.py, with two departures: TuiModel builds its
service on the torch device it is given ("cuda" unless the caller asks
for another), and _browser_roots lists $GROOVE_ASSETS/projects and the
working directory's projects/, the roots this package's
project/paths.Paths searches, where groove_tpu's lists a fixed location
of the reference's asset tree first.)
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from groove_tpu_torch.engine import factory
from groove_tpu_torch.engine.service import EngineService
from groove_tpu_torch.gui.prefs import Preferences

PANELS = ("tracks", "palette", "browser", "params", "pattern")


def _browser_roots() -> list[Path]:
    import os

    roots = []
    env = os.environ.get("GROOVE_ASSETS")
    if env and (Path(env) / "projects").is_dir():
        roots.append(Path(env) / "projects")
    cwd = Path.cwd() / "projects"
    if cwd.is_dir() and cwd not in roots:
        roots.append(cwd)
    return roots


class TuiModel:
    def __init__(self, svc: Optional[EngineService] = None,
                 prefs: Optional[Preferences] = None,
                 use_audio: bool = True, device="cuda"):
        self.events: list[tuple[str, object]] = []
        self.svc = svc or EngineService(on_event=self._on_event,
                                        use_audio=use_audio, device=device)
        if svc is not None:
            # external service: still capture events
            prev = self.svc.on_event
            self.svc.on_event = lambda k, d: (prev(k, d),
                                              self._on_event(k, d))
        self.prefs = prefs or Preferences.load()
        self.focus = "tracks"
        self.cursor = {p: 0 for p in PANELS}
        self.selected_track: Optional[str] = None
        self.project_path: Optional[str] = None
        self.quit_requested = False
        self.browser_files = sorted(
            p for root in _browser_roots() for p in root.rglob("*.json*")
            if p.is_file()
        )
        startup = self.prefs.startup_project()
        if startup:
            self.open_project(startup)

    # -- events --------------------------------------------------------------

    def _on_event(self, kind, data):
        self.events.append((kind, data))
        del self.events[:-200]

    # -- derived state ---------------------------------------------------

    @property
    def song(self):
        return self.svc.song

    def tracks(self) -> list:
        return list(self.song.tracks) if self.song else []

    def devices_for_channel(self, channel: int) -> list[str]:
        out = []
        for d in (self.song.devices if self.song else []):
            if d.role == "instrument" and d.instrument.midi_in == channel:
                out.append(f"{d.uvid} ({d.instrument.kind})")
            elif d.role == "controller" and d.controller.midi_in == channel:
                out.append(f"{d.uvid} ({d.controller.kind})")
        return out

    def effect_chain(self) -> list[str]:
        return [f"{d.uvid} ({d.effect.kind})"
                for d in (self.song.devices if self.song else [])
                if d.role == "effect"]

    # -- parameter editor (generated from the Control-derive registry,
    #    compiler/params.py; the reference's per-entity widgets) ----------

    def param_rows(self) -> list:
        """[(uvid, kind, Param, current_value_or_None)] for every
        controllable param of every device."""
        from groove_tpu_torch.compiler import params as param_mod
        rows = []
        for d in (self.song.devices if self.song else []):
            settings = d.instrument or d.controller or d.effect
            for p in param_mod.REGISTRY.get(settings.kind, []):
                rows.append((d.uvid, settings.kind, p,
                             settings.params.get(p.name)))
        return rows

    def adjust_param(self, direction: int) -> None:
        """Nudge the selected param by 5% of its ControlValue range
        (arrow keys; the reference drags its widgets continuously)."""
        rows = self.param_rows()
        c = self.cursor["params"]
        if not rows or c >= len(rows):
            return
        uvid, kind, p, value = rows[c]
        cv = p.from_domain(float(value)) if value is not None else 0.5
        cv = min(1.0, max(0.0, cv + 0.05 * direction))
        self.svc.set_device_param(uvid, p.name, p.to_domain(cv))
        self.svc.sync()

    # -- pattern grid (note rows, settings/src/lib.rs:48-78) --------------

    def _sel_pattern(self):
        t = self._sel_track()
        if not t or not t.pattern_ids or not self.song:
            return None
        pid = t.pattern_ids[0]
        return next((p for p in self.song.patterns if p.id == pid), None)

    def pattern_rows(self) -> list:
        pat = self._sel_pattern()
        return list(pat.notes) if pat else []

    def transpose_step(self, direction: int) -> None:
        """Shift every key of the selected step row by one semitone."""
        pat = self._sel_pattern()
        c = self.cursor["pattern"]
        if not pat or c >= len(pat.notes):
            return
        row = [min(127, max(0, int(k) + direction)) if k else 0
               for k in pat.notes[c]]
        self.svc.set_pattern_step(pat.id, c, row)
        self.svc.sync()

    def toggle_step(self) -> None:
        """Rest <-> note: clear the row, or plant middle C on a rest
        (key 0 = rest, compiler/events.py)."""
        pat = self._sel_pattern()
        c = self.cursor["pattern"]
        if not pat or c >= len(pat.notes):
            return
        row = [] if any(pat.notes[c]) else [60]
        self.svc.set_pattern_step(pat.id, c, row)
        self.svc.sync()

    # -- actions ----------------------------------------------------------

    def open_project(self, path):
        self.project_path = str(path)
        self.svc.open_project(path)
        self.svc.sync()
        self.prefs.note_project(path)
        ts = self.tracks()
        self.selected_track = ts[0].id if ts else None

    def save_project(self, path=None):
        path = path or self.project_path
        if path:
            self.svc.save(path)
            self.svc.sync()

    def _sel_track(self):
        for t in self.tracks():
            if t.id == self.selected_track:
                return t
        return None

    # -- key handling -------------------------------------------------------

    def handle_key(self, key: str) -> None:
        """key: single character or a name ('up','down','tab','enter')."""
        if key == "q":
            self.quit_requested = True
            return
        if key == "tab":
            i = PANELS.index(self.focus)
            self.focus = PANELS[(i + 1) % len(PANELS)]
            return
        if key == " ":
            if self.svc.is_playing():
                self.svc.stop()
            else:
                self.svc.play()
            return
        if key in ("+", "="):
            if self.song:
                self.svc.set_tempo(self.song.clock.bpm + (10 if key == "+"
                                                          else 1))
                self.svc.sync()
            return
        if key in ("-", "_"):
            if self.song:
                self.svc.set_tempo(max(1.0, self.song.clock.bpm -
                                       (10 if key == "_" else 1)))
                self.svc.sync()
            return
        if key == "s":
            self.save_project()
            return
        if key == "l":
            # the ControlBar's Loop checkbox (control_panel.rs:143-145);
            # a default 4-beat range applies when none was set yet
            self.toggle_loop()
            return
        if key == "n":
            self.svc.add_track()
            self.svc.sync()
            ts = self.tracks()
            if ts:
                self.selected_track = ts[-1].id
            return
        if key in ("up", "down"):
            items = self._focus_items()
            if not items:
                return
            c = self.cursor[self.focus]
            c = max(0, min(len(items) - 1, c + (1 if key == "down" else -1)))
            self.cursor[self.focus] = c
            if self.focus == "tracks":
                ts = self.tracks()
                if c < len(ts):
                    self.selected_track = ts[c].id
            return
        if key in ("left", "right"):
            d = 1 if key == "right" else -1
            if self.focus == "params":
                self.adjust_param(d)
            elif self.focus == "pattern":
                self.transpose_step(d)
            return
        if key == "x" and self.focus == "pattern":
            self.toggle_step()
            return
        if key == "enter":
            self._activate()
            return
        if key == "D" and self.focus == "tracks":
            t = self._sel_track()
            if t:
                self.svc.remove_track(t.id)
                self.svc.sync()
                ts = self.tracks()
                self.selected_track = ts[0].id if ts else None
            return
        if key == "d" and self.focus == "tracks":
            t = self._sel_track()
            if t:
                self.svc.duplicate_track(t.id)
                self.svc.sync()
            return

    def _focus_items(self) -> list:
        if self.focus == "tracks":
            return self.tracks()
        if self.focus == "palette":
            return factory.sorted_keys()
        if self.focus == "params":
            return self.param_rows()
        if self.focus == "pattern":
            return self.pattern_rows()
        return self.browser_files

    def _activate(self):
        c = self.cursor[self.focus]
        if self.focus == "palette":
            keys = factory.sorted_keys()
            if c < len(keys):
                t = self._sel_track()
                channel = t.midi_channel if t else 0
                self.svc.add_device(keys[c], midi_channel=channel)
                self.svc.sync()
        elif self.focus == "browser":
            if c < len(self.browser_files):
                self.open_project(self.browser_files[c])

    # -- loop range (ControlBar checkbox + range fields,
    #    src/panels/control_panel.rs:143-170) ------------------------------

    def toggle_loop(self) -> None:
        if self.svc.is_loop_enabled:
            self.svc.set_loop_enabled(False)
        elif self.svc.loop_range is not None:
            self.svc.set_loop_enabled(True)
        else:
            self.svc.set_loop(0.0, 4.0)
        self.svc.sync()

    def set_loop_range(self, start_beats: float, end_beats: float) -> None:
        self.svc.set_loop(start_beats, end_beats)
        self.svc.sync()

    # -- rendering --------------------------------------------------------

    def control_bar(self) -> str:
        title = self.song.title if self.song else "(no project)"
        bpm = f"{self.song.clock.bpm:7.2f}" if self.song else "    ---"
        state = "PLAYING" if self.svc.is_playing() else "stopped"
        if self.svc.is_loop_enabled and self.svc.loop_range is not None:
            ls, le = self.svc.loop_range
            loop = f"loop {ls:g}..{le:g} [l]"
        else:
            loop = "loop off [l]"
        return f" {title}  |  {bpm} BPM [+/-]  |  {state} [space]  |  {loop}"

    def panel_lines(self, panel: str) -> list[str]:
        mark = "▸" if self.focus == panel else " "
        if panel == "palette":
            lines = [f"{mark} palette (enter: add to track)"]
            for i, k in enumerate(factory.sorted_keys()):
                cur = ">" if (self.focus == panel
                              and self.cursor[panel] == i) else " "
                lines.append(f"{cur} {k}")
            return lines
        if panel == "browser":
            lines = [f"{mark} projects (enter: open)"]
            for i, p in enumerate(self.browser_files):
                cur = ">" if (self.focus == panel
                              and self.cursor[panel] == i) else " "
                lines.append(f"{cur} {p.name}")
            return lines
        if panel == "tracks":
            lines = [f"{mark} tracks (n:new d:dup D:del)"]
            for i, t in enumerate(self.tracks()):
                cur = ">" if t.id == self.selected_track else " "
                pats = ",".join(t.pattern_ids) or "-"
                lines.append(f"{cur} {t.id}  ch{t.midi_channel}  [{pats}]")
                for dev in self.devices_for_channel(t.midi_channel):
                    lines.append(f"      {dev}")
            chain = self.effect_chain()
            if chain:
                lines.append("  effects:")
                lines.extend(f"      {d}" for d in chain)
            return lines
        if panel == "params":
            lines = [f"{mark} params (←/→: adjust)"]
            for i, (uvid, kind, p, value) in enumerate(self.param_rows()):
                cur = ">" if (self.focus == panel
                              and self.cursor[panel] == i) else " "
                shown = "(default)" if value is None else (
                    f"{value:g}" if isinstance(value, (int, float))
                    else str(value))
                lines.append(f"{cur} {uvid}.{p.name} = {shown}")
            return lines
        if panel == "pattern":
            t = self._sel_track()
            pat = self._sel_pattern()
            head = f"{mark} pattern"
            if pat is not None:
                head += f" {pat.id} (track {t.id}; ←/→: transpose, x: rest)"
            lines = [head]
            for i, row in enumerate(self.pattern_rows()):
                cur = ">" if (self.focus == panel
                              and self.cursor[panel] == i) else " "
                keys = " ".join(str(k) for k in row if k) or "·"
                lines.append(f"{cur} {i:2d}  {keys}")
            return lines
        if panel == "log":
            return [f"  [{k}] {d if d is not None else ''}".rstrip()
                    for k, d in self.events[-8:]]
        raise ValueError(panel)
