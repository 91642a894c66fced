"""Curses driver for the groove TUI — a dumb blitter over TuiModel.

Layout mirrors src/bin/groove-egui.rs:96-159: top control bar, left
palette, right project browser, center track lanes, bottom event log.

    $ python -m groove_tpu_torch.gui [project.json] [--device cuda]

Keys: Tab cycle focus · arrows move (←/→ adjust param / transpose step) ·
Enter activate · Space play/stop · =/- BPM ±1 · +/_ BPM ±10 ·
n new track · d duplicate · D delete · x rest toggle (pattern) ·
s save · q quit.

(A copy of groove_tpu/gui/tui.py, statement for statement, held so by
tests/test_torch_hostcopy.py, but for main, which takes --device: the
torch device the service renders on, "cuda" unless asked for another.)
"""

from __future__ import annotations

import curses
import sys

from groove_tpu_torch.gui.model import TuiModel

KEYMAP = {
    curses.KEY_UP: "up",
    curses.KEY_DOWN: "down",
    curses.KEY_LEFT: "left",
    curses.KEY_RIGHT: "right",
    9: "tab",
    10: "enter",
    curses.KEY_ENTER: "enter",
}


def _blit(win, y, x, lines, width, height):
    for i, line in enumerate(lines[:height]):
        try:
            win.addnstr(y + i, x, line, width - 1)
        except curses.error:
            pass


def run(stdscr, model: TuiModel) -> None:
    curses.curs_set(0)
    stdscr.nodelay(True)
    stdscr.timeout(100)  # refresh cadence; playback state updates live
    while not model.quit_requested:
        stdscr.erase()
        h, w = stdscr.getmaxyx()
        left_w = max(24, w // 5)
        right_w = max(28, w // 4)
        center_w = w - left_w - right_w
        log_h = 6
        body_h = h - 2 - log_h
        _blit(stdscr, 0, 0, [model.control_bar()], w, 1)
        try:
            stdscr.hline(1, 0, curses.ACS_HLINE, w)
        except curses.error:
            pass
        _blit(stdscr, 2, 0, model.panel_lines("palette"), left_w, body_h)
        # center: track lanes on top, param editor + pattern grid below
        # (the per-entity widgets / note rows of the reference's center
        # panel, orchestrator_panel.rs)
        tracks_h = max(4, body_h // 2)
        edit_h = body_h - tracks_h
        _blit(stdscr, 2, left_w, model.panel_lines("tracks"),
              center_w, tracks_h)
        edit_w = center_w // 2
        _blit(stdscr, 2 + tracks_h, left_w, model.panel_lines("params"),
              edit_w, edit_h)
        _blit(stdscr, 2 + tracks_h, left_w + edit_w,
              model.panel_lines("pattern"), center_w - edit_w, edit_h)
        _blit(stdscr, 2, left_w + center_w, model.panel_lines("browser"),
              right_w, body_h)
        _blit(stdscr, h - log_h, 0, model.panel_lines("log"), w, log_h)
        stdscr.refresh()
        try:
            ch = stdscr.getch()
        except curses.error:
            continue
        if ch == -1:
            continue
        key = KEYMAP.get(ch)
        if key is None and 0 <= ch < 256:
            key = chr(ch)
        if key:
            model.handle_key(key)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="groove_tpu_torch.gui")
    ap.add_argument("project", nargs="?", help="project file to open")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    model = TuiModel(device=args.device)
    try:
        if args.project:
            model.open_project(args.project)
        curses.wrapper(run, model)
    finally:
        model.svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
