"""Interactive app layer: preferences, view-model, curses TUI.

The reference's GUI is an eframe/egui windowed DAW
(src/bin/groove-egui.rs:96-159: top control bar, left palette, right
browser, bottom event log, central track view). This package is the
terminal-native equivalent over the same EngineService: the layout,
commands, and event surfaces match panel-for-panel; rendering targets
curses instead of pixels. The view-model (model.py) is UI-toolkit-free so
the whole surface is testable headless.

(A copy of groove_tpu/gui/__init__.py, statement for
statement: only the imports name this package;
tests/test_torch_hostcopy.py holds it so.)
"""
