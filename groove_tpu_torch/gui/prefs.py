"""User preferences with last-project reload.

Mirrors the reference Preferences (src/panels/legacy/preferences.rs:13-29):
selected MIDI in/out, should_reload_last_project, last_project_filename —
JSON at a well-known per-user location (Paths::prefs_file() analog;
overridable via GROOVE_TPU_PREFS for tests/CI).

(A copy of groove_tpu/gui/prefs.py, statement for
statement: only the imports name this package;
tests/test_torch_hostcopy.py holds it so.)
Both packages read and write the same preferences file.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional


def prefs_file() -> Path:
    env = os.environ.get("GROOVE_TPU_PREFS")
    if env:
        return Path(env)
    base = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "groove_tpu" / "preferences.json"


@dataclass
class Preferences:
    selected_midi_input: Optional[str] = None
    selected_midi_output: Optional[str] = None
    should_reload_last_project: bool = False
    last_project_filename: Optional[str] = None
    extras: dict = field(default_factory=dict)

    @classmethod
    def load(cls) -> "Preferences":
        try:
            d = json.loads(prefs_file().read_text())
        except (OSError, ValueError):
            return cls()
        known = {f for f in cls.__dataclass_fields__ if f != "extras"}
        return cls(**{k: d[k] for k in known if k in d},
                   extras={k: v for k, v in d.items() if k not in known})

    def save(self) -> None:
        path = prefs_file()
        path.parent.mkdir(parents=True, exist_ok=True)
        d = asdict(self)
        d.update(d.pop("extras"))
        path.write_text(json.dumps(d, indent=2))

    def note_project(self, filename) -> None:
        self.last_project_filename = str(filename)
        self.save()

    def startup_project(self) -> Optional[str]:
        if self.should_reload_last_project and self.last_project_filename:
            if Path(self.last_project_filename).exists():
                return self.last_project_filename
        return None
