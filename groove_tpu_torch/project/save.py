"""Project persistence: SongSettings -> JSON (round-trippable).

The reference saves projects by serializing the whole Orchestrator with
serde (src/panels/orchestrator_panel.rs:242-266, control_panel.rs:117-135).
Here the settings layer is the stable format (the reference's own design
rationale, settings/src/lib.rs:3-9), so saving means emitting the settings
tree back to JSON; `SongSettings.from_json(save(song))` is the identity on
everything the schema models.

(A copy of groove_tpu/project/save.py, statement for
statement: only the imports name this package;
tests/test_torch_hostcopy.py holds it so.)
"""

from __future__ import annotations

import json

from groove_tpu_torch.core.time import BeatValue
from groove_tpu_torch.project.schema import SongSettings


def _beat_value(nv: BeatValue | None):
    return nv.serde_name if nv else None


def song_to_dict(song: SongSettings) -> dict:
    d: dict = {
        "title": song.title,
        "clock": {
            "bpm": song.clock.bpm,
            "midi-ticks-per-second": song.clock.midi_ticks_per_second,
            "time-signature": [song.clock.time_signature.top,
                               song.clock.time_signature.bottom],
        },
        "devices": [],
    }
    for dev in song.devices:
        if dev.role == "instrument":
            i = dev.instrument
            body = {i.kind: [{"midi-in": i.midi_in}, i.params]}
        elif dev.role == "controller":
            c = dev.controller
            body = {c.kind: [{"midi-in": c.midi_in, "midi-out": c.midi_out},
                             c.params]}
        else:
            body = {dev.effect.kind: dev.effect.params}
        d["devices"].append({dev.role: [dev.uvid, body]})
    if song.patch_cables:
        d["patch-cables"] = song.patch_cables
    if song.controls:
        d["controls"] = [
            {"id": c.id, "source": c.source,
             "target": {"id": c.target.id, "param": c.target.param}}
            for c in song.controls
        ]
    if song.patterns:
        d["patterns"] = [
            {k: v for k, v in (
                ("id", p.id), ("note-value", _beat_value(p.note_value)),
                ("notes", p.notes)) if v is not None}
            for p in song.patterns
        ]
    if song.tracks:
        d["tracks"] = [
            {"id": t.id, "midi-channel": t.midi_channel,
             "patterns": t.pattern_ids}
            for t in song.tracks
        ]
    if song.paths:
        d["paths"] = [
            {k: v for k, v in (
                ("id", p.id), ("note-value", _beat_value(p.note_value)),
                ("steps", [_step_to_dict(s) for s in p.steps])) if v is not None}
            for p in song.paths
        ]
    if song.trips:
        d["trips"] = [
            {k: v for k, v in (
                ("id", t.id),
                ("target", {"id": t.target.id, "param": t.target.param}),
                ("start-measure", t.start_measure),
                ("paths", t.path_ids)) if v is not None}
            for t in song.trips
        ]
    if song.sends:
        d["sends"] = [
            {"source": s.source, "aux": s.aux, "amount": s.amount}
            for s in song.sends
        ]
    return d


def _step_to_dict(s):
    if s.kind == "flat":
        return {"flat": {"value": s.start}}
    if s.kind == "triggered":
        return {"triggered": {}}
    return {s.kind: {"start": s.start, "end": s.end}}


def save_project(song: SongSettings, path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(song_to_dict(song), f, indent=2)
