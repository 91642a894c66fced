"""Project-file settings schema.

Mirrors the reference's `groove-settings` crate (settings/src/lib.rs,
songs.rs, instruments.rs, effects.rs, controllers.rs), which keeps the file
format stable and separate from the engine. All serde names are kebab-case.

Loader policy matches the reference: unknown/bad references produce warnings
and are skipped (settings/src/songs.rs:137-198); bad patch-cable types are
hard errors (songs.rs:146-149, orchestrator.rs patch() validation). On top
of that we accept the documented data quirks the reference schema misses:

  - `oscillator` and `envelope` instrument kinds used by demo projects
    (projects/demos/instruments/oscillator-*.json, envelope-adsr-linear.json)
    but absent from InstrumentSettings (settings/src/instruments.rs:26-39).
  - Limiter `min`/`max` aliases for `minimum`/`maximum`
    (test-data/perf-1.json vs test-data/kitchen-sink.json).
  - Controller tuple variants with the params element omitted
    (projects/demos/controllers/arpeggiator.json has only MidiChannelParams).
  - `start-measure` on trips: present in data (test-data/kitchen-sink.json,
    drums-filtered-24db.json) but not in ControlTripSettings
    (settings/src/controllers.rs:91-99) — parsed, kept, and ignored by the
    compiler exactly like the reference silently ignores it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Optional

from groove_tpu_torch.core.time import BeatValue, Tempo, TimeSignature
from groove_tpu_torch.project import json5


def warn(msg: str) -> None:
    print(f"Warning: {msg}", file=sys.stderr)


class ProjectError(ValueError):
    pass


# --------------------------------------------------------------------------
# Clock


@dataclass
class ClockSettings:
    bpm: float = 128.0
    midi_ticks_per_second: int = 960
    time_signature: TimeSignature = field(default_factory=TimeSignature)

    @classmethod
    def from_json(cls, d: dict) -> "ClockSettings":
        ts = d.get("time-signature", [4, 4])
        if isinstance(ts, dict):
            # object form {"top": 4, "bottom": 4}
            # (test-data/kitchen-sink.json, projects/dev-loop.json5)
            sig = TimeSignature(int(ts.get("top", 4)), int(ts.get("bottom", 4)))
        elif isinstance(ts, (list, tuple)) and len(ts) >= 2:
            sig = TimeSignature(int(ts[0]), int(ts[1]))
        else:
            raise ProjectError(f"malformed time-signature {ts!r} "
                               "(expected [top, bottom] or an object)")
        if sig.top <= 0:
            raise ProjectError(f"time-signature top must be positive, "
                               f"got {sig.top}")
        try:
            # the bottom must name a BeatValue (the reference's
            # TimeSignature bottoms are the BeatValueSettings divisors);
            # validating HERE keeps the ValueError out of compile time
            BeatValue.from_divisor(sig.bottom)
        except ValueError as e:
            raise ProjectError(f"malformed time-signature {ts!r}: {e}") \
                from e
        return cls(
            bpm=float(d.get("bpm", 128.0)),
            midi_ticks_per_second=int(d.get("midi-ticks-per-second", 960)),
            time_signature=sig,
        )

    @property
    def tempo(self) -> Tempo:
        return Tempo(self.bpm)


# --------------------------------------------------------------------------
# Devices


@dataclass
class InstrumentSettings:
    """One of the instrument kinds (settings/src/instruments.rs:24-39 plus
    the demo-only `oscillator`/`envelope` kinds)."""

    kind: str               # toy-instrument|welsh|welsh-raw|drumkit|sampler|
                            # fm-synthesizer|oscillator|envelope
    midi_in: int
    params: dict            # kind-specific params, kebab-case keys preserved


@dataclass
class ControllerSettings:
    kind: str               # test|arpeggiator|lfo|signal-passthrough-controller
    midi_in: int
    midi_out: int
    params: dict


@dataclass
class EffectSettings:
    kind: str               # toy|mixer|gain|limiter|bitcrusher|chorus|
                            # compressor|delay|reverb|filter-*
    params: dict


@dataclass
class DeviceSettings:
    role: str               # instrument|controller|effect
    uvid: str
    instrument: Optional[InstrumentSettings] = None
    controller: Optional[ControllerSettings] = None
    effect: Optional[EffectSettings] = None


_INSTRUMENT_KINDS = {
    "toy-instrument", "welsh", "welsh-raw", "drumkit", "sampler",
    "fm-synthesizer",
    # Data quirks: demo-only kinds (see module docstring).
    "oscillator", "envelope",
}
_CONTROLLER_KINDS = {
    "test", "arpeggiator", "lfo", "signal-passthrough-controller",
    # "Pocket Calculator" toy controller+instrument
    # (orchestration/src/entities.rs:88-89, projects/calculator.json:12-33).
    "calculator",
    # Trigger: fire a control value at a musical time
    # (orchestration/src/entities.rs:135-136 declares
    # #[everything(controller)] Trigger; body and settings surface missing
    # at HEAD — params {time: beats, value: ControlValue} are a documented
    # RECONSTRUCTION).
    "trigger",
    # Timer: the performance runs until every controller is finished; a
    # Timer is finished after its MusicalTime duration
    # (orchestrator.rs:1678-1737 tests: Timer(4 beats) at 240 BPM ->
    # exactly 1 s of samples; Timer(default/zero) -> 0 samples). No serde
    # surface at HEAD — params {beats} are a documented RECONSTRUCTION.
    "timer",
}
_EFFECT_KINDS = {
    "toy", "mixer", "gain", "limiter", "bitcrusher", "chorus", "compressor",
    "delay", "reverb",
    "filter-low-pass-12db", "filter-low-pass-24db", "filter-high-pass-12db",
    "filter-band-pass-12db", "filter-band-stop-12db", "filter-all-pass-12db",
    "filter-peaking-eq-12db", "filter-low-shelf-12db", "filter-high-shelf-12db",
}


def _single_kind(d: dict, known: set, what: str) -> tuple[str, Any]:
    if len(d) != 1:
        raise ProjectError(f"{what} must have exactly one kind, got {list(d)}")
    kind, payload = next(iter(d.items()))
    if kind not in known:
        raise ProjectError(f"unknown {what} kind {kind!r}")
    return kind, payload


def _parse_instrument(uvid: str, d: dict) -> InstrumentSettings:
    kind, payload = _single_kind(d, _INSTRUMENT_KINDS, "instrument")
    # Tuple variants serialize as [midi-channel-params, kind-params]; the
    # demo-only kinds fold everything into a single map.
    if isinstance(payload, list):
        midi = payload[0] if payload else {}
        params = dict(payload[1]) if len(payload) > 1 else {}
        # demo-only kinds carry their params inside the first element
        for k, v in midi.items():
            if k != "midi-in":
                params[k] = v
        midi_in = int(midi.get("midi-in", 0))
    else:
        params = dict(payload)
        midi_in = int(params.pop("midi-in", 0))
    return InstrumentSettings(kind=kind, midi_in=midi_in, params=params)


def _parse_controller(uvid: str, d: dict) -> ControllerSettings:
    kind, payload = _single_kind(d, _CONTROLLER_KINDS, "controller")
    if isinstance(payload, list):
        midi = payload[0] if payload else {}
        params = dict(payload[1]) if len(payload) > 1 else {}
    else:
        # map form: every non-MIDI key is a kind param (dropping them
        # silently lost e.g. a trigger's time/value — warn-and-skip
        # policy demands the data survive)
        midi = payload if isinstance(payload, dict) else {}
        params = {k: v for k, v in midi.items()
                  if k not in ("midi-in", "midi-out")}
    return ControllerSettings(
        kind=kind,
        midi_in=int(midi.get("midi-in", 0)),
        midi_out=int(midi.get("midi-out", 0)),
        params=params,
    )


def _parse_effect(uvid: str, d: dict) -> EffectSettings:
    kind, payload = _single_kind(d, _EFFECT_KINDS, "effect")
    params = dict(payload) if isinstance(payload, dict) else {}
    if kind == "limiter":
        # min/max aliases (test-data/perf-1.json:95-99)
        if "min" in params and "minimum" not in params:
            params["minimum"] = params.pop("min")
        if "max" in params and "maximum" not in params:
            params["maximum"] = params.pop("max")
    return EffectSettings(kind=kind, params=params)


def _parse_device(d: dict) -> DeviceSettings:
    role, payload = _single_kind(
        d, {"instrument", "controller", "effect"}, "device"
    )
    if not isinstance(payload, (list, tuple)) or len(payload) < 2:
        raise ProjectError(f"malformed {role} device {payload!r} "
                           "(expected [uvid, settings])")
    uvid = str(payload[0])
    body = payload[1]
    dev = DeviceSettings(role=role, uvid=uvid)
    if role == "instrument":
        dev.instrument = _parse_instrument(uvid, body)
    elif role == "controller":
        dev.controller = _parse_controller(uvid, body)
    else:
        dev.effect = _parse_effect(uvid, body)
    return dev


# --------------------------------------------------------------------------
# Patterns / tracks / automation


@dataclass
class PatternSettings:
    id: str
    note_value: Optional[BeatValue]
    notes: list[list[int]]

    @classmethod
    def from_json(cls, d: dict) -> "PatternSettings":
        nv = d.get("note-value")
        return cls(
            id=str(d["id"]),
            note_value=BeatValue.from_name(nv) if nv else None,
            notes=[[int(n) for n in row] for row in d.get("notes", [])],
        )


@dataclass
class TrackSettings:
    id: str
    midi_channel: int
    pattern_ids: list[str]

    @classmethod
    def from_json(cls, d: dict) -> "TrackSettings":
        return cls(
            id=str(d["id"]),
            midi_channel=int(d["midi-channel"]),
            pattern_ids=[str(p) for p in d.get("patterns", [])],
        )


@dataclass
class ControlTargetSettings:
    id: str
    param: str


@dataclass
class ControlSettings:
    id: str
    source: str
    target: ControlTargetSettings

    @classmethod
    def from_json(cls, d: dict) -> "ControlSettings":
        t = d.get("target", {})
        return cls(
            id=str(d.get("id", "")),
            source=str(d["source"]),
            target=ControlTargetSettings(str(t["id"]), str(t["param"])),
        )


@dataclass
class ControlStepSettings:
    """Flat/Slope/Logarithmic/Exponential/Triggered
    (settings/src/controllers.rs:18-38)."""

    kind: str
    start: float = 0.0
    end: float = 0.0

    @classmethod
    def from_json(cls, d: dict) -> "ControlStepSettings":
        if not isinstance(d, dict) or not d:
            raise ProjectError(f"malformed control step {d!r} "
                               "(expected {kind: payload})")
        kind, payload = next(iter(d.items()))
        try:
            if kind == "flat":
                v = (payload[0] if isinstance(payload, list)
                     else payload.get("value"))
                return cls("flat", float(v), float(v))
            if kind in ("slope", "logarithmic", "exponential"):
                if isinstance(payload, list):
                    start, end = float(payload[0]), float(payload[1])
                else:
                    start, end = float(payload["start"]), float(payload["end"])
                return cls(kind, start, end)
        except (TypeError, AttributeError, IndexError, KeyError) as e:
            raise ProjectError(
                f"malformed {kind} control step payload {payload!r}") from e
        if kind == "triggered":
            return cls("triggered")
        raise ProjectError(f"unknown control step kind {kind!r}")


@dataclass
class ControlPathSettings:
    id: str
    note_value: Optional[BeatValue]
    steps: list[ControlStepSettings]

    @classmethod
    def from_json(cls, d: dict) -> "ControlPathSettings":
        nv = d.get("note-value")
        return cls(
            id=str(d["id"]),
            note_value=BeatValue.from_name(nv) if nv else None,
            steps=[ControlStepSettings.from_json(s) for s in d.get("steps", [])],
        )


@dataclass
class ControlTripSettings:
    id: str
    target: ControlTargetSettings
    path_ids: list[str]
    start_measure: Optional[int] = None  # present in data, ignored (see module doc)

    @classmethod
    def from_json(cls, d: dict) -> "ControlTripSettings":
        t = d["target"]
        return cls(
            id=str(d["id"]),
            target=ControlTargetSettings(str(t["id"]), str(t["param"])),
            path_ids=[str(p) for p in d.get("paths", [])],
            start_measure=d.get("start-measure"),
        )


# --------------------------------------------------------------------------
# Song


@dataclass
class SendSettings:
    """Aux-track send (BusRoute: src/mini/bus_station.rs:7-53).

    groove_tpu format extension: the reference's BusStation has no project-
    file surface (GUI-era serde only); we accept an optional `sends` array
    of {source, aux, amount}."""

    source: str
    aux: str
    amount: float

    @classmethod
    def from_json(cls, d: dict) -> "SendSettings":
        return cls(str(d["source"]), str(d["aux"]), float(d.get("amount", 1.0)))


@dataclass
class SongSettings:
    """Top-level project file (settings/src/songs.rs:17-56)."""

    title: Optional[str]
    clock: ClockSettings
    devices: list[DeviceSettings]
    patch_cables: list[list[str]]
    controls: list[ControlSettings]
    patterns: list[PatternSettings]
    tracks: list[TrackSettings]
    paths: list[ControlPathSettings]
    trips: list[ControlTripSettings]
    sends: list[SendSettings] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: Any) -> "SongSettings":
        if not isinstance(d, dict):
            raise ProjectError("project root must be an object")
        if "clock" not in d:
            raise ProjectError('missing field "clock"')

        def section(name, parse):
            """Parse one top-level array, converting opaque crashes on
            malformed entries (wrong-typed values, missing keys) into
            ProjectError with the entry repr — the loader's failure
            policy is typed errors or warn-and-skip, never a KeyError/
            TypeError escaping to the caller (test_fuzzed_projects_
            fail_closed). Existing ProjectErrors pass through so their
            specific messages stay pinned."""
            items = d.get(name, [])
            if not isinstance(items, list):
                raise ProjectError(f"{name!r} must be an array, "
                                   f"got {type(items).__name__}")
            out = []
            for x in items:
                try:
                    out.append(parse(x))
                except ProjectError:
                    raise
                except (TypeError, KeyError, IndexError, AttributeError,
                        ValueError) as e:
                    raise ProjectError(
                        f"malformed {name} entry {x!r}: {e}") from e
            return out

        try:
            clock = ClockSettings.from_json(d["clock"])
        except ProjectError:
            raise
        except (TypeError, KeyError, IndexError, AttributeError,
                ValueError) as e:
            raise ProjectError(f"malformed clock {d['clock']!r}: {e}") from e
        return cls(
            title=d.get("title"),
            clock=clock,
            devices=section("devices", _parse_device),
            patch_cables=section("patch-cables",
                                 lambda c: [str(s) for s in c]),
            controls=section("controls", ControlSettings.from_json),
            patterns=section("patterns", PatternSettings.from_json),
            tracks=section("tracks", TrackSettings.from_json),
            paths=section("paths", ControlPathSettings.from_json),
            trips=section("trips", ControlTripSettings.from_json),
            sends=section("sends", SendSettings.from_json),
        )

    @classmethod
    def from_json5_str(cls, text: str) -> "SongSettings":
        return cls.from_json(json5.loads(text))

    @classmethod
    def from_project_file(cls, path) -> "SongSettings":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json5_str(f.read())
