"""Entity factory: the palette's source of addable device kinds.

The reference GUI drags entities out of `EntityFactory::global()`
(src/panels/palette_panel.rs:30-46); the factory maps an EntityKey to a
constructor with usable defaults. Here the registry maps every project-file
device kind (settings/src/{instruments,effects,controllers}.rs) to its
role and default params, so a track can be populated interactively and the
result still round-trips through the settings schema.

(A copy of groove_tpu/engine/factory.py, statement for
statement: only the imports name this package;
tests/test_torch_hostcopy.py holds it so.)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EntityProto:
    key: str          # palette name == project-file kind
    role: str         # instrument|controller|effect
    params: dict      # default params (raw JSON domain)


_PROTOS = [
    # instruments (settings/src/instruments.rs:24-39 + demo kinds)
    EntityProto("welsh", "instrument", {"name": "piano"}),
    EntityProto("fm-synthesizer", "instrument", {"ratio": 2.0, "depth": 1.0,
                                                 "beta": 1.0}),
    EntityProto("drumkit", "instrument", {"name": "707"}),
    EntityProto("sampler", "instrument", {"filename": "pluck.wav",
                                          "root": 440.0}),
    EntityProto("toy-instrument", "instrument", {"fake-value": 0.5}),
    EntityProto("oscillator", "instrument", {"waveform": "sine",
                                             "frequency": 440.0}),
    EntityProto("envelope", "instrument", {"attack": 0.1, "decay": 0.2,
                                           "sustain": 1.0, "release": 0.3}),
    # effects (settings/src/effects.rs:17-56)
    EntityProto("gain", "effect", {"ceiling": 1.0}),
    EntityProto("limiter", "effect", {"minimum": 0.0, "maximum": 1.0}),
    EntityProto("bitcrusher", "effect", {"bits": 8}),
    EntityProto("chorus", "effect", {"voices": 2, "delay-seconds": 0.01}),
    EntityProto("compressor", "effect", {"threshold": 0.5, "ratio": 0.5,
                                         "attack": 0.1, "release": 0.1}),
    EntityProto("delay", "effect", {"delay": 0.25}),
    EntityProto("reverb", "effect", {"attenuation": 0.8, "seconds": 1.0}),
    EntityProto("mixer", "effect", {}),
    EntityProto("filter-low-pass-12db", "effect", {"cutoff": 1000.0,
                                                   "q": 0.707}),
    EntityProto("filter-high-pass-12db", "effect", {"cutoff": 1000.0,
                                                    "q": 0.707}),
    EntityProto("filter-band-pass-12db", "effect", {"cutoff": 1000.0,
                                                    "bandwidth": 100.0}),
    EntityProto("filter-band-stop-12db", "effect", {"cutoff": 1000.0,
                                                    "bandwidth": 100.0}),
    EntityProto("filter-all-pass-12db", "effect", {"cutoff": 1000.0,
                                                   "q": 0.707}),
    EntityProto("filter-peaking-eq-12db", "effect", {"cutoff": 1000.0,
                                                     "q": 1.0}),
    EntityProto("filter-low-shelf-12db", "effect", {"cutoff": 1000.0,
                                                    "db-gain": 0.0}),
    EntityProto("filter-high-shelf-12db", "effect", {"cutoff": 1000.0,
                                                     "db-gain": 0.0}),
    EntityProto("filter-low-pass-24db", "effect", {"cutoff": 1000.0,
                                                   "passband-ripple": 1.0}),
    # controllers (settings/src/controllers.rs:101-112 + reconstructions)
    EntityProto("arpeggiator", "controller", {"bpm": 120.0}),
    EntityProto("lfo", "controller", {"waveform": "sine", "frequency": 1.0}),
    EntityProto("signal-passthrough-controller", "controller", {}),
    EntityProto("trigger", "controller", {"time": 0.0, "value": 1.0}),
    EntityProto("timer", "controller", {"beats": 4}),
    EntityProto("calculator", "controller", {}),
]

REGISTRY = {p.key: p for p in _PROTOS}


def sorted_keys() -> list[str]:
    """Palette ordering (EntityFactory::global().sorted_keys())."""
    return sorted(REGISTRY)


def prototype(key: str) -> EntityProto:
    return REGISTRY[key]
