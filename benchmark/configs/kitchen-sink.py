"""The kitchen-sink song: an analogue of upstream groove's
test-data/kitchen-sink.json, which is not in this repository. It is a
frozen copy of groove_tpu_torch.testing.synth's kitchen_sink_project
(with north_star_project's drum pattern), so that later changes to the
program cannot move it: the 707 kit through one chain per effect route,
static, tripped by a path rising over the song, and sidechain-driven,
into a gain bank. The seed draws nothing here: the kit's content is the
seeded data (benchmark/kit.py)."""

from __future__ import annotations

SIDECHAIN_UVID = "sc"
KITCHEN_SINK = {
    "comp-inst": ("compressor", {"threshold": 0.15, "ratio": 0.25,
                                 "attack": 0.0, "release": 0.0}, {}, None),
    "comp-smooth": ("compressor", {"threshold": 0.1, "ratio": 0.3,
                                   "attack": 0.01, "release": 0.25}, {},
                    None),
    "comp-trip": ("compressor", {"threshold": 0.1, "ratio": 0.3,
                                 "attack": 0.005, "release": 0.1},
                  {"release": (0.05, 0.5)}, None),
    "comp-sc": ("compressor", {"threshold": 0.5, "ratio": 0.25,
                               "attack": 0.0, "release": 0.0}, {},
                "threshold"),
    "delay-static": ("delay", {"delay": 0.125}, {}, None),
    "delay-trip": ("delay", {"delay": 0.05}, {"delay": (0.01, 0.25)}, None),
    "delay-sc": ("delay", {"delay": 0.0}, {}, "delay"),
    "chorus-static": ("chorus", {"voices": 3, "delay-seconds": 0.02}, {},
                      None),
    "chorus-trip": ("chorus", {"voices": 2, "delay-seconds": 0.01},
                    {"voices": (1.0, 4.0), "delay-seconds": (0.005, 0.03)},
                    None),
    "reverb-static": ("reverb", {"attenuation": 0.5, "seconds": 1.5}, {},
                      None),
    "reverb-trip": ("reverb", {"attenuation": 0.5, "seconds": 1.0},
                    {"seconds": (0.3, 2.0)}, None),
    "toy": ("toy", {"my-value": 0.0}, {}, None),
}
KITCHEN_STATELESS = (
    ("st-gain", "gain", {"ceiling": 0.8}),
    ("st-limiter", "limiter", {"minimum": 0.0, "maximum": 0.25}),
    ("st-crusher", "bitcrusher", {"bits": 6}),
    ("st-lp24", "filter-low-pass-24db",
     {"cutoff": 4000.0, "passband-ripple": 0.707}),
)
KITCHEN_LEVEL = 0.12


def drum_pattern() -> dict:
    """Kick, snare, hats and crash on keys 35/38/42/44/49, sixteenths."""
    kick = [35 if i % 4 == 0 else 0 for i in range(16)]
    snare = [38 if i % 8 == 4 else 0 for i in range(16)]
    hats = [(44 if i % 4 == 3 else 42) if i % 2 == 0 or i % 4 == 3 else 0
            for i in range(16)]
    crash = [49] + [0] * 15
    return {"id": "beat", "note-value": "sixteenth",
            "notes": [kick, snare, hats, crash]}


def rise(path_id: str, low: float, high: float, measures: int) -> dict:
    """A path rising once from `low` to `high` over the song: one
    exponential step a measure."""
    return {"id": path_id, "note-value": "whole", "steps": [
        {"exponential": {"start": low + (high - low) * k / measures,
                         "end": low + (high - low) * (k + 1) / measures}}
        for k in range(measures)]}


def project(cfg: dict, seed: int) -> dict:
    measures, bpm = int(cfg["measures"]), float(cfg["bpm"])
    devices = [
        {"instrument": ["drums", {"drumkit": [{"midi-in": 9},
                                              {"name": cfg["kit"]["name"]}]}]},
        {"controller": [SIDECHAIN_UVID,
                        {"signal-passthrough-controller": [{}]}]},
        {"effect": ["bank", {"gain": {"ceiling": KITCHEN_LEVEL}}]},
    ]
    cables = [["bank", "main-mixer"], ["drums", SIDECHAIN_UVID, "bank"]]
    paths, trips, controls = [], [], []
    for uvid, (kind, params, trip, sidechain) in KITCHEN_SINK.items():
        devices.append({"effect": [uvid, {kind: dict(params)}]})
        cables.append(["drums", uvid, "bank"])
        for param, (low, high) in trip.items():
            pid = f"{uvid}-{param}"
            paths.append(rise(pid, low, high, measures))
            trips.append({"id": f"trip-{pid}", "paths": [pid],
                          "target": {"id": uvid, "param": param}})
        if sidechain is not None:
            controls.append({"id": f"sc-{uvid}", "source": SIDECHAIN_UVID,
                             "target": {"id": uvid, "param": sidechain}})
    for uvid, kind, params in KITCHEN_STATELESS:
        devices.append({"effect": [uvid, {kind: dict(params)}]})
    cables.append(["drums", *(u for u, _, _ in KITCHEN_STATELESS), "bank"])
    return {
        "title": "kitchen-sink analogue",
        "clock": {"bpm": bpm, "time-signature": [4, 4]},
        "devices": devices,
        "patch-cables": cables,
        "patterns": [drum_pattern()],
        "tracks": [{"id": "drum-track", "midi-channel": 9,
                    "patterns": ["beat"] * measures}],
        "paths": paths, "trips": trips, "controls": controls,
    }
