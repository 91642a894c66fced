"""Seeded synthetic assets and projects for the port's tests and on-card
smoke run.

write_assets builds a 707 drumkit tree — 16-bit stereo WAVs named
"<inst> R<r>.wav" under samples/elphnt.io/707/, four round robins for
every instrument of GM_707_MAP: decaying noise, sine or mixed bursts of
0.1 s up to `max_seconds`, made from numpy's seeded generator. The kit's
rate must equal the song's, or the render leaves the drum kernel.

north_star_project is an analogue of drums-filtered-24db: a 707 drumkit on
channel 9 (kick, snare, hats and crash on keys 35/38/42/44/49 as
16th-note patterns) feeding filter-low-pass-24db `low-pass-1`, whose
cutoff trip rises from `low` to `high` over the song (0 -> 25 Hz,
1 -> 20 kHz), then the main mixer.

filter_bank_project is an analogue of a filter bank: the same kit drives
parallel patch-cable chains through one filter each, summed by a gain
into the main mixer, so that one song takes every route of the effect
filters (FILTER_BANK).

welsh_project is an analogue of a Welsh-voice song (scale-c4-major's
kind): two inline welsh-raw voices, a refined-cascade pad and a
single-pass lead with noise and an amplitude LFO (WELSH_PAD,
WELSH_LEAD).

sidechain_project drives one parameter of every sidechain-able effect kind
from a passthrough controller on the kit (SIDECHAIN_ROUTES);
welsh_patch_project plays two `welsh` instruments by patch name, whose
patches write_welsh_patches writes (SHORT_PATCHES: short envelopes).

kitchen_sink_project is an analogue of kitchen-sink ("every effect +
trips"): the kit drives one parallel chain per effect route (KITCHEN_SINK:
compressors instantaneous, smoothed, with a release trip and with a
sidechain-driven threshold; delays static, with a trip and
sidechain-driven; choruses static and with voices and delay-seconds
trips; reverbs static and with a seconds trip; the toy; gain, limiter,
bitcrusher and a static 24 dB filter in one chain), summed by a gain into
the main mixer.

perf1_project is an analogue of perf-1 (BASELINE.md: two Welsh synths, a
drumkit and an arpeggiator at BPM 1024 through gain, limiter, reverb,
bitcrusher and filter chains): two inline welsh-raw voices with short
envelopes (PERF1_PAD, PERF1_LEAD), the lead played by an arpeggiator
over held chords.

fm_project is an analogue of the FM synth demos
(fm-synthesizer-beta-*.json): three inline FM voices, a pad of chords
under a beta trip, a sparse lead under a depth trip and a voice in
quarters under a ratio trip, which between them take the three routes of
the modulator phase (FM_PAD, FM_LEAD, FM_RATIO).

instruments_project is an analogue of the instrument demos: every other
instrument kind into the main mixer through gains (INSTRUMENT_LEVELS):
the 707 kit written at 48 kHz (write_assets(kit=KIT_48K,
sample_rate=48000)), a sampler on a 48 kHz WAV (write_sampler_wav), the
calculator on a synthetic pocket-calculator-24 bank
(write_calculator_bank), sine, sawtooth with a frequency trip,
pulse-width and noise oscillators, an envelope chord line, the toy
instrument, and UNKNOWN_UVID, a silent toy instrument with notes whose
kind a caller may replace by an unknown one (unknown_instrument).

smf_bytes writes a Standard MIDI File (format 0 or 1) from tracks of
(tick, event bytes); midi_song is an analogue of a MIDI file import: a
drum channel and two GM programs with a tempo change, whose programs
map to the Welsh patches write_welsh_patches writes (MIDI_PATCHES)."""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import numpy as np

from groove_tpu_torch.io.wav import write_wav_16bit_stereo
from groove_tpu_torch.models.sampler import GM_707_MAP, ROUND_ROBINS

KIT_DIR = Path("samples") / "elphnt.io" / "707"
FILTER_UVID = "low-pass-1"
# trip value whose cutoff is 2 kHz: 25 * 800 ** v = 2000
TRIP_2KHZ = math.log(80.0) / math.log(800.0)


def _burst(rng, name: str, n: int, sample_rate: int) -> np.ndarray:
    """One decaying stereo burst [n, 2] in [-1, 1)."""
    t = np.arange(n) / sample_rate
    decay = np.exp(-t * rng.uniform(4.0, 12.0) / max(t[-1], 1e-3))
    noise = rng.standard_normal((n, 2))
    f0 = rng.uniform(45.0, 90.0) if "Kick" in name else \
        rng.uniform(120.0, 900.0)
    sweep = f0 * (1.0 + 2.0 * np.exp(-t * 30.0))
    sine = np.sin(2.0 * np.pi * np.cumsum(sweep) / sample_rate)[:, None]
    if any(s in name for s in ("Kick", "Tom", "Cowbell")):
        body = sine + 0.05 * noise
    elif any(s in name for s in ("Snare", "Clap", "Rim")):
        body = 0.5 * sine + 0.5 * noise
    else:  # hats, cymbals, tambourine
        body = noise
    x = body * decay[:, None]
    return (rng.uniform(0.18, 0.32) * x / np.max(np.abs(x))).astype(np.float32)


def write_assets(root, seed: int = 0, sample_rate: int = 44100,
                 max_seconds: float = 1.5, kit: str = "707") -> Path:
    """Write the synthetic 707 kit under `root` as drumkit `kit` (its
    WAVs at `sample_rate`); returns `root`."""
    root = Path(root)
    kit = root / KIT_DIR.parent / kit
    kit.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in sorted(set(GM_707_MAP.values())):
        longest = max_seconds if name in ("Crash", "Ride") \
            else min(max_seconds, 0.6)
        for r in range(1, ROUND_ROBINS + 1):
            seconds = rng.uniform(0.1, max(longest, 0.1))
            n = max(16, int(seconds * sample_rate))
            write_wav_16bit_stereo(kit / f"{name} R{r}.wav",
                                   _burst(rng, name, n, sample_rate),
                                   sample_rate)
    return root


def north_star_project(measures: int = 1, bpm: float = 185.0,
                       low: float = 0.0, high: float = 1.0) -> dict:
    """The drums -> automated lp24 -> main-mixer project as a JSON dict.
    One 4/4 measure per pattern; the cutoff rises once, from `low` to
    `high` (trip values), over the whole song: one slow-start exponential
    step per measure. A rise keeps the cascade's input gain and its state
    consistent; a jump back down to 25 Hz would release the state built
    up at 20 kHz through poles next to z = 1, a transient of millions."""
    kick = [35 if i % 4 == 0 else 0 for i in range(16)]
    snare = [38 if i % 8 == 4 else 0 for i in range(16)]
    hats = [(44 if i % 4 == 3 else 42) if i % 2 == 0 or i % 4 == 3 else 0
            for i in range(16)]
    crash = [49] + [0] * 15
    return {
        "title": "north-star analogue",
        "clock": {"bpm": bpm, "time-signature": [4, 4]},
        "devices": [
            {"instrument": ["drums", {"drumkit": [{"midi-in": 9},
                                                  {"name": "707"}]}]},
            {"effect": [FILTER_UVID, {"filter-low-pass-24db": {
                "cutoff": 25.0, "passband-ripple": 0.707}}]},
        ],
        "patch-cables": [["drums", FILTER_UVID, "main-mixer"]],
        "patterns": [{"id": "beat", "note-value": "sixteenth",
                      "notes": [kick, snare, hats, crash]}],
        "tracks": [{"id": "drum-track", "midi-channel": 9,
                    "patterns": ["beat"] * measures}],
        "paths": [{"id": "rise", "note-value": "whole", "steps": [
            {"exponential": {"start": low + (high - low) * k / measures,
                             "end": low + (high - low) * (k + 1) / measures}}
            for k in range(measures)]}],
        "trips": [{"id": "trip-1", "paths": ["rise"],
                   "target": {"id": FILTER_UVID, "param": "cutoff"}}],
    }


def high_sweep_project(measures: int = 1, bpm: float = 185.0) -> dict:
    """The same song with the cutoff kept at or above 2 kHz, which stays
    away from z = 1 and routes to the single-pass cascade."""
    return north_star_project(measures, bpm, low=TRIP_2KHZ, high=1.0)


def _trip_value(hz: float) -> float:
    """The cutoff trip value (a Normal, 25 * 800 ** v Hz) of `hz`."""
    return math.log(hz / 25.0) / math.log(800.0)


def _rise(path_id: str, low: float, high: float, measures: int) -> dict:
    """A path rising once from trip value `low` to `high` over the song:
    one exponential step per measure."""
    return {"id": path_id, "note-value": "whole", "steps": [
        {"exponential": {"start": low + (high - low) * k / measures,
                         "end": low + (high - low) * (k + 1) / measures}}
        for k in range(measures)]}


# filter-bank device -> (effect kind, static params, the fidelity route
# the reference takes for it; kernels in filter_bank_project's docstring)
FILTER_BANK = {
    "peq": ("filter-peaking-eq-12db",
            {"cutoff": 1000.0, "q": 1.5, "db-gain": 6.0}, "plain"),
    "lp12-q20": ("filter-low-pass-12db", {"cutoff": 1000.0, "q": 20.0},
                 "refine"),
    "hp40": ("filter-high-pass-12db", {"cutoff": 40.0, "q": 0.707},
             "serial"),
    "bp-sweep": ("filter-band-pass-12db",
                 {"cutoff": 500.0, "bandwidth": 1000.0}, "plain"),
    "lp12-sweep": ("filter-low-pass-12db", {"cutoff": 25.0, "q": 0.707},
                   "refine"),
    "lp24-8k": ("filter-low-pass-24db",
                {"cutoff": 8000.0, "passband-ripple": 0.707}, "plain"),
    "lp24-sc": ("filter-low-pass-24db",
                {"cutoff": 1000.0, "passband-ripple": 0.707}, "plain"),
}
SIDECHAIN_UVID = "sc"
# the sidechain-driven filter's transients (its cutoff jumps with the
# drums' level) peak near 3x full scale over a 3-minute song: its chain
# has a level of its own
SIDECHAIN_LEVEL = 0.25


def filter_bank_project(measures: int = 1, bpm: float = 185.0) -> dict:
    """The drums -> filter bank -> gain -> main-mixer project. Static:
    peaking EQ at 1 kHz (K5), low-pass 1 kHz q 20 (refine: K4 twice),
    high-pass 40 Hz (serial scan), low-pass-24db at 8 kHz (K6). Automated:
    a band-pass rising from 500 Hz to 5 kHz, 1 kHz wide (K4), and a
    low-pass rising from 25 Hz to about 1.4 kHz (refine: K4 twice).
    Sidechain: a passthrough controller on the drums drives a
    low-pass-24db's cutoff (K3), followed by a gain of SIDECHAIN_LEVEL."""
    p = north_star_project(measures, bpm)
    devices = p["devices"][:1] + [
        {"controller": [SIDECHAIN_UVID,
                        {"signal-passthrough-controller": [{}]}]},
        {"effect": ["bank", {"gain": {"ceiling": 0.35}}]},
        {"effect": ["sc-level", {"gain": {"ceiling": SIDECHAIN_LEVEL}}]},
    ]
    cables = [["bank", "main-mixer"]]
    for uvid, (kind, params, _) in FILTER_BANK.items():
        devices.append({"effect": [uvid, {kind: dict(params)}]})
        if uvid == "lp24-sc":
            cables.append(["drums", SIDECHAIN_UVID, uvid, "sc-level", "bank"])
        else:
            cables.append(["drums", uvid, "bank"])
    p["title"] = "filter-bank analogue"
    p["devices"] = devices
    p["patch-cables"] = cables
    p["paths"] = [_rise("bp-rise", _trip_value(500.0), _trip_value(5000.0),
                        measures),
                  _rise("lp-rise", 0.0, 0.6, measures)]
    p["trips"] = [
        {"id": "trip-bp", "paths": ["bp-rise"],
         "target": {"id": "bp-sweep", "param": "cutoff"}},
        {"id": "trip-lp", "paths": ["lp-rise"],
         "target": {"id": "lp12-sweep", "param": "cutoff"}}]
    p["controls"] = [{"id": "sc-cutoff", "source": SIDECHAIN_UVID,
                      "target": {"id": "lp24-sc", "param": "cutoff"}}]
    return p


# Welsh analogue: two welsh-raw voices (inline WelshSynthParams, so no
# patch file is needed). Envelope releases equal their decays (the
# reference's patch derivation), so both voices ring about 1.6 s past
# note-off.
WELSH_PAD = {
    # resonant low resting cutoff: its sustained poles sit next to z = 1,
    # so filter_fidelity_mode routes it to the refined cascade (K8)
    "oscillator-1": {"waveform": "sawtooth", "tune": {"float": 1.0},
                     "mix-pct": 1.0},
    "oscillator-2": {"waveform": "sine", "tune": {"float": 2.0},
                     "mix-pct": 0.5},
    "oscillator-2-track": True, "oscillator-2-sync": False, "noise": 0.0,
    "lfo": {"routing": "none", "waveform": "sine", "frequency": 0.0,
            "depth": "none"},
    "glide": 0, "unison": False, "polyphony": "multi",
    "filter-type-24db": {"cutoff-hz": 120.0, "cutoff-pct": 0.2},
    "filter-type-12db": {"cutoff-hz": 120.0, "cutoff-pct": 0.2},
    "filter-resonance": 0.6, "filter-envelope-weight": 0.45,
    "filter-envelope": {"attack": 0.3, "decay": 1.6, "sustain": 0.2,
                        "release": 1.6},
    "amp-envelope": {"attack": 0.15, "decay": 1.6, "sustain": 0.7,
                     "release": 1.6},
}
WELSH_LEAD = {
    # bright filter with noise and an amplitude LFO: the single-pass
    # cascade (K7)
    "oscillator-1": {"waveform": "square", "tune": {"float": 1.0},
                     "mix-pct": 1.0},
    "oscillator-2": {"waveform": "sawtooth", "tune": {"float": 1.005},
                     "mix-pct": 0.6},
    "oscillator-2-track": True, "oscillator-2-sync": False, "noise": 0.25,
    "lfo": {"routing": "amplitude", "waveform": "sine", "frequency": 5.0,
            "depth": {"pct": 0.3}},
    "glide": 0, "unison": False, "polyphony": "multi",
    "filter-type-24db": {"cutoff-hz": 2500.0, "cutoff-pct": 0.6},
    "filter-type-12db": {"cutoff-hz": 2500.0, "cutoff-pct": 0.6},
    "filter-resonance": 0.2, "filter-envelope-weight": 0.9,
    "filter-envelope": {"attack": 0.01, "decay": 1.6, "sustain": 0.5,
                        "release": 1.6},
    "amp-envelope": {"attack": 0.01, "decay": 1.6, "sustain": 0.6,
                     "release": 1.6},
}


def welsh_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """Two welsh-raw voices at centre pan into the main mixer (so the song
    is channel-symmetric): a pad of 4-note chords in half notes on channel
    0 (refined cascade) and a lead in eighths on channel 1 (single-pass
    cascade, noise 0.25, amplitude LFO). The melody comes from numpy's
    generator seeded 0. 90 measures at 120 bpm are 3 minutes
    (7,938,048 frames)."""
    rng = np.random.default_rng(0)
    chords = [(48, 55, 60, 64), (53, 57, 60, 65), (45, 52, 57, 60),
              (43, 50, 55, 59)]
    scale = [60, 62, 64, 67, 69, 72, 74, 76]
    pads, leads = [], []
    for k in range(4):
        a, b = chords[k], chords[(k + 1) % 4]
        pads.append({"id": f"pad-{k}", "note-value": "half",
                     "notes": [[a[i], b[i]] for i in range(4)]})
        line = [int(scale[i]) if r > 0.2 else 0 for i, r in
                zip(rng.integers(0, len(scale), 8), rng.random(8))]
        leads.append({"id": f"lead-{k}", "note-value": "eighth",
                      "notes": [line]})
    return {
        "title": "welsh analogue",
        "clock": {"bpm": bpm, "time-signature": [4, 4]},
        "devices": [
            {"instrument": ["pad", {"welsh-raw": [
                {"midi-in": 0, "gain": 0.06}, dict(WELSH_PAD)]}]},
            {"instrument": ["lead", {"welsh-raw": [
                {"midi-in": 1, "gain": 0.25}, dict(WELSH_LEAD)]}]},
        ],
        "patch-cables": [["pad", "main-mixer"], ["lead", "main-mixer"]],
        "patterns": pads + leads,
        "tracks": [
            {"id": "pad-track", "midi-channel": 0,
             "patterns": [f"pad-{k % 4}" for k in range(measures)]},
            {"id": "lead-track", "midi-channel": 1,
             "patterns": [f"lead-{k % 4}" for k in range(measures)]},
        ],
    }


# kitchen-sink route -> (effect kind, static params, trip targets: param
# -> (trip value at the start, at the end), driven by the sidechain)
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
# the stateless chain, in order, then a static 24 dB filter (K6)
KITCHEN_STATELESS = (
    ("st-gain", "gain", {"ceiling": 0.8}),
    ("st-limiter", "limiter", {"minimum": 0.0, "maximum": 0.25}),
    ("st-crusher", "bitcrusher", {"bits": 6}),
    ("st-lp24", "filter-low-pass-24db",
     {"cutoff": 4000.0, "passband-ripple": 0.707}),
)
KITCHEN_LEVEL = 0.12  # the bank gain: the 3-minute song's peak about 0.5


def kitchen_sink_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """The drums -> one chain per effect route (KITCHEN_SINK,
    KITCHEN_STATELESS) -> gain `bank` -> main-mixer project. A
    passthrough controller on the drums (its own chain into the bank)
    drives the sidechain routes; each trip rises once over the song."""
    p = north_star_project(measures, bpm)
    devices = p["devices"][:1] + [
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
            paths.append(_rise(pid, low, high, measures))
            trips.append({"id": f"trip-{pid}", "paths": [pid],
                          "target": {"id": uvid, "param": param}})
        if sidechain is not None:
            controls.append({"id": f"sc-{uvid}", "source": SIDECHAIN_UVID,
                             "target": {"id": uvid, "param": sidechain}})
    for uvid, kind, params in KITCHEN_STATELESS:
        devices.append({"effect": [uvid, {kind: dict(params)}]})
    cables.append(["drums", *(u for u, _, _ in KITCHEN_STATELESS), "bank"])
    p["title"] = "kitchen-sink analogue"
    p["devices"] = devices
    p["patch-cables"] = cables
    p["paths"], p["trips"], p["controls"] = paths, trips, controls
    return p


# sidechain analogue: one passthrough controller on the kit drives a
# parameter of every effect kind that takes a sidechain (compressor
# release, delay time, chorus delay, reverb RT60, bitcrusher depth, a
# 12 dB low-pass cutoff): route -> (effect kind, static params, the
# sidechain's target param)
SIDECHAIN_ROUTES = {
    "sc-comp": ("compressor", {"threshold": 0.1, "ratio": 0.3,
                               "attack": 0.005, "release": 0.1}, "release"),
    "sc-delay": ("delay", {"delay": 0.0}, "delay"),
    "sc-chorus": ("chorus", {"voices": 3, "delay-seconds": 0.01},
                  "delay-seconds"),
    "sc-reverb": ("reverb", {"attenuation": 0.5, "seconds": 1.0},
                  "seconds"),
    "sc-crusher": ("bitcrusher", {"bits": 8}, "bits-to-crush"),
    "sc-lp12": ("filter-low-pass-12db", {"cutoff": 1000.0, "q": 0.7},
                "cutoff"),
}


def sidechain_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """The drums -> one chain per SIDECHAIN_ROUTES effect -> gain `bank`
    -> main-mixer project, each route's parameter driven by the
    passthrough controller `sc` on the drums (one block late, mapped to
    the parameter's domain), and sc's own chain into the bank."""
    p = north_star_project(measures, bpm)
    devices = p["devices"][:1] + [
        {"controller": [SIDECHAIN_UVID,
                        {"signal-passthrough-controller": [{}]}]},
        {"effect": ["bank", {"gain": {"ceiling": 0.3}}]},
    ]
    cables = [["bank", "main-mixer"], ["drums", SIDECHAIN_UVID, "bank"]]
    controls = []
    for uvid, (kind, params, param) in SIDECHAIN_ROUTES.items():
        devices.append({"effect": [uvid, {kind: dict(params)}]})
        cables.append(["drums", uvid, "bank"])
        controls.append({"id": f"sc-{uvid}", "source": SIDECHAIN_UVID,
                         "target": {"id": uvid, "param": param}})
    p["title"] = "sidechain analogue"
    p["devices"] = devices
    p["patch-cables"] = cables
    p["paths"], p["trips"], p["controls"] = [], [], controls
    return p


# perf-1 analogue voices: the Welsh analogue's pad and lead with short
# envelopes (a 0.05 s release), so that a BPM of 1024 keeps each note's
# window a few thousand samples long
_SHORT = {"attack": 0.005, "decay": 0.05, "sustain": 0.6, "release": 0.05}
PERF1_PAD = {**WELSH_PAD, "filter-envelope": dict(_SHORT),
             "amp-envelope": dict(_SHORT)}
PERF1_LEAD = {**WELSH_LEAD, "filter-envelope": dict(_SHORT),
              "amp-envelope": dict(_SHORT)}
PERF1_BPM = 1024.0


def perf1_project(measures: int = 1, bpm: float = PERF1_BPM) -> dict:
    """Two welsh-raw voices, the 707 kit and an arpeggiator (midi 2 -> 1,
    at the song's BPM, a held 3-note chord a measure) through three
    chains into the main mixer: drums ->
    gain -> limiter -> bitcrusher; pad -> static low-pass-24db (K6) ->
    reverb; lead (the arpeggiated chords) -> low-pass-12db (K5) -> gain.
    768 measures at 1024 bpm are 3 minutes."""
    beat = north_star_project(1, bpm)["patterns"]
    chords = [(48, 55, 60), (53, 57, 60), (45, 52, 57), (43, 50, 55)]
    pads = [{"id": f"pad-{k}", "note-value": "whole",
             "notes": [[c[i]] for i in range(3)]}
            for k, c in enumerate(chords)]
    # a chord held a measure, an octave above the pad: the arpeggiator
    # cycles the held set, one note a sixteenth
    held = [{"id": f"held-{k}", "note-value": "whole",
             "notes": [[c[i] + 12] for i in range(3)]}
            for k, c in enumerate(chords)]
    return {
        "title": "perf-1 analogue",
        "clock": {"bpm": bpm, "time-signature": [4, 4]},
        "devices": [
            {"instrument": ["drums", {"drumkit": [{"midi-in": 9},
                                                  {"name": "707"}]}]},
            {"instrument": ["pad", {"welsh-raw": [
                {"midi-in": 0, "gain": 0.08}, dict(PERF1_PAD)]}]},
            {"instrument": ["lead", {"welsh-raw": [
                {"midi-in": 1, "gain": 0.2}, dict(PERF1_LEAD)]}]},
            {"controller": ["arp", {"arpeggiator": [
                {"midi-in": 2, "midi-out": 1}, {"bpm": bpm}]}]},
            {"effect": ["d-gain", {"gain": {"ceiling": 0.7}}]},
            {"effect": ["d-limiter", {"limiter": {"minimum": 0.0,
                                                  "maximum": 0.3}}]},
            {"effect": ["d-crusher", {"bitcrusher": {"bits": 8}}]},
            {"effect": ["p-lp24", {"filter-low-pass-24db": {
                "cutoff": 3000.0, "passband-ripple": 0.707}}]},
            {"effect": ["p-reverb", {"reverb": {"attenuation": 0.4,
                                                "seconds": 1.2}}]},
            {"effect": ["l-lp12", {"filter-low-pass-12db": {
                "cutoff": 2500.0, "q": 0.9}}]},
            {"effect": ["l-gain", {"gain": {"ceiling": 0.6}}]},
        ],
        "patch-cables": [["drums", "d-gain", "d-limiter", "d-crusher",
                          "main-mixer"],
                         ["pad", "p-lp24", "p-reverb", "main-mixer"],
                         ["lead", "l-lp12", "l-gain", "main-mixer"]],
        "patterns": beat + pads + held,
        "tracks": [
            {"id": "drum-track", "midi-channel": 9,
             "patterns": ["beat"] * measures},
            {"id": "pad-track", "midi-channel": 0,
             "patterns": [f"pad-{k % 4}" for k in range(measures)]},
            {"id": "arp-track", "midi-channel": 2,
             "patterns": [f"held-{k % 4}" for k in range(measures)]},
        ],
    }


# Welsh patches with short envelopes (the perf-1 analogue's voices) under
# the names welsh_patch_project plays: write_welsh_patches(root,
# SHORT_PATCHES)
SHORT_PATCHES = {"piano": PERF1_PAD, "new-age-lead": PERF1_LEAD}


def welsh_patch_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """Two `welsh` instruments by patch name ("piano": chords in quarter
    notes on channel 0, "new-age-lead": a line in eighths on channel 1),
    their patches found under patches/welsh/ (write_welsh_patches), into
    the main mixer."""
    chords = [(48, 55, 60), (53, 57, 60), (45, 52, 57), (43, 50, 55)]
    rng = np.random.default_rng(4)
    pads, leads = [], []
    for k, c in enumerate(chords):
        pads.append({"id": f"pad-{k}", "note-value": "quarter",
                     "notes": [[c[i]] * 4 for i in range(3)]})
        line = [int(v) for v in rng.choice([60, 62, 64, 67, 69, 72], 8)]
        leads.append({"id": f"lead-{k}", "note-value": "eighth",
                      "notes": [line]})
    return {
        "title": "welsh patch analogue",
        "clock": {"bpm": bpm, "time-signature": [4, 4]},
        "devices": [
            {"instrument": ["pad", {"welsh": [{"midi-in": 0, "gain": 0.1},
                                              {"name": "piano"}]}]},
            {"instrument": ["lead", {"welsh": [
                {"midi-in": 1, "gain": 0.2}, {"name": "new-age-lead"}]}]},
        ],
        "patch-cables": [["pad", "main-mixer"], ["lead", "main-mixer"]],
        "patterns": pads + leads,
        "tracks": [
            {"id": "pad-track", "midi-channel": 0,
             "patterns": [f"pad-{k % 4}" for k in range(measures)]},
            {"id": "lead-track", "midi-channel": 1,
             "patterns": [f"lead-{k % 4}" for k in range(measures)]},
        ],
    }


def write_project(path, project: dict) -> Path:
    path = Path(path)
    path.write_text(json.dumps(project, indent=1))
    return path


# ---- FM analogue -----------------------------------------------------------

def _fm_voice(ratio: float, depth: float, beta: float, gain: float,
              carrier: dict, modulator: dict) -> dict:
    return {"gain": gain, "pan": 0.0, "ratio": ratio, "depth": depth,
            "beta": beta, "carrier-envelope": carrier,
            "modulator-envelope": modulator}


# pad: chords under a beta trip 0 -> 20; lead: sparse eighths under a depth
# trip; ratio voice: quarters under a ratio trip 1 -> 3.5
FM_PAD = _fm_voice(2.0, 1.0, 0.0, 0.05,
                   {"attack": 0.05, "decay": 0.6, "sustain": 0.7,
                    "release": 0.8},
                   {"attack": 0.2, "decay": 1.0, "sustain": 0.5,
                    "release": 0.8})
FM_LEAD = _fm_voice(3.0, 0.5, 4.0, 0.12,
                    {"attack": 0.005, "decay": 0.1, "sustain": 0.6,
                     "release": 0.1},
                    {"attack": 0.01, "decay": 0.2, "sustain": 0.4,
                     "release": 0.1})
FM_RATIO = _fm_voice(1.0, 1.0, 2.5, 0.1,
                     {"attack": 0.01, "decay": 0.2, "sustain": 0.5,
                      "release": 0.3},
                     {"attack": 0.01, "decay": 0.3, "sustain": 0.6,
                      "release": 0.3})
FM_TRIPS = {"pad": ("beta", 0.0, 20.0), "lead": ("depth", 0.1, 1.5),
            "ratio-voice": ("ratio", 1.0, 3.5)}


def _path(path_id: str, low: float, high: float, measures: int,
          kind: str = "slope") -> dict:
    """A path from `low` to `high` over the song, one step a measure."""
    return {"id": path_id, "note-value": "whole", "steps": [
        {kind: {"start": low + (high - low) * k / measures,
                "end": low + (high - low) * (k + 1) / measures}}
        for k in range(measures)]}


def _song(title: str, bpm: float, devices, cables, patterns, tracks,
          trips=()) -> dict:
    paths, trip_list = [], []
    for uvid, (param, low, high, measures) in trips:
        pid = f"{uvid}-{param}"
        paths.append(_path(pid, low, high, measures))
        trip_list.append({"id": f"trip-{pid}", "paths": [pid],
                          "target": {"id": uvid, "param": param}})
    return {"title": title, "clock": {"bpm": bpm, "time-signature": [4, 4]},
            "devices": devices, "patch-cables": cables,
            "patterns": patterns, "tracks": tracks, "paths": paths,
            "trips": trip_list}


def fm_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """Three fm-synthesizer voices into the main mixer: the pad (4-note
    chords, a whole note each, channel 0) under a beta trip, the lead
    (eighths on the first half of each measure, channel 1) under a depth
    trip, and the ratio voice (quarters, channel 2) under a ratio trip.
    At 90 measures the pad's one span bucket is past
    fm.HOST_PHASE_MAX_ELEMS (its phases are traced), the lead's is within
    it (host phase tables) and the ratio voice integrates its modulator
    phase; at a few measures both the pad and the lead ship tables."""
    rng = np.random.default_rng(1)
    chords = [(48, 55, 60, 64), (53, 57, 60, 65), (45, 52, 57, 60),
              (43, 50, 55, 59)]
    scale = [60, 62, 64, 67, 69, 72, 74, 76]
    patterns = []
    for k, c in enumerate(chords):
        patterns.append({"id": f"fm-pad-{k}", "note-value": "whole",
                         "notes": [[key] for key in c]})
        line = [int(x) for x in rng.choice(scale, 4)] + [0] * 4
        patterns.append({"id": f"fm-lead-{k}", "note-value": "eighth",
                         "notes": [line]})
        patterns.append({"id": f"fm-ratio-{k}", "note-value": "quarter",
                         "notes": [[int(x) - 12 for x in
                                    rng.choice(scale, 4)]]})
    voices = {"pad": (0, FM_PAD), "lead": (1, FM_LEAD),
              "ratio-voice": (2, FM_RATIO)}
    devices = [{"instrument": [uvid, {"fm-synthesizer": [
        {"midi-in": ch}, dict(voice)]}]}
        for uvid, (ch, voice) in voices.items()]
    cables = [[uvid, "main-mixer"] for uvid in voices]
    names = {"pad": "fm-pad", "lead": "fm-lead", "ratio-voice": "fm-ratio"}
    tracks = [{"id": f"{uvid}-track", "midi-channel": ch,
               "patterns": [f"{names[uvid]}-{k % 4}"
                            for k in range(measures)]}
              for uvid, (ch, _) in voices.items()]
    trips = [(uvid, (param, low, high, measures))
             for uvid, (param, low, high) in FM_TRIPS.items()]
    return _song("fm analogue", bpm, devices, cables, patterns, tracks,
                 trips)


# ---- instruments analogue --------------------------------------------------

KIT_48K = "707-48k"
CALCULATOR_DIR = Path("samples") / "pocket-calculator-24"
SAMPLER_WAV = "synthetic-sampler-48k.wav"
UNKNOWN_UVID = "mystery"
# device -> the gain its chain takes into the main mixer
INSTRUMENT_LEVELS = {
    "kit48": 0.6, "sampler": 0.3, "calculator": 0.3, "osc-sine": 0.02,
    "osc-saw": 0.015, "osc-pulse": 0.01, "osc-noise": 0.01,
    "envelope": 0.08, "toy": 0.5, UNKNOWN_UVID: 1.0,
}


def write_calculator_bank(root, seed: int = 2, sample_rate: int = 44100,
                          sounds: int = 24) -> Path:
    """A synthetic pocket-calculator-24 bank under `root`: `sounds` short
    beeps (0.05-0.25 s, 400-2400 Hz) named in sorted order."""
    root = Path(root)
    bank = root / CALCULATOR_DIR
    bank.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(sounds):
        n = int(rng.uniform(0.05, 0.25) * sample_rate)
        t = np.arange(n) / sample_rate
        tone = np.sin(2.0 * np.pi * rng.uniform(400.0, 2400.0) * t)
        x = (0.4 * tone * np.exp(-t * 12.0))[:, None].repeat(2, 1)
        write_wav_16bit_stereo(bank / f"beep-{i:02d}.wav",
                               x.astype(np.float32), sample_rate)
    return root


def write_sampler_wav(root, seed: int = 3, sample_rate: int = 48000,
                      seconds: float = 1.2) -> str:
    """A decaying harmonic tone at A4 under `root`/samples, recorded at
    `sample_rate`; returns its name for a sampler's `filename`."""
    path = Path(root) / "samples" / SAMPLER_WAV
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    x = sum(rng.uniform(0.2, 1.0) / h * np.sin(2.0 * np.pi * 440.0 * h * t)
            for h in range(1, 6))
    x = x * np.exp(-t * 2.5)
    x = 0.5 * x / np.max(np.abs(x))
    stereo = np.stack([x, 0.9 * x], 1).astype(np.float32)
    write_wav_16bit_stereo(path, stereo, sample_rate)
    return SAMPLER_WAV


def write_instrument_assets(root, seed: int = 1) -> Path:
    """The instruments analogue's assets under `root`: the 707 kit at 48
    kHz (KIT_48K), the calculator bank and the sampler WAV."""
    write_assets(root, seed, sample_rate=48000, max_seconds=0.6,
                 kit=KIT_48K)
    write_calculator_bank(root)
    write_sampler_wav(root)
    return Path(root)


def instruments_project(measures: int = 1, bpm: float = 120.0) -> dict:
    """Every instrument kind but the Welsh and FM voices, each through a
    gain (INSTRUMENT_LEVELS) into the main mixer: the 48 kHz kit
    (channel 9, the north star's beat), the sampler (channel 2, quarters
    around its root), the calculator (its own jingle on channel 4), the
    sine (220 Hz), sawtooth (frequency trip 100 -> 400 Hz), pulse-width
    (0.3 at 330 Hz) and noise oscillators, the envelope instrument (3-note
    chords in half notes, channel 3), the toy instrument, and the silent
    UNKNOWN_UVID toy with notes on channel 6."""
    beat = north_star_project(1, bpm)["patterns"][0]
    rng = np.random.default_rng(4)
    patterns = [beat,
                {"id": "samp", "note-value": "quarter",
                 "notes": [[int(x) for x in rng.choice(
                     [57, 60, 64, 67, 69, 72], 4)]]},
                {"id": "env", "note-value": "half",
                 "notes": [[60, 65], [64, 69], [67, 72]]},
                {"id": "myst", "note-value": "half",
                 "notes": [[60, 62]]}]
    inst = {
        "kit48": {"drumkit": [{"midi-in": 9}, {"name": KIT_48K}]},
        "sampler": {"sampler": [{"midi-in": 2},
                                {"filename": SAMPLER_WAV, "root": 69}]},
        "osc-sine": {"oscillator": {"waveform": "sine", "frequency": 220.0,
                                    "midi-in": 7}},
        "osc-saw": {"oscillator": {"waveform": "sawtooth",
                                   "frequency": 150.0, "midi-in": 7}},
        "osc-pulse": {"oscillator": {"waveform": {"pulse-width": 0.3},
                                     "frequency": 330.0, "midi-in": 7}},
        "osc-noise": {"oscillator": {"waveform": "noise", "midi-in": 7}},
        "envelope": {"envelope": {"attack": 0.05, "decay": 0.2,
                                  "sustain": 0.6, "release": 0.4,
                                  "midi-in": 3}},
        "toy": {"toy-instrument": {"fake-value": 0.05, "midi-in": 8}},
        UNKNOWN_UVID: {"toy-instrument": {"fake-value": 0.0,
                                          "midi-in": 6}},
    }
    devices = [{"instrument": [u, body]} for u, body in inst.items()]
    devices.append({"controller": ["calculator", {"calculator": [
        {"midi-in": 4, "midi-out": 4}, {"clock": {"bpm": bpm}}]}]})
    cables = []
    for uvid, level in INSTRUMENT_LEVELS.items():
        devices.append({"effect": [f"{uvid}-level",
                                   {"gain": {"ceiling": level}}]})
        cables.append([uvid, f"{uvid}-level", "main-mixer"])
    tracks = [{"id": "kit-track", "midi-channel": 9,
               "patterns": ["beat"] * measures},
              {"id": "samp-track", "midi-channel": 2,
               "patterns": ["samp"] * measures},
              {"id": "env-track", "midi-channel": 3,
               "patterns": ["env"] * measures},
              {"id": "myst-track", "midi-channel": 6,
               "patterns": ["myst"] * measures}]
    lo, hi = _trip_value(100.0), _trip_value(400.0)
    trips = [("osc-saw", ("frequency", lo, hi, measures))]
    return _song("instruments analogue", bpm, devices, cables, patterns,
                 tracks, trips)


def unknown_instrument(compiled, kind: str = "mystery-instrument"):
    """Give UNKNOWN_UVID an instrument kind no renderer knows (a project
    file cannot name one: the schema refuses it); returns `compiled`."""
    compiled.devices[UNKNOWN_UVID].kind = kind
    return compiled


# ---- Standard MIDI Files ---------------------------------------------------

def _varint(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def smf_bytes(tracks, division: int = 480, fmt: int = 1) -> bytes:
    """A Standard MIDI File: tracks are lists of (absolute tick, event
    bytes with their status byte); each track ends with End of Track."""
    if fmt == 0 and len(tracks) != 1:
        raise ValueError("a format-0 file holds one track")
    out = b"MThd" + struct.pack(">IHHH", 6, fmt, len(tracks), division)
    for track in tracks:
        data, last = b"", 0
        for tick, ev in sorted(track, key=lambda e: e[0]):
            data += _varint(tick - last) + bytes(ev)
            last = tick
        data += _varint(0) + b"\xff\x2f\x00"
        out += b"MTrk" + struct.pack(">I", len(data)) + data
    return out


def tempo_event(tick: int, bpm: float):
    us = int(round(60_000_000 / bpm))
    return tick, b"\xff\x51\x03" + us.to_bytes(3, "big")


def note_events(channel: int, key: int, vel: int, on: int, off: int):
    return [(on, bytes([0x90 | channel, key, vel])),
            (off, bytes([0x80 | channel, key, 0]))]


# GM programs of midi_song's two melodic channels -> the patches
# gm_program_to_patch names for them, written by write_welsh_patches
MIDI_PROGRAMS = {0: 0, 1: 81}   # channel -> program (piano, new-age-lead)
MIDI_PATCHES = {"piano": WELSH_PAD, "new-age-lead": WELSH_LEAD}


def write_welsh_patches(root, patches=None) -> Path:
    """Welsh patch files patches/welsh/<name>.json under `root`."""
    d = Path(root) / "patches" / "welsh"
    d.mkdir(parents=True, exist_ok=True)
    for name, voice in (patches or MIDI_PATCHES).items():
        (d / f"{name}.json").write_text(json.dumps({"name": name,
                                                    **voice}))
    return Path(root)


def midi_song(measures: int = 4, bpm: float = 120.0, fmt: int = 1,
              division: int = 480) -> bytes:
    """A MIDI file analogue: the north star's beat on channel 9, 3-note
    chords (program 0) on channel 0 a half note each, a melody in eighths
    (program 81) on channel 1, 4/4, and a tempo change to 1.25 x `bpm`
    half-way. Format 1: a tempo track and one track a channel; format 0:
    one track."""
    q = division
    tempo = [tempo_event(0, bpm), (0, b"\xff\x58\x04\x04\x02\x18\x08"),
             tempo_event((measures // 2) * 4 * q, bpm * 1.25)]
    drums, pads, lead = [], [], []
    kick_snare_hat = {0: 36, 4: 42, 8: 38, 12: 42}
    rng = np.random.default_rng(5)
    chords = [(48, 55, 60), (53, 57, 60), (45, 52, 57), (43, 50, 55)]
    for m in range(measures):
        base = m * 4 * q
        for step in range(16):
            key = kick_snare_hat.get(step % 16, 42 if step % 2 == 0 else 0)
            if key:
                t = base + step * q // 4
                drums += note_events(9, key, 100, t, t + q // 8)
        for half in range(2):
            t = base + half * 2 * q
            for key in chords[(2 * m + half) % 4]:
                pads += note_events(0, key, 10, t, t + 2 * q - 10)
        for e in range(8):
            t = base + e * q // 2
            key = int(rng.choice([60, 62, 64, 67, 69, 72]))
            lead += note_events(1, key, 25, t, t + q // 2 - 20)
    progs = [(0, bytes([0xC0 | ch, prog]))
             for ch, prog in MIDI_PROGRAMS.items()]
    if fmt == 0:
        return smf_bytes([tempo + progs + drums + pads + lead], division, 0)
    return smf_bytes([tempo, [progs[0]] + pads, [progs[1]] + lead, drums],
                     division, 1)
