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


# Welsh voice branches that the analogue's two voices leave out: name ->
# (the device replaced, its inline patch)
WELSH_VARIANTS = {
    # a monophonic lead gliding 80 ms between its notes
    "glide": ("lead", dict(WELSH_LEAD, glide=0.08, polyphony="mono")),
    # a lead under a pitch LFO: host phase tables where a bucket is within
    # welsh.HOST_PHASE_MAX_ELEMS
    "pitch-lfo": ("lead", dict(WELSH_LEAD, lfo={
        "routing": "pitch", "waveform": "triangle", "frequency": 4.0,
        "depth": {"pct": 0.1}})),
    # a unison pad: three rendered notes a note
    "unison": ("pad", dict(WELSH_PAD, unison=True)),
}


def welsh_variant_project(name: str, measures: int = 1,
                          bpm: float = 120.0) -> dict:
    """The Welsh analogue with one voice's patch replaced by
    WELSH_VARIANTS[name] (same notes, gains and cables)."""
    uvid, patch = WELSH_VARIANTS[name]
    p = welsh_project(measures, bpm)
    for dev in p["devices"]:
        if dev["instrument"][0] == uvid:
            dev["instrument"][1]["welsh-raw"][1] = dict(patch)
    p["title"] = f"welsh analogue, {name}"
    return p


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


def oscillator_project() -> dict:
    """A sine instrument at 440 Hz and one whole note at 128 bpm (the
    reference's demos/instruments/oscillator-sine-a4.json, which its
    service and GUI tests open): no assets."""
    return {
        "title": "oscillator sine a4", "clock": {"bpm": 128.0},
        "devices": [{"instrument": ["oscillator-1", {"oscillator": {
            "waveform": "sine", "frequency": 440.0}}]}],
        "patch-cables": [["oscillator-1", "main-mixer"]],
        "patterns": [{"id": "p", "note-value": "whole", "notes": [[69]]}],
        "tracks": [{"id": "t", "midi-channel": 0, "patterns": ["p"]}],
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


# ---- live analogue ---------------------------------------------------------

# The pad: a resonant low-pass pad whose second oscillator is noise, with a
# sample-and-hold LFO on the cutoff and a short glide
LIVE_PAD = {
    "oscillator-1": {"waveform": "sawtooth", "tune": {"float": 1.0},
                     "mix-pct": 1.0},
    "oscillator-2": {"waveform": "noise", "tune": {"float": 1.0},
                     "mix-pct": 0.8},
    "oscillator-2-track": True, "oscillator-2-sync": False, "noise": 0.1,
    "lfo": {"routing": "filter-cutoff", "waveform": "noise",
            "frequency": 6.0, "depth": {"pct": 0.15}},
    "glide": 0.04, "unison": False, "polyphony": "multi",
    "filter-type-24db": {"cutoff-hz": 900.0, "cutoff-pct": 0.45},
    "filter-type-12db": {"cutoff-hz": 900.0, "cutoff-pct": 0.45},
    "filter-resonance": 0.5, "filter-envelope-weight": 0.6,
    "filter-envelope": {"attack": 0.05, "decay": 0.8, "sustain": 0.4,
                        "release": 0.5},
    "amp-envelope": {"attack": 0.02, "decay": 0.6, "sustain": 0.7,
                     "release": 0.3},
}
# MIDI channel of each live instrument (the free-running oscillator takes
# none)
LIVE_CHANNELS = {"pad": 0, "fm": 1, "sampler": 2, "envelope": 3,
                 "drums": 9}
LIVE_VOICES = 8  # voices a pool, the reference's default
LIVE_SIDECHAIN = "duck"


def write_live_assets(root) -> Path:
    """The live analogue's assets under `root`: the 707 kit at 44.1 kHz
    and the sampler's 48 kHz WAV."""
    write_assets(root)
    write_sampler_wav(root)
    return Path(root)


def live_project(measures: int = 2, bpm: float = 120.0) -> dict:
    """The live analogue: a song a player plays along with from a MIDI
    keyboard, every live instrument kind through the kitchen sink's effect
    kinds into a bus.

        pad (welsh-raw LIVE_PAD, ch 0) -> pad-comp (compressor, its
            threshold driven by the sidechain `duck`: the pad ducks under
            the drums) -> pad-verb (reverb) -> bus
        fm (ch 1) -> fm-delay -> bus, and a send of 0.3 into pad-verb
        drums (707, ch 9) -> duck (passthrough) -> drum-comp (smoothed
            compressor) -> bus
        sampler (ch 2) -> samp-lp (low-pass 12 dB under a cutoff trip) ->
            bus
        envelope (ch 3) -> env-hp (high-pass 12 dB at 40 Hz: its poles
            take the serial scan) -> bus
        osc (a 220 Hz sine, always on) -> osc-lp (low-pass 24 dB,
            static) -> bus
        bus (gain) -> limiter -> main-mixer

    The sequenced patterns (dyads on the pad in quarters, the north
    star's beat, an FM line in eighths) are what a play-along plays;
    `measures` of them. Assets:
    write_live_assets."""
    beat = north_star_project(1, bpm)["patterns"][0]
    rng = np.random.default_rng(6)
    scale = [60, 62, 64, 67, 69, 72]
    patterns = [beat,
                {"id": "pad-chords", "note-value": "quarter",
                 "notes": [[48, 53, 45, 43], [60, 57, 57, 55]]},
                {"id": "fm-line", "note-value": "eighth",
                 "notes": [[int(x) for x in rng.choice(scale, 8)]]}]
    ch = LIVE_CHANNELS
    devices = [
        {"instrument": ["pad", {"welsh-raw": [
            {"midi-in": ch["pad"], "gain": 0.15}, dict(LIVE_PAD)]}]},
        {"instrument": ["fm", {"fm-synthesizer": [
            {"midi-in": ch["fm"]}, dict(FM_LEAD)]}]},
        {"instrument": ["drums", {"drumkit": [{"midi-in": ch["drums"]},
                                              {"name": "707"}]}]},
        {"instrument": ["sampler", {"sampler": [
            {"midi-in": ch["sampler"]},
            {"filename": SAMPLER_WAV, "root": 69}]}]},
        {"instrument": ["envelope", {"envelope": {
            "attack": 0.01, "decay": 0.2, "sustain": 0.5, "release": 0.3,
            "midi-in": ch["envelope"]}}]},
        {"instrument": ["osc", {"oscillator": {"waveform": "sine",
                                               "frequency": 220.0}}]},
        {"controller": [LIVE_SIDECHAIN,
                        {"signal-passthrough-controller": [{}]}]},
        {"effect": ["pad-comp", {"compressor": {
            "threshold": 0.5, "ratio": 0.25, "attack": 0.0,
            "release": 0.0}}]},
        {"effect": ["pad-verb", {"reverb": {"attenuation": 0.5,
                                            "seconds": 1.2}}]},
        {"effect": ["fm-delay", {"delay": {"delay": 0.125}}]},
        {"effect": ["drum-comp", {"compressor": {
            "threshold": 0.1, "ratio": 0.3, "attack": 0.005,
            "release": 0.1}}]},
        {"effect": ["samp-lp", {"filter-low-pass-12db": {
            "cutoff": 3000.0, "q": 0.7}}]},
        {"effect": ["env-hp", {"filter-high-pass-12db": {
            "cutoff": 40.0, "q": 0.707}}]},
        {"effect": ["osc-lp", {"filter-low-pass-24db": {
            "cutoff": 1500.0, "passband-ripple": 0.707}}]},
        {"effect": ["osc-level", {"gain": {"ceiling": 0.05}}]},
        {"effect": ["bus", {"gain": {"ceiling": 0.6}}]},
        {"effect": ["limiter", {"limiter": {"minimum": -0.9,
                                            "maximum": 0.9}}]},
    ]
    cables = [["pad", "pad-comp", "pad-verb", "bus"],
              ["fm", "fm-delay", "bus"],
              ["drums", LIVE_SIDECHAIN, "drum-comp", "bus"],
              ["sampler", "samp-lp", "bus"],
              ["envelope", "env-hp", "bus"],
              ["osc", "osc-lp", "osc-level", "bus"],
              ["bus", "limiter", "main-mixer"]]
    tracks = [{"id": "pad-track", "midi-channel": ch["pad"],
               "patterns": ["pad-chords"] * measures},
              {"id": "drum-track", "midi-channel": ch["drums"],
               "patterns": ["beat"] * measures},
              {"id": "fm-track", "midi-channel": ch["fm"],
               "patterns": ["fm-line"] * measures}]
    lo, hi = _trip_value(800.0), _trip_value(6000.0)
    p = _song("live analogue", bpm, devices, cables, patterns, tracks,
              [("samp-lp", ("cutoff", lo, hi, measures))])
    p["controls"] = [{"id": "duck-pad", "source": LIVE_SIDECHAIN,
                      "target": {"id": "pad-comp", "param": "threshold"}}]
    p["sends"] = [{"source": "fm", "aux": "pad-verb", "amount": 0.3}]
    return p


def live_performance(seconds: float, sample_rate: int = 44100,
                     seed: int = 0) -> list[tuple[int, bytes]]:
    """A seeded scripted performance on LIVE_CHANNELS: [(frame, MIDI
    bytes)] in frame order. Pad chords of 4 notes a second (gliding from
    the last chord), an FM line in sixteenths held across each other with
    a burst of 10 held notes a bar (more than a pool holds: steals), the
    drums' kick, snare and hats (repeated keys: round robins) with short
    note-offs, sampler quarters and envelope dyads. Note-offs are 0x8n or
    a note-on of velocity 0, and a run of notes on one channel uses
    running status, as a keyboard's stream does."""
    rng = np.random.default_rng(seed)
    sr = sample_rate
    ev: list[tuple[int, int, bytes]] = []  # (frame, order, bytes)
    ch = LIVE_CHANNELS

    def note(c, key, vel, t_on, t_off, zero_off=False):
        on_f, off_f = int(t_on * sr), int(t_off * sr)
        ev.append((on_f, 1, bytes([0x90 | c, key, vel])))
        off = bytes([0x90 | c, key, 0]) if zero_off \
            else bytes([0x80 | c, key, 0])
        ev.append((max(off_f, on_f + 1), 0, off))

    chords = [(48, 55, 60, 64), (53, 57, 60, 65), (45, 52, 57, 60),
              (43, 50, 55, 59)]
    beat = 0.125  # a sixteenth at 120 bpm
    n_steps = int(seconds / beat)
    for k in range(int(np.ceil(seconds))):
        for key in chords[k % 4]:
            note(ch["pad"], key, int(rng.integers(60, 110)),
                 k + 0.002 * (key % 3), k + 0.9, zero_off=bool(k % 2))
    for s in range(n_steps):
        t = s * beat
        if s % 16 == 8:  # a burst past the pool's 8 voices
            for i in range(10):
                note(ch["fm"], 60 + i, 90, t + i * 0.004, t + 1.2)
        elif rng.random() < 0.7:
            note(ch["fm"], int(rng.choice([60, 62, 64, 67, 69, 72, 74])),
                 int(rng.integers(50, 120)), t, t + 0.4, zero_off=True)
        for key, every in ((35, 4), (38, 8), (42, 2)):
            if s % every == (4 if key == 38 else 0):
                note(ch["drums"], key, int(rng.integers(80, 127)), t,
                     t + 0.02)
        if s % 4 == 2:
            note(ch["sampler"], int(rng.choice([57, 60, 64, 67])), 100, t,
                 t + 0.3)
        if s % 8 == 0:
            for key in (64, 69):
                note(ch["envelope"], key, 70, t, t + 0.6)
    ev.sort(key=lambda e: (e[0], e[1]))
    return [(f, b) for f, _, b in ev if f < int(seconds * sr)]


def running_status(events: list[tuple[int, bytes]]) -> bytes:
    """The performance as one byte stream with running status: a message
    whose status byte repeats the previous one's drops it."""
    out, last = bytearray(), None
    for _, msg in events:
        out += msg[1:] if msg[0] == last else msg
        last = msg[0]
    return bytes(out)


def write_live_performance(path, events: list[tuple[int, bytes]]) -> Path:
    """The performance's bytes as a file a MIDI port would deliver
    (running_status)."""
    path = Path(path)
    path.write_bytes(running_status(events))
    return path


def block_schedule(events: list[tuple[int, bytes]], block_frames: int,
                   n_blocks: int) -> list[tuple[bytes, int]]:
    """The performance's running-status byte stream cut per block: entry k
    holds the bytes and the message count of the events in [k, k + 1) x
    block_frames (delivered before block k renders, they pin to its
    start). Concatenated, the bytes are write_live_performance's file
    (events past the last block left out)."""
    out = [[bytearray(), 0] for _ in range(n_blocks)]
    last = None
    for f, msg in events:
        k = f // block_frames
        if k < n_blocks:
            out[k][0] += msg[1:] if msg[0] == last else msg
            out[k][1] += 1
        last = msg[0]
    return [(bytes(b), n) for b, n in out]


def play_live(renderer, schedule, timeout: float = 10.0, times=None,
              after_block=None) -> np.ndarray:
    """Play a block_schedule through a LiveSongService whose MIDI port is
    a pipe, as a keyboard's bytes would arrive: before each block, that
    block's bytes go into the pipe and the service's input thread parses
    them; the block renders once every message has reached the renderer.
    times: a list that receives each block's render seconds (the pull,
    fetch included); after_block(): called after each block. Returns the
    audio [blocks x block_frames, 2]."""
    import os
    import time

    from groove_tpu_torch.engine.livesong import LiveSongService

    r_fd, w_fd = os.pipe()
    reader = os.fdopen(r_fd, "rb", buffering=0)
    blocks: list = []
    svc = LiveSongService(renderer, midi_source=reader, sink=blocks.append)
    expect = 0
    try:
        for data, count in schedule:
            if data:
                os.write(w_fd, data)
                expect += count
                deadline = time.monotonic() + timeout
                while svc.events_handled < expect:
                    if time.monotonic() > deadline:
                        raise TimeoutError("MIDI bytes never reached the "
                                           "renderer")
                    time.sleep(0.0002)
            t0 = time.perf_counter()
            svc.pump(1)
            if times is not None:
                times.append(time.perf_counter() - t0)
            if after_block is not None:
                after_block()
    finally:
        os.close(w_fd)
        svc.stop()
    return np.concatenate(blocks)
