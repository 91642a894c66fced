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
1 -> 20 kHz), then the main mixer."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from groove_tpu.io.wav import write_wav_16bit_stereo
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
                 max_seconds: float = 1.5) -> Path:
    """Write the synthetic 707 kit under `root`; returns `root`."""
    root = Path(root)
    kit = root / KIT_DIR
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


def write_project(path, project: dict) -> Path:
    path = Path(path)
    path.write_text(json.dumps(project, indent=1))
    return path
