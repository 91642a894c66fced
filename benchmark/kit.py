"""The seeded synthetic 707 kit that stands in for the unmounted samples.

A frozen copy of groove_tpu_torch.testing.synth.write_assets with one
change: every sample's length is drawn from a generator of its own with
a fixed seed, and only the samples' content from the run's seed, so that
every seed asks the drum layer for the same work. The WAVs are 16-bit
stereo, written with the standard library; program and reference read
the same files.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

KIT_DIR = Path("samples") / "elphnt.io"
# the port's models/sampler.GM_707_MAP and ROUND_ROBINS, frozen
GM_707_MAP = {
    35: "Kick 1", 36: "Kick 2", 37: "Rim", 38: "Snare 1", 39: "Clap",
    40: "Snare 2", 41: "Tom 3", 42: "Hat Closed", 43: "Tom 3",
    44: "Hat Closed", 45: "Tom 2", 46: "Hat Open", 47: "Tom 2",
    48: "Tom 1", 49: "Crash", 50: "Tom 1", 51: "Ride", 52: "Crash",
    53: "Ride", 54: "Tambourine", 55: "Crash", 56: "Cowbell",
    57: "Crash", 59: "Ride",
}
ROUND_ROBINS = 4
LENGTH_SEED = 0


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


def _write(path: Path, x: np.ndarray, sample_rate: int) -> None:
    """[n, 2] float -> 16-bit stereo PCM (x 32767, truncated, saturated)."""
    q = np.clip(np.trunc(x.astype(np.float64) * 32767.0), -32768, 32767)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(q.astype("<i2").tobytes())


def write_kit(root, seed: int, kit: dict) -> Path:
    """Write the kit `kit` ({"name", "sample_rate", "max_seconds",
    "short_seconds"}) under `root`; returns `root`."""
    root = Path(root)
    rate = int(kit["sample_rate"])
    folder = root / KIT_DIR / kit["name"]
    folder.mkdir(parents=True, exist_ok=True)
    lengths = np.random.default_rng(LENGTH_SEED)
    rng = np.random.default_rng(seed % 2**64)
    for name in sorted(set(GM_707_MAP.values())):
        longest = kit["max_seconds"] if name in ("Crash", "Ride") \
            else min(kit["max_seconds"], kit["short_seconds"])
        for r in range(1, ROUND_ROBINS + 1):
            seconds = lengths.uniform(0.1, max(longest, 0.1))
            n = max(16, int(seconds * rate))
            _write(folder / f"{name} R{r}.wav", _burst(rng, name, n, rate),
                   rate)
    return root
