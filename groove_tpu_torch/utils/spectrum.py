"""Reusable spectrum analysis for debugging patches and filters.

The reference declares `spectrum-analyzer = "1.2"` and a plotters-based
`visualization` feature (Cargo.toml:41,37,71) as its debugging surface for
exactly this purpose — inspecting what a patch or filter actually does in
the frequency domain. No call site survives at reference HEAD, so this
module is a RECONSTRUCTION of that intent: a small, calibrated analysis
API plus a terminal renderer (the image has no GUI toolkit, so the
plotters analog draws in ASCII).

Calibration: `analyze` windows with Hann and divides by the window's
coherent gain, so a full-scale sine (amplitude 1.0) at a bin center reads
0 dBFS regardless of FFT length. Tests pin this (tests/test_spectrum.py).

Usage (library):
    sp = analyze(samples, sample_rate)       # samples [n] or [2, n]
    sp.peak()              -> (freq_hz, db)
    sp.peaks(5)            -> five strongest local maxima, descending
    sp.level_at(440.0)     -> dBFS near a frequency
    sp.band_db(200, 2000)  -> total energy in a band, dBFS
    print(sp.ascii(width=72, height=16))

Usage (CLI):
    python -m groove_tpu_torch.utils.spectrum out.wav
    python -m groove_tpu_torch.utils.spectrum project.json [--device UVID]
        [--on cuda|cpu]

(This is the port of groove_tpu/utils/spectrum.py: Spectrum and analyze
are copies; _render_project renders on the port's Renderer, on the
torch device --on names, and main takes --on; the reference's --device
names an instrument, so the torch device takes another flag.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Spectrum", "analyze", "main"]


@dataclass
class Spectrum:
    """Magnitude spectrum in dBFS (0 dBFS == full-scale sine)."""

    freqs: np.ndarray  # [k] bin centers, Hz
    db: np.ndarray     # [k] magnitude, dBFS
    sample_rate: int

    FLOOR = -200.0

    def peak(self) -> tuple[float, float]:
        i = int(np.argmax(self.db))
        return float(self.freqs[i]), float(self.db[i])

    def peaks(self, n: int = 5, min_separation_hz: float = 0.0):
        """The `n` strongest local maxima, strongest first. Peaks closer
        than `min_separation_hz` — or one semitone (~6%), whichever is
        wider — to an already-selected peak are skipped, so a long FFT's
        mainlobe ripple doesn't list as several peaks."""
        if min_separation_hz <= 0.0:
            min_separation_hz = 2.0 * float(self.freqs[1] - self.freqs[0])
        d = self.db
        interior = (d[1:-1] >= d[:-2]) & (d[1:-1] >= d[2:])
        idx = np.flatnonzero(interior) + 1
        idx = idx[np.argsort(d[idx])[::-1]]
        out: list[tuple[float, float]] = []
        for i in idx:
            f = float(self.freqs[i])
            if any(abs(f - f0) < max(min_separation_hz, 0.0595 * f0)
                   for f0, _ in out):
                continue
            out.append((f, float(d[i])))
            if len(out) == n:
                break
        return out

    def level_at(self, hz: float, width_bins: int = 2) -> float:
        """Max dBFS within ±width_bins of the bin nearest `hz` (tolerant
        of scalloping when the tone is off-center)."""
        i = int(np.argmin(np.abs(self.freqs - hz)))
        lo, hi = max(i - width_bins, 0), min(i + width_bins + 1, len(self.db))
        return float(np.max(self.db[lo:hi]))

    def band_db(self, f_lo: float, f_hi: float) -> float:
        """Total (power-summed) level of all bins in [f_lo, f_hi], dBFS."""
        m = (self.freqs >= f_lo) & (self.freqs <= f_hi)
        if not m.any():
            return self.FLOOR
        # Hann ENBW = 1.5 bins: dividing the power sum by it makes a single
        # in-band tone read its own dBFS instead of +1.76 (mainlobe spread)
        p = np.sum(10.0 ** (self.db[m] / 10.0)) / 1.5
        return float(10.0 * np.log10(max(p, 1e-30)))

    def columns(self, width: int, f_lo: float = 20.0,
                f_hi: float | None = None):
        """Max dBFS per log-spaced frequency span — the shared binning
        for the terminal plot (ascii) and the web GUI's canvas analyzer
        (gui/web.spectrum). Empty columns carry the previous value
        (narrow low-freq spans). Returns (cols [width], f_lo, f_hi)."""
        f_hi = f_hi or self.sample_rate / 2.0
        f_lo = max(f_lo, float(self.freqs[1]))
        edges = np.exp(np.linspace(math.log(f_lo), math.log(f_hi), width + 1))
        cols = np.full(width, self.FLOOR)
        for c in range(width):
            m = (self.freqs >= edges[c]) & (self.freqs < edges[c + 1])
            if m.any():
                cols[c] = np.max(self.db[m])
        for c in range(1, width):
            if cols[c] == self.FLOOR:
                cols[c] = cols[c - 1]
        return cols, f_lo, f_hi

    def ascii(self, width: int = 72, height: int = 16,
              f_lo: float = 20.0, f_hi: float | None = None,
              db_lo: float = -96.0, db_hi: float = 6.0) -> str:
        """Log-frequency bar chart in terminal characters (the plotters
        analog). Each column is the max of its log-spaced frequency span."""
        cols, f_lo, f_hi = self.columns(width, f_lo, f_hi)
        rows = []
        span = db_hi - db_lo
        for r in range(height):
            thresh = db_hi - span * (r + 0.5) / height
            line = "".join("#" if v >= thresh else " " for v in cols)
            label = f"{db_hi - span * r / height:6.0f}|" if r % 4 == 0 else "      |"
            rows.append(label + line)
        ticks = [20, 100, 1000, 10000]
        axis = [" "] * width
        for t in ticks:
            if f_lo <= t <= f_hi:
                c = int(round((math.log(t) - math.log(f_lo))
                              / (math.log(f_hi) - math.log(f_lo)) * (width - 1)))
                lab = f"{t//1000}k" if t >= 1000 else str(t)
                for j, ch in enumerate(lab):
                    if c + j < width:
                        axis[c + j] = ch
        rows.append("      +" + "-" * width)
        rows.append("  dBFS " + "".join(axis) + " Hz")
        return "\n".join(rows)


def analyze(samples, sample_rate: int, nfft: int | None = None) -> Spectrum:
    """Hann-windowed magnitude spectrum of mono or stereo audio, calibrated
    so a full-scale bin-centered sine reads 0 dBFS. Stereo ([2, n] or
    [n, 2]) is averaged to mono first."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 2:
        x = x.mean(axis=0 if x.shape[0] <= 2 else 1)
    n = len(x) if nfft is None else min(nfft, len(x))
    x = x[:n]
    w = np.hanning(n)
    spec = np.fft.rfft(x * w)
    # amplitude of a sine: |X| * 2 / sum(w); power floor keeps log finite
    amp = np.abs(spec) * 2.0 / np.sum(w)
    db = 20.0 * np.log10(np.maximum(amp, 1e-10))
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    return Spectrum(freqs=freqs, db=np.maximum(db, Spectrum.FLOOR),
                    sample_rate=sample_rate)


def _render_project(path: str, device: str | None, on: str = "cuda"):
    from groove_tpu_torch.compiler.song import compile_midi_file, \
        compile_song
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.project.schema import SongSettings

    if on.startswith("cuda"):
        from groove_tpu_torch import require_cuda
        require_cuda()
    if path.endswith((".mid", ".midi")):
        compiled = compile_midi_file(path)
    else:
        compiled = compile_song(SongSettings.from_project_file(path))
    r = Renderer(compiled, on)
    if device is None:
        return np.asarray(r.render()).T, compiled.sample_rate  # [2, n]
    dev = compiled.devices.get(device)
    if dev is None or dev.role != "instrument":
        known = [u for u, d in compiled.devices.items()
                 if d.role == "instrument"]
        raise SystemExit(f"--device must name an instrument; got {device!r} "
                         f"(instruments: {', '.join(known)})")
    audio = r._render_instrument(r.inputs, dev, compiled.n_frames)
    return audio.cpu().numpy(), compiled.sample_rate


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Spectrum of a WAV file or a rendered project "
                    "(debugging aid for patches and filters).")
    ap.add_argument("input", help="WAV file, project JSON/JSON5, or SMF")
    ap.add_argument("--device", default=None,
                    help="render only this device uvid (projects only)")
    ap.add_argument("--on", default="cuda",
                    help="torch device a project renders on (default: cuda)")
    ap.add_argument("--peaks", type=int, default=5)
    ap.add_argument("--width", type=int, default=72)
    ap.add_argument("--height", type=int, default=16)
    ap.add_argument("--band", nargs=2, type=float, metavar=("LO", "HI"),
                    help="also print total level in [LO, HI] Hz")
    args = ap.parse_args(argv)

    if args.input.lower().endswith(".wav"):
        from groove_tpu_torch.io.wav import read_wav
        samples, rate = read_wav(args.input)
        samples = np.asarray(samples)
        if samples.ndim == 2 and samples.shape[1] == 2:
            samples = samples.T
    else:
        samples, rate = _render_project(args.input, args.device, args.on)

    sp = analyze(samples, rate)
    print(sp.ascii(width=args.width, height=args.height))
    print()
    for f, d in sp.peaks(args.peaks):
        print(f"  peak {f:9.1f} Hz  {d:7.1f} dBFS")
    if args.band:
        print(f"  band {args.band[0]:.0f}-{args.band[1]:.0f} Hz: "
              f"{sp.band_db(*args.band):.1f} dBFS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
