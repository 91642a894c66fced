"""render(project, assets): the plain reference's int16 [n, 2] render of
a song, in float64 NumPy, from the project dict and the kit's WAV files
alone.

It knows the devices and effects the benchmark's songs use, each from
its stated behaviour, and refuses any other:

- drumkit: GM notes to the kit's one-shots, four round robins cycled per
  key in time order, each played whole from its note's block at
  velocity / 127;
- gain (x * ceiling), limiter (sign(x) * clip(|x|, minimum, maximum)),
  toy (-x), bitcrusher (the 16-bit image trunc(|x| * 32767) with its
  `bits` low bits cleared, sign kept);
- compressor: above the threshold a level t + (e - t) * ratio. With
  attack and release 0 the level e is |x| and the sample itself is
  moved; otherwise e is a peak held at the release rate
  (p[n] = max(|x[n]|, r p[n-1]), r = exp(-1 / (release * rate))) then
  smoothed at the attack rate (e[n] = a e[n-1] + (1 - a) p[n]), and the
  sample is scaled by the level over e;
- delay: y[n] = x[n - d], d = round(seconds * rate) (held per block
  when automated);
- chorus: the mean of `voices` taps spaced delay / voices apart, tap 0
  dry (count and delay held per block when automated);
- reverb: four feedback combs (29.7, 37.1, 41.1, 43.7 ms, gain
  0.001^(d / (seconds * rate))), summed, then two all-passes (5.0 and
  1.7 ms, g = 0.7), times `attenuation`;
- filter-low-pass-24db: two bilinear sections of a fourth-order
  low-pass (s-domain 1 / (s^2 + b s / q + 1), b = 0.765367 and
  1.847759, prewarped at the cutoff);
- signal-passthrough-controller and mixers: their inputs' sum. A
  sidechain link sends the source's input, |mean of its two channels|
  at the last frame of each block, to the target's parameter for the
  next block (block 0 reads 0); delay seconds so driven are clipped to
  [0, 1].

Parameters follow a sidechain link first, then a trip, then the
configured value. Each device's input is the sum of every device cabled
into it, and the song is the main mixer's input, quantized as trunc(x *
32767) saturated to int16.

Values that decide a whole number (a delay in frames, a chorus's tap
count) are taken in float32, the precision the configurations state;
everything else is float64. round_to="bfloat16" is the control: every
device's output is stored in bfloat16, the step below that float32.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

from benchmark.reference import song as timeline

MAIN = "main-mixer"
I16 = 32767.0
GM_707 = {
    35: "Kick 1", 36: "Kick 2", 37: "Rim", 38: "Snare 1", 39: "Clap",
    40: "Snare 2", 41: "Tom 3", 42: "Hat Closed", 43: "Tom 3",
    44: "Hat Closed", 45: "Tom 2", 46: "Hat Open", 47: "Tom 2",
    48: "Tom 1", 49: "Crash", 50: "Tom 1", 51: "Ride", 52: "Crash",
    53: "Ride", 54: "Tambourine", 55: "Crash", 56: "Cowbell",
    57: "Crash", 59: "Ride",
}
ROUND_ROBINS = 4
COMBS_S = (0.0297, 0.0371, 0.0411, 0.0437)
ALLPASSES_S = (0.005, 0.0017)
ALLPASS_G = 0.7
LP24_B = (0.765367, 1.847759)
SIDECHAIN_SECONDS = 1.0


def bfloat16(x: np.ndarray) -> np.ndarray:
    """x stored in bfloat16 (round to nearest even), back as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def read_wav(path: Path) -> np.ndarray:
    """A 16-bit PCM WAV as float64 [2, n] in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: not 16-bit PCM")
        ch = w.getnchannels()
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    x = x.reshape(-1, ch).T.astype(np.float64) / 32768.0
    return np.vstack([x, x]) if ch == 1 else x[:2]


def hold(values, n: int) -> np.ndarray:
    """A block-rate curve held for each block's 64 frames -> [n]."""
    return np.repeat(np.asarray(values), timeline.BLOCK)[:n]


def round32(seconds, rate: int) -> np.ndarray:
    """round(seconds * rate) in float32, as whole frames."""
    s = np.asarray(seconds, np.float32)
    return np.round(s * np.float32(rate)).astype(np.int64)


def taps(x: np.ndarray, back: np.ndarray) -> np.ndarray:
    """y[:, i] = x[:, i - back[i]], zero before the start."""
    if np.all(back == back[0]):
        d = int(back[0])
        y = np.zeros_like(x)
        y[:, d:] = x[:, :x.shape[1] - d]
        return y
    i = np.arange(x.shape[1]) - back
    return np.where(i >= 0, x[:, np.maximum(i, 0)], 0.0)


def feedback_comb(x: np.ndarray, d: int, g) -> np.ndarray:
    """y[n] = x[n - d] + g[n] y[n - d]: d independent lanes, one step a
    block of d frames."""
    n = x.shape[1]
    nb = -(-n // d)
    xb = np.zeros((2, nb + 1, d))
    xb[:, 1:].reshape(2, -1)[:, :n] = x
    gb = np.zeros((nb, d))
    gb.reshape(-1)[:n] = np.broadcast_to(g, (n,))
    y = np.zeros((2, nb, d))
    prev = np.zeros((2, d))
    for b in range(nb):
        prev = xb[:, b] + gb[b] * prev
        y[:, b] = prev
    return y.reshape(2, -1)[:, :n]


def allpass(x: np.ndarray, d: int, g: float) -> np.ndarray:
    """(-g + z^-d) / (1 - g z^-d): w[n] = x[n] + g w[n - d],
    y[n] = -g x[n] + (1 - g^2) w[n - d]."""
    from scipy.signal import lfilter

    n = x.shape[1]
    nb = -(-n // d)
    xb = np.zeros((2, nb, d))
    xb.reshape(2, -1)[:, :n] = x
    w = lfilter([1.0], [1.0, -g], xb, axis=1)
    wd = np.zeros_like(w)
    wd[:, 1:] = w[:, :-1]
    return (-g * xb + (1.0 - g * g) * wd).reshape(2, -1)[:, :n]


def peak_hold(mag: np.ndarray, r: np.ndarray) -> np.ndarray:
    """p[n] = max(mag[n], r[n] p[n-1]) from 0, in closed form:
    log p[n] = L[n] + max over k <= n of (log mag[k] - L[k]), L the
    running sum of log r."""
    with np.errstate(divide="ignore"):
        lr = np.cumsum(np.log(np.broadcast_to(r, mag.shape)), axis=-1)
        lm = np.log(mag)
    return np.exp(lr + np.maximum.accumulate(lm - lr, axis=-1))


class Song:
    def __init__(self, project: dict, assets, sample_rate: int,
                 round_to=None):
        self.assets = Path(assets)
        self.rate = int(sample_rate)
        self.round_to = round_to
        self.clock = timeline.Clock(project, self.rate)
        self.notes, end = timeline.notes(project, self.clock)
        self.n = self.clock.length_frames(end)
        self.nb = -(-self.n // timeline.BLOCK)
        self.devices, self.role = {}, {}
        for d in project["devices"]:
            (role, (uvid, spec)), = d.items()
            (kind, params), = spec.items()
            if isinstance(params, list):
                merged = {}
                for part in params:
                    merged.update(part)
                params = merged
            self.devices[uvid] = (kind, params)
            self.role[uvid] = role
        self.devices.setdefault(MAIN, ("mixer", {}))
        self.sources = {}
        for chain in project.get("patch-cables", []):
            for a, b in zip(chain, chain[1:]):
                self.sources.setdefault(b, []).append(a)
        self.links = {}  # target uvid -> [(param, source uvid)]
        for c in project.get("controls", []):
            t = c["target"]
            self.links.setdefault(t["id"], []).append(
                (t["param"], c["source"]))
        self.curves = timeline.trips(project, self.clock, self.nb,
                                     self.configured)
        self.inputs, self.outputs = {}, {}

    def configured(self, uvid: str, param: str) -> float:
        return float(self.devices[uvid][1].get(param, 0.0))

    # ---- parameters -------------------------------------------------------

    def sidechain(self, source: str) -> np.ndarray:
        """The control value a link from `source` carries, per block."""
        self.output(source)
        last = self.inputs[source][:, timeline.BLOCK - 1::timeline.BLOCK]
        v = np.abs(np.mean(last, axis=0))
        return np.concatenate([[0.0], v[:-1]])[:self.nb]

    def block_param(self, uvid: str, name: str, default: float):
        """A parameter as a per-block array, or a float when static."""
        for param, source in self.links.get(uvid, []):
            if param == name:
                return self.sidechain(source)
        if (uvid, name) in self.curves:
            return self.curves[(uvid, name)].astype(np.float64)
        return float(self.devices[uvid][1].get(name, default))

    def param(self, uvid: str, name: str, default: float):
        """A parameter per frame (held per block), or a float."""
        v = self.block_param(uvid, name, default)
        return v if isinstance(v, float) else hold(v, self.n)

    # ---- devices ----------------------------------------------------------

    def output(self, uvid: str) -> np.ndarray:
        if uvid not in self.outputs:
            kind, params = self.devices[uvid]
            if self.role.get(uvid) == "instrument":
                y = self.instrument(uvid, kind, params)
            else:
                x = np.zeros((2, self.n))
                for s in self.sources.get(uvid, []):
                    x = x + self.output(s)
                self.inputs[uvid] = x
                y = self.effect(uvid, kind, params, x)
            if self.round_to == "bfloat16":
                y = bfloat16(y)
            self.outputs[uvid] = y
        return self.outputs[uvid]

    def instrument(self, uvid, kind, params) -> np.ndarray:
        if kind != "drumkit":
            raise NotImplementedError(f"reference: no instrument {kind}")
        folder = self.assets / "samples" / "elphnt.io" / params["name"]
        rows = {}
        for key, name in GM_707.items():
            rows[key] = [read_wav(folder / f"{name} R{r}.wav")
                         for r in range(1, ROUND_ROBINS + 1)
                         if (folder / f"{name} R{r}.wav").exists()]
        y = np.zeros((2, self.n))
        count = {}
        channel = int(params.get("midi-in", 0))
        for on, ch, key, vel in self.notes:
            if ch != channel or not rows.get(key):
                continue
            i = count.get(key, 0)
            count[key] = i + 1
            s = rows[key][i % len(rows[key])]
            m = min(s.shape[1], self.n - on)
            y[:, on:on + m] += s[:, :m] * (vel / 127.0)
        return y

    def effect(self, uvid, kind, params, x) -> np.ndarray:
        P = lambda name, default: self.param(uvid, name, default)  # noqa
        rate, n = self.rate, self.n
        if kind in ("mixer", "signal-passthrough-controller"):
            return x
        if kind == "gain":
            return x * P("ceiling", 1.0)
        if kind == "toy":
            return -x
        if kind == "limiter":
            return np.sign(x) * np.clip(np.abs(x), P("minimum", 0.0),
                                        P("maximum", 1.0))
        if kind == "bitcrusher":
            step = float(2 ** int(np.clip(np.floor(params.get("bits", 8)),
                                          0, 15)))
            image = np.trunc(np.abs(x) * I16)
            return np.sign(x) * np.trunc(image / step) * step / I16
        if kind == "compressor":
            return self.compressor(uvid, x)
        if kind == "delay":
            d = self.block_param(uvid, "delay", 0.0)
            if isinstance(d, float):
                return taps(x, np.full(n, int(round(d * rate))))
            if any(p == "delay" for p, _ in self.links.get(uvid, [])):
                d = np.clip(d, 0.0, SIDECHAIN_SECONDS)
            return taps(x, hold(round32(d, rate), n))
        if kind == "chorus":
            return self.chorus(uvid, params, x)
        if kind == "reverb":
            return self.reverb(uvid, x)
        if kind == "filter-low-pass-24db":
            return self.lp24(uvid, x)
        raise NotImplementedError(f"reference: no effect {kind}")

    def compressor(self, uvid, x) -> np.ndarray:
        thr = self.param(uvid, "threshold", 1.0)
        ratio = self.param(uvid, "ratio", 1.0)
        att = self.param(uvid, "attack", 0.0)
        rel = self.param(uvid, "release", 0.0)
        if isinstance(att, float) and isinstance(rel, float) \
                and att <= 0.0 and rel <= 0.0:
            mag = np.abs(x)
            return np.where(mag > thr,
                            np.sign(x) * (thr + (mag - thr) * ratio), x)
        from scipy.signal import lfilter

        def coef(seconds):
            return np.exp(-1.0 / (np.maximum(seconds, 1e-6) * self.rate))
        peak = peak_hold(np.abs(x), coef(rel))
        a = coef(att)
        if not isinstance(a, float):
            raise NotImplementedError("reference: an automated attack")
        env = lfilter([1.0 - a], [1.0, -a], peak, axis=-1)
        level = thr + (env - thr) * ratio
        return x * np.where(env > thr, level / np.maximum(env, 1e-9), 1.0)

    def chorus(self, uvid, params, x) -> np.ndarray:
        n, rate = self.n, self.rate
        d = self.block_param(uvid, "delay-seconds", 0.0)
        v = self.block_param(uvid, "voices", 1.0)
        if isinstance(d, float) and isinstance(v, float):
            voices = max(1, int(params.get("voices", 1)))
            total = int(round(d * rate))
            wet = sum(taps(x, np.full(n, k * total // voices))
                      for k in range(voices))
            wet = wet / voices
        else:
            if any(p in ("delay-seconds", "voices")
                   for p, _ in self.links.get(uvid, [])):
                raise NotImplementedError("reference: a sidechained chorus")
            total = hold(round32(np.broadcast_to(d, (self.nb,)), rate), n)
            if isinstance(v, float):
                top = max(1, int(params.get("voices", 1)))
                count = np.full(n, top)
            else:
                top = max(1, int(round(float(np.max(v)))))
                count = hold(np.clip(np.round(np.asarray(v, np.float32)),
                                     1, top).astype(np.int64), n)
            wet = np.zeros_like(x)
            for k in range(top):
                wet = wet + np.where(k < count, taps(x, k * total // count),
                                     0.0)
            wet = wet / count
        mix = self.param(uvid, "wet-dry-mix", 1.0)
        return x * (1.0 - mix) + wet * mix

    def reverb(self, uvid, x) -> np.ndarray:
        rate = self.rate
        seconds = self.param(uvid, "seconds", 0.0)
        y = np.zeros_like(x)
        for c in COMBS_S:
            d = max(1, int(round(c * rate)))
            if isinstance(seconds, float):
                g = 0.001 ** (d / (seconds * rate)) if seconds > 0 else 0.0
            else:
                s = seconds.astype(np.float64)
                with np.errstate(divide="ignore"):
                    g = np.where(s > 0, np.exp(np.log(0.001) * d
                                               / (s * rate)), 0.0)
            y = y + feedback_comb(x, d, g)
        for c in ALLPASSES_S:
            y = allpass(y, max(1, int(round(c * rate))), ALLPASS_G)
        return self.param(uvid, "attenuation", 1.0) * y

    def lp24(self, uvid, x) -> np.ndarray:
        from scipy.signal import sosfilt

        cutoff = self.block_param(uvid, "cutoff", 1000.0)
        q = self.block_param(uvid, "passband-ripple", 0.707)
        if not (isinstance(cutoff, float) and isinstance(q, float)):
            raise NotImplementedError("reference: an automated lp24")
        q = max(q, 1e-3)
        fs = float(self.rate)
        wp = 2.0 * fs * np.tan(np.pi * cutoff / fs)
        gain, sos = 1.0, []
        for b in LP24_B:
            # s^2 / wp^2 + (b / q) s / wp + 1 through s = 2 fs (z-1)/(z+1)
            c2, c1 = 4.0 * fs * fs / (wp * wp), 2.0 * fs * b / (q * wp)
            a0 = c2 + c1 + 1.0
            gain /= a0
            sos.append([1.0, 2.0, 1.0, 1.0, (2.0 - 2.0 * c2) / a0,
                        (c2 - c1 + 1.0) / a0])
        return sosfilt(np.asarray(sos), x * gain, axis=-1)


def render(project: dict, assets, sample_rate: int = 44100,
           round_to=None) -> np.ndarray:
    """The song as int16 [n, 2]; round_to="bfloat16" for the control."""
    s = Song(project, assets, sample_rate, round_to)
    y = s.output(MAIN)
    return np.clip(np.trunc(y * I16), -32768, 32767).astype(np.int16).T
