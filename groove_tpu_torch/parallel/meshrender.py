"""Single-song timeline sharding over devices (port of
groove_tpu/parallel/meshrender.py).

One song's whole render, cut along its timeline into one shard a device.
Two facts make it work:

  1. The segment step (engine/stream.StreamingRenderer.step) renders any
     segment of the song from an explicit entry state, and its float
     schedule is the same at every segmentation, so "one device a
     contiguous shard" is d streaming segments rendered side by side.
     A note overlapping a shard renders its window inside the shard, as
     the streamed render does.

  2. Every carried effect state forgets: biquad poles decay |p|^n,
     feedback combs g^(n/D), compressor followers e^(-n/tau), and delay
     and chorus lines remember exactly their length. So the dependence
     across a seam resolves by RELAXATION: round 0 renders every shard
     from a zero entry state; each further round hands every shard's exit
     state one shard to the right and renders again. These are Jacobi
     rounds, as groove_tpu's lax.ppermute makes them: round r + 1's entry
     of shard k + 1 is round r's exit of shard k, and shard 0 starts from
     zeros in every round. After K further rounds a shard is exact up to
     contributions older than K whole shards.

The exit state moves to the next shard's device with .to(device), the
counterpart of ppermute; the step advances its state in place, so every
shard of every round steps on a copy of its own. Shards past the song's
end render silence (their state never flows left). Cost: (K + 1) renders
of the song spread over d devices.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from groove_tpu_torch.compiler.song import CompiledSong
from groove_tpu_torch.engine.stream import BLOCK, StreamingRenderer
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.parallel import resolve_devices
from groove_tpu_torch.utils import profiling


def effect_memory_seconds(compiled: CompiledSong) -> float:
    """Upper bound on how long any carried effect state remembers its
    input, to a −100 dBFS contribution: delay/chorus lines remember
    exactly their length; a feedback comb decays 60 dB per RT60 (so
    5/3·RT60 reaches −100 dB); a smoothed follower forgets e^(−t/release)
    (11.5·release for 1e−5); biquad poles — 1.9 s generously covers the
    deepest reachable corpus pole (25 Hz q 5.33: |p| ≈ 1−3.3e−4,
    ln(1e−5)/ln|p| ≈ 0.79 s).

    A time-driven param is bounded by its MAXIMUM over every source the
    engines honor, mirroring StreamingRenderer._init_state's tail sizing:
    the static value, a trip/LFO automation curve's host maximum, and —
    for signal-passthrough (sidechain) links, whose runtime value has no
    compile-time maximum — the engine-wide SIDECHAIN_SECONDS_MAX clamp
    the dispatch sites apply."""
    from groove_tpu_torch.engine.render import SIDECHAIN_SECONDS_MAX

    sc_targets = {(t, p) for _, t, p in compiled.sidechain}

    def pmax(dev, name) -> float:
        v = float(dev.params.get(name, 0.0))
        if name in dev.automation:
            curve = np.asarray(dev.automation[name])
            if curve.size:
                v = max(v, float(np.max(curve)))
        if (dev.uvid, name) in sc_targets:
            v = max(v, SIDECHAIN_SECONDS_MAX)
        return v

    mem = 0.0
    for dev in compiled.devices.values():
        k = dev.kind
        if k == "delay":
            mem = max(mem, pmax(dev, "delay"))
        elif k == "chorus":
            mem = max(mem, pmax(dev, "delay-seconds"))
        elif k == "reverb":
            mem = max(mem, 5.0 / 3.0 * pmax(dev, "seconds") + 0.05)
        elif k == "compressor":
            mem = max(mem, 11.5 * max(pmax(dev, "release"),
                                      pmax(dev, "attack")))
        elif k.startswith("filter-"):
            mem = max(mem, 1.9)
    return mem


def _replica(stream: StreamingRenderer, device) -> StreamingRenderer:
    """`stream` on another device: its host collection shared, its
    device inputs and noise keys copied there."""
    r = copy.copy(stream)
    r.device = torch.device(device)
    r.inputs = {k: v.to(r.device) for k, v in stream.inputs.items()}
    r._noise_keys = {key: {w: v.to(r.device) for w, v in keys.items()}
                     for key, keys in stream._noise_keys.items()}
    return r


class MeshRenderer:
    """Renders one compiled song with its timeline sharded over devices.

    devices: torch devices, one shard each (repeats allowed: logical
    shards on one device); None takes every visible CUDA device and
    raises when there is none. iterations: relaxation rounds after the
    zero-state round; each extends exactness one whole shard of effect
    memory back. None derives it from the song's effect memory:
    ceil(memory / shard seconds), clamped to [1, 8]."""

    def __init__(self, compiled: CompiledSong, devices=None,
                 iterations: int | None = None):
        self.c = compiled
        self.devices = resolve_devices(devices)
        d = len(self.devices)
        self.n_devices = d
        # shard length: the plan split into d equal 64-frame-multiple spans
        shard = -(-compiled.n_frames // (d * BLOCK)) * BLOCK
        self.S = max(BLOCK, shard)
        if iterations is None:
            mem_frames = int(effect_memory_seconds(compiled)
                             * compiled.sample_rate)
            iterations = min(8, max(1, -(-mem_frames // self.S)))
        self.iterations = int(iterations)
        # one streaming renderer a distinct device; the host collection
        # runs once
        self.stream = StreamingRenderer(compiled, self.devices[0],
                                        segment_frames=self.S)
        self.streams = {self.devices[0]: self.stream}
        for dev in self.devices[1:]:
            if dev not in self.streams:
                self.streams[dev] = _replica(self.stream, dev)
        self._xs = None

    def _shard_xs(self, k: int) -> dict:
        """Shard k's segment inputs on its device; past the plan's end
        the oscillator tracks' empty slices are zeros."""
        xs = self.streams[self.devices[k]]._seg_xs(k * self.S, self.S)
        for key, v in xs.items():
            if key.endswith("/osc") and v.shape[0] < self.S:
                xs[key] = torch.nn.functional.pad(v, (0, self.S - v.shape[0]))
        return xs

    def render_device(self) -> torch.Tensor:
        """The (iterations + 1) Jacobi rounds over the d shards; the
        song [n, 2] on the first device."""
        d, S = self.n_devices, self.S
        if self._xs is None:
            self._xs = [self._shard_xs(k) for k in range(d)]
        entry: list = [None] * d  # None: the zero state
        audio: list = [None] * d
        for _ in range(self.iterations + 1):
            exits = []
            for k, dev in enumerate(self.devices):
                s = self.streams[dev]
                state = s.init_state() if entry[k] is None else entry[k]
                audio[k] = s.step(state, self._xs[k], S)
                exits.append(state)
            # one shard to the right, each a copy of its own on its device
            entry = [None] + [
                {key: v.to(self.devices[k + 1], copy=True)
                 for key, v in exits[k].items()} for k in range(d - 1)]
        d0 = self.devices[0]
        return torch.cat([a.to(d0) for a in audio])[: self.c.n_frames]

    def render(self) -> np.ndarray:
        """Float render [n, 2] on the host."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.float32)
        return profiling.host_sync(self.render_device())

    def render_quantized(self) -> np.ndarray:
        """int16 render [n, 2], quantized on the first device (io.wav
        spec, bitwise the host quantization)."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.int16)
        return profiling.host_sync(quantize_16bit(self.render_device()))
