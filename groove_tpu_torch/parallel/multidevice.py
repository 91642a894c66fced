"""Multi-device render of an arbitrary compiled song (port of
groove_tpu/parallel/multidevice.py).

A song is a heterogeneous graph: each chain into the main mixer is a
different little program. The song is partitioned into independent
COMPONENTS (connected components over audio edges, aux sends and sidechain
control edges, the main mixer left out: a sidechain that observes one
chain and compresses another welds the two into one component); each
component renders as a sub-song of its own on its own Renderer, placed
round-robin over the devices; every component's render is dispatched
before any is waited on, and the partial mixes are summed on the first
device, from zeros, in component order.

Nonlinear effects (compressor, bitcrusher, limiter) live inside one
component and see their whole input there; only the final linear mix-bus
sum crosses devices, so the output equals the single-device Renderer up to
the reassociation of that sum (about 1e-6 of the peak).

The render of a component queues its kernels on its device without
waiting on the host (a card's component renders make no host
synchronisation that would hold the next device's dispatch back;
chip_smoke.py counts them), so on D cards the components render at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from groove_tpu_torch.compiler.song import MAIN_MIXER_UVID, CompiledSong
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.parallel import resolve_devices
from groove_tpu_torch.utils import profiling


def partition_components(c: CompiledSong) -> list[list[str]]:
    """Connected components of the device graph (audio edges + sends +
    sidechain), excluding the main mixer. Returns lists of uvids in the
    compiled topological order; components are ordered by their first
    source's position in the main mix (deterministic partial-mix sum
    order)."""
    parent: dict[str, str] = {}

    def find(a: str) -> str:
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: str, b: str) -> None:
        parent[find(a)] = find(b)

    for u in c.devices:
        if u != MAIN_MIXER_UVID:
            find(u)
    for sink, sources in c.sinks.items():
        for src in sources:
            if sink != MAIN_MIXER_UVID and src != MAIN_MIXER_UVID:
                union(sink, src)
    for src, aux, _ in c.sends:
        union(src, aux)
    for src, tgt, _ in c.sidechain:
        union(src, tgt)

    groups: dict[str, list[str]] = {}
    for u in c.order:
        if u == MAIN_MIXER_UVID or u not in c.devices:
            continue
        groups.setdefault(find(u), []).append(u)
    # deterministic order: by first appearance in the topological order
    return sorted(groups.values(), key=lambda g: c.order.index(g[0]))


def _sub_song(c: CompiledSong, comp: list[str]) -> CompiledSong:
    """A CompiledSong containing one component plus its own main mixer."""
    comp_set = set(comp)
    devices = {u: c.devices[u] for u in comp}
    devices[MAIN_MIXER_UVID] = c.devices[MAIN_MIXER_UVID]
    sinks = {
        sink: [s for s in sources if s in comp_set]
        for sink, sources in c.sinks.items()
        if sink in comp_set or sink == MAIN_MIXER_UVID
    }
    order = [u for u in c.order if u in comp_set or u == MAIN_MIXER_UVID]
    return dataclasses.replace(
        c,
        devices=devices,
        sinks=sinks,
        order=order,
        sidechain=[e for e in c.sidechain if e[0] in comp_set],
        sends=[e for e in c.sends if e[0] in comp_set],
    )


class MultiDeviceRenderer:
    """Concurrent per-component rendering across devices.

    devices: torch devices (repeats allowed); None takes every visible
    CUDA device and raises when there is none. assignments: one
    (component uvids, device, Renderer) per component."""

    def __init__(self, compiled: CompiledSong, devices=None):
        self.c = compiled
        self.devices = resolve_devices(devices)
        self.assignments = []
        for i, comp in enumerate(partition_components(compiled)):
            dev = self.devices[i % len(self.devices)]
            self.assignments.append(
                (comp, dev, Renderer(_sub_song(compiled, comp), device=dev)))

    def render_device(self) -> torch.Tensor:
        """Every component dispatched on its device, then the partial
        mixes summed on the first device from zeros, in component order:
        the mix [n, 2] there."""
        partials = [r.render_device() for _, _, r in self.assignments]
        d0 = self.devices[0]
        mix = torch.zeros((self.c.n_frames, 2), dtype=torch.float32,
                          device=d0)
        for p in partials:
            mix = mix + p.to(d0, non_blocking=True)
        return mix

    def render(self) -> np.ndarray:
        """Float render [n, 2] on the host."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.float32)
        return profiling.host_sync(self.render_device())

    def render_quantized(self) -> np.ndarray:
        """int16 render [n, 2], quantized on the first device (io.wav
        spec, bitwise the host quantization); the CLI's --wav
        --multidevice path."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.int16)
        return profiling.host_sync(quantize_16bit(self.render_device()))
