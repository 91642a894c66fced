"""Rendering across several torch devices (port of groove_tpu/parallel/).

groove_tpu maps its parallelism onto a jax device mesh; here a device list
takes the mesh's place, and the collectives become copies between devices:
  - multidevice.py  one song's independent components (connected parts of
                    its device graph), one Renderer each, round-robin over
                    the devices, the partial mixes summed on the first;
  - meshrender.py   one song's timeline cut into one shard a device, each a
                    StreamingRenderer segment, the carried states relaxed
                    across the shard seams in Jacobi rounds;
  - timeshard.py    one biquad section over a timeline cut into shards,
                    composed exactly from each shard's transition;
  - mesh.py         a track-sharded Welsh mix, and songs rendered one a
                    device.

Every entry point takes `devices`; without it, every visible CUDA device
(resolve_devices), and with none visible it raises rather than fall back
to the CPU. A device may appear several times: logical shards on one card
(or on the CPU, as the tests run them).
"""

from __future__ import annotations

import torch


def resolve_devices(devices=None) -> list[torch.device]:
    """`devices` as torch devices; None: every visible CUDA device.
    Raises when there is none."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("groove_tpu_torch.parallel: an empty device "
                             "list")
        return out
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("groove_tpu_torch.parallel: no CUDA device is "
                           "visible; pass devices=[...] to run elsewhere")
    return [torch.device(f"cuda:{i}") for i in range(count)]
