"""Track-sharded rendering over devices (port of
groove_tpu/parallel/mesh.py).

The mix bus is a sum over track outputs, which groove_tpu maps onto a
psum over a 'tracks' mesh axis. Here each device renders its shard of
tracks (their Welsh notes in one batch through the voice kernels, each
track's effect a static low-pass on the biquad kernel) and sums them;
the shard sums are then added on the first device in shard order, the
counterpart of the psum. Also: independent songs rendered one a device.
"""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.models import welsh as welsh_model
from groove_tpu_torch.models.voices import row_sum, scatter_notes
from groove_tpu_torch.ops import iir
from groove_tpu_torch.parallel import resolve_devices
from groove_tpu_torch.utils import profiling


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first n_devices visible CUDA devices (all of them by
    default): the device list the other entry points take."""
    devs = resolve_devices()
    return devs[: n_devices or len(devs)]


def sharded_welsh_mix_step(voice_params, n_frames: int, span: int,
                           sample_rate: float, devices=None):
    """A render step over tracks sharded across `devices`.

    step(keys, vels, gates, ons, gains): keys/vels/gates/ons [n_tracks,
    notes_per_track], gains [n_tracks], n_tracks a multiple of the device
    count. Returns the master mix [2, n_frames] on the first device: each
    shard renders its tracks' notes (welsh.render_notes), scatters each
    track's notes into its timeline, applies the 8 kHz static low-pass
    (iir.biquad_best), times the track's gain, and sums its tracks in
    order; the shard sums add on the first device in shard order."""
    devices = resolve_devices(devices)
    coefs = iir.rbj_low_pass(8000.0, 0.707, sample_rate)

    def step(keys, vels, gates, ons, gains) -> torch.Tensor:
        keys, vels, gates, ons = (np.asarray(a) for a in (keys, vels, gates,
                                                          ons))
        gains = np.asarray(gains, np.float32)
        n_tracks, notes = keys.shape
        d = len(devices)
        if n_tracks % d:
            raise ValueError(f"{n_tracks} tracks do not shard over {d} "
                             "devices")
        per = n_tracks // d
        shard_sums = []
        for k, dev in enumerate(devices):
            t = slice(k * per, (k + 1) * per)

            def rows(a, dt):
                return torch.from_numpy(np.ascontiguousarray(
                    a[t].reshape(-1)).astype(dt)).to(dev)

            # every track's notes in one batch, each note keyed by its
            # index within its track
            ids = torch.arange(notes, device=dev).repeat(per)
            mono = welsh_model.render_notes(
                voice_params, rows(keys, np.int32), rows(vels, np.float32),
                rows(gates, np.int32), span, sample_rate, note_ids=ids)
            tracks = torch.stack([
                scatter_notes(mono[i * notes:(i + 1) * notes], ons[t][i],
                              n_frames) for i in range(per)])
            tracks = iir.biquad_best(tracks, coefs)
            g = torch.from_numpy(gains[t]).to(dev)
            shard_sums.append(row_sum(
                torch.stack([tracks, tracks], dim=1) * g[:, None, None]))
        d0 = devices[0]
        mix = shard_sums[0].to(d0)
        for p in shard_sums[1:]:
            mix = mix + p.to(d0)
        return mix

    return step


def render_songs_data_parallel(songs, devices=None) -> list[np.ndarray]:
    """Render independent compiled songs one a device (round-robin):
    every song's render dispatched before any is fetched. Returns each
    song's float [n, 2] on the host."""
    devices = resolve_devices(devices)
    renders = [Renderer(song, device=devices[i % len(devices)])
               .render_device() for i, song in enumerate(songs)]
    return [profiling.host_sync(r) for r in renders]
