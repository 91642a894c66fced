"""The port's drum accumulation (groove_tpu_torch/ops/drums.py, kernel K1)
against the reference's Pallas kernel run through the interpreter on the
CPU, on the hit layouts of tests/test_pallas_drums.py (chunk-edge
crossings included) with varied velocities.

Both sum, per frame and in hit-layout order, acc + row * (vel / 127),
and both divide by 127 (no reciprocal rewrite was seen). Where hits
overlap, XLA's CPU code for the interpreted kernel contracts part of the
multiply-adds, so the sums differ by rounding: measured at most 2.4e-7
(2 ulp at full scale) on the "stacked" layout, 1.2e-7 on "single-chunk",
bitwise on the others; the bar is 4.8e-7. The twin keeps the reference's
two roundings per hit, and the CUDA kernel is held to the twin bit for
bit on a card by tests/test_torch_cuda.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.models import sampler as jsampler
from groove_tpu.ops import pallas_drums as pd
from groove_tpu_torch.models import sampler as tsampler
from groove_tpu_torch.ops import drums

CHUNK = pd.CHUNK


def _table():
    r = np.random.default_rng(11)
    data = (r.standard_normal((4, 2, 700)) * 0.5).astype(np.float32)
    lengths = np.array([700, 650, 300, 120], np.int64)
    for s, ln in enumerate(lengths):
        data[s, :, ln:] = 0.0
    return data, lengths


LAYOUTS = {
    "single-chunk": (
        [0, 1, 2, 3, -1, 0], [0, 128, 192, 1024, 2048, 4096], 8192),
    "chunk-edges": (
        [0, 1, 0, 1, 2, 3, 2, 0],
        [CHUNK - 256, CHUNK - 64, 2 * CHUNK - 128, 3 * CHUNK - 192,
         512, CHUNK + 960, 2 * CHUNK + 64, 3 * CHUNK + 4096],
        CHUNK * 3 + 5000),
    "past-end": ([0, 1], [128, 8192], 4096),
    "stacked": ([0, 1, 2, 3, 0, 1, 2, 3, 0],
                [0, 0, 64, 64, 64, 128, 128, 640, 704], 2048),
}


def _prepared(name):
    data, lengths = _table()
    slots, on, n = LAYOUTS[name]
    slots = np.asarray(slots, np.int32)
    on = np.asarray(on, np.int64)
    vels = np.random.default_rng(len(on)).integers(
        1, 128, len(on)).astype(np.float32)
    gate = np.full(len(slots), 2**30, np.int64)
    ptable = pd.prepare_table(data)
    meta = pd.prepare_hits(slots, on, gate, vels, lengths, n)
    return data, lengths, slots, on, gate, vels, ptable, meta, n


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_twin_matches_interpreted_kernel(name):
    _, _, _, _, _, _, ptable, meta, n = _prepared(name)
    y_jax = np.asarray(pd.accumulate_oneshots_pallas(
        jnp.asarray(ptable), *[jnp.asarray(m) for m in meta], n_frames=n,
        interpret=True))
    y = drums.accumulate_hits(torch.from_numpy(ptable),
                              *[torch.from_numpy(m) for m in meta],
                              n_frames=n)
    assert y.shape == (2, n) and y.dtype == torch.float32
    assert np.max(np.abs(y.numpy() - y_jax)) <= 4.8e-7


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_host_layout_matches(name):
    data, lengths, slots, on, gate, vels, ptable, meta, n = _prepared(name)
    assert np.array_equal(drums.prepare_table(data), ptable)
    for a, b in zip(drums.prepare_hits(slots, on, gate, vels, lengths, n),
                    meta):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_accumulate_oneshots_matches(name):
    """models/sampler.accumulate_oneshots (the plain timeline sum) against
    the reference's XLA version, bit for bit."""
    data, lengths, slots, on, gate, vels, _, _, n = _prepared(name)
    y_jax = np.asarray(jsampler.accumulate_oneshots(
        jnp.asarray(data), jnp.asarray(lengths), slots, on, gate, vels, n))
    y = tsampler.accumulate_oneshots(torch.from_numpy(data),
                                     torch.from_numpy(lengths), slots, on,
                                     gate, vels, n)
    assert np.array_equal(y.numpy(), y_jax)


def test_unaligned_hit_is_refused():
    data, lengths = _table()
    with pytest.raises(ValueError):
        drums.prepare_hits(np.zeros(1, np.int32), np.array([100]),
                           np.array([2**30]), np.array([127.0]), lengths,
                           4096)
