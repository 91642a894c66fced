"""The port's int16 quantizer (groove_tpu_torch/io/wav.quantize_16bit)
bit for bit against the reference's host spec (groove_tpu.io.wav.
_chunk_to_i2: trunc(f64(x) * 32767), saturated) and its device quantizer
(quantize_16bit_device), on edge values: ±1, ±k/32767 and their float32
neighbours, the finite saturation range, zeros and subnormals."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from groove_tpu.io import wav as jwav
from groove_tpu_torch.io.wav import quantize_16bit


def _edge_values() -> np.ndarray:
    k = np.array([0, 1, 2, 3, 100, 12345, 16383, 16384, 32766, 32767],
                 np.float64)
    base = np.concatenate([k / 32767.0, k / 32768.0, [1.0, 1.5, 2.0, 1e30,
                                                      np.finfo(np.float32)
                                                      .max]]).astype(
        np.float32)
    with np.errstate(over="ignore"):
        up = np.nextafter(base, np.float32(np.inf))
    vals = [base, up, np.nextafter(base, np.float32(-np.inf)),
            np.array([0.0, -0.0, 1e-45, 1e-40, 1e-38], np.float32)]
    v = np.concatenate(vals)
    v = v[np.isfinite(v)]
    return np.concatenate([v, -v]).astype(np.float32)


def _random_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.uniform(-1.2, 1.2, 100_000)).astype(np.float32)


@pytest.mark.parametrize("make", [_edge_values, _random_values],
                         ids=["edges", "random"])
def test_quantize_matches_host_spec(make):
    v = make()
    x = np.stack([v, v[::-1]], axis=-1)  # [n, 2]
    got = quantize_16bit(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int16
    assert np.array_equal(got, jwav._chunk_to_i2(x))


@pytest.mark.parametrize("make", [_edge_values, _random_values],
                         ids=["edges", "random"])
def test_quantize_matches_reference_device_quantizer(make):
    v = make()
    got = quantize_16bit(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, np.asarray(jwav.quantize_16bit_device(v)))
