"""The plain reference's closed forms against the per-sample loops they
stand for, and its timeline against a brute-force count of units."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from benchmark.reference import render as ref
from benchmark.reference import song as timeline

RNG = np.random.default_rng(7)


def test_peak_hold_is_the_max_decay_recurrence():
    mag = np.abs(RNG.standard_normal((2, 3000))) * (RNG.random((2, 3000))
                                                    > 0.7)
    for r in (0.999, np.repeat(RNG.uniform(0.9, 0.9999, 3000 // 64 + 1),
                               64)[:3000]):
        rr = np.broadcast_to(r, (3000,))
        want, p = np.zeros_like(mag), np.zeros(2)
        for n in range(3000):
            p = np.maximum(mag[:, n], rr[n] * p)
            want[:, n] = p
        np.testing.assert_allclose(ref.peak_hold(mag, r), want, rtol=1e-9,
                                   atol=1e-300)


@pytest.mark.parametrize("d", [1, 7, 64])
def test_feedback_comb_and_allpass_are_their_recurrences(d):
    x = RNG.standard_normal((2, 1000))
    g = RNG.uniform(0.5, 0.95, 1000)
    y, w = np.zeros_like(x), np.zeros_like(x)
    for n in range(1000):
        if n >= d:
            y[:, n] = x[:, n - d] + g[n] * y[:, n - d]
    np.testing.assert_allclose(ref.feedback_comb(x, d, g), y, atol=1e-12)
    ap = np.zeros_like(x)
    for n in range(1000):
        w[:, n] = x[:, n] + (0.7 * w[:, n - d] if n >= d else 0.0)
        ap[:, n] = -0.7 * x[:, n] + (0.51 * w[:, n - d] if n >= d else 0.0)
    np.testing.assert_allclose(ref.allpass(x, d, 0.7), ap, atol=1e-12)


def test_taps_read_back_and_zero_before_the_start():
    x = RNG.standard_normal((2, 500))
    for back in (np.full(500, 37), RNG.integers(0, 60, 500)):
        want = np.array([[x[c, i - b] if i >= b else 0.0
                          for i, b in enumerate(back)] for c in range(2)])
        np.testing.assert_array_equal(ref.taps(x, back), want)


def test_bfloat16_rounds_as_torch_does():
    x = RNG.standard_normal(10000) * 10.0 ** RNG.integers(-6, 3, 10000)
    want = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(ref.bfloat16(x),
                                  want.to(torch.float64).numpy())


@pytest.mark.parametrize("bpm", [120.0, 128.0, 1024.0, 97.3])
def test_blocks_and_length_against_counted_units(bpm):
    clock = timeline.Clock({"clock": {"bpm": bpm}}, 44100)

    def units(f):
        return int(Fraction(bpm).limit_denominator(10**12) * f * 65536
                   / (60 * 44100))
    for beats in (Fraction(0), Fraction(1, 4), Fraction(13, 16),
                  Fraction(7), Fraction(4 * 90)):
        t = int(beats * 65536)
        b = 0
        while units(64 * (b + 1)) <= t:
            b += 1
        assert clock.block_of(beats) == b
        if t:
            e = 0
            while units(64 * e) < t:
                e += 1
            assert clock.length_frames(beats) == 64 * e
    got = clock.block_beats(500)
    assert np.array_equal(got, [units(64 * b) / 65536 for b in range(500)])


def test_an_exponential_step_starts_slowly_and_ends_on_its_value():
    project = {"clock": {"bpm": 120.0},
               "paths": [{"id": "p", "note-value": "whole", "steps": [
                   {"exponential": {"start": 0.1, "end": 0.5}},
                   {"exponential": {"start": 0.5, "end": 0.9}}]}],
               "trips": [{"id": "t", "paths": ["p"],
                          "target": {"id": "d", "param": "x"}}]}
    clock = timeline.Clock(project, 44100)
    nb = 2 * 88200 // 64 + 10
    (key, v), = timeline.trips(project, clock, nb, lambda *a: 0.0).items()
    assert key == ("d", "x")
    half = int(np.searchsorted(clock.block_beats(nb), 2.0))
    assert v[0] == np.float32(0.1)
    assert 0.1 < v[half] < 0.3  # concave: under the straight line's 0.3
    second = int(np.searchsorted(clock.block_beats(nb), 4.0))
    assert 0.5 <= v[second] < 0.5 + 1e-3
    assert v[-1] == np.float32(0.9)


def test_lp24_is_the_bilinear_fourth_order_low_pass():
    from scipy.signal import bilinear, lfilter

    song = ref.Song({"clock": {"bpm": 120.0}, "devices": [
        {"effect": ["f", {"filter-low-pass-24db": {
            "cutoff": 4000.0, "passband-ripple": 0.707}}]}],
        "patch-cables": [], "tracks": []}, ".", 44100)
    x = np.zeros((2, 4096))
    x[:, 0] = 1.0
    fs, fc = 44100.0, 4000.0
    wp = 2 * fs * np.tan(np.pi * fc / fs)
    num, den = np.ones(1), np.ones(1)
    for b in ref.LP24_B:
        bz, az = bilinear([1.0], [1 / wp**2, b / (0.707 * wp), 1.0], fs)
        num, den = np.convolve(num, bz), np.convolve(den, az)
    np.testing.assert_allclose(song.lp24("f", x)[0],
                               lfilter(num, den, x[0]), atol=1e-12)
