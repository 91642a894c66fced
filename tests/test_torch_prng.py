"""groove_tpu_torch.ops.prng against jax.random (threefry2x32,
jax_threefry_partitionable on): PRNGKey, fold_in and uniform bit for bit,
for several seeds, fold data and lengths (odd ones included), and the
noise the Welsh voice draws — id-keyed rows, their windows and the S&H
bank."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.models import welsh as jwelsh
from groove_tpu.ops import oscillator as josc
from groove_tpu_torch.models import welsh as twelsh
from groove_tpu_torch.ops import oscillator as tosc
from groove_tpu_torch.ops import prng

SEEDS = (0, 1, 7, 12345, 2**31 + 11, 2**32 - 1)


def _key_data(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def test_partitionable_threefry_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.prng_key(seed)
    assert np.array_equal(_key_data(kj), kt.numpy())
    for data in (0, 1, 3, 7, 1000, 2**31 - 1, 2**32 - 5):
        assert np.array_equal(_key_data(jax.random.fold_in(kj, data)),
                              prng.fold_in(kt, data).numpy()), data


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 2, 5, 64, 999, 4097])
def test_uniform_matches(seed, n):
    for which, lo, hi in ((1, -1.0, 1.0), (3, -1.0, 1.0), (7, 0.0, 1.0)):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), which)
        kt = prng.fold_in(prng.prng_key(seed), which)
        want = np.asarray(jax.random.uniform(kj, (n,), jnp.float32, lo, hi))
        got = prng.uniform(kt, (n,), lo, hi).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_uniform_2d_shape_matches():
    kj, kt = jax.random.PRNGKey(5), prng.prng_key(5)
    want = np.asarray(jax.random.uniform(kj, (7, 33), jnp.float32, -1, 1))
    assert np.array_equal(prng.uniform(kt, (7, 33), -1.0, 1.0).numpy(), want)


@pytest.mark.parametrize("which", [1, 2, 3])
def test_noise_rows_match(which):
    ids = np.array([0, 4, 17, 3, 2**20], np.int32)
    kj = jax.random.fold_in(jax.random.PRNGKey(0), which)
    want = np.asarray(josc.noise_rows(kj, ids, 1235))
    kt = prng.fold_in(prng.prng_key(0), which)
    got = tosc.noise_rows(kt, torch.from_numpy(ids), 1235).numpy()
    assert np.array_equal(got, want)


def test_noise_window_is_the_full_row_sliced():
    """The sliced voice draws only its window [age0, age0 + S) of each
    note's noise row: bitwise the full row sliced, zeros outside the
    note's window (ages before 0 and from span on)."""
    span, S = 3000, 512
    ids = torch.tensor([2, 9, 11, 40])
    key = prng.fold_in(prng.prng_key(0), 3)
    full = tosc.noise_rows(key, ids, span).numpy()
    keys = tosc.noise_keys(key, ids)
    for age0 in ([0, 64, 128, 2496], [-512, -64, 2560, 3008],
                 [2944, 1024, -1000, 2999]):
        a = torch.tensor(age0)
        got = tosc.noise_window(keys, a, S, span).numpy()
        for i, a0 in enumerate(age0):
            want = np.zeros(S, np.float32)
            lo, hi = max(a0, 0), min(a0 + S, span)
            if hi > lo:
                want[lo - a0:hi - a0] = full[i, lo:hi]
            assert np.array_equal(got[i], want), (age0, i)


def test_sample_and_hold_bank_matches():
    from groove_tpu.project.patches import LfoPreset as JLfo
    from groove_tpu_torch.project.patches import LfoPreset as TLfo

    d = {"routing": "filter-cutoff", "waveform": "noise",
         "frequency": 7.5, "depth": {"pct": 0.4}}
    lj, lt = JLfo.from_json(d), TLfo.from_json(d)
    span = 44100
    want = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 7),
        (jwelsh._sh_cycles(lj, span, 44100.0),), jnp.float32, -1.0, 1.0))
    got = twelsh.sh_bank(twelsh._sh_cycles(lt, span, 44100.0)).numpy()
    assert np.array_equal(got, want)
    t = (np.arange(0, span, 64, dtype=np.float32) / np.float32(44100))[None]
    assert np.array_equal(twelsh._host_lfo_values(lt, t, span, 44100.0),
                          jwelsh._host_lfo_values(lj, t, span, 44100.0))
