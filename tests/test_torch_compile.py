"""The port's compile_song (groove_tpu_torch/compiler/song.py) against
groove_tpu's on the synthetic projects, bit for bit: frame counts, graph,
notes, drum slots, automation curves and sample tables. Also the voice
and sampler host helpers it uses."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.compiler.song import compile_song as jax_compile
from groove_tpu.models import sampler as jsampler
from groove_tpu.models import voices as jvoices
from groove_tpu.project.paths import Paths
from groove_tpu.project.schema import SongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.models import sampler as tsampler
from groove_tpu_torch.models import voices as tvoices
from groove_tpu_torch.testing import synth

PROJECTS = {
    "north-star": lambda: synth.north_star_project(measures=1),
    "high-sweep": lambda: synth.high_sweep_project(measures=1),
    "two-measures": lambda: synth.north_star_project(measures=2, bpm=240.0),
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return synth.write_assets(tmp_path_factory.mktemp("assets"),
                              max_seconds=0.4)


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(PROJECTS))
def test_compile_song_matches_reference(assets, name):
    song = SongSettings.from_json(PROJECTS[name]())
    ref = jax_compile(song, Paths(roots=[assets]))
    got = compile_song(song, Paths(roots=[assets]))
    for attr in ("title", "sample_rate", "bpm", "time_signature", "n_frames",
                 "n_blocks", "sinks", "order", "sidechain", "sends"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.devices.keys() == ref.devices.keys()
    for uvid, rd in ref.devices.items():
        gd = got.devices[uvid]
        assert (gd.role, gd.kind, gd.params) == (rd.role, rd.kind, rd.params)
        assert gd.automation.keys() == rd.automation.keys()
        for k in rd.automation:
            assert _eq(gd.automation[k], rd.automation[k]), (uvid, k)
        assert (gd.notes is None) == (rd.notes is None)
        if rd.notes is not None:
            for f in ("keys", "vels", "on_frames", "off_frames"):
                assert _eq(getattr(gd.notes, f), getattr(rd.notes, f)), f
        if rd.sample_table is not None:
            for f in ("data", "lengths", "rates"):
                assert _eq(getattr(gd.sample_table, f),
                           getattr(rd.sample_table, f)), f
            assert gd.drum_note_slots == rd.drum_note_slots
            assert _eq(gd.slots, rd.slots)


def test_north_star_analogue_shape(assets):
    """About 1.3 s (under one 65536-frame drum chunk); the trip rises from
    25 Hz to 20 kHz; every drum key of the pattern maps to a kit slot."""
    c = compile_song(SongSettings.from_json(synth.north_star_project()),
                     Paths(roots=[assets]))
    assert c.n_frames == 57216
    curve = c.devices[synth.FILTER_UVID].automation["cutoff"]
    assert curve[0] == pytest.approx(25.0, rel=1e-3)
    assert curve[-1] == pytest.approx(20000.0, rel=2e-2)
    assert np.all(np.diff(curve.astype(np.float64)) >= -1e-3)
    drums = c.devices["drums"]
    assert drums.notes.count == 4 + 2 + 12 + 1  # kick, snare, hats, crash
    assert np.all(drums.slots >= 0)
    assert set(np.unique(drums.notes.keys)) == {35, 38, 42, 44, 49}


def test_high_sweep_stays_above_2khz(assets):
    c = compile_song(SongSettings.from_json(synth.high_sweep_project()),
                     Paths(roots=[assets]))
    curve = c.devices[synth.FILTER_UVID].automation["cutoff"]
    assert curve.min() == pytest.approx(2000.0, rel=1e-3)


# ---- voice and sampler host helpers ---------------------------------------

def test_note_freqs_bitwise():
    keys = np.arange(0, 128, dtype=np.int32)
    assert _eq(tvoices.note_freqs(keys), jvoices.note_freqs(keys))


@pytest.mark.parametrize("gate,tail", [(0, 0.0), (1000, 0.5), (44100, 1.37)])
def test_span_for(gate, tail):
    assert tvoices.span_for(gate, tail, 44100) == \
        jvoices.span_for(gate, tail, 44100)


def _note_events(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    on = np.sort(rng.integers(0, 2000, n)) * 64
    off = on + rng.integers(1, 40, n) * 64
    keys = rng.integers(30, 90, n).astype(np.int32)
    return keys, on.astype(np.int32), off.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voice_policies_match(seed):
    keys, on, off = _note_events(seed)
    assert _eq(tvoices.apply_mono_policy(on, off),
               jvoices.apply_mono_policy(on, off))
    for limit in (1, 2, 3):
        assert _eq(tvoices.apply_multilimit_policy(on, off, limit),
                   jvoices.apply_multilimit_policy(on, off, limit))
    assert _eq(tvoices.glide_prev_keys(keys, on),
               jvoices.glide_prev_keys(keys, on))


@pytest.mark.parametrize("stereo", [False, True])
def test_scatter_notes_matches(stereo):
    rng = np.random.default_rng(4)
    shape = (6, 2, 300) if stereo else (6, 300)
    notes = rng.standard_normal(shape).astype(np.float32)
    on = np.array([0, 64, 64, 640, 900, 1000], np.int32)
    ref = np.asarray(jvoices.scatter_notes(jnp.asarray(notes), on, 1100))
    got = tvoices.scatter_notes(torch.from_numpy(notes), on, 1100).numpy()
    assert np.array_equal(got, ref)


def test_assign_drum_slots_and_loader_match(assets):
    table_j, slots_j = jsampler.load_drumkit(Paths(roots=[assets]), "707")
    table_t, slots_t = tsampler.load_drumkit(Paths(roots=[assets]), "707")
    assert slots_t == slots_j and _eq(table_t.data, table_j.data)
    assert table_t.slot_names == table_j.slot_names
    keys = np.array([35, 35, 38, 42, 42, 42, 42, 42, 49, 60], np.int32)
    assert _eq(tsampler.assign_drum_slots(keys, slots_t),
               jsampler.assign_drum_slots(keys, slots_j))
    assert tsampler.GM_707_MAP == jsampler.GM_707_MAP
    assert tsampler.root_frequency(69) == jsampler.root_frequency(69)
