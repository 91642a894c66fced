"""The CUDA kernels of groove_tpu_torch against their plain torch twins on
a card, bit for bit: K1 (drums), K3 (lp24) and K2 (refined lp24), plus a
short render of the slice on the card against the same render on the CPU.

These tests need an NVIDIA GPU (marker `cuda`; they skip without one) and
import no jax, so the machine with the card runs them:

    python -m pytest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from groove_tpu.project.paths import Paths
from groove_tpu.project.schema import SongSettings
from groove_tpu_torch.compiler.song import compile_song
from groove_tpu_torch.engine.render import Renderer
from groove_tpu_torch.ops import drums, iir, iir_kernels
from groove_tpu_torch.testing import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sweep(rows: int, low: float, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    cut = (low * (20000.0 / low) ** np.linspace(0.0, 1.0, nb) ** 3)
    gain, secs = iir.lp24_sections(cut.astype(np.float32), np.float32(0.707),
                                   44100.0)
    x = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    x = torch.from_numpy(x * np.repeat(gain, 64)[:n])
    secs = [tuple(torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(c, (rows, nb)))) for c in sec) for sec in secs]
    return x, secs


@pytest.mark.parametrize("refined", [False, True], ids=["K3", "K2"])
@pytest.mark.parametrize("rows,n,low", [(2, 57216, 25.0), (16, 16384, 2000.0),
                                        (3, 5000, 300.0)])
def test_lp24_kernel_matches_twin(cuda_device, refined, rows, n, low):
    x, secs = _sweep(rows, low, n)
    fn = (iir_kernels.lp24_refined_blockrate if refined
          else iir_kernels.lp24_blockrate)
    key = "lp24_refined" if refined else "lp24"
    before = iir_kernels.LAUNCHES[key]
    y = fn(x.to(cuda_device), [tuple(c.to(cuda_device) for c in s)
                               for s in secs])
    torch.cuda.synchronize()
    assert iir_kernels.LAUNCHES[key] == before + 1
    assert torch.equal(y.cpu(), fn(x, secs))


def _hits(n: int, count: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((6, 2, 70000)) * 0.5).astype(np.float32)
    lengths = rng.integers(100, 69999, 6)
    for s, ln in enumerate(lengths):
        table[s, :, ln:] = 0.0
    on = np.sort(rng.integers(0, n // 64, count)) * 64
    slots = rng.integers(-1, 6, count).astype(np.int32)
    vels = rng.integers(1, 128, count).astype(np.float32)
    meta = drums.prepare_hits(slots, on, np.full(count, 2**30), vels,
                              lengths, n)
    return (torch.from_numpy(drums.prepare_table(table)),
            [torch.from_numpy(m) for m in meta])


@pytest.mark.parametrize("n,count", [(4096, 20), (441000, 400),
                                     (3 * drums.CHUNK + 64, 300)])
def test_drum_kernel_matches_twin(cuda_device, n, count):
    table, meta = _hits(n, count)
    before = drums.LAUNCHES["drums"]
    y = drums.accumulate_hits(table.to(cuda_device),
                              *[m.to(cuda_device) for m in meta], n_frames=n)
    torch.cuda.synchronize()
    assert drums.LAUNCHES["drums"] == before + 1
    assert torch.equal(y.cpu(), drums.accumulate_hits(table, *meta,
                                                      n_frames=n))


def test_wrappers_refuse_bad_inputs(cuda_device):
    x, secs = _sweep(2, 500.0, 4096)
    with pytest.raises(TypeError):
        iir_kernels.lp24_blockrate(x.double().to(cuda_device), secs)
    table, meta = _hits(4096, 5)
    with pytest.raises(ValueError):
        drums.accumulate_hits(table.to(cuda_device), *meta, n_frames=4096)


@pytest.mark.parametrize("make", [synth.north_star_project,
                                  synth.high_sweep_project],
                         ids=["north-star", "high-sweep"])
def test_short_slice_on_card_equals_cpu(cuda_device, tmp_path, make):
    assets = synth.write_assets(tmp_path, max_seconds=0.4)
    compiled = compile_song(SongSettings.from_json(make()),
                            Paths(roots=[assets]))
    on_card = Renderer(compiled, cuda_device).render()
    assert np.array_equal(on_card, Renderer(compiled, "cpu").render())
