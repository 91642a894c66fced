"""The port's lp24 cascades (groove_tpu_torch/ops/iir_kernels.py: K2 and K3
with block-rate denominators, K6 with per-sample or static ones) against
the reference's Pallas kernels run through the interpreter on the CPU,
the static cascade's routing, and the port's numpy coefficient design
against groove_tpu.ops.iir bit for bit.

Inputs are numpy-seeded noise through a 2 kHz -> 20 kHz sweep (poles away
from z = 1) and a 25 Hz -> 20 kHz sweep that rests near 25 Hz (the deep
corner). The twins use one correctly rounded fused multiply-add per
in-block recurrence step; XLA contracts the interpreted kernels' own
multiply-adds on the CPU, so the two agree to rounding, amplified near
z = 1. Residuals are max |port - JAX| in dBFS of the f64 reference's peak.
Measured on the CPU (numpy seed 0, n = 16384):

    kernel  rows  sweep            measured   bar
    K3      2     2 kHz -> 20 kHz  -138.5     -131
    K3      16    2 kHz -> 20 kHz  -135.4     -128
    K3      2     25 Hz -> 20 kHz  -93.3      -86
    K3      16    25 Hz -> 20 kHz  -83.5      -76
    K2      2     2 kHz -> 20 kHz  -123.3     -116
    K2      16    2 kHz -> 20 kHz  -121.7     -114
    K2      2     25 Hz -> 20 kHz  -125.4     -118
    K2      16    25 Hz -> 20 kHz  -120.3     -113

Against the f64 reference the twins land within 2 dB of the interpreted
kernels on every case (K2 at the 25 Hz corner: -117.1 vs -115.0 dBFS).

K6 (numpy seed 4), and the static cascade's three routes through
iir.lp24_apply_blockrate (numpy seed 10, n = 16384):

    case                                      measured   bar
    K6  2 rows, static 8 kHz                  -141.0     -133
    K6  [2, 3, 5000], static 8 kHz            -144.5     -136
    K6  2 rows, per-sample 60 Hz -> 15 kHz    -106.3     -98
    static 8 kHz (K6)                         -144.5     -136
    static 30 Hz (two serial scans)           equal      -130
    static 1 kHz q 8 (two refined sections)   -136.4     -128
The kernels themselves are held to the twins bit for bit on a CUDA card
by tests/test_torch_cuda.py."""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.ops import iir as jiir
from groove_tpu.ops import pallas_iir
from groove_tpu_torch.ops import iir as tiir
from groove_tpu_torch.ops import iir_kernels as tk

N = 16384
SR = 44100.0

CASES = [
    # (kernel, rows, low cutoff Hz, bar dBFS)
    ("K3", 2, 2000.0, -131.0),
    ("K3", 16, 2000.0, -128.0),
    ("K3", 2, 25.0, -86.0),
    ("K3", 16, 25.0, -76.0),
    ("K2", 2, 2000.0, -116.0),
    ("K2", 16, 2000.0, -114.0),
    ("K2", 2, 25.0, -118.0),
    ("K2", 16, 25.0, -113.0),
]

KERNELS = {
    "K3": (pallas_iir.lp24_blockrate_pallas, tk.lp24_blockrate),
    "K2": (pallas_iir.lp24_refined_blockrate_pallas,
           tk.lp24_refined_blockrate),
}


def _sweep_inputs(rows: int, low: float, n: int = N, seed: int = 0):
    """Gain-scaled noise [rows, n] and the block-rate sections of a sweep
    from `low` to 20 kHz that rests near `low` (cubic in log frequency)."""
    rng = np.random.default_rng(seed)
    nb = -(-n // 64)
    t = np.linspace(0.0, 1.0, nb) ** 3
    cut = (low * (20000.0 / low) ** t).astype(np.float32)
    gain, secs = jiir.lp24_sections(cut, np.float32(0.707), SR)
    x = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    x = x * np.repeat(gain, 64)[:n]
    secs = [tuple(np.ascontiguousarray(np.broadcast_to(c, (rows, nb)))
                  for c in sec) for sec in secs]
    return x, secs


def _f64_ref(x, secs):
    n = x.shape[-1]
    y = x.astype(np.float64)
    for sec in secs:
        coefs = tuple(np.repeat(np.asarray(c, np.float64), 64, axis=-1)
                      [..., :n] for c in sec)
        y = jiir.biquad_ref(y, coefs)
    return y


def _db(a, b, ref) -> float:
    peak = max(1.0, float(np.abs(ref).max()))
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return 20.0 * np.log10(float(diff.max()) / peak + 1e-30)


@pytest.mark.parametrize("kernel,rows,low,bar", CASES,
                         ids=[f"{k}-B{r}-{int(lo)}Hz" for k, r, lo, _ in CASES])
def test_twin_matches_interpreted_kernel(kernel, rows, low, bar):
    x, secs = _sweep_inputs(rows, low)
    jax_fn, port_fn = KERNELS[kernel]
    y_jax = np.asarray(jax_fn(
        jnp.asarray(x), [tuple(jnp.asarray(c) for c in s) for s in secs],
        interpret=True))
    y_port = port_fn(torch.from_numpy(x),
                     [tuple(torch.from_numpy(c) for c in s) for s in secs])
    assert y_port.shape == (rows, N) and y_port.dtype == torch.float32
    db = _db(y_port.numpy(), y_jax, _f64_ref(x, secs))
    assert db <= bar, f"{kernel} rows={rows} {low} Hz: {db:.1f} dBFS > {bar}"


@pytest.mark.parametrize("low", [2000.0, 25.0], ids=["2kHz", "25Hz"])
def test_twins_against_f64(low):
    """Against f64 (CPU, seed 0): K3 -139.4 / K2 -126.1 dBFS at 2 kHz;
    at the 25 Hz corner K3 -79.8 and K2 -117.1 — the correction pass is
    what holds the corner below the -80 dBFS fidelity bar."""
    x, secs = _sweep_inputs(2, low)
    ts = [tuple(torch.from_numpy(c) for c in s) for s in secs]
    ref = _f64_ref(x, secs)
    db3 = _db(tk.lp24_blockrate(torch.from_numpy(x), ts).numpy(), ref, ref)
    db2 = _db(tk.lp24_refined_blockrate(torch.from_numpy(x), ts).numpy(),
              ref, ref)
    assert db2 <= -110.0, db2
    if low < 100.0:
        assert db2 <= db3 - 30.0, (db2, db3)
    else:
        assert db3 <= -130.0, db3


K6_CASES = {
    "static-B2": ((2, 16384), "static", -133.0),
    "static-2x3x5000": ((2, 3, 5000), "static", -136.0),
    "per-sample-B2": ((2, 16384), "per-sample", -98.0),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_twin_matches_interpreted_kernel(case):
    shape, mode, bar = K6_CASES[case]
    n = shape[-1]
    x = (np.random.default_rng(4).standard_normal(shape) * 0.3) \
        .astype(np.float32)
    if mode == "static":
        gain, secs = jiir.lp24_sections(8000.0, 0.707, SR)
    else:
        gain, secs = jiir.lp24_sections(np.geomspace(60.0, 15000.0, n)
                                        .astype(np.float32),
                                        np.float32(0.9), SR)
    x = (x * gain).astype(np.float32)
    y_jax = np.asarray(pallas_iir.lp24_cascade_pallas(
        jnp.asarray(x), [tuple(jnp.asarray(c) for c in s) for s in secs],
        interpret=True))
    ts = [tuple(torch.from_numpy(np.asarray(c)) if np.ndim(c) else c
                for c in s) for s in secs]
    y = tk.lp24_cascade(torch.from_numpy(x), ts)
    assert y.shape == shape and y.dtype == torch.float32
    ref = x.astype(np.float64)
    for s in secs:
        ref = jiir.biquad_ref(ref, tuple(np.asarray(c, np.float64)
                                         for c in s))
    db = _db(y.numpy(), y_jax, ref)
    assert db <= bar, f"K6 {case}: {db:.1f} dBFS > {bar}"
    assert _db(y.numpy(), ref, ref) <= _db(y_jax, ref, ref) + 3.0


STATIC_LP24 = {
    # id: (cutoff, q, kernels reached, bar vs the reference dBFS)
    "8kHz-K6": (8000.0, 0.707, ["lp24_cascade"], -136.0),
    "30Hz-serial": (30.0, 0.707, ["biquad_serial"] * 2, -130.0),
    "1kHz-q8-refine": (1000.0, 8.0, ["biquad_blockrate"] * 4, -128.0),
}


@pytest.mark.parametrize("case", list(STATIC_LP24))
def test_static_lp24_routes(monkeypatch, case):
    """lp24_apply_blockrate with a static cutoff designs on the host and
    routes on the poles: the fused cascade K6, two serial scans at the
    deep corner, two refined sections (K4 twice each) for a high-q
    resonance — against the reference's routing with its kernels
    interpreted."""
    from groove_tpu_torch.ops import biquad_kernels as bk

    cutoff, q, expect, bar = STATIC_LP24[case]
    seen = []
    for mod, name in ((tk, "lp24_cascade"), (bk, "biquad_serial"),
                      (bk, "biquad_blockrate")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    monkeypatch.setattr(jiir, "USE_PALLAS", True)
    monkeypatch.setattr(pallas_iir, "FORCE_INTERPRET", True)
    x = (np.random.default_rng(10).standard_normal((2, 16384)) * 0.3) \
        .astype(np.float32)
    y = tiir.lp24_apply_blockrate(torch.from_numpy(x), cutoff, q, SR)
    assert seen == expect
    y_jax = np.asarray(jiir.lp24_apply_blockrate(jnp.asarray(x), cutoff, q,
                                                 SR))
    gain, secs = jiir.lp24_sections(cutoff, q, SR)
    ref = x.astype(np.float64) * np.float64(gain)
    for s in secs:
        ref = jiir.biquad_ref(ref, tuple(np.float64(c) for c in s))
    assert _db(y.numpy(), y_jax, ref) <= bar
    assert _db(y.numpy(), ref, ref) <= -100.0


def test_unaligned_length_and_leading_dims():
    """n not a multiple of the in-block length, x of shape [2, 3, n]."""
    rng = np.random.default_rng(3)
    n = 5000
    x = (rng.standard_normal((2, 3, n)) * 0.2).astype(np.float32)
    nb = -(-n // 64)
    cut = np.geomspace(300.0, 9000.0, nb).astype(np.float32)
    gain, secs = jiir.lp24_sections(cut, np.float32(0.9), SR)
    x = x * np.repeat(gain, 64)[:n]
    y_jax = np.asarray(pallas_iir.lp24_refined_blockrate_pallas(
        jnp.asarray(x), [tuple(jnp.asarray(c) for c in s) for s in secs],
        interpret=True))
    y = tk.lp24_refined_blockrate(
        torch.from_numpy(x),
        [tuple(torch.from_numpy(np.asarray(c)) for c in s) for s in secs])
    assert y.shape == x.shape
    # measured 2.5e-7 of the peak on the CPU
    assert np.max(np.abs(y.numpy() - y_jax)) < 2e-6 * np.abs(y_jax).max()


@pytest.mark.parametrize("fidelity,expect", [
    (None, "K3"), ("refine", "K2"), ("serial", "K2")])
def test_routing_follows_kernel_routing(fidelity, expect):
    """lp24_apply_blockrate_sections: gain first, then K2 for refine and
    serial, K3 for unrouted filters (no CPU-serial or chunked detours)."""
    x, secs = _sweep_inputs(2, 25.0, n=4096, seed=5)
    gain = np.linspace(0.5, 1.0, 64).astype(np.float32)
    xt = torch.from_numpy(x)
    ts = [tuple(torch.from_numpy(c) for c in s) for s in secs]
    got = tiir.lp24_apply_blockrate_sections(xt, torch.from_numpy(gain), ts,
                                             fidelity=fidelity)
    y = xt * tiir.upsample_hold(torch.from_numpy(gain), 4096)
    fn = tk.lp24_refined_blockrate if expect == "K2" else tk.lp24_blockrate
    assert torch.equal(got, fn(y, ts))


def test_unknown_fidelity_raises():
    x = torch.zeros((2, 128))
    _, secs = tiir.lp24_sections(np.full(2, 500.0, np.float32),
                                 np.float32(0.7), SR)
    with pytest.raises(ValueError):
        tiir.lp24_apply_blockrate_sections(
            x, np.ones(2, np.float32),
            [tuple(torch.from_numpy(np.asarray(c)) for c in s)
             for s in secs], fidelity="bogus")


def test_non_cuda_device_raises():
    x = torch.zeros((2, 128), device="meta")
    secs = [tuple(torch.zeros(2, device="meta") for _ in range(5))] * 2
    with pytest.raises(RuntimeError, match="unsupported device"):
        tk.lp24_blockrate(x, secs)


# ---- host coefficient design: bit for bit ---------------------------------

def _cutoffs():
    rng = np.random.default_rng(11)
    return np.concatenate([
        np.geomspace(20.0, 21000.0, 300),
        rng.uniform(25.0, 20000.0, 200)]).astype(np.float32)


@pytest.mark.parametrize("q", [0.3, 0.707, 5.33])
def test_lp24_sections_bitwise(q):
    cut = _cutoffs()
    qs = np.full_like(cut, q)
    g_j, s_j = jiir.lp24_sections(cut, qs, SR)
    g_t, s_t = tiir.lp24_sections(cut, qs, SR)
    assert np.array_equal(g_j, g_t) and g_t.dtype == np.float32
    for a, b in zip(s_j, s_t):
        for cj, ct in zip(a, b):
            assert np.array_equal(np.asarray(cj), np.asarray(ct))


RBJ = [
    ("rbj_low_pass", (0.707,)), ("rbj_high_pass", (2.0,)),
    ("rbj_all_pass", (0.9,)), ("rbj_band_pass", (30.0,)),
    ("rbj_band_stop", (200.0,)), ("rbj_peaking_eq", (1.5, 6.0)),
    ("rbj_low_shelf", (-4.0,)), ("rbj_high_shelf", (3.0,)),
]


@pytest.mark.parametrize("name,extra", RBJ, ids=[r[0] for r in RBJ])
def test_rbj_design_bitwise(name, extra):
    cut = _cutoffs()
    args = [np.full_like(cut, v) for v in extra]
    cj = getattr(jiir, name)(cut, *args, SR)
    ct = getattr(tiir, name)(cut, *args, SR)
    for a, b in zip(cj, ct):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(b).dtype == np.float32


def test_planner_helpers_match():
    for n in (1, 100, 4096, 57216, 7938048):
        assert tiir.block_for(n) == jiir.block_for(n)
    assert (tiir._CRITICAL_A1, tiir._CRITICAL_A2, tiir._PLAN_A1,
            tiir._PLAN_A2) == (jiir._CRITICAL_A1, jiir._CRITICAL_A2,
                               jiir._PLAN_A1, jiir._PLAN_A2)
    for low in (25.0, 300.0, 2000.0):
        _, secs = jiir.lp24_sections(np.geomspace(low, 20000.0, 50)
                                     .astype(np.float32), np.float32(0.707),
                                     SR)
        a1 = np.stack([s[3] for s in secs])
        a2 = np.stack([s[4] for s in secs])
        assert tiir.needs_refinement(a1, a2) == jiir.needs_refinement(a1, a2)


def test_upsample_hold_matches():
    c = np.arange(7, dtype=np.float32).reshape(1, 7) * 0.5
    for n in (1, 64, 400, 448):
        got = tiir.upsample_hold(torch.from_numpy(c), n).numpy()
        assert np.array_equal(got, np.asarray(jiir.upsample_hold(c, n)))


# ---- the twins' fused multiply-add ----------------------------------------

def _is_correctly_rounded(a, b, c, r) -> bool:
    """r is a * b + c rounded once to the nearest float32 (ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    err = abs(v - Fraction(float(r)))
    for nb in (np.nextafter(r, np.float32(np.inf)),
               np.nextafter(r, np.float32(-np.inf))):
        e = abs(v - Fraction(float(nb)))
        if e < err:
            return False
        if e == err and int(np.float32(r).view(np.int32)) & 1:
            return False
    return True


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(7)
    n = 3000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)  # cancellation
    c[::2] = (rng.standard_normal(n // 2) * 1e-3).astype(np.float32)
    # exact-midpoint products: (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 sits
    # half an ulp above 1 + 2^-11, so a tiny c decides the rounding — the
    # case a plain float64 evaluation double-rounds wrongly
    h = np.float32(1.0 + 2.0 ** -12)
    a[:3] = h
    b[:3] = h
    c[:3] = np.array([0.0, 2.0 ** -60, -(2.0 ** -60)], np.float32)
    r = tk.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert r[1] > r[0] == r[2] == np.float32(1.0 + 2.0 ** -11)
    bad = [i for i in range(n) if not _is_correctly_rounded(a[i], b[i], c[i],
                                                            r[i])]
    assert not bad, bad[:5]
