"""IIR filter design and routing (port of groove_tpu/ops/iir.py).

Host side: the numpy f32 coefficient design (RBJ cookbook sections and
the filters004 24 dB cascade) with the same expressions, hence the same
bits, as the reference's numpy path — the engines design control tables
on the host and ship them as data (the "HOST-designed control
constants" invariant). Device side: upsample_hold in torch and the
routing of block-rate lp24 cascades onto the hand kernels of
ops/iir_kernels.py.

TDF2 biquad with a0 == 1:
    y[n]  = b0 x[n] + s1[n-1]
    s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
    s2[n] = b2 x[n] - a2 y[n]
"""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.ops import iir_kernels

CONTROL_BLOCK = 64  # the reference's handle_work cadence (SAMPLE_BUFFER_SIZE)

# Poles this close to z = 1 (cutoff below ~100 Hz at 44.1 kHz) lose ~10 dB
# through the blocked scheme's prefix products.
_CRITICAL_A1 = -1.98
_CRITICAL_A2 = 0.975
# Plan thresholds for automated sweeps: wider than the static ones.
_PLAN_A1 = -1.95
_PLAN_A2 = 0.95


def block_for(n: int, max_block: int = 128) -> int:
    """In-block length of the two-level serial scheme, ~sqrt(n) clamped to
    [16, max_block]: total serial depth is block + n/block."""
    b = 16
    while b < max_block and b * b < n:
        b *= 2
    return b


def needs_refinement(a1_b, a2_b) -> bool:
    """True when any block's poles are near z = 1 (the plan thresholds):
    an automated filter there takes the defect-correction cascade."""
    a1 = np.asarray(a1_b, np.float64)
    a2 = np.asarray(a2_b, np.float64)
    return bool(((a1 < _PLAN_A1) & (a2 > _PLAN_A2)).any())


def upsample_hold(c: torch.Tensor, n: int,
                  cblock: int = CONTROL_BLOCK) -> torch.Tensor:
    """Block-rate values [..., nb] -> per-sample [..., n] by zero-order
    hold."""
    nb = c.shape[-1]
    out = c.unsqueeze(-1).expand(*c.shape, cblock)
    return out.reshape(*c.shape[:-1], nb * cblock)[..., :n]


def lp24_apply_blockrate_sections(x: torch.Tensor, gain_b, sections_b,
                                  cblock: int = CONTROL_BLOCK,
                                  fidelity=None) -> torch.Tensor:
    """24 dB cascade from PRECOMPUTED block-rate coefficients: gain_b and
    each section's five coefficients broadcast against
    x.shape[:-1] + (ceil(n / cblock),). The numerators are filters004's
    constant (1, 2, 1); only the denominators reach the kernels.

    Routing follows the reference's KERNEL routing (groove_tpu's
    iir.lp24_apply_blockrate_sections with Pallas available):
      - fidelity "refine" or "serial" -> the fused refined cascade (K2,
        iir_kernels.lp24_refined_blockrate);
      - no fidelity entry -> the single-pass cascade (K3,
        iir_kernels.lp24_blockrate).
    Divergence from the reference: for few rows and long n (rows <= 4,
    n >= 65536, e.g. the master-bus [2, n] cascade) the TPU left the
    refined pass to XLA's row-packed _solve_chunked. Here K2 serves that
    case too, so its cross-block chain runs serially over the whole row
    (latency-bound with two rows; an exact chunked re-solve is the later
    speed-up). There is no CPU-serial branch and no residence-based
    deepening to "serial": the kernel algorithm is the only one."""
    n = x.shape[-1]
    nb = -(-n // cblock)
    cshape = x.shape[:-1] + (nb,)

    def blk(c):
        return torch.as_tensor(c, dtype=torch.float32,
                               device=x.device).expand(cshape)

    y = x * upsample_hold(blk(gain_b), n, cblock)
    sections = [tuple(blk(c) for c in sec) for sec in sections_b]
    if fidelity in ("refine", "serial"):
        return iir_kernels.lp24_refined_blockrate(y, sections, cblock)
    if fidelity is not None:
        raise ValueError(f"unknown filter fidelity {fidelity!r}")
    return iir_kernels.lp24_blockrate(y, sections, cblock)


# --------------------------------------------------------------------------
# RBJ Audio EQ Cookbook coefficients, numpy f32 (the reference's host
# path): cutoff/q/... may be scalars or arrays (per-block automation);
# each returns normalized (b0, b1, b2, a1, a2).


def _norm(b0, b1, b2, a0, a1, a2):
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def _w0(cutoff, sample_rate):
    return 2.0 * np.pi * cutoff / sample_rate


def _f32(*vals):
    return tuple(np.asarray(v, np.float32) for v in vals)


def rbj_low_pass(cutoff, q, sample_rate):
    cutoff, q = _f32(cutoff, q)
    w0 = _w0(cutoff, sample_rate)
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    # 1-cos(w0) == 2 sin^2(w0/2): cancellation-free at low cutoffs
    one_minus_cw = 2.0 * np.sin(w0 / 2.0) ** 2
    return _norm(
        one_minus_cw / 2, one_minus_cw, one_minus_cw / 2,
        1 + alpha, -2 * cw, 1 - alpha,
    )


def rbj_high_pass(cutoff, q, sample_rate):
    cutoff, q = _f32(cutoff, q)
    w0 = _w0(cutoff, sample_rate)
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    one_plus_cw = 2.0 * np.cos(w0 / 2.0) ** 2
    return _norm(
        one_plus_cw / 2, -one_plus_cw, one_plus_cw / 2,
        1 + alpha, -2 * cw, 1 - alpha,
    )


def _alpha_bw_hz(w0, cutoff, bandwidth_hz):
    """alpha from a bandwidth in Hz: Q = cutoff / bandwidth."""
    q = cutoff / np.maximum(bandwidth_hz, 1e-6)
    return np.sin(w0) / (2.0 * q)


def rbj_band_pass(cutoff, bandwidth, sample_rate):
    """Constant 0 dB peak gain variant (cookbook's second BPF form)."""
    cutoff, bandwidth = _f32(cutoff, bandwidth)
    w0 = _w0(cutoff, sample_rate)
    cw = np.cos(w0)
    alpha = _alpha_bw_hz(w0, cutoff, bandwidth)
    return _norm(alpha, np.zeros_like(alpha), -alpha, 1 + alpha, -2 * cw,
                 1 - alpha)


def rbj_band_stop(cutoff, bandwidth, sample_rate):
    cutoff, bandwidth = _f32(cutoff, bandwidth)
    w0 = _w0(cutoff, sample_rate)
    cw = np.cos(w0)
    alpha = _alpha_bw_hz(w0, cutoff, bandwidth)
    one = np.ones_like(alpha)
    return _norm(one, -2 * cw, one, 1 + alpha, -2 * cw, 1 - alpha)


def rbj_all_pass(cutoff, q, sample_rate):
    cutoff, q = _f32(cutoff, q)
    w0 = _w0(cutoff, sample_rate)
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    return _norm(1 - alpha, -2 * cw, 1 + alpha, 1 + alpha, -2 * cw, 1 - alpha)


def rbj_peaking_eq(cutoff, q, db_gain, sample_rate):
    cutoff, q, db_gain = _f32(cutoff, q, db_gain)
    w0 = _w0(cutoff, sample_rate)
    cw, sw = np.cos(w0), np.sin(w0)
    a = 10.0 ** (db_gain / 40.0)
    alpha = sw / (2.0 * q)
    return _norm(
        1 + alpha * a, -2 * cw, 1 - alpha * a, 1 + alpha / a, -2 * cw,
        1 - alpha / a
    )


def _shelf_alpha(w0, a, slope=1.0):
    sw = np.sin(w0)
    return sw / 2.0 * np.sqrt((a + 1.0 / a) * (1.0 / slope - 1.0) + 2.0)


def rbj_low_shelf(cutoff, db_gain, sample_rate, slope=1.0):
    cutoff, db_gain = _f32(cutoff, db_gain)
    w0 = _w0(cutoff, sample_rate)
    cw = np.cos(w0)
    a = 10.0 ** (db_gain / 40.0)
    alpha = _shelf_alpha(w0, a, slope)
    two_sqrt_a_alpha = 2.0 * np.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) - (a - 1) * cw + two_sqrt_a_alpha),
        2 * a * ((a - 1) - (a + 1) * cw),
        a * ((a + 1) - (a - 1) * cw - two_sqrt_a_alpha),
        (a + 1) + (a - 1) * cw + two_sqrt_a_alpha,
        -2 * ((a - 1) + (a + 1) * cw),
        (a + 1) + (a - 1) * cw - two_sqrt_a_alpha,
    )


def rbj_high_shelf(cutoff, db_gain, sample_rate, slope=1.0):
    cutoff, db_gain = _f32(cutoff, db_gain)
    w0 = _w0(cutoff, sample_rate)
    cw = np.cos(w0)
    a = 10.0 ** (db_gain / 40.0)
    alpha = _shelf_alpha(w0, a, slope)
    two_sqrt_a_alpha = 2.0 * np.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) + (a - 1) * cw + two_sqrt_a_alpha),
        -2 * a * ((a - 1) + (a + 1) * cw),
        a * ((a + 1) + (a - 1) * cw - two_sqrt_a_alpha),
        (a + 1) - (a - 1) * cw + two_sqrt_a_alpha,
        2 * ((a - 1) - (a + 1) * cw),
        (a + 1) - (a - 1) * cw - two_sqrt_a_alpha,
    )


# --------------------------------------------------------------------------
# 24 dB/oct resonant low-pass: 4th-order Butterworth as a cascade of two
# biquads, bilinear transform with prewarping (doc/filters004.txt). The
# resonance Q divides each section's s-domain b1; section b1 constants
# 0.765367 / 1.847759.

_LP24_B1 = (0.765367, 1.847759)


def lp24_sections(cutoff, q, sample_rate):
    """Returns (gain, [(b0, b1, b2, a1, a2) x 2]) for the 24 dB low-pass,
    numpy f32. `cutoff`/`q` may be arrays (per-block automation)."""
    cutoff = np.asarray(cutoff, np.float32)
    q = np.asarray(q, np.float32)
    fs = sample_rate
    wp = 2.0 * fs * np.tan(np.pi * cutoff / fs)
    gain = np.ones_like(cutoff)
    sections = []
    for b1s in _LP24_B1:
        # s-domain denominator (1, b1s/q, 1) prewarped: b2/wp^2, b1/wp
        b0s = 1.0
        b1p = (b1s / q) / wp
        b2p = 1.0 / (wp * wp)
        # bilinear; the constant numerator maps to (1, 2, 1)
        ad = np.ones_like(cutoff)
        bd = 4.0 * b2p * fs * fs + 2.0 * b1p * fs + b0s
        gain = gain * ad / bd
        beta1 = (2.0 * b0s - 8.0 * b2p * fs * fs) / bd
        beta2 = (4.0 * b2p * fs * fs - 2.0 * b1p * fs + b0s) / bd
        alpha1 = 2.0 * np.ones_like(cutoff)
        alpha2 = np.ones_like(cutoff)
        sections.append((np.ones_like(cutoff), alpha1, alpha2, beta1, beta2))
    return gain, sections
