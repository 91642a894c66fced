"""IIR filter design and routing (port of groove_tpu/ops/iir.py).

Design: the RBJ cookbook sections and the filters004 24 dB cascade, with
the reference's expressions. Host inputs (numbers, numpy arrays) design
in numpy f32, bit for bit the reference's numpy path — the engines design
control tables on the host and ship them as data (the "HOST-designed
control constants" invariant). Torch inputs (a sidechain's per-block
control values, computed on the render's device) design in torch f32 with
the same expressions, as the reference designs them in-graph with
jax.numpy; there cos, sin, tan and powers are evaluated in float64 and
rounded once to float32, so the CPU and a CUDA device give the same bits.

Routing: the reference's dispatch with Pallas available, onto the hand
kernels of ops/iir_kernels.py (lp24: K2, K3, K6) and
ops/biquad_kernels.py (one section: K4, K5, K9 and the serial scan):
  - biquad_blockrate: fidelity "serial" -> serial scan; "refine" ->
    biquad_blockrate_refined (K4 twice); static coefficients ->
    biquad_best; block-rate ones -> K4 (the reference's _blockrate_fast
    with Pallas available);
  - biquad_best: static deep-corner poles -> serial scan; static high-q
    resonances -> biquad_blockrate_refined; else K5 (scalar) or K9
    (per-sample coefficients);
  - lp24_apply_blockrate: a static cascade -> two serial scans, two
    refined sections (K4 x 4) or K6; block-rate cutoffs ->
    lp24_apply_blockrate_sections (K2 or K3);
  - lp24_apply: cutoff/q per sample or static -> K6 (both sections in one
    call); along another axis -> biquad_best per section.

TDF2 biquad with a0 == 1:
    y[n]  = b0 x[n] + s1[n-1]
    s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
    s2[n] = b2 x[n] - a2 y[n]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from groove_tpu_torch.ops import biquad_kernels, iir_kernels
from groove_tpu_torch.ops.iir_kernels import as_f32, is_scalar

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


def _static_poles(coefs):
    """(a1, a2) of compile-time scalar coefficients, or None. Torch
    tensors are run-time values (a sidechain's design), as tracers are
    in the reference: never routed on their values."""
    if any(torch.is_tensor(c) for c in coefs[3:5]):
        return None
    try:
        return float(coefs[3]), float(coefs[4])
    except (TypeError, ValueError):
        return None


def _near_critical_static(coefs) -> bool:
    """True when coefficients are compile-time scalars with poles near
    z = 1."""
    p = _static_poles(coefs)
    return p is not None and p[0] < _CRITICAL_A1 and p[1] > _CRITICAL_A2


def _near_refinable_static(coefs) -> bool:
    """Static poles in the band between the plan thresholds and the
    serial thresholds: high-q resonant filters (1 kHz q 20: a1 -1.973,
    a2 0.993), which get the defect-correction pass."""
    p = _static_poles(coefs)
    return p is not None and p[0] < _PLAN_A1 and p[1] > _PLAN_A2


def biquad_best(x: torch.Tensor, coefs) -> torch.Tensor:
    """One section with fidelity dispatch: static near-critical poles
    (deep corner) take the serial scan; the refinable band (high-q
    resonances) takes the defect-correction pass; everything else the
    biquad kernel (K5 for scalar, K9 for per-sample coefficients)."""
    if _near_critical_static(coefs):
        return biquad_kernels.biquad_serial(x, coefs)
    if _near_refinable_static(coefs):
        return biquad_blockrate_refined(x, coefs)
    return biquad_kernels.biquad_pallas(x, coefs)


def _block_coefs(coefs_b, x: torch.Tensor, cblock: int):
    """Each coefficient as float32 on x's device, broadcast against
    x.shape[:-1] + (ceil(n / cblock),)."""
    nb = -(-x.shape[-1] // cblock)
    cshape = x.shape[:-1] + (nb,)
    return tuple(as_f32(c, x.device).expand(cshape) for c in coefs_b)


def _roll0(v: torch.Tensor, k: int) -> torch.Tensor:
    """Shift right along the last axis with zero history."""
    return torch.nn.functional.pad(v, (k, 0))[..., :-k]


def biquad_blockrate_refined(x: torch.Tensor, coefs_b,
                             cblock: int = CONTROL_BLOCK) -> torch.Tensor:
    """Blocked solve + ONE defect-correction pass (the reference's
    biquad_blockrate_refined without its row-packed `chunks` branch: K4
    serves every solve). The TDF2 engine with time-varying coefficients
    realizes

        y[n] = b0[n] x[n] + b1[n-1] x[n-1] + b2[n-2] x[n-2]
                         - a1[n-1] y[n-1] - a2[n-2] y[n-2]

    (coefficients indexed at state-ENTRY time). The per-sample defect d
    of the solve y0 against that recurrence, in the reference's
    epsilon-regrouped form, is solved with numerator (1, 0, 0) and added:
    y0 + c. The defect, the shifts and the sum are elementwise torch, as
    the reference computes them outside any kernel."""
    n = x.shape[-1]
    cb_f = _block_coefs(coefs_b, x, cblock)
    b0u, b1u, b2u, a1u, a2u = (upsample_hold(c, n, cblock) for c in cb_f)
    y0 = biquad_kernels.biquad_blockrate(x, cb_f, cblock)
    b1s, b2s = _roll0(b1u, 1), _roll0(b2u, 2)
    a1s, a2s = _roll0(a1u, 1), _roll0(a2u, 2)
    y1v, y2v = _roll0(y0, 1), _roll0(y0, 2)
    e1 = a1s + 2.0   # exact in f32 for near-critical a1 (Sterbenz)
    e2 = a2s - 1.0
    second = (y0 - y1v) - (y1v - y2v)   # nearly exact: y0 is smooth there
    d = (b0u * x + b1s * _roll0(x, 1) + b2s * _roll0(x, 2)) \
        - second - e1 * y1v - e2 * y2v
    ones_b = torch.ones_like(cb_f[3])
    zeros_b = torch.zeros_like(cb_f[3])
    c = biquad_kernels.biquad_blockrate(
        d, (ones_b, zeros_b, zeros_b, cb_f[3], cb_f[4]), cblock)
    return y0 + c


def biquad_blockrate(x: torch.Tensor, coefs_b, cblock: int = CONTROL_BLOCK,
                     fidelity=None) -> torch.Tensor:
    """Biquad with BLOCK-RATE coefficients (held for cblock samples):
    coefs_b entries broadcast against x.shape[:-1] + (ceil(n/cblock),), or
    scalars. fidelity: None | "refine" | "serial", the HOST-side routing
    decision (engine/render.compute_filter_fidelity)."""
    n = x.shape[-1]
    if fidelity == "serial":
        if not all(is_scalar(c) for c in coefs_b):
            coefs_b = tuple(upsample_hold(c, n, cblock)
                            for c in _block_coefs(coefs_b, x, cblock))
        return biquad_kernels.biquad_serial(x, coefs_b)
    if fidelity == "refine":
        return biquad_blockrate_refined(x, coefs_b, cblock)
    if fidelity is not None:
        raise ValueError(f"unknown filter fidelity {fidelity!r}")
    if all(is_scalar(c) for c in coefs_b):
        return biquad_best(x, coefs_b)
    return biquad_kernels.biquad_blockrate(
        x, _block_coefs(coefs_b, x, cblock), cblock)


def lp24_apply_blockrate(x: torch.Tensor, cutoff_b, q_b, sample_rate,
                         cblock: int = CONTROL_BLOCK,
                         fidelity=None) -> torch.Tensor:
    """24 dB cascade with cutoff/q given as scalars (a static filter) or
    block-rate values ([..., ceil(n/cblock)]). A static cascade designs
    its sections on the host and routes on the host's fidelity decision
    (or its own pole checks): two serial scans, two refined sections, or
    the fused per-sample-denominator cascade K6."""
    n = x.shape[-1]
    if is_scalar(cutoff_b) and is_scalar(q_b):
        gain_s, secs_s = lp24_sections(cutoff_b, q_b, sample_rate)
        y = x * float(gain_s)
        if fidelity == "serial" \
                or all(_near_critical_static(s) for s in secs_s):
            for sec in secs_s:
                y = biquad_kernels.biquad_serial(y, sec)
            return y
        if fidelity == "refine" \
                or any(_near_refinable_static(s) for s in secs_s):
            for sec in secs_s:
                y = biquad_blockrate_refined(y, sec, cblock)
            return y
        if fidelity is not None:
            raise ValueError(f"unknown filter fidelity {fidelity!r}")
        return iir_kernels.lp24_cascade(y, secs_s)
    nb = -(-n // cblock)
    cshape = x.shape[:-1] + (nb,)
    cutoff_b = as_f32(cutoff_b, x.device).expand(cshape)
    gain_b, sections_b = lp24_sections(cutoff_b, q_b, sample_rate)
    return lp24_apply_blockrate_sections(x, gain_b, sections_b,
                                         cblock=cblock, fidelity=fidelity)


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
        return as_f32(c, x.device).expand(cshape)

    y = x * upsample_hold(blk(gain_b), n, cblock)
    sections = [tuple(blk(c) for c in sec) for sec in sections_b]
    if fidelity in ("refine", "serial"):
        return iir_kernels.lp24_refined_blockrate(y, sections, cblock)
    if fidelity is not None:
        raise ValueError(f"unknown filter fidelity {fidelity!r}")
    return iir_kernels.lp24_blockrate(y, sections, cblock)


# --------------------------------------------------------------------------
# Coefficient design, backend-generic like the reference's: numpy f32 for
# host inputs, torch f32 when any input is a tensor.


class _Numpy:
    """numpy float32: the reference's host expressions, op for op."""

    pi = np.pi
    cos, sin, tan, sqrt = np.cos, np.sin, np.tan, np.sqrt
    maximum, zeros_like, ones_like = np.maximum, np.zeros_like, np.ones_like

    @staticmethod
    def asarray(v):
        return np.asarray(v, np.float32)

    @staticmethod
    def pow10(e):
        return 10.0 ** e

    @staticmethod
    def div(a, b):
        return a / b


class _Torch:
    """torch float32 on one device; transcendentals in float64, rounded
    once to float32 (device-independent bits). A quotient with a Python
    number on either side goes through div: torch's own operators
    multiply by a reciprocal there (a CUDA tensor divided by a number;
    any number divided by a tensor), which rounds differently from the
    reference's true division and, for the former, from the CPU."""

    pi = math.pi
    sqrt, zeros_like, ones_like = torch.sqrt, torch.zeros_like, \
        torch.ones_like

    def __init__(self, device):
        self.device = device

    def asarray(self, v):
        return as_f32(v, self.device)

    @staticmethod
    def cos(v):
        return torch.cos(v.double()).float()

    @staticmethod
    def sin(v):
        return torch.sin(v.double()).float()

    @staticmethod
    def tan(v):
        return torch.tan(v.double()).float()

    @staticmethod
    def pow10(e):
        return torch.pow(10.0, e.double()).float()

    @staticmethod
    def maximum(v, lo):
        return torch.clamp_min(v, lo)

    def div(self, a, b):
        return torch.div(self.asarray(a), self.asarray(b))


def _coef_ns(*vals):
    """numpy for host inputs, torch when any input is a tensor."""
    for v in vals:
        if torch.is_tensor(v):
            return _Torch(v.device)
    return _Numpy


def _norm(b0, b1, b2, a0, a1, a2):
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def _w0(cutoff, sample_rate, ns):
    return ns.div(2.0 * ns.pi * cutoff, sample_rate)


def _f32(ns, *vals):
    return tuple(ns.asarray(v) for v in vals)


def rbj_low_pass(cutoff, q, sample_rate):
    ns = _coef_ns(cutoff, q)
    cutoff, q = _f32(ns, cutoff, q)
    w0 = _w0(cutoff, sample_rate, ns)
    cw, sw = ns.cos(w0), ns.sin(w0)
    alpha = sw / (2.0 * q)
    # 1-cos(w0) == 2 sin^2(w0/2): cancellation-free at low cutoffs
    one_minus_cw = 2.0 * ns.sin(w0 / 2.0) ** 2
    return _norm(
        one_minus_cw / 2, one_minus_cw, one_minus_cw / 2,
        1 + alpha, -2 * cw, 1 - alpha,
    )


def rbj_high_pass(cutoff, q, sample_rate):
    ns = _coef_ns(cutoff, q)
    cutoff, q = _f32(ns, cutoff, q)
    w0 = _w0(cutoff, sample_rate, ns)
    cw, sw = ns.cos(w0), ns.sin(w0)
    alpha = sw / (2.0 * q)
    one_plus_cw = 2.0 * ns.cos(w0 / 2.0) ** 2
    return _norm(
        one_plus_cw / 2, -one_plus_cw, one_plus_cw / 2,
        1 + alpha, -2 * cw, 1 - alpha,
    )


def _alpha_bw_hz(w0, cutoff, bandwidth_hz, ns):
    """alpha from a bandwidth in Hz: Q = cutoff / bandwidth."""
    q = cutoff / ns.maximum(bandwidth_hz, 1e-6)
    return ns.sin(w0) / (2.0 * q)


def rbj_band_pass(cutoff, bandwidth, sample_rate):
    """Constant 0 dB peak gain variant (cookbook's second BPF form)."""
    ns = _coef_ns(cutoff, bandwidth)
    cutoff, bandwidth = _f32(ns, cutoff, bandwidth)
    w0 = _w0(cutoff, sample_rate, ns)
    cw = ns.cos(w0)
    alpha = _alpha_bw_hz(w0, cutoff, bandwidth, ns)
    return _norm(alpha, ns.zeros_like(alpha), -alpha, 1 + alpha, -2 * cw,
                 1 - alpha)


def rbj_band_stop(cutoff, bandwidth, sample_rate):
    ns = _coef_ns(cutoff, bandwidth)
    cutoff, bandwidth = _f32(ns, cutoff, bandwidth)
    w0 = _w0(cutoff, sample_rate, ns)
    cw = ns.cos(w0)
    alpha = _alpha_bw_hz(w0, cutoff, bandwidth, ns)
    one = ns.ones_like(alpha)
    return _norm(one, -2 * cw, one, 1 + alpha, -2 * cw, 1 - alpha)


def rbj_all_pass(cutoff, q, sample_rate):
    ns = _coef_ns(cutoff, q)
    cutoff, q = _f32(ns, cutoff, q)
    w0 = _w0(cutoff, sample_rate, ns)
    cw, sw = ns.cos(w0), ns.sin(w0)
    alpha = sw / (2.0 * q)
    return _norm(1 - alpha, -2 * cw, 1 + alpha, 1 + alpha, -2 * cw, 1 - alpha)


def rbj_peaking_eq(cutoff, q, db_gain, sample_rate):
    ns = _coef_ns(cutoff, q, db_gain)
    cutoff, q, db_gain = _f32(ns, cutoff, q, db_gain)
    w0 = _w0(cutoff, sample_rate, ns)
    cw, sw = ns.cos(w0), ns.sin(w0)
    a = ns.pow10(ns.div(db_gain, 40.0))
    alpha = sw / (2.0 * q)
    return _norm(
        1 + alpha * a, -2 * cw, 1 - alpha * a, 1 + alpha / a, -2 * cw,
        1 - alpha / a
    )


def _shelf_alpha(w0, a, slope, ns):
    sw = ns.sin(w0)
    return sw / 2.0 * ns.sqrt((a + 1.0 / a) * (1.0 / slope - 1.0) + 2.0)


def rbj_low_shelf(cutoff, db_gain, sample_rate, slope=1.0):
    ns = _coef_ns(cutoff, db_gain)
    cutoff, db_gain = _f32(ns, cutoff, db_gain)
    w0 = _w0(cutoff, sample_rate, ns)
    cw = ns.cos(w0)
    a = ns.pow10(ns.div(db_gain, 40.0))
    alpha = _shelf_alpha(w0, a, slope, ns)
    two_sqrt_a_alpha = 2.0 * ns.sqrt(a) * alpha
    return _norm(
        a * ((a + 1) - (a - 1) * cw + two_sqrt_a_alpha),
        2 * a * ((a - 1) - (a + 1) * cw),
        a * ((a + 1) - (a - 1) * cw - two_sqrt_a_alpha),
        (a + 1) + (a - 1) * cw + two_sqrt_a_alpha,
        -2 * ((a - 1) + (a + 1) * cw),
        (a + 1) + (a - 1) * cw - two_sqrt_a_alpha,
    )


def rbj_high_shelf(cutoff, db_gain, sample_rate, slope=1.0):
    ns = _coef_ns(cutoff, db_gain)
    cutoff, db_gain = _f32(ns, cutoff, db_gain)
    w0 = _w0(cutoff, sample_rate, ns)
    cw = ns.cos(w0)
    a = ns.pow10(ns.div(db_gain, 40.0))
    alpha = _shelf_alpha(w0, a, slope, ns)
    two_sqrt_a_alpha = 2.0 * ns.sqrt(a) * alpha
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
    float32 (numpy for host inputs, torch for tensors). `cutoff`/`q` may
    be arrays (per-block automation)."""
    ns = _coef_ns(cutoff, q)
    cutoff = ns.asarray(cutoff)
    q = ns.asarray(q)
    fs = sample_rate
    wp = 2.0 * fs * ns.tan(ns.div(ns.pi * cutoff, fs))
    gain = ns.ones_like(cutoff)
    sections = []
    for b1s in _LP24_B1:
        # s-domain denominator (1, b1s/q, 1) prewarped: b2/wp^2, b1/wp
        b0s = 1.0
        b1p = ns.div(b1s, q) / wp
        b2p = 1.0 / (wp * wp)
        # bilinear; the constant numerator maps to (1, 2, 1)
        ad = ns.ones_like(cutoff)
        bd = 4.0 * b2p * fs * fs + 2.0 * b1p * fs + b0s
        gain = gain * ad / bd
        beta1 = (2.0 * b0s - 8.0 * b2p * fs * fs) / bd
        beta2 = (4.0 * b2p * fs * fs - 2.0 * b1p * fs + b0s) / bd
        alpha1 = 2.0 * ns.ones_like(cutoff)
        alpha2 = ns.ones_like(cutoff)
        sections.append((ns.ones_like(cutoff), alpha1, alpha2, beta1, beta2))
    return gain, sections


def lp24_apply(x: torch.Tensor, cutoff, q, sample_rate,
               axis: int = -1) -> torch.Tensor:
    """Run the 24 dB low-pass cascade; cutoff/q broadcast against x (per
    sample, or scalars). Along the last axis both sections run fused in one
    K6 call (iir_kernels.lp24_cascade), as the reference's does with Pallas
    available. Along another axis each section goes to biquad_best on x
    with that axis moved last, its coefficients broadcast against the
    moved x as the reference's biquad takes them (its XLA scan there is
    not ported: the kernels replace it)."""
    gain, sections = lp24_sections(cutoff, q, sample_rate)
    y = x * (float(gain) if is_scalar(gain) else as_f32(gain, x.device))
    if axis == -1:
        return iir_kernels.lp24_cascade(y, sections)
    y = y.movedim(axis, -1)
    for sec in sections:
        y = biquad_best(y, sec)
    return y.movedim(-1, axis)
