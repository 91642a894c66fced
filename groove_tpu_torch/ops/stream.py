"""Stateful (segment-streaming) variants of the stateful DSP ops (port of
groove_tpu/ops/stream.py).

The streaming renderer (engine/stream.py) renders a song in fixed-size
segments with an explicitly carried state. Every op here is
segmentation-invariant bit for bit: for segment lengths that are
multiples of 64 frames, the float operations applied to each sample are
the same wherever the segment boundaries fall, because every recurrence
runs on a grid fixed in song time with strictly serial propagation across
it (ops/stream_kernels.py, S1-S4):

  - biquads run the two-level scheme with 64-sample blocks, entry and
    exit state carried (S3), or the per-sample serial scan (S4);
  - feedback combs and all-passes walk delay-length chunks, each output
    one multiply and one add of values D samples back (S2);
  - the envelope follower's peak hold and one-pole fold within fixed
    64-sample blocks and chain across them (S1).

The delays and the chorus are gathers from concat(tail, segment), which
carry no arithmetic across a seam.

Coefficients: where the reference takes per-sample arrays that hold one
value per 64-frame block (upsampled automation), these ops also take the
block-rate form [..., S / 64] and hand it to the kernels as such; the
refined section's defect, which needs per-sample coefficients, holds them
itself (iir.upsample_hold). The reference's Python float64 constants (the
reverb's comb gains, the all-pass's g and 1 - g^2) round once to float32,
as they do there as weak scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.ops import delayfx, dynamics, iir, stream_kernels
from groove_tpu_torch.ops.iir import _Torch, upsample_hold
from groove_tpu_torch.ops.iir_kernels import is_scalar

STREAM_BLOCK = 64  # the reference's SAMPLE_BUFFER_SIZE / control cadence


def _per_sample(c, n: int):
    """A coefficient as per-sample values: numbers pass, block-rate
    tensors [..., n / 64] (n != n / 64) are held for 64 samples."""
    if is_scalar(c) or not torch.is_tensor(c):
        return c
    nb = n // STREAM_BLOCK
    if c.shape[-1] == nb and nb != n:
        return upsample_hold(c, n, STREAM_BLOCK)
    return c


# --------------------------------------------------------------------------
# biquad with state handoff (block = 64, segmentation-invariant)


def biquad_stream(x, coefs, state, serial: bool = False):
    """One biquad section over a segment; x: [..., S] with S % 64 == 0.
    state: (s1, s2) TDF2 state entering the segment. Returns (y, (s1',
    s2')). serial=True (the host-side fidelity decision) or static
    near-critical poles take the per-sample serial scan (S4); the rest
    the two-level scheme at 64-sample blocks (S3). coefs: numbers, or
    tensors per 64-frame block [..., S / 64] or per sample [..., S]."""
    if serial or iir._near_critical_static(coefs):
        return biquad_serial_stream(x, coefs, state)
    return stream_kernels.biquad_state(x, coefs, state)


def biquad_serial_stream(x, coefs, state):
    """Per-sample TDF2 serial scan with entry/exit state (S4).
    Coefficients: numbers, or tensors per 64-frame block or per sample
    (automated filters in the deep-corner band)."""
    n = x.shape[-1]
    return stream_kernels.biquad_serial_state(
        x, tuple(_per_sample(c, n) for c in coefs), state)


# --------------------------------------------------------------------------
# one-pole and peak hold with state: folded within fixed 64-blocks, serial
# across (S1)


def one_pole_stream(x, a, b, y0):
    """y[n] = a[n] y[n-1] + b[n] x[n] with y[-1] = y0; x: [..., S],
    S % 64 == 0. Returns (y, y_last)."""
    return stream_kernels.scan_stream(x, a, b, y0, stream_kernels.LINEAR)


# --------------------------------------------------------------------------
# pure delay lines (exact: y[n] = x[n-D])


def delay_stream(x, hist):
    """y[n] = x[n-D] with D = hist.shape[-1] (the carried input tail).
    Returns (y, hist'). Exact at any segmentation."""
    d = hist.shape[-1]
    if d == 0:
        return x, hist
    z = torch.cat([hist, x], dim=-1)
    n = x.shape[-1]
    return z[..., :n], z[..., -d:]


def delay_stream_automated(x, hist, delay_seconds_b, sample_rate: float,
                           cblock: int = STREAM_BLOCK):
    """Automated delay time over a segment: hist carries the last D_max
    input samples; y[n] = history[n - D(block(n))] by gather, so
    segmentation is invisible. delay_seconds_b: this segment's block-rate
    curve [S / 64]."""
    d_max = hist.shape[-1]
    n = x.shape[-1]
    z = torch.cat([hist, x], dim=-1)
    d_b = delayfx._samples_b(delay_seconds_b, sample_rate, x.device)
    d_up = torch.clamp_max(upsample_hold(d_b, n, cblock), d_max)
    idx = torch.arange(n, dtype=torch.int32, device=x.device) + d_max - d_up
    y = torch.index_select(z, -1, idx.to(torch.int64))
    return y, (z[..., -d_max:] if d_max else hist)


def chorus_stream(x, hist, voices: int, total_delay: int, wet_dry_mix):
    """Multi-tap chorus over a segment (cf. delayfx.chorus): taps at
    v * total_delay // voices, tap 0 dry. hist: [..., total_delay] input
    tail."""
    voices = max(1, int(voices))
    d = hist.shape[-1]
    z = torch.cat([hist, x], dim=-1)
    n = x.shape[-1]
    wet = torch.zeros_like(x)
    for v in range(voices):
        dv = v * total_delay // voices
        wet = wet + z[..., d - dv:d - dv + n]
    wet = _Torch(x.device).div(wet, voices)
    y = x * (1.0 - wet_dry_mix) + wet * wet_dry_mix
    return y, (z[..., -d:] if d else hist)


def chorus_stream_automated(x, hist, voices, delay_seconds_b,
                            sample_rate: float, wet_dry_mix,
                            cblock: int = STREAM_BLOCK,
                            voices_b=None, max_voices=None):
    """chorus_stream with an automated total delay and/or tap count (cf.
    delayfx.chorus_automated): hist covers the delay curve's maximum and
    every tap is a gather of concat(hist, x) masked by v < V(n).
    delay_seconds_b / voices_b: this segment's block-rate curves [S / 64]
    (delay_seconds_b may be a number when only `voices` is automated)."""
    d = hist.shape[-1]
    n = x.shape[-1]
    z = torch.cat([hist, x], dim=-1)
    d_up, v_up, n_taps = delayfx.chorus_tap_curves(
        delay_seconds_b, voices, voices_b, max_voices, n, sample_rate,
        cblock, device=x.device)
    base = torch.arange(n, dtype=torch.int32, device=x.device) + d
    wet = torch.zeros_like(x)
    for v in range(n_taps):
        dv = torch.clamp_max(
            torch.div(v * d_up, v_up, rounding_mode="floor"), d)
        active = (v < v_up).to(x.dtype)
        wet = wet + torch.index_select(
            z, -1, (base - dv).to(torch.int64)) * active
    wet = _Torch(x.device).div(wet, v_up.to(x.dtype))
    y = x * (1.0 - wet_dry_mix) + wet * wet_dry_mix
    return y, (z[..., -d:] if d else hist)


# --------------------------------------------------------------------------
# feedback comb / all-pass with carried delay-line tails (S2)


def comb_feedback_stream(x, hist_x, hist_y, g):
    """y[n] = x[n-D] + g y[n-D]; hist_x/hist_y: [..., D] carried tails of
    the input/output. Returns (y, hist_x', hist_y')."""
    return stream_kernels.comb_stream(x, hist_x, hist_y, g)


def comb_feedback_stream_automated(x, hist_x, hist_y, g):
    """comb_feedback_stream with a per-sample feedback g [..., n] (an
    automated reverb RT60), read at each sample's absolute position."""
    return stream_kernels.comb_stream(x, hist_x, hist_y, g)


def allpass_stream(x, hist_w, g: float):
    """Schroeder all-pass, one-multiply form (cf. delayfx.allpass):
    w[n] = x[n] + g w[n-D]; y[n] = -g x[n] + (1 - g^2) w[n-D]. hist_w:
    [..., D] carried tail of w. Returns (y, hist_w')."""
    return stream_kernels.allpass_stream(x, hist_w, g)


def _reverb_tail(y, state: dict, prefix: str, new: dict):
    for i, _ in enumerate(delayfx.ALLPASS_DELAYS_S):
        hw = state[f"{prefix}/ap{i}/w"]
        y, hw2 = allpass_stream(y, hw, delayfx.ALLPASS_G)
        new[f"{prefix}/ap{i}/w"] = hw2
    return y


def reverb_stream(x, state: dict, attenuation, seconds: float,
                  sample_rate: float, prefix: str):
    """Schroeder reverb (delayfx.reverb topology) with carried delay-line
    tails: state holds f"{prefix}/comb{i}/x|y" and f"{prefix}/ap{i}/w".
    Returns (y, new entries)."""
    new = {}
    combs = torch.zeros_like(x)
    for i, d_s in enumerate(delayfx.COMB_DELAYS_S):
        d = max(1, int(round(d_s * sample_rate)))
        g = 0.001 ** (d / (seconds * sample_rate)) if seconds > 0 else 0.0
        y, hx2, hy2 = comb_feedback_stream(
            x, state[f"{prefix}/comb{i}/x"], state[f"{prefix}/comb{i}/y"], g)
        new[f"{prefix}/comb{i}/x"] = hx2
        new[f"{prefix}/comb{i}/y"] = hy2
        combs = combs + y
    return attenuation * _reverb_tail(combs, state, prefix, new), new


def reverb_stream_automated(x, state: dict, attenuation, seconds_b,
                            sample_rate: float, prefix: str,
                            cblock: int = STREAM_BLOCK):
    """reverb_stream with an automated `seconds` curve (cf.
    delayfx.reverb_automated): the comb gains follow the block-rate curve
    at the 64-sample control cadence; the all-passes keep their static g.
    seconds_b: this segment's block-rate curve [S / 64]."""
    n = x.shape[-1]
    sec_s = upsample_hold(torch.as_tensor(seconds_b, dtype=torch.float32,
                                          device=x.device), n, cblock)
    new = {}
    combs = torch.zeros_like(x)
    for i, d_s in enumerate(delayfx.COMB_DELAYS_S):
        d = max(1, int(round(d_s * sample_rate)))
        g = delayfx.reverb_comb_g(sec_s, d, sample_rate)
        y, hx2, hy2 = comb_feedback_stream_automated(
            x, state[f"{prefix}/comb{i}/x"], state[f"{prefix}/comb{i}/y"], g)
        new[f"{prefix}/comb{i}/x"] = hx2
        new[f"{prefix}/comb{i}/y"] = hy2
        combs = combs + y
    return attenuation * _reverb_tail(combs, state, prefix, new), new


# --------------------------------------------------------------------------
# envelope follower / smoothed compressor with state (S1)


def max_decay_stream(x, r, y0):
    """Peak hold with exponential release: y[n] = max(x[n], r[n] y[n-1]),
    y[-1] = y0; x: [..., S], S % 64 == 0. Returns (y, y_last)."""
    return stream_kernels.scan_stream(x, r, 1.0, y0,
                                      stream_kernels.MAX_DECAY)


def follower_stream(x, attack_s, release_s, sample_rate, st_env, st_peak):
    """Decoupled peak detector (dynamics.envelope_follower) with carried
    states: release-rate peak hold, then attack-rate one-pole smoothing.
    attack_s/release_s: numbers or [S] tensors. Returns (env, st_env',
    st_peak')."""
    mag = torch.abs(x)
    r = dynamics._follower_coef(release_s, sample_rate)
    peak, st_peak2 = max_decay_stream(mag, r, st_peak)
    a_att = dynamics._follower_coef(attack_s, sample_rate)
    one = 1.0 if torch.is_tensor(a_att) else np.float32(1.0)
    env, st_env2 = one_pole_stream(peak, a_att, one - a_att, st_env)
    return env, st_env2, st_peak2


def compressor_smoothed_stream(x, threshold, ratio, attack_s, release_s,
                               sample_rate, st_env, st_peak):
    env, st_env2, st_peak2 = follower_stream(
        x, attack_s, release_s, sample_rate, st_env, st_peak)
    over = env > threshold
    target = threshold + (env - threshold) * ratio
    g = torch.where(over, torch.div(target, torch.clamp_min(env, 1e-9)),
                    1.0)
    return x * g, st_env2, st_peak2


# --------------------------------------------------------------------------
# defect-correction refinement, streaming form (iir.biquad_blockrate_
# refined with carried histories)


def refined_state_init(batch_shape, coef_batch=(), device="cpu") -> dict:
    """Zero state for biquad_stream_refined: solver TDF2 state,
    correction TDF2 state, 2-sample input/output histories, 2-sample
    histories of the (b1, b2, a1, a2) per-sample coefficient streams.
    coef_batch: leading batch dims of the coefficient arrays, () for
    coefficients shared across rows."""
    b = tuple(batch_shape)

    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    return {"ss1": z(*b), "ss2": z(*b), "cs1": z(*b), "cs2": z(*b),
            "xh": z(*b, 2), "yh": z(*b, 2), "ch": z(4, *coef_batch, 2)}


def _roll_hist(v, hist, k: int):
    """Shift right along the last axis by k, filling from the carried
    history (hist[..., -k:] are the k samples just before the segment)."""
    return torch.cat([hist[..., -k:], v[..., :-k]], dim=-1)


def biquad_stream_refined(x, coefs, st: dict):
    """One biquad section plus the defect-correction pass, segment-
    streamed. x: [..., S]; coefs: tensors per 64-frame block [S / 64] or
    per sample [S] (shared across rows); st from refined_state_init.
    Returns (y, st'). The solve and the correction run on S3; the defect
    is elementwise torch on per-sample coefficients."""
    n = x.shape[-1]
    coefs = tuple(torch.as_tensor(c, dtype=torch.float32, device=x.device)
                  for c in coefs)
    coefs = tuple(c.expand(n) if c.dim() == 0 else c for c in coefs)
    b0, b1, b2, a1, a2 = (_per_sample(c, n) for c in coefs)
    y0, (ss1, ss2) = biquad_stream(x, coefs, (st["ss1"], st["ss2"]))
    b1s = _roll_hist(b1, st["ch"][0], 1)
    b2s = _roll_hist(b2, st["ch"][1], 2)
    a1s = _roll_hist(a1, st["ch"][2], 1)
    a2s = _roll_hist(a2, st["ch"][3], 2)
    x1 = _roll_hist(x, st["xh"], 1)
    x2 = _roll_hist(x, st["xh"], 2)
    y1v = _roll_hist(y0, st["yh"], 1)
    y2v = _roll_hist(y0, st["yh"], 2)
    e1 = a1s + 2.0   # exact for near-critical a1 (Sterbenz)
    e2 = a2s - 1.0
    second = (y0 - y1v) - (y1v - y2v)
    d = (b0 * x + b1s * x1 + b2s * x2) - second - e1 * y1v - e2 * y2v
    ca1, ca2 = coefs[3:5]
    ones, zeros = torch.ones_like(ca1), torch.zeros_like(ca1)
    c, (cs1, cs2) = biquad_stream(d, (ones, zeros, zeros, ca1, ca2),
                                  (st["cs1"], st["cs2"]))
    st2 = {
        "ss1": ss1, "ss2": ss2, "cs1": cs1, "cs2": cs2,
        "xh": x[..., -2:], "yh": y0[..., -2:],
        "ch": torch.stack([b1[..., -2:], b2[..., -2:],
                           a1[..., -2:], a2[..., -2:]]),
    }
    return y0 + c, st2
