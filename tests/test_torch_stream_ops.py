"""groove_tpu_torch/ops/stream.py, the carried-state ops of the streamed
render, on the CPU twins of S1-S4 (ops/stream_kernels.py): each op against
groove_tpu/ops/stream.py on the same seeded inputs (outputs and exported
state within dBFS bars set about 8 dB above the measured residual, the
gathers bit for bit), and each op chained over segments of 64-multiple
lengths equal to one call bit for bit (the comb at a segment length that
is no multiple of its delay, and shorter than it). The kernels themselves
are held to these twins on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groove_tpu.ops import iir as jiir
from groove_tpu.ops import stream as jops
from groove_tpu_torch.ops import stream as tops
from groove_tpu_torch.ops import stream_kernels as sk

SR = 44100.0
S = 4096
RNG = np.random.default_rng(7)
X = (RNG.standard_normal((2, S)) * 0.3).astype(np.float32)
A = RNG.uniform(0.9, 0.999, S).astype(np.float32)
Y0 = np.array([0.1, -0.2], np.float32)
HX = (RNG.standard_normal((2, 1310)) * 0.1).astype(np.float32)
HY = (RNG.standard_normal((2, 1310)) * 0.1).astype(np.float32)
G = RNG.uniform(0.5, 0.9, S).astype(np.float32)
CUT = np.geomspace(200.0, 8000.0, S // 64).astype(np.float32)
STATE = (np.array([0.01, 0.02], np.float32), np.array([0.0, -0.01],
                                                      np.float32))


def _t(v):
    return torch.from_numpy(np.array(v, copy=True))


def _j(v):
    return jnp.asarray(v)


def _block_coefs():
    return [np.asarray(c, np.float32)
            for c in jiir.rbj_low_pass(CUT, np.float32(0.707), SR)]


def _static(design, *args):
    return [float(c) for c in design(*args, SR)]


def _case(name: str):
    """(port outputs, reference outputs) of one op on the seeded inputs."""
    x = X
    if name == "one_pole":
        return (tops.one_pole_stream(_t(x), _t(A), 1 - _t(A), _t(Y0)),
                jops.one_pole_stream(_j(x), _j(A), 1 - _j(A), _j(Y0)))
    if name == "max_decay":
        m, y0 = np.abs(x), np.abs(Y0)
        return (tops.max_decay_stream(_t(m), 0.999, _t(y0)),
                jops.max_decay_stream(_j(m), 0.999, _j(y0)))
    if name == "follower":
        st = (_t(Y0 * 0 + 0.05), _t(np.abs(Y0)))
        jst = (_j(Y0 * 0 + 0.05), _j(np.abs(Y0)))
        rel = np.repeat(np.linspace(0.05, 0.5, S // 64), 64).astype(
            np.float32)
        return (tops.follower_stream(_t(x), 0.01, _t(rel), SR, *st),
                jops.follower_stream(_j(x), 0.01, _j(rel), SR, *jst))
    if name == "compressor":
        st = (_t(Y0 * 0 + 0.05), _t(np.abs(Y0)))
        jst = (_j(Y0 * 0 + 0.05), _j(np.abs(Y0)))
        return (tops.compressor_smoothed_stream(_t(x), 0.1, 0.3, 0.005, 0.1,
                                                SR, *st),
                jops.compressor_smoothed_stream(_j(x), 0.1, 0.3, 0.005, 0.1,
                                                SR, *jst))
    if name == "delay":
        return (tops.delay_stream(_t(x), _t(HX)),
                jops.delay_stream(_j(x), _j(HX)))
    if name == "delay_automated":
        d = np.linspace(0.001, 0.029, S // 64).astype(np.float32)
        return (tops.delay_stream_automated(_t(x), _t(HX), _t(d), SR),
                jops.delay_stream_automated(_j(x), _j(HX), _j(d), SR))
    if name == "chorus":
        return (tops.chorus_stream(_t(x), _t(HX), 3, 1310, 0.7),
                jops.chorus_stream(_j(x), _j(HX), 3, 1310, 0.7))
    if name == "chorus_automated":
        d = np.linspace(0.005, 0.029, S // 64).astype(np.float32)
        v = np.linspace(1.0, 4.0, S // 64).astype(np.float32)
        return (tops.chorus_stream_automated(
                    _t(x), _t(HX), 2, _t(d), SR, 0.8, voices_b=_t(v),
                    max_voices=4),
                jops.chorus_stream_automated(
                    _j(x), _j(HX), 2, _j(d), SR, 0.8, voices_b=_j(v),
                    max_voices=4))
    if name == "comb":
        return (tops.comb_feedback_stream(_t(x), _t(HX), _t(HY), 0.8),
                jops.comb_feedback_stream(_j(x), _j(HX), _j(HY), 0.8))
    if name == "comb_automated":
        return (tops.comb_feedback_stream_automated(_t(x), _t(HX), _t(HY),
                                                    _t(G)),
                jops.comb_feedback_stream_automated(_j(x), _j(HX), _j(HY),
                                                    _j(G)))
    if name == "allpass":
        return (tops.allpass_stream(_t(x), _t(HX[:, :75]), 0.7),
                jops.allpass_stream(_j(x), _j(HX[:, :75]), 0.7))
    if name in ("reverb", "reverb_automated"):
        st = _reverb_state()
        if name == "reverb":
            y, new = tops.reverb_stream(_t(x), {k: _t(v) for k, v in
                                                st.items()}, 0.5, 1.5, SR,
                                        "rv")
            jy, jnew = jops.reverb_stream(_j(x), {k: _j(v) for k, v in
                                                  st.items()}, 0.5, 1.5, SR,
                                          "rv")
        else:
            sec = np.linspace(0.3, 2.0, S // 64).astype(np.float32)
            y, new = tops.reverb_stream_automated(
                _t(x), {k: _t(v) for k, v in st.items()}, 0.5, _t(sec), SR,
                "rv")
            jy, jnew = jops.reverb_stream_automated(
                _j(x), {k: _j(v) for k, v in st.items()}, 0.5, _j(sec), SR,
                "rv")
        keys = sorted(new)
        return ((y, *[new[k] for k in keys]),
                (jy, *[jnew[k] for k in keys]))
    if name == "biquad_static":
        co = _static(jiir.rbj_low_pass, 1000.0, 0.707)
        return (tops.biquad_stream(_t(x), co, tuple(map(_t, STATE))),
                jops.biquad_stream(_j(x), co, tuple(map(_j, STATE))))
    if name == "biquad_block":
        cb = _block_coefs()
        return (tops.biquad_stream(_t(x), [_t(c) for c in cb],
                                   tuple(map(_t, STATE))),
                jops.biquad_stream(_j(x), [_j(np.repeat(c, 64)) for c in cb],
                                   tuple(map(_j, STATE))))
    if name == "biquad_serial":
        co = _static(jiir.rbj_high_pass, 40.0, 0.707)
        return (tops.biquad_stream(_t(x[:, :1024]), co,
                                   tuple(map(_t, STATE)), serial=True),
                jops.biquad_stream(_j(x[:, :1024]), co,
                                   tuple(map(_j, STATE)), serial=True))
    if name == "biquad_refined":
        cb = _block_coefs()
        st = tops.refined_state_init((2,))
        jst = jops.refined_state_init((2,))
        y, st2 = tops.biquad_stream_refined(_t(x), [_t(c) for c in cb], st)
        jy, jst2 = jops.biquad_stream_refined(
            _j(x), [_j(np.repeat(c, 64)) for c in cb], jst)
        keys = sorted(st2)
        return (y, *[st2[k] for k in keys]), (jy, *[jst2[k] for k in keys])
    raise KeyError(name)


def _reverb_state() -> dict:
    from groove_tpu_torch.ops import delayfx

    rng = np.random.default_rng(3)
    st = {}
    for i, d_s in enumerate(delayfx.COMB_DELAYS_S):
        d = max(1, int(round(d_s * SR)))
        for w in "xy":
            st[f"rv/comb{i}/{w}"] = (rng.standard_normal((2, d))
                                     * 0.1).astype(np.float32)
    for i, d_s in enumerate(delayfx.ALLPASS_DELAYS_S):
        d = max(1, int(round(d_s * SR)))
        st[f"rv/ap{i}/w"] = (rng.standard_normal((2, d))
                             * 0.1).astype(np.float32)
    return st


def _flat(v) -> list:
    if isinstance(v, (tuple, list)):
        return [a for t in v for a in _flat(t)]
    return [np.asarray(v, np.float64)]


# op -> dBFS bar on the worst of its outputs and exported state (None: bit
# for bit). Measured on the CPU: one_pole -147.0, max_decay -111.9 (the
# reference's in-block associative tree multiplies r in another order than
# the twin's serial fold), follower -100.8 and compressor -108.4 (a
# per-sample release's exp runs in float64 here, in float32 there), comb
# -142.3, automated -141.7, allpass -146.1, reverb -137.9, automated -138.0,
# a static biquad -122.9, block-rate coefficients and the refined section
# bit for bit on these inputs (-88.6 on others: the two-level scheme's
# in-block maps are fused multiply-adds here, as in K4), the serial scan
# -78.6 at 40 Hz (its deep-corner poles amplify one rounding's change).
BARS = {
    "one_pole": -139.0, "max_decay": -104.0, "follower": -93.0,
    "compressor": -100.0, "delay": None, "delay_automated": None,
    "chorus": None, "chorus_automated": None, "comb": -134.0,
    "comb_automated": -133.0, "allpass": -138.0, "reverb": -130.0,
    "reverb_automated": -130.0, "biquad_static": -115.0,
    "biquad_block": -80.0, "biquad_serial": -70.0, "biquad_refined": -80.0,
}


@pytest.mark.parametrize("name", list(BARS))
def test_twin_matches_reference(name):
    mine, ref = _case(name)
    mine, ref = _flat(mine), _flat(ref)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape
        if BARS[name] is None:
            assert np.array_equal(a, b)
            continue
        peak = max(1.0, float(np.abs(b).max()))
        db = 20.0 * np.log10(float(np.abs(a - b).max()) / peak + 1e-30)
        assert db <= BARS[name], (name, db)


def _pair(out):
    """(y, (s1, s2)) -> (y, s1, s2)."""
    return (out[0], *out[1])


def _chained(fn, cuts, *per_time, extra=(), state=None, n_state=1,
             length=S):
    """fn over [0, length) cut at `cuts`, the state handed on, against one
    call: fn(*per_time parts, *extra, *state) -> (y, *state')."""
    bounds = [0, *cuts, length]
    ys = []
    st = state
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        parts = [p[..., lo:hi] for p in per_time]
        out = fn(*parts, *extra, *st)
        ys.append(out[0])
        st = out[1:1 + n_state]
    whole = fn(*per_time, *extra, *state)
    assert torch.equal(torch.cat(ys, -1), whole[0])
    for a, b in zip(st, whole[1:]):
        assert torch.equal(a, b)


CUTS = [64, 1088, 2048, 3968]


def test_chained_scans_equal_one_call():
    x, a = _t(X), _t(A)
    _chained(lambda xs, aa, y0: tops.one_pole_stream(xs, aa, 1 - aa, y0),
             CUTS, x, a, state=(_t(Y0),))
    _chained(lambda xs, y0: tops.max_decay_stream(xs, 0.999, y0), CUTS,
             x.abs(), state=(_t(np.abs(Y0)),))
    _chained(lambda xs, rel, e, p: tops.follower_stream(xs, 0.01, rel, SR,
                                                        e, p),
             CUTS, x, _t(np.repeat(np.linspace(0.05, 0.5, S // 64), 64)
                         .astype(np.float32)),
             state=(_t(Y0 * 0), _t(Y0 * 0)), n_state=2)


def test_chained_combs_equal_one_call():
    """The comb's delay (1310) divides no segment length; a 64-frame
    segment is shorter than it."""
    x = _t(X)
    _chained(lambda xs, hx, hy: tops.comb_feedback_stream(xs, hx, hy, 0.8),
             [64, 128, 1500, 2900], x, state=(_t(HX), _t(HY)), n_state=2)
    _chained(lambda xs, g, hx, hy: tops.comb_feedback_stream_automated(
        xs, hx, hy, g), CUTS, x, _t(G), state=(_t(HX), _t(HY)), n_state=2)
    _chained(lambda xs, hw: tops.allpass_stream(xs, hw, 0.7), CUTS, x,
             state=(_t(HX[:, :75]),))
    _chained(lambda xs, h: tops.delay_stream(xs, h), CUTS, x,
             state=(_t(HX),))
    _chained(lambda xs, h: tops.chorus_stream(xs, h, 3, 1310, 0.7), CUTS, x,
             state=(_t(HX),))


def test_chained_reverb_equal_one_call():
    st0 = {k: _t(v) for k, v in _reverb_state().items()}
    keys = sorted(st0)

    def fn(xs, sec, *vals):
        y, new = tops.reverb_stream_automated(
            xs, dict(zip(keys, vals)), 0.5, sec[..., ::64], SR, "rv")
        return (y, *[new[k] for k in keys])

    sec = _t(np.repeat(np.linspace(0.3, 2.0, S // 64), 64)
             .astype(np.float32))
    _chained(fn, CUTS, _t(X), sec, state=tuple(st0[k] for k in keys),
             n_state=len(keys))


@pytest.mark.parametrize("route", ["static", "block", "sample", "serial",
                                   "refined"])
def test_chained_biquads_equal_one_call(route):
    x = _t(X)
    cb = [_t(c) for c in _block_coefs()]
    st = tuple(map(_t, STATE))
    if route == "refined":
        keys = sorted(tops.refined_state_init((2,)))

        def fn(xs, *args):
            co, vals = args[:5], args[5:]
            y, st2 = tops.biquad_stream_refined(xs, co, dict(zip(keys,
                                                                 vals)))
            return (y, *[st2[k] for k in keys])

        # the coefficients are block-rate: cut them with the blocks
        bounds = [0, *CUTS, S]
        init = tops.refined_state_init((2,))
        ys, vals = [], [init[k] for k in keys]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out = fn(x[..., lo:hi], *[c[lo // 64:hi // 64] for c in cb],
                     *vals)
            ys.append(out[0])
            vals = out[1:]
        whole = fn(x, *cb, *[init[k] for k in keys])
        assert torch.equal(torch.cat(ys, -1), whole[0])
        for a, b in zip(vals, whole[1:]):
            assert torch.equal(a, b)
        return
    if route == "block":
        bounds = [0, *CUTS, S]
        ys, s = [], st
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            y, s = tops.biquad_stream(x[..., lo:hi],
                                      [c[lo // 64:hi // 64] for c in cb], s)
            ys.append(y)
        y1, s1 = tops.biquad_stream(x, cb, st)
        assert torch.equal(torch.cat(ys, -1), y1)
        assert all(torch.equal(a, b) for a, b in zip(s, s1))
        return
    if route == "sample":
        from groove_tpu_torch.ops.iir import upsample_hold

        per = [upsample_hold(c, S) for c in cb]
        _chained(lambda xs, *rest: _pair(sk.biquad_state(xs, rest[:5],
                                                         rest[5:])),
                 CUTS, x, *per, state=st, n_state=2)
        return
    if route == "static":
        co = _static(jiir.rbj_peaking_eq, 1000.0, 2.0, 6.0)
        _chained(lambda xs, s1, s2: _pair(tops.biquad_stream(xs, co,
                                                             (s1, s2))),
                 CUTS, x, state=st, n_state=2)
        return
    co = _static(jiir.rbj_high_pass, 40.0, 0.707)
    _chained(lambda xs, s1, s2: _pair(tops.biquad_stream(
        xs, co, (s1, s2), serial=True)), [64, 448], x[..., :1024], state=st,
        n_state=2, length=1024)


def test_block_rate_and_per_sample_coefficients_agree():
    """S3 reads a block-rate coefficient per block and the same values held
    per sample identically (the engine hands it block-rate curves)."""
    from groove_tpu_torch.ops.iir import upsample_hold

    cb = [_t(c) for c in _block_coefs()]
    st = tuple(map(_t, STATE))
    y1, s1 = sk.biquad_state(_t(X), cb, st)
    y2, s2 = sk.biquad_state(_t(X), [upsample_hold(c, S) for c in cb], st)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def test_wrappers_refuse_ragged_segments():
    with pytest.raises(ValueError, match="multiple of 64"):
        sk.scan_stream(_t(X[:, :100]), 0.5)
    with pytest.raises(ValueError, match="multiple of 64"):
        sk.biquad_state(_t(X[:, :100]), [1.0, 0.0, 0.0, 0.0, 0.0],
                        (0.0, 0.0))
