"""The carried-state kernels of the segment-streamed render, S1-S4 (the
recurrences groove_tpu/ops/stream.py leaves to XLA scans; no Pallas
kernel in the reference):

  S1  scan_stream        one_pole_stream (:114), max_decay_stream (:385):
                         csrc/scan_stream.cu, y0 [R] in, y_last out;
  S2  comb_stream        comb_feedback_stream(_automated) (:253, :275),
      allpass_stream     allpass_stream (:302): csrc/comb_stream.cu, the
                         delay-line tails [R, D] in and out;
  S3  biquad_state       biquad_stream (:44), iir.biquad(block=64,
                         initial_state, return_state): csrc/biquad.cu
                         biquad_tiled_state (K5's scalar, K4's block and
                         K9's sample modes on csrc/tiled.cuh at ln = 64,
                         the chain seeded by the state and exporting it);
  S4  biquad_serial_state
                         biquad_serial_stream (:63): csrc/serial.cu
                         biquad_serial_state, (s1, s2) in and out.

Every recurrence runs on a grid fixed in song time — the 64-frame block
for S1 and S3, the delay length D for S2, the sample for S4 — never on
the offline path's length-dependent choices (scan_kernels.chunk_for,
iir_kernels.geometry), so a song cut into any 64-multiple segments gives
the bits of one segment (tests/test_torch_stream_ops.py).

Each kernel has its plain twin here in the same operation order, in torch
(S3 reuses the K4/K5/K9 twin's phase 1 and chain of ops/iir_kernels.py,
whose fused multiply-adds are fma32) or, for S4's loop over samples, in
numpy float32 scalars on the host; kernels build with -fmad=false, so
kernel and twin agree bit for bit. A CPU tensor runs the twin, a CUDA
tensor the kernel (LAUNCHES counts its calls); there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.ops.biquad_kernels import _prepare_serial, _streams
from groove_tpu_torch.ops.iir_kernels import (BLOCK as BLOCK_MODE, SAMPLE,
                                              SCALAR, as_f32, block_views,
                                              chain, check_input, dispatch,
                                              fold_back, is_scalar, phase1,
                                              ptr, raw_stream, rows_of,
                                              scalar32, stream_of,
                                              strides_of, tiled_buffers)

STREAM_BLOCK = 64
LINEAR, MAX_DECAY = 0, 1   # csrc/scan_stream.cu Mode
COMB, ALLPASS = 0, 1       # csrc/comb_stream.cu Mode
LAUNCHES = {"scan_stream": 0, "comb_stream": 0, "biquad_stream": 0,
            "biquad_serial_stream": 0}


def _check_len(n: int, what: str) -> None:
    if n <= 0 or n % STREAM_BLOCK:
        raise ValueError(f"{what} needs a positive multiple of "
                         f"{STREAM_BLOCK} samples, got {n}")


def _rows(v, x: torch.Tensor, R: int) -> torch.Tensor:
    """A per-row value (number or tensor broadcastable to x.shape[:-1]) as
    a contiguous float32 [R] tensor on x's device."""
    t = as_f32(v, x.device).expand(x.shape[:-1]).reshape(R)
    return t.contiguous()


def _time_rows(c, x: torch.Tensor, R: int, S: int):
    """A coefficient as the stream kernels read it: a float32 value, or a
    float32 [R, S] view, contiguous in time, whose rows may broadcast
    (stride 0)."""
    if not torch.is_tensor(c):
        return float(np.float32(c))
    t = c.to(device=x.device, dtype=torch.float32).expand(x.shape)
    t = t.reshape(R, S)
    return t if t.stride(-1) == 1 else t.contiguous()


def _value_args(c) -> list:
    """(pointer, value, row stride) of a _time_rows coefficient."""
    if torch.is_tensor(c):
        return [ptr(c), 0.0, c.stride(0)]
    return [ptr(None), c, 0]


# --------------------------------------------------------------------------
# S1: first-order scans with a carried value


def scan_stream(x: torch.Tensor, a, b=1.0, y0=0.0, mode: int = LINEAR):
    """y[k] = a[k] y[k-1] + b[k] x[k] (LINEAR) or max(x[k], a[k] y[k-1])
    (MAX_DECAY) along the last axis of x [..., S] (S a multiple of 64),
    y[-1] = y0 (broadcastable to x.shape[:-1]). a and b: numbers or
    tensors broadcastable to x; b x is formed first. Returns (y,
    y_last)."""
    if mode not in (LINEAR, MAX_DECAY):
        raise ValueError(f"scan_stream: no mode {mode}")
    S = x.shape[-1]
    _check_len(S, "scan_stream")
    x2 = rows_of(x, "scan_stream")
    R = x2.shape[0]
    ca = _time_rows(a, x, R, S)
    cb = _time_rows(b, x, R, S) if mode == LINEAR else 1.0
    yr = _rows(y0, x, R)
    y, last = dispatch(x2, lambda: _scan_plain(x2, ca, cb, yr, mode),
                       lambda: _launch_scan(x2, ca, cb, yr, mode),
                       "scan_stream", LAUNCHES, "scan_stream kernel")
    return y.reshape(x.shape), last.reshape(x.shape[:-1])


def _launch_scan(x2, ca, cb, y0, mode):
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "scan_stream kernel")
    R, S = x2.shape
    nb = S // STREAM_BLOCK
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty((R, S), **f32)
    last = torch.empty((R,), **f32)
    blk = torch.empty((R, nb, 2), **f32)
    entry = torch.empty((R, nb), **f32)
    err = library().scan_stream(
        mode, ptr(x2), x2.stride(0), *_value_args(ca), *_value_args(cb),
        ptr(y0), ptr(last), ptr(y), ptr(blk), ptr(entry), R, S,
        stream_of(x2))
    if err:
        raise RuntimeError(f"scan_stream kernel launch failed: CUDA error "
                           f"{err}")
    return y, last


def _scan_plain(x2, a, b, y0, mode):
    """The kernel's three passes in torch: each 64-block folded from its
    first element, the chain of blocks from y0, then y = C + A e
    (max_decay: max(C, A e))."""
    R, S = x2.shape
    nb = S // STREAM_BLOCK
    v = (b * x2 if mode == LINEAR else x2).reshape(R, nb, STREAM_BLOCK)
    ab = a.reshape(R, nb, STREAM_BLOCK) if torch.is_tensor(a) else None
    As, Cs = [], []
    for j in range(STREAM_BLOCK):
        aj = ab[..., j] if ab is not None else a
        vj = v[..., j]
        if j == 0:
            A = aj if ab is not None else torch.full_like(vj, aj)
            C = vj
        elif mode == LINEAR:
            C = aj * C + vj
            A = aj * A
        else:
            C = torch.maximum(vj, C * aj)
            A = A * aj
        As.append(A)
        Cs.append(C)
    A = torch.stack(As, -1)
    C = torch.stack(Cs, -1)
    entry = torch.empty((R, nb), dtype=torch.float32, device=x2.device)
    y = y0
    Ae, Ce = A[..., -1], C[..., -1]
    for k in range(nb):
        entry[:, k] = y
        y = Ae[:, k] * y + Ce[:, k] if mode == LINEAR \
            else torch.maximum(Ce[:, k], Ae[:, k] * y)
    e = entry[..., None]
    out = C + A * e if mode == LINEAR else torch.maximum(C, A * e)
    return out.reshape(R, S), y


def scan_stream_plain(x: torch.Tensor, a, b=1.0, y0=0.0,
                      mode: int = LINEAR):
    """S1's twin on x's device, whatever the device."""
    S = x.shape[-1]
    _check_len(S, "scan_stream")
    x2 = rows_of(x, "scan_stream")
    R = x2.shape[0]
    cb = _time_rows(b, x, R, S) if mode == LINEAR else 1.0
    y, last = _scan_plain(x2, _time_rows(a, x, R, S), cb, _rows(y0, x, R),
                          mode)
    return y.reshape(x.shape), last.reshape(x.shape[:-1])


# --------------------------------------------------------------------------
# S2: combs and all-passes with carried delay-line tails


def _allpass_constants(g: float):
    """g, -g and 1 - g^2 as the reference's Python float64 expressions,
    each rounded once to float32."""
    g = float(g)
    return (float(np.float32(g)), float(np.float32(-g)),
            float(np.float32(1.0 - g * g)))


def _tails(h, x2: torch.Tensor) -> torch.Tensor:
    R = x2.shape[0]
    t = h.to(device=x2.device, dtype=torch.float32)
    return t.reshape(R, t.shape[-1]).contiguous()


def comb_stream(x: torch.Tensor, hist_x, hist_y, g):
    """y[t] = x[t-D] + g[t] y[t-D] along the last axis of x [..., S], the
    samples before it from the tails hist_x, hist_y [..., D]; g a number or
    a tensor broadcastable to x. Returns (y, hist_x', hist_y'), the new
    tails the last D samples of concat(tail, segment)."""
    D = hist_x.shape[-1]
    x2 = rows_of(x, "comb_stream")
    R, S = x2.shape
    hx, hy = _tails(hist_x, x2), _tails(hist_y, x2)
    cg = _time_rows(g, x, R, S)
    y, hx2, hy2 = dispatch(
        x2, lambda: _comb_plain(x2, cg, hx, hy),
        lambda: _launch_comb(COMB, x2, cg, 0.0, 0.0, hx, hy),
        "comb_stream", LAUNCHES, "comb_stream kernel")
    tail = x.shape[:-1] + (D,)
    return y.reshape(x.shape), hx2.reshape(tail), hy2.reshape(tail)


def allpass_stream(x: torch.Tensor, hist_w, g: float):
    """Schroeder all-pass w[t] = x[t] + g w[t-D], y[t] = -g x[t] +
    (1 - g^2) w[t-D] along the last axis of x [..., S], the w samples
    before it from the tail hist_w [..., D]; g a number. Returns (y,
    hist_w')."""
    D = hist_w.shape[-1]
    x2 = rows_of(x, "allpass_stream")
    hw = _tails(hist_w, x2)
    gv, ng, c1 = _allpass_constants(g)
    y, hw2 = dispatch(
        x2, lambda: _allpass_plain(x2, gv, ng, c1, hw),
        lambda: _launch_comb(ALLPASS, x2, gv, ng, c1, hw, None),
        "comb_stream", LAUNCHES, "comb_stream kernel")
    return y.reshape(x.shape), hw2.reshape(x.shape[:-1] + (D,))


def _launch_comb(mode, x2, g, ng, c1, hx, hy):
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "comb_stream kernel")
    R, S = x2.shape
    D = hx.shape[1]
    y = torch.empty_like(x2)
    hx2 = torch.empty_like(hx)
    hy2 = torch.empty_like(hx) if hy is not None else None
    pg, gv, grs = _value_args(g)
    err = library().comb_stream(
        mode, ptr(x2), pg, gv, grs, ng, c1, ptr(hx), ptr(hy), ptr(hx2),
        ptr(hy2), ptr(y), R, S, D, stream_of(x2))
    if err:
        raise RuntimeError(f"comb_stream kernel launch failed: CUDA error "
                           f"{err}")
    return (y, hx2, hy2) if mode == COMB else (y, hx2)


def _chunks(t: torch.Tensor, D: int) -> torch.Tensor:
    """[R, S] -> [R, nc, D], zero-padded to whole chunks."""
    R, S = t.shape
    nc = -(-S // D)
    return torch.nn.functional.pad(t, (0, nc * D - S)).reshape(R, nc, D)


def _tail(hist: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The last D samples of concat(hist, seg)."""
    D = hist.shape[-1]
    return torch.cat([hist, seg], -1)[:, -D:].contiguous()


def _comb_plain(x2, g, hx, hy):
    """The reference's chunk walk: chunk c's input is chunk c - 1 of x
    (chunk -1 the tail), y = x_prev + g y_prev a chunk at a time."""
    R, S = x2.shape
    D = hx.shape[1]
    xc = _chunks(x2, D)
    gc = _chunks(g, D) if torch.is_tensor(g) else None
    y = hy
    ys = []
    for c in range(xc.shape[1]):
        xp = hx if c == 0 else xc[:, c - 1]
        y = xp + (gc[:, c] if gc is not None else g) * y
        ys.append(y)
    y = torch.stack(ys, 1).reshape(R, -1)[:, :S].contiguous()
    return y, _tail(hx, x2), _tail(hy, y)


def _allpass_plain(x2, g, ng, c1, hw):
    R, S = x2.shape
    D = hw.shape[1]
    xc = _chunks(x2, D)
    w = hw
    ys, ws = [], []
    for c in range(xc.shape[1]):
        xch = xc[:, c]
        ys.append(ng * xch + c1 * w)
        w = xch + g * w
        ws.append(w)
    y = torch.stack(ys, 1).reshape(R, -1)[:, :S].contiguous()
    w = torch.stack(ws, 1).reshape(R, -1)[:, :S]
    return y, _tail(hw, w)


def comb_stream_plain(x, hist_x, hist_y, g):
    """S2's comb twin on x's device, whatever the device."""
    D = hist_x.shape[-1]
    x2 = rows_of(x, "comb_stream")
    R, S = x2.shape
    y, hx2, hy2 = _comb_plain(x2, _time_rows(g, x, R, S),
                              _tails(hist_x, x2), _tails(hist_y, x2))
    tail = x.shape[:-1] + (D,)
    return y.reshape(x.shape), hx2.reshape(tail), hy2.reshape(tail)


def allpass_stream_plain(x, hist_w, g: float):
    """S2's all-pass twin on x's device, whatever the device."""
    x2 = rows_of(x, "allpass_stream")
    y, hw2 = _allpass_plain(x2, *_allpass_constants(g), _tails(hist_w, x2))
    return y.reshape(x.shape), hw2.reshape(x.shape[:-1] + (hist_w.shape[-1],))


# --------------------------------------------------------------------------
# S3: one biquad section, two-level scheme at ln = 64, state in and out


def _state(state, x: torch.Tensor, R: int) -> torch.Tensor:
    """(s1, s2), each broadcastable to x.shape[:-1], as contiguous float32
    [R, 2]."""
    return torch.stack([_rows(state[0], x, R), _rows(state[1], x, R)], -1)


def _coef_mode(coefs, S: int) -> int:
    """SCALAR for five numbers, BLOCK when the tensors hold one entry per
    64-frame block (last axis S / 64), SAMPLE for one per sample."""
    if all(is_scalar(c) for c in coefs):
        return SCALAR
    last = {c.shape[-1] for c in coefs if not is_scalar(c)
            and np.ndim(c) > 0}
    nb = S // STREAM_BLOCK
    if last <= {nb, 1} and nb != S and nb in last:
        return BLOCK_MODE
    if last <= {S, 1}:
        return SAMPLE
    raise ValueError(f"biquad_state: coefficients with last axes {last} "
                     f"fit neither {nb} blocks nor {S} samples")


def biquad_state(x: torch.Tensor, coefs, state):
    """One TDF2 section (b0, b1, b2, a1, a2) over x [..., S] (S a multiple
    of 64) from the state (s1, s2) entering it, on the two-level scheme
    with 64-sample blocks. coefs: five numbers (static), or tensors
    broadcastable to x.shape[:-1] + (S / 64,) (one set per 64-frame block)
    or to x.shape (one per sample). Returns (y, (s1', s2'))."""
    S = x.shape[-1]
    _check_len(S, "biquad_state")
    mode = _coef_mode(coefs, S)
    if mode == SCALAR:
        x2 = rows_of(x, "biquad_state")
        views = None
    else:
        x2, views = block_views(x, coefs, "biquad_state",
                                per_sample=mode == SAMPLE)
    R = x2.shape[0]
    st = _state(state, x, R)
    count = {SCALAR: 1, BLOCK_MODE: S // STREAM_BLOCK, SAMPLE: S}[mode]
    y, st2 = dispatch(
        x2, lambda: _biquad_plain(x2, _streams(x2, coefs if views is None
                                               else views, mode, count), st),
        lambda: _launch_biquad(x2, mode, coefs, views, st),
        "biquad_stream", LAUNCHES, "biquad_stream kernel")
    shape = x.shape[:-1]
    return y.reshape(x.shape), (st2[:, 0].reshape(shape),
                                st2[:, 1].reshape(shape))


def biquad_state_plain(x: torch.Tensor, coefs, state):
    """S3's twin on x's device, whatever the device."""
    S = x.shape[-1]
    _check_len(S, "biquad_state")
    mode = _coef_mode(coefs, S)
    x2 = rows_of(x, "biquad_state")
    R = x2.shape[0]
    if mode != SCALAR:
        x2, coefs = block_views(x, coefs, "biquad_state",
                                per_sample=mode == SAMPLE)
    count = {SCALAR: 1, BLOCK_MODE: S // STREAM_BLOCK, SAMPLE: S}[mode]
    y, st2 = _biquad_plain(x2, _streams(x2, coefs, mode, count),
                           _state(state, x, R))
    shape = x.shape[:-1]
    return y.reshape(x.shape), (st2[:, 0].reshape(shape),
                                st2[:, 1].reshape(shape))


def _launch_biquad(x2, mode, coefs, views, st):
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "biquad_stream kernel")
    B, n = x2.shape
    (y,), _scratch, ptrs = tiled_buffers(x2, STREAM_BLOCK, outputs=1,
                                         pairs=2)
    st2 = torch.empty_like(st)
    if views is None:
        arrays, strides, count = [None] * 5, None, 1
        values = [scalar32(c) for c in coefs]
    else:
        arrays, strides, count = views, strides_of(views), views[0].shape[1]
        values = [0.0] * 5
    err = library().biquad_tiled_state(
        mode, x2.data_ptr(), *(ptr(a) for a in arrays), strides, count,
        *values, y.data_ptr(), *ptrs, st.data_ptr(), st2.data_ptr(), B, n,
        raw_stream(x2.device))
    if err:
        raise RuntimeError(f"biquad_stream kernel launch failed: CUDA "
                           f"error {err}")
    return y, st2


def _biquad_plain(x2, streams, st):
    """K4/K5/K9's twin at ln = 64 with the chain seeded by st [B, 2]:
    phase 1, the chain (exporting its exit state), the combine."""
    B, n = x2.shape
    nb = n // STREAM_BLOCK
    na1, na2, b1m, b2m, b0 = streams.per_sample(B, n, x2.device)
    fold = lambda v: v.reshape(B, nb, STREAM_BLOCK)  # noqa: E731
    p11, p12, q1, m, c = phase1(fold(na1), fold(na2), fold(b1m), fold(b2m),
                                fold(x2), STREAM_BLOCK)
    s, exit_state = chain(m, c, st)
    y = b0 * x2 + fold_back(p11 * s[..., 0:1] + p12 * s[..., 1:2] + q1)
    return y.contiguous(), exit_state


# --------------------------------------------------------------------------
# S4: the per-sample serial scan, state in and out


def biquad_serial_state(x: torch.Tensor, coefs, state):
    """Per-sample TDF2 scan over x [..., S] from the state (s1, s2); coefs
    five numbers or per-sample tensors broadcastable to x.shape. Returns
    (y, (s1', s2'))."""
    x2, st = _prepare_serial(x, coefs)
    R = x2.shape[0]
    s0 = _state(state, x, R)
    y, st2 = dispatch(x2, lambda: _serial_plain(x2, st, s0),
                      lambda: _launch_serial(x2, st, s0),
                      "biquad_serial_stream", LAUNCHES,
                      "biquad_serial_stream kernel")
    shape = x.shape[:-1]
    return y.reshape(x.shape), (st2[:, 0].reshape(shape),
                                st2[:, 1].reshape(shape))


def biquad_serial_state_plain(x: torch.Tensor, coefs, state):
    """S4's twin on x's device, whatever the device."""
    x2, st = _prepare_serial(x, coefs)
    y, st2 = _serial_plain(x2, st, _state(state, x, x2.shape[0]))
    shape = x.shape[:-1]
    return y.reshape(x.shape), (st2[:, 0].reshape(shape),
                                st2[:, 1].reshape(shape))


def _launch_serial(x2, st, s0):
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "biquad_serial_stream kernel")
    st.check(x2, "biquad_serial_stream kernel")
    B, n = x2.shape
    stride = -(-n // 4) * 4
    if stride != n or x2.data_ptr() % 16:
        xp = torch.zeros((B, stride), dtype=torch.float32, device=x2.device)
        xp[:, :n] = x2
        x2 = xp
    y = torch.empty((B, stride), dtype=torch.float32, device=x2.device)
    s1 = torch.empty_like(s0)
    err = library().biquad_serial_state(
        st.mode, ptr(x2), *(ptr(t) for t in st.arrays), *st.values,
        *st.layout, ptr(y), B, n, stride, ptr(s0), ptr(s1), stream_of(x2))
    if err:
        raise RuntimeError(f"biquad_serial_stream kernel launch failed: "
                           f"CUDA error {err}")
    return y[:, :n], s1


def _serial_plain(x2, st, s0):
    """The serial kernel's loop over samples from the state s0 [B, 2],
    row by row; returns (y, exit state [B, 2]) on x2's device. The loop
    runs on numpy float32 scalars on the host (each multiply and add
    rounded once, as the kernel's): a loop of torch calls would cost a
    dispatch, on a card a launch, an operation."""
    B, n = x2.shape
    x = x2.detach().cpu().numpy().astype(np.float32, copy=False)
    if st.mode == SCALAR:
        coefs = [np.full((B, n), v, np.float32) for v in st.values]
    else:
        coefs = [t.expand(B, n).cpu().numpy() for t in st.arrays]
    b0, b1, b2, a1, a2 = coefs
    bx0, bx1, bx2 = (b * x for b in (b0, b1, b2))
    s = s0.detach().cpu().numpy()
    y = np.empty((B, n), np.float32)
    exit_state = np.empty((B, 2), np.float32)
    for r in range(B):
        s1, s2 = s[r, 0], s[r, 1]
        c0, c1, c2 = bx0[r].tolist(), bx1[r].tolist(), bx2[r].tolist()
        p1, p2 = a1[r], a2[r]
        yr = y[r]
        for k in range(n):
            yn = np.float32(c0[k]) + s1
            s1, s2 = (np.float32(c1[k]) - p1[k] * yn + s2,
                      np.float32(c2[k]) - p2[k] * yn)
            yr[k] = yn
        exit_state[r] = (s1, s2)
    return (torch.from_numpy(y).to(x2.device),
            torch.from_numpy(exit_state).to(x2.device))
