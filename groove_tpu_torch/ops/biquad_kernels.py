"""Single-section biquad kernels K4, K5 and K9, and the per-sample serial
scan (port of the biquad family of groove_tpu/ops/pallas_iir.py and of
groove_tpu/ops/iir.py biquad_serial).

One TDF2 section, a0 == 1:
    y[n]  = b0 x[n] + s1[n-1]
    s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
    s2[n] = b2 x[n] - a2 y[n]

K4, K5 and K9 run the reference's two-level scheme (phase 1 in-block
prefix maps, phase 2 the serial cross-block chain, combine
y = b0 x + ((p11 S1 + p12 S2) + q1); see ops/iir_kernels.py) in
csrc/biquad.cu with three coefficient modes. On a card all three run on
shared-memory tiles (biquad_tiled, csrc/tiled.cuh: three launches, x read
twice and y written once, K9's per-sample coefficients staged beside the
tile, from a wrapper that checks, allocates y and one scratch buffer, and
launches):

  K4  biquad_blockrate   one coefficient set per 64-frame control block,
                         ln = max(block_for(n, 128), 64) (_biquad_blk_2d);
  K5  biquad_scalar      static coefficients, ln = block_for(n, 128)
                         (_biquad_scalar_2d);
  K9  biquad_per_sample  one set per sample, ln = block_for(n, 128)
                         (_biquad_ps_2d).

The coefficients reach the kernels as the reference prepares them
(pallas_iir.py:536, :627-628), in f32: -a1, -a2, b1 - a1 b0,
b2 - a2 b0, b0, the two differences rounded once (see _prep).
biquad_serial is the per-sample scan the reference leaves to XLA's
lax.scan, on a kernel of its own (csrc/serial.cu), one thread per row.

Each kernel has its plain torch twin here in the same operation order
(the in-block recurrence's fused multiply-adds are fma32, __fmaf_rn in
the kernel): the CPU runs the twin, a CUDA tensor runs the kernel, and
LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import torch

from groove_tpu_torch.ops.iir_kernels import (BLOCK, CBLOCK, SAMPLE, SCALAR,
                                              Streams, as_f32, block_views,
                                              check_input, dispatch, fma32,
                                              fold_back, geometry, is_scalar,
                                              on_device, phase1, phase2, ptr,
                                              raw_stream, rows_of, rows_view,
                                              scalar32, stream_of, strides_of,
                                              tiled_buffers)

# kernel launches per wrapper (one per call of the C entry point)
LAUNCHES = {"biquad_blockrate": 0, "biquad_scalar": 0,
            "biquad_per_sample": 0, "biquad_serial": 0}


def _prep(b0, b1, b2, a1, a2):
    """na1, na2, b1m, b2m, b0 (float32 tensors). b1 - a1 b0 and
    b2 - a2 b0 round once (fma32), as XLA's contracted evaluation of the
    reference does: where b1 == a1 (peaking EQ, shelves) the unfused
    difference cancels and lost 12.7-14.6 dB against f64 (measured on
    the CPU, tests/test_torch_biquad.py)."""
    return (-a1, -a2, fma32(-a1, b0, b1), fma32(-a2, b0, b2), b0)


def _streams(x: torch.Tensor, coefs, mode: int, count: int) -> Streams:
    """The kernel's five coefficient streams na1, na2, b1m, b2m, b0 from
    (b0, b1, b2, a1, a2), each broadcast against x.shape[:-1] + (count,)
    (ignored for SCALAR)."""
    if mode == SCALAR:
        # host tensors: a card's coefficient is read (a counted host
        # sync) in scalar32
        prepped = _prep(*(torch.tensor(scalar32(c)) for c in coefs))
        return Streams(SCALAR, [c.item() for c in prepped], 1)
    prepped = _prep(*(as_f32(c, x.device) for c in coefs))
    shape = x.shape[:-1] + (count,)
    return Streams(mode, [rows_view(c, shape, x.device) for c in prepped],
                   count)


def _prepare(x: torch.Tensor, coefs, mode: int):
    """(x2 [B, n], Streams, ln) for one biquad call in `mode`."""
    if x.dtype != torch.float32:
        raise TypeError(f"biquad kernels take float32, got {x.dtype}")
    n = x.shape[-1]
    count = {SCALAR: 1, BLOCK: -(-n // CBLOCK), SAMPLE: n}[mode]
    x2 = x.reshape(-1, n).contiguous()
    ln = geometry(n, blockrate=mode == BLOCK)[0]
    return x2, _streams(x, coefs, mode, count), ln


def _plain_of(x: torch.Tensor, coefs, mode: int) -> torch.Tensor:
    x2, st, ln = _prepare(x, coefs, mode)
    return _plain(x2, st, ln).reshape(x.shape)


def biquad_blockrate(x: torch.Tensor, coefs_b,
                     cblock: int = CBLOCK) -> torch.Tensor:
    """K4: one section over [..., n] with block-rate coefficients, each
    broadcast against x.shape[:-1] + (ceil(n / 64),) (the reference's
    biquad_blockrate_pallas). On a card the kernels read b0, b1, b2, a1,
    a2 as they are given (block_views) and prepare the streams of _prep
    in registers, so the call makes no torch operation on x or the
    coefficients."""
    if cblock != CBLOCK:
        raise ValueError(f"biquad kernels take cblock {CBLOCK}, got {cblock}")
    x2, views = block_views(x, coefs_b, "biquad kernels")
    y = dispatch(x2, lambda: _plain(*_prepare(x, coefs_b, BLOCK)),
                 lambda: _launch_tiled(x2, geometry(x2.shape[1])[0],
                                       views=views), "biquad_blockrate",
                 LAUNCHES, "biquad kernel")
    return y.reshape(x.shape)


def biquad_blockrate_plain(x: torch.Tensor, coefs_b) -> torch.Tensor:
    """K4's plain twin on x's device, whatever the device."""
    return _plain_of(x, coefs_b, BLOCK)


def biquad_scalar(x: torch.Tensor, coefs) -> torch.Tensor:
    """K5: one section with static coefficients over [..., n]. On a card
    the kernels take b0, b1, b2, a1, a2 as five float32 values and
    prepare the streams of _prep in registers, so the call makes no torch
    operation on x."""
    x2 = rows_of(x, "biquad kernels")
    ln = geometry(x2.shape[1], blockrate=False)[0]
    values = [scalar32(c) for c in coefs]
    y = dispatch(x2, lambda: _plain(*_prepare(x, coefs, SCALAR)),
                 lambda: _launch_tiled(x2, ln, values=values),
                 "biquad_scalar", LAUNCHES, "biquad kernel")
    return y.reshape(x.shape)


def biquad_scalar_plain(x: torch.Tensor, coefs) -> torch.Tensor:
    """K5's plain twin on x's device, whatever the device."""
    return _plain_of(x, coefs, SCALAR)


def biquad_per_sample(x: torch.Tensor, coefs) -> torch.Tensor:
    """K9: one section with per-sample coefficients, each broadcastable
    against x.shape. On a card the kernels read b0, b1, b2, a1, a2 as they
    are given (block_views per sample: strided [B, n] views, a broadcast
    stays stride 0) and prepare the streams of _prep in registers, so the
    call makes no torch operation on x or on coefficients of that form."""
    x2, views = block_views(x, coefs, "biquad kernels", per_sample=True)
    ln = geometry(x2.shape[1], blockrate=False)[0]
    y = dispatch(x2, lambda: _plain(*_prepare(x, coefs, SAMPLE)),
                 lambda: _launch_tiled(x2, ln, views=views, mode=SAMPLE),
                 "biquad_per_sample", LAUNCHES, "biquad kernel")
    return y.reshape(x.shape)


def biquad_per_sample_plain(x: torch.Tensor, coefs) -> torch.Tensor:
    """K9's plain twin on x's device, whatever the device."""
    return _plain_of(x, coefs, SAMPLE)


def biquad_pallas(x: torch.Tensor, coefs) -> torch.Tensor:
    """The reference's biquad_pallas: static coefficients go to K5,
    per-sample ones to K9."""
    if all(is_scalar(c) for c in coefs):
        return biquad_scalar(x, coefs)
    return biquad_per_sample(x, coefs)


def _blockrate_earlier(x: torch.Tensor, coefs_b) -> torch.Tensor:
    """K4's earlier route on a card: csrc/biquad.cu's biquad_scan with its
    padded copy of x and its prefix rows in device memory. On no render
    path and not counted: the yardstick the tiled kernels are timed and
    compared against."""
    x2, st, ln = _prepare(x, coefs_b, BLOCK)
    return _launch(x2, st, ln).reshape(x.shape)


def _per_sample_earlier(x: torch.Tensor, coefs) -> torch.Tensor:
    """K9's earlier route on a card: biquad_scan on the five prepared
    per-sample streams, with its padded copy of x and its prefix rows in
    device memory. On no path and not counted: the yardstick the tiled
    kernel is timed and compared against."""
    x2, st, ln = _prepare(x, coefs, SAMPLE)
    return _launch(x2, st, ln).reshape(x.shape)


def _launch_tiled(x2: torch.Tensor, ln: int, views=None, values=None,
                  mode: int = BLOCK) -> torch.Tensor:
    """Run csrc/biquad.cu's biquad_tiled on [B, n] CUDA inputs: the five
    coefficients (b0, b1, b2, a1, a2) as `views` in `mode` (K4: BLOCK,
    [B, ceil(n / 64)]; K9: SAMPLE, [B, n]), or K5 with their five static
    float32 `values`. Two allocations, no copy, no synchronisation, so a
    call can be captured in a CUDA graph. Raises on a refused launch."""
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "biquad kernel")
    B, n = x2.shape
    (y,), _scratch, ptrs = tiled_buffers(x2, ln, outputs=1, pairs=2)
    if views is None:
        mode, arrays, strides, count = SCALAR, [None] * 5, None, 1
    else:
        arrays, strides, count = views, strides_of(views), views[0].shape[1]
        values = [0.0] * 5
    with on_device(x2.device):
        err = library().biquad_tiled(
            mode, x2.data_ptr(), *(ptr(a) for a in arrays), strides, count,
            *values, y.data_ptr(), *ptrs, B, n, ln, raw_stream(x2.device))
    if err:
        raise RuntimeError(f"biquad kernel launch failed: CUDA error {err}")
    return y


def _launch(x2: torch.Tensor, st: Streams, ln: int) -> torch.Tensor:
    """Run csrc/biquad.cu's biquad_scan on [B, n] CUDA inputs. Allocates
    the output and the scratch; raises on a refused launch."""
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "biquad kernel")
    st.check(x2, "biquad kernel")
    B, n = x2.shape
    nb = -(-n // ln)
    npad = nb * ln
    f32 = dict(dtype=torch.float32, device=x2.device)
    xp = torch.nn.functional.pad(x2, (0, npad - n))
    y = torch.empty((B, n), **f32)
    p11, p12, q1 = (torch.empty((B, npad), **f32) for _ in range(3))
    m = torch.empty((B, nb, 4), **f32)
    c = torch.empty((B, nb, 2), **f32)
    s = torch.empty((B, nb, 2), **f32)
    with on_device(x2.device):
        err = library().biquad_scan(
            st.mode, ptr(xp), *(ptr(t) for t in st.arrays), *st.values,
            *st.layout, ptr(y), ptr(p11), ptr(p12), ptr(q1), ptr(m), ptr(c),
            ptr(s), B, n, npad, ln, stream_of(x2))
    if err:
        raise RuntimeError(f"biquad kernel launch failed: CUDA error {err}")
    return y


def _plain(x2: torch.Tensor, st: Streams, ln: int) -> torch.Tensor:
    """The kernel's arithmetic in torch: phase 1, phase 2, combine."""
    B, n = x2.shape
    nb = -(-n // ln)
    npad = nb * ln
    na1, na2, b1m, b2m, b0 = st.per_sample(B, npad, x2.device)
    z = torch.nn.functional.pad(x2, (0, npad - n))
    fold = lambda v: v.reshape(B, nb, ln)  # noqa: E731
    p11, p12, q1, m, c = phase1(fold(na1), fold(na2), fold(b1m), fold(b2m),
                                fold(z), ln)
    s = phase2(m, c)
    y = b0 * z + fold_back(p11 * s[..., 0:1] + p12 * s[..., 1:2] + q1)
    return y[:, :n].contiguous()


# --------------------------------------------------------------------------
# The per-sample serial scan


def _prepare_serial(x: torch.Tensor, coefs):
    if x.dtype != torch.float32:
        raise TypeError(f"biquad kernels take float32, got {x.dtype}")
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    if all(is_scalar(c) for c in coefs):
        return x2, Streams(SCALAR, [scalar32(c) for c in coefs], 1)
    return x2, Streams(SAMPLE, [rows_view(c, x.shape, x.device)
                                for c in coefs], n)


def biquad_serial(x: torch.Tensor, coefs) -> torch.Tensor:
    """Per-sample TDF2 scan over [..., n], zero initial state; coefs
    (b0, b1, b2, a1, a2) scalars or per-sample arrays broadcastable to
    x.shape (the reference's iir.biquad_serial)."""
    x2, st = _prepare_serial(x, coefs)
    y = dispatch(x2, lambda: _serial_plain(x2, st),
                 lambda: _launch_serial(x2, st), "biquad_serial", LAUNCHES,
                 "biquad serial kernel")
    return y.reshape(x.shape)


def biquad_serial_plain(x: torch.Tensor, coefs) -> torch.Tensor:
    """The serial scan's plain twin on x's device, whatever the device."""
    x2, st = _prepare_serial(x, coefs)
    return _serial_plain(x2, st).reshape(x.shape)


def _launch_serial(x2: torch.Tensor, st: Streams) -> torch.Tensor:
    from groove_tpu_torch.kernels.build import library

    check_input(x2, "biquad serial kernel")
    st.check(x2, "biquad serial kernel")
    B, n = x2.shape
    # the kernel moves x and y as float4: rows 16-byte aligned
    stride = -(-n // 4) * 4
    if stride != n or x2.data_ptr() % 16:
        xp = torch.zeros((B, stride), dtype=torch.float32, device=x2.device)
        xp[:, :n] = x2
        x2 = xp
    y = torch.empty((B, stride), dtype=torch.float32, device=x2.device)
    with on_device(x2.device):
        err = library().biquad_serial_scan(
            st.mode, ptr(x2), *(ptr(t) for t in st.arrays), *st.values,
            *st.layout, ptr(y), B, n, stride, stream_of(x2))
    if err:
        raise RuntimeError(f"biquad serial kernel launch failed: CUDA "
                           f"error {err}")
    return y[:, :n]


def _serial_plain(x2: torch.Tensor, st: Streams) -> torch.Tensor:
    """A Python loop over samples, vectorised over rows. The numerator
    products b x do not depend on the recurrence, so they are formed for
    all samples at once (each is one rounded multiply either way)."""
    B, n = x2.shape
    if n == 0:
        return torch.empty_like(x2)
    a1s = a2s = None
    if st.mode == SCALAR:
        b0, b1, b2, a1, a2 = st.values
    else:
        b0, b1, b2, a1, a2 = (t.expand(B, n) for t in st.arrays)
        a1s, a2s = a1.t().unbind(0), a2.t().unbind(0)
    bx0, bx1, bx2 = ((b * x2).t().unbind(0) for b in (b0, b1, b2))
    s1 = torch.zeros(B, dtype=torch.float32, device=x2.device)
    s2 = torch.zeros_like(s1)
    ys = []
    for k in range(n):
        if a1s is not None:
            a1, a2 = a1s[k], a2s[k]
        yn = bx0[k] + s1
        s1, s2 = bx1[k] - a1 * yn + s2, bx2[k] - a2 * yn
        ys.append(yn)
    return torch.stack(ys, 1)
