"""Block-rate lp24 cascade kernels K2 and K3 (port of the block-rate
family of groove_tpu/ops/pallas_iir.py).

The cascade is two TDF2 sections with numerators (1, 2, 1) and
denominators held for each 64-frame control block. Each section runs the
two-level serial scheme of the reference (never associative doubling of
the 2x2 maps, which diverges in f32 near z = 1):

  phase 1  in-block prefix maps: per row and per ln-sample block, a serial
           scan over ln samples storing the SHIFTED prefix rows p11, p12,
           q1 (identity at j = 0) and the whole-block map (M, C);
  phase 2  cross-block entry states: the serial chain
           S[k+1] = M[k] S[k] + C[k] per row over all blocks;
  combine  y = x + ((p11 S1 + p12 S2) + q1).

K2 (the refined cascade) adds, per section, the defect of the solve
against the shifted-coefficient TDF2 recurrence in its epsilon-regrouped
form, and an r-only correction scan that reuses the solve's p11/p12.

Each kernel has its plain torch twin here, written in the same operation
order: the CPU runs the twin, a CUDA tensor runs the kernel
(csrc/lp24.cu), and LAUNCHES counts kernel launches. Every multiply and
add rounds separately except the in-block scans' recurrences, which use
one correctly rounded fused multiply-add per map entry (fma32 here,
__fmaf_rn in the kernel): near z = 1 the unfused prefix products lost
12 dB against the f64 reference on the north-star analogue (measured on
the CPU), where XLA's contracted evaluation of the reference kernels does
not. ln is max(block_for(n, 128), 64), as in the reference kernels, so
both group the recurrence identically.
"""

from __future__ import annotations

import ctypes

import torch

CBLOCK = 64

# kernel launches per wrapper (one per call of the C entry point)
LAUNCHES = {"lp24": 0, "lp24_refined": 0}


def _geometry(n: int) -> tuple[int, int, int]:
    """(ln, nb, npad): in-block length, number of ln-blocks, padded n."""
    from groove_tpu_torch.ops.iir import block_for

    ln = max(block_for(n, max_block=128), CBLOCK)
    nb = -(-n // ln)
    return ln, nb, nb * ln


def _denoms(sections_b, rows: int, nb64: int):
    """Negated denominators (na1, na2) of both sections as contiguous
    [rows, nb64] f32 tensors: (na1a, na2a, na1b, na2b)."""
    out = []
    for sec in sections_b:
        for c in (sec[3], sec[4]):
            out.append((-c).reshape(rows, nb64).contiguous())
    return tuple(out)


def _prepare(x: torch.Tensor, sections_b, cblock: int):
    if cblock != CBLOCK:
        raise ValueError(f"lp24 kernels take cblock {CBLOCK}, got {cblock}")
    if x.dtype != torch.float32:
        raise TypeError(f"lp24 kernels take float32, got {x.dtype}")
    n = x.shape[-1]
    nb64 = -(-n // cblock)
    cshape = x.shape[:-1] + (nb64,)
    sections_b = [tuple(torch.as_tensor(c, dtype=torch.float32,
                                        device=x.device).expand(cshape)
                        for c in sec) for sec in sections_b]
    x2 = x.reshape(-1, n).contiguous()
    return x2, _denoms(sections_b, x2.shape[0], nb64)


def lp24_blockrate(x: torch.Tensor, sections_b,
                   cblock: int = CBLOCK) -> torch.Tensor:
    """K3: fused single-pass lp24 cascade over [..., n] with block-rate
    sections (the reference's lp24_blockrate_pallas)."""
    x2, den = _prepare(x, sections_b, cblock)
    if x2.device.type == "cpu":
        y = lp24_blockrate_plain(x2, *den)
    elif x2.device.type == "cuda":
        y = _launch(False, x2, den)
        LAUNCHES["lp24"] += 1
    else:
        raise RuntimeError(f"lp24 kernel: unsupported device {x2.device}")
    return y.reshape(x.shape)


def lp24_refined_blockrate(x: torch.Tensor, sections_b,
                           cblock: int = CBLOCK) -> torch.Tensor:
    """K2: fused refined lp24 cascade (solve + defect + correction per
    section) over [..., n] (the reference's
    lp24_refined_blockrate_pallas)."""
    x2, den = _prepare(x, sections_b, cblock)
    if x2.device.type == "cpu":
        y = lp24_refined_blockrate_plain(x2, *den)
    elif x2.device.type == "cuda":
        y = _launch(True, x2, den)
        LAUNCHES["lp24_refined"] += 1
    else:
        raise RuntimeError(f"lp24 kernel: unsupported device {x2.device}")
    return y.reshape(x.shape)


def _launch(refined: bool, x2: torch.Tensor, den) -> torch.Tensor:
    """Run csrc/lp24.cu's lp24_cascade on [B, n] CUDA inputs. Allocates
    the output and every scratch buffer; raises on a refused launch."""
    from groove_tpu_torch.kernels.build import library

    B, n = x2.shape
    nb64 = -(-n // CBLOCK)
    for t in (x2,) + den:
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
                and t.device == x2.device):
            raise ValueError("lp24 kernel: inputs must be contiguous "
                             "float32 on one CUDA device")
    for t in den:
        if tuple(t.shape) != (B, nb64):
            raise ValueError(f"lp24 kernel: coefficients {tuple(t.shape)} "
                             f"!= {(B, nb64)}")
    ln, nb, npad = _geometry(n)
    f32 = dict(dtype=torch.float32, device=x2.device)
    xp = torch.nn.functional.pad(x2, (0, npad - n))
    y = torch.empty((B, n), **f32)
    full = [torch.empty((B, npad), **f32) for _ in range(6 if refined else 4)]
    m = torch.empty((B, nb, 4), **f32)
    c = torch.empty((B, nb, 2), **f32)
    s = torch.empty((B, nb, 2), **f32)
    p11, p12, q1, ya = full[:4]
    y0, d = (full[4], full[5]) if refined else (None, None)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    err = library().lp24_cascade(
        int(refined), ptr(xp), *(ptr(t) for t in den), ptr(y),
        ptr(p11), ptr(p12), ptr(q1), ptr(ya), ptr(y0), ptr(d),
        ptr(m), ptr(c), ptr(s), B, n, npad, ln, nb64,
        ctypes.c_void_p(torch.cuda.current_stream(x2.device).cuda_stream))
    if err:
        raise RuntimeError(f"lp24 kernel launch failed: CUDA error {err}")
    return y


# --------------------------------------------------------------------------
# Plain torch twins: the kernels' arithmetic in the same operation order,
# vectorised over rows and blocks, serial where the kernels are serial.


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add a * b + c (CUDA's
    __fmaf_rn), for CPU and CUDA tensors alike. The f32 product is exact
    in f64; TwoSum gives the f64 sum's exact error, which rounds the sum
    to odd (a sticky bit), so the final rounding to f32 is the single
    correct one — no double-rounding case."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _per_sample(na: torch.Tensor, npad: int) -> torch.Tensor:
    """Block-rate [B, nb64] -> per-sample [B, npad] (zeros past nb64)."""
    from groove_tpu_torch.ops.iir import upsample_hold

    nbp = npad // CBLOCK
    na = torch.nn.functional.pad(na, (0, nbp - na.shape[-1]))
    return upsample_hold(na, npad)


def _phase1(na1, na2, z, ln: int):
    """In-block prefix maps over [B, nb, ln]: shifted rows (p11, p12, q1)
    and the block maps m [B, nb, 4], c [B, nb, 2]."""
    p11s, p12s, q1s = (torch.empty_like(z) for _ in range(3))
    one = torch.ones_like(z[..., 0])
    zero = torch.zeros_like(z[..., 0])
    p11, p12, p21, p22, q1, q2 = one, zero, zero, one, zero, zero
    for j in range(ln):
        p11s[..., j] = p11
        p12s[..., j] = p12
        q1s[..., j] = q1
        a, b, xj = na1[..., j], na2[..., j], z[..., j]
        c1 = (2.0 + a) * xj
        c2 = (1.0 + b) * xj
        p11, p12, p21, p22, q1, q2 = (
            fma32(a, p11, p21), fma32(a, p12, p22), b * p11, b * p12,
            fma32(a, q1, q2) + c1, fma32(b, q1, c2))
    return (p11s, p12s, q1s, torch.stack([p11, p12, p21, p22], -1),
            torch.stack([q1, q2], -1))


def _corr_phase1(na1, na2, d, ln: int):
    """r-only in-block scan of the correction (numerator (1, 0, 0)): the
    shifted r1 rows and the block-end (r1, r2) [B, nb, 2]."""
    q1s = torch.empty_like(d)
    r1 = torch.zeros_like(d[..., 0])
    r2 = torch.zeros_like(d[..., 0])
    for j in range(ln):
        q1s[..., j] = r1
        a, b, dj = na1[..., j], na2[..., j], d[..., j]
        r1, r2 = fma32(a, r1, r2) + a * dj, fma32(b, r1, b * dj)
    return q1s, torch.stack([r1, r2], -1)


def _phase2(m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Serial cross-block chain per row: entry states S [B, nb, 2]."""
    B, nb = m.shape[:2]
    s = torch.empty((B, nb, 2), dtype=m.dtype, device=m.device)
    s1 = torch.zeros(B, dtype=m.dtype, device=m.device)
    s2 = torch.zeros_like(s1)
    for k in range(nb):
        s[:, k, 0] = s1
        s[:, k, 1] = s2
        mk, ck = m[:, k], c[:, k]
        s1, s2 = (mk[:, 0] * s1 + mk[:, 1] * s2 + ck[:, 0],
                  mk[:, 2] * s1 + mk[:, 3] * s2 + ck[:, 1])
    return s


def _shift(v: torch.Tensor, k: int) -> torch.Tensor:
    """Shift right along the last axis with zero history."""
    return torch.nn.functional.pad(v, (k, 0))[..., :-k]


def _section(z, na1, na2, ln: int, refined: bool):
    """One cascade section on a padded [B, npad] input."""
    B, npad = z.shape
    nb = npad // ln
    fold = lambda v: v.reshape(B, nb, ln)  # noqa: E731
    p11, p12, q1, m, c = _phase1(fold(na1), fold(na2), fold(z), ln)
    s = _phase2(m, c)
    S1, S2 = s[..., 0:1], s[..., 1:2]
    y0 = z + _fold_back(p11 * S1 + p12 * S2 + q1)
    if not refined:
        return y0
    z1, z2 = _shift(z, 1), _shift(z, 2)
    y1, y2 = _shift(y0, 1), _shift(y0, 2)
    e1 = 2.0 - _shift(na1, 1)
    e2 = -_shift(na2, 2) - 1.0
    second = (y0 - y1) - (y1 - y2)
    d = (z + 2.0 * z1 + z2) - second - e1 * y1 - e2 * y2
    q1c, r = _corr_phase1(fold(na1), fold(na2), fold(d), ln)
    sc = _phase2(m, r)
    corr = fold(d) + p11 * sc[..., 0:1] + p12 * sc[..., 1:2] + q1c
    return y0 + _fold_back(corr)


def _fold_back(v: torch.Tensor) -> torch.Tensor:
    """[B, nb, ln] -> [B, nb * ln]."""
    return v.reshape(v.shape[0], -1)


def _cascade_plain(x2, na1a, na2a, na1b, na2b, refined: bool):
    B, n = x2.shape
    ln, nb, npad = _geometry(n)
    z = torch.nn.functional.pad(x2, (0, npad - n))
    ya = _section(z, _per_sample(na1a, npad), _per_sample(na2a, npad), ln,
                  refined)
    y = _section(ya, _per_sample(na1b, npad), _per_sample(na2b, npad), ln,
                 refined)
    return y[:, :n].contiguous()


def lp24_blockrate_plain(x2, na1a, na2a, na1b, na2b) -> torch.Tensor:
    """K3's plain twin: x2 [B, n], negated denominators [B, nb64]."""
    return _cascade_plain(x2, na1a, na2a, na1b, na2b, refined=False)


def lp24_refined_blockrate_plain(x2, na1a, na2a, na1b,
                                 na2b) -> torch.Tensor:
    """K2's plain twin: x2 [B, n], negated denominators [B, nb64]."""
    return _cascade_plain(x2, na1a, na2a, na1b, na2b, refined=True)
