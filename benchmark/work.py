"""The least time of the work a kernel call asks for: a frozen copy of
chip_smoke.py's work arithmetic (bounds, iir_work, drum_work, scan_work,
distinct_bytes, coef_bytes, and S1's and S2's work from stream_calls),
with the peaks of one NVIDIA H100 SXM, and the table of the program's
kernel entry points it counts, by module attribute.

A call's work is counted from its arguments' shapes (and, for the drum
layer, the hit lists it is given), never from what a kernel does: a
kernel that is replaced or fused reads the same work."""

from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores; a dependent float operation's latency in
# cycles at the card's highest SM clock (nvidia-smi clocks.max.sm)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
DEPENDENT_OP_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
CBLOCK = 64  # the control block: block-rate coefficients hold 64 frames
LINEAR, MAX_DECAY = 0, 1


def bounds(nbytes: float, flops: float, chain_ops: float) -> dict:
    """The card's least time for the work: the largest of the bytes over
    the HBM rate, the operations over the float32 peak and the dependency
    chain's time."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    chain = chain_ops * DEPENDENT_OP_CYCLES / SM_CLOCK_HZ * 1e3
    return {"bytes": nbytes, "flops": flops, "chain_ops": chain_ops,
            "bytes_ms": by_bytes, "flops_ms": by_ops, "chain_ms": chain,
            "bound_ms": max(by_bytes, by_ops, chain),
            "bound_by": ("bytes" if by_bytes >= max(by_ops, chain)
                         else "operations")}


def block_for(n: int, max_block: int = 128) -> int:
    b = 16
    while b < max_block and b * b < n:
        b *= 2
    return b


def geometry(n: int, blockrate: bool = True) -> tuple[int, int, int]:
    """(ln, nb, npad) of the two-level serial scheme: ln ~ sqrt(n) in
    [16, 128], at least CBLOCK for block-rate coefficients."""
    ln = block_for(n, max_block=128)
    if blockrate:
        ln = max(ln, CBLOCK)
    nb = -(-n // ln)
    return ln, nb, nb * ln


def iir_work(kind: str, rows: int, n: int, coef_bytes: float,
             state_rows: int = 0) -> tuple:
    """(bytes, flops, chain ops) of one IIR call on [rows, n] (chip_smoke
    iir_work): x read and y written once, the coefficients once, a
    carried state read and written once; 13 float operations a sample in
    phase 1 and 5-6 in the combine (the refined passes add 13 for the
    defect, 7 for the correction scan and 6 for its combine); 8 a block
    in phase 2. A cascade's chain is one chain of nb steps plus every
    pass's in-block scans; the serial scan's is 4 operations a sample."""
    io = 2.0 * rows * n * 4 + coef_bytes + 2.0 * rows * state_rows * 4
    if kind in ("serial", "S4"):
        return io, 9.0 * rows * n, 4.0 * n
    if kind in ("K7", "K8", "S3"):
        ln, nb = CBLOCK, n // CBLOCK
    else:
        ln, nb, _ = geometry(n, blockrate=kind in ("K2", "K3", "K4"))
    per_sample = {"K4": 19, "K5": 19, "K9": 19, "K3": 36, "K6": 36,
                  "K2": 88, "K7": 36, "K8": 88, "S3": 19}[kind]
    passes = (2 if kind in ("K2", "K3", "K6", "K7", "K8") else 1) \
        * (2 if kind in ("K2", "K8") else 1)
    flops = rows * (per_sample * n + 8 * nb * passes)
    chain = 2 * ln * passes + 3 * nb
    return io, float(flops), float(chain)


def distinct_bytes(c) -> float:
    """Bytes of the distinct values of a coefficient tensor (dimensions
    read with stride 0 count once; a number or a 0-dim tensor counts 0)."""
    import torch

    if not torch.is_tensor(c) or c.dim() == 0:
        return 0.0
    return 4.0 * float(math.prod(n for n, st in zip(c.shape, c.stride())
                                 if st != 0))


def coef_bytes(coefs) -> float:
    return sum(distinct_bytes(c) for c in coefs)


def is_scalar(c) -> bool:
    import torch

    return not torch.is_tensor(c) or c.numel() == 1


def drum_work(hits, n: int, chunk: int) -> tuple:
    """(bytes, flops, chain ops) of one drum accumulation over the
    prepared hits (table, counts, slots, starts, shifts, limits, vels):
    the table and hit lists read once, [2, n] written once; a multiply and
    an add a channel for every sample of every hit inside the timeline."""
    import numpy as np

    _, counts, _, starts, shifts, limits, _ = (t.cpu().numpy() for t in hits)
    listed = np.arange(limits.shape[1])[None, :] < counts[:, None]
    on = (np.arange(len(counts), dtype=np.int64)[:, None] * chunk + starts
          + 64 * shifts.astype(np.int64))
    span = np.clip(np.minimum(limits, n - on), 0, None)
    nbytes = 2.0 * n * 4 + sum(float(t.numel() * t.element_size())
                               for t in hits)
    return nbytes, 4.0 * float(span[listed].sum()), 0.0


def scan_work(x, a, b, axis: int, mode: int) -> tuple:
    """(bytes, flops, chain ops) of one first-order scan: x read and y
    written once, each coefficient's distinct values once; 3 operations
    an element (linear) or 2 (max-decay); the chain of a log-depth scan."""
    steps = x.shape[axis]
    linear = mode == LINEAR
    io = 8.0 * x.numel() + distinct_bytes(a) + (distinct_bytes(b)
                                                if linear else 0.0)
    levels = math.ceil(math.log2(max(steps, 2)))
    return (io, (3.0 if linear else 2.0) * x.numel(),
            2.0 * levels + (1.0 if linear else 0.0))


def _rows_n(x) -> tuple:
    n = x.shape[-1]
    return x.numel() // max(n, 1), n


# ---- the program's kernel entry points and their work ---------------------

def _lp24(kind):
    def work(x, sections, *rest, **kw):
        rows, n = _rows_n(x)
        return iir_work(kind, rows, n,
                        coef_bytes([c for sec in sections for c in sec[3:]]))
    return work


def _lp24_state(kind, state_rows):
    def work(x, sections, *rest, **kw):
        rows, n = _rows_n(x)
        return iir_work(kind, rows, n,
                        coef_bytes([c for sec in sections for c in sec[3:]]),
                        state_rows)
    return work


def _biquad_blockrate(x, coefs_b, *rest, **kw):
    rows, n = _rows_n(x)
    return iir_work("K4", rows, n, coef_bytes(list(coefs_b)))


def _biquad_pallas(x, coefs, *rest, **kw):
    rows, n = _rows_n(x)
    flat = list(coefs)
    kind = "K5" if all(is_scalar(c) for c in flat) else "K9"
    return iir_work(kind, rows, n, coef_bytes(flat))


def _biquad_serial(x, coefs, *rest, **kw):
    rows, n = _rows_n(x)
    return iir_work("serial", rows, n, coef_bytes(list(coefs)))


def _scan1(x, a, b=1.0, axis=-1, mode=LINEAR, **kw):
    return scan_work(x, a, b, axis, mode)


def _drums(table, counts, slots, starts, shifts, limits, vels, n_frames):
    from groove_tpu_torch.ops.drums import CHUNK

    return drum_work((table, counts, slots, starts, shifts, limits, vels),
                     int(n_frames), CHUNK)


def _scan_stream(x, a, b=1.0, y0=0.0, mode=LINEAR, **kw):
    io, flops, _ = scan_work(x, a, b, -1, mode)
    return io, flops, 2.0 * (x.shape[-1] // 64) + (1.0 if mode == LINEAR
                                                   else 0.0)


def _comb_stream(x, hist_x, hist_y, g, **kw):
    rows, n = _rows_n(x)
    d = hist_x.shape[-1]
    io = 8.0 * x.numel() + distinct_bytes(g) + 2 * 2 * rows * d * 4.0
    return io, 2.0 * x.numel(), 2.0 * math.ceil(n / d)


def _allpass_stream(x, hist_w, g, **kw):
    rows, n = _rows_n(x)
    d = hist_w.shape[-1]
    return (8.0 * x.numel() + 2 * rows * d * 4.0, 5.0 * x.numel(),
            2.0 * math.ceil(n / d))


def _biquad_state(x, coefs, state, **kw):
    rows, n = _rows_n(x)
    return iir_work("S3", rows, n, coef_bytes(list(coefs)), 2)


def _biquad_serial_state(x, coefs, state, **kw):
    rows, n = _rows_n(x)
    return iir_work("S4", rows, n, coef_bytes(list(coefs)), 2)


# (module, attribute) -> work function of the call's arguments. Every
# kernel launch of the program goes through one of these; the callers
# look them up on their modules at call time.
ENTRY_POINTS = {
    ("groove_tpu_torch.ops.drums", "accumulate_hits"): _drums,
    ("groove_tpu_torch.ops.scan_kernels", "scan1"): _scan1,
    ("groove_tpu_torch.ops.iir_kernels", "lp24_blockrate"): _lp24("K3"),
    ("groove_tpu_torch.ops.iir_kernels", "lp24_refined_blockrate"):
        _lp24("K2"),
    ("groove_tpu_torch.ops.iir_kernels", "lp24_cascade"): _lp24("K6"),
    ("groove_tpu_torch.ops.iir_kernels", "lp24_blockrate_stream"):
        _lp24_state("K7", 4),
    ("groove_tpu_torch.ops.iir_kernels", "lp24_refined_blockrate_stream"):
        _lp24_state("K8", 20),
    ("groove_tpu_torch.ops.biquad_kernels", "biquad_blockrate"):
        _biquad_blockrate,
    ("groove_tpu_torch.ops.biquad_kernels", "biquad_pallas"): _biquad_pallas,
    ("groove_tpu_torch.ops.biquad_kernels", "biquad_serial"): _biquad_serial,
    ("groove_tpu_torch.ops.stream_kernels", "scan_stream"): _scan_stream,
    ("groove_tpu_torch.ops.stream_kernels", "comb_stream"): _comb_stream,
    ("groove_tpu_torch.ops.stream_kernels", "allpass_stream"):
        _allpass_stream,
    ("groove_tpu_torch.ops.stream_kernels", "biquad_state"): _biquad_state,
    ("groove_tpu_torch.ops.stream_kernels", "biquad_serial_state"):
        _biquad_serial_state,
}


def count(key, args, kwargs):
    """The work of one call of entry point `key`: the tuple, counted from
    the arguments' shapes now (nothing is kept alive), or for the drum
    layer, which reads its hit lists from the card, a function that
    counts it after the window."""
    fn = ENTRY_POINTS[key]
    if fn is _drums:
        return lambda: fn(*args, **kwargs)
    return fn(*args, **kwargs)


def least_seconds(work: tuple) -> float:
    return bounds(*work)["bound_ms"] / 1e3
