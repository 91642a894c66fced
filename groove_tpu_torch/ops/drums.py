"""One-shot drum accumulation kernel K1 (port of
groove_tpu/ops/pallas_drums.py).

prepare_table and prepare_hits are the reference's numpy host layout:
per 65536-frame chunk, the hits that start in it (stable in note order),
with chunk-local 128-aligned starts and a 64-frame shift flag. The CUDA
kernel (csrc/drums.cu) and its plain twin here both consume that layout
and sum, for every frame, the covering hits in layout order:
acc + row[t - on] * (vel / 127). On a card the kernel is output-stationary
on 2048-frame tiles: each thread block culls the hits of the chunks that
can reach its tile into a shared-memory list, in layout order, and every
thread runs over that list for its frames. The wrapper checks, allocates
y and launches, and nothing else: a call can be captured in a CUDA
graph."""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.kernels import build
from groove_tpu_torch.ops import iir_kernels
from groove_tpu_torch.utils import profiling

CHUNK = 65536    # timeline frames per hit-list chunk (multiple of 128)

# kernel launches of accumulate_hits
LAUNCHES = {"drums": 0}


def prepare_table(table_data: np.ndarray) -> np.ndarray:
    """Pad [slots, 2, max_len] to a 128-multiple row length + 128."""
    max_len = table_data.shape[-1]
    row_len = -(-max_len // 128) * 128 + 128
    out = np.zeros(table_data.shape[:-1] + (row_len,), np.float32)
    out[..., :max_len] = table_data
    return out


def prepare_hits(slots, on_frames, gate_frames, vels, lengths,
                 n_frames: int):
    """Host-side per-chunk hit lists (hit times are static at compile).

    Returns (counts [nchunks], and [nchunks, M] slot/start/shift/limit/vel
    arrays) with starts chunk-local and 128-aligned; the 64-remainder is
    folded into a shift flag."""
    slots = np.asarray(slots, np.int32)
    on = np.asarray(on_frames, np.int64)
    rem = (on % 128).astype(np.int64)
    if not np.all((rem == 0) | (rem == 64)):
        raise ValueError("drum hits must be 64-frame aligned")
    starts = (on - rem).astype(np.int64)
    shifts = (rem // 64).astype(np.int32)
    limit = np.minimum(np.asarray(lengths, np.int64)[np.maximum(slots, 0)],
                       np.asarray(gate_frames, np.int64)).astype(np.int32)
    vels_eff = np.where(slots >= 0, np.asarray(vels, np.float32), 0.0)
    live = (vels_eff > 0) & (limit > 0) & (starts < n_frames)
    chunk_of = (starts // CHUNK).astype(np.int64)
    nchunks = max(1, -(-n_frames // CHUNK))
    counts = np.zeros(nchunks, np.int32)
    order = np.argsort(chunk_of[live], kind="stable")
    idx_live = np.nonzero(live)[0][order]
    for i in idx_live:
        counts[chunk_of[i]] += 1
    M = max(1, int(counts.max()) if len(idx_live) else 1)
    shape = (nchunks, M)
    o_slots = np.zeros(shape, np.int32)
    o_starts = np.zeros(shape, np.int32)
    o_shifts = np.zeros(shape, np.int32)
    o_limits = np.zeros(shape, np.int32)
    o_vels = np.zeros(shape, np.float32)
    fill = np.zeros(nchunks, np.int32)
    for i in idx_live:
        ci = int(chunk_of[i])
        k = fill[ci]
        fill[ci] = k + 1
        o_slots[ci, k] = max(int(slots[i]), 0)
        o_starts[ci, k] = int(starts[i] - ci * CHUNK)
        o_shifts[ci, k] = int(shifts[i])
        o_limits[ci, k] = int(limit[i])
        o_vels[ci, k] = float(vels_eff[i])
    return counts, o_slots, o_starts, o_shifts, o_limits, o_vels


def accumulate_hits(table_padded: torch.Tensor, counts, slots, starts,
                    shifts, limits, vels, n_frames: int) -> torch.Tensor:
    """K1: sum prepared one-shot hits into a [2, n_frames] timeline
    (the reference's accumulate_oneshots_pallas). table_padded:
    [slots, 2, row_len] f32 (prepare_table); the hit arrays as
    prepare_hits returns them, as tensors on the table's device. Runs in
    a "kernel" span of kind "drums"."""
    with profiling.span("kernel", kind="drums"):
        if table_padded.device.type == "cpu":
            return accumulate_hits_plain(table_padded, counts, slots, starts,
                                         shifts, limits, vels, n_frames)
        if table_padded.device.type != "cuda":
            raise RuntimeError(
                f"drum kernel: unsupported device {table_padded.device}")
        y = _launch(table_padded, counts, slots, starts, shifts, limits,
                    vels, n_frames)
        LAUNCHES["drums"] += 1
        return y


def _launch(table, counts, slots, starts, shifts, limits, vels,
            n_frames: int) -> torch.Tensor:
    """Run csrc/drums.cu's drums_accumulate: one allocation (y), no copy,
    no synchronisation. Raises on inputs the kernel does not take and on a
    refused launch."""
    if table.dim() != 3 or table.shape[1] != 2:
        raise ValueError(f"drum kernel: table {tuple(table.shape)} is not "
                         "[slots, 2, row_len]")
    nchunks, M = slots.shape
    for name, t, dt in (("table", table, torch.float32),
                        ("counts", counts, torch.int32),
                        ("slots", slots, torch.int32),
                        ("starts", starts, torch.int32),
                        ("shifts", shifts, torch.int32),
                        ("limits", limits, torch.int32),
                        ("vels", vels, torch.float32)):
        if t.device != table.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"drum kernel: {name} must be contiguous {dt} "
                             f"on {table.device}")
        if name != "table" and t.shape != (
                (nchunks,) if name == "counts" else (nchunks, M)):
            raise ValueError(f"drum kernel: {name} has shape "
                             f"{tuple(t.shape)}")
    if nchunks < -(-n_frames // CHUNK):
        raise ValueError("drum kernel: fewer hit chunks than the timeline")
    # the kernel reads rows as float4 and offsets them in 32-bit integers
    if table.shape[-1] % 4 or table.data_ptr() % 16 \
            or table.numel() >= 2**31:
        raise ValueError("drum kernel: the table needs rows of a multiple "
                         "of 4 frames, 16-byte alignment and < 2^31 floats")
    y = torch.empty((2, n_frames), dtype=torch.float32, device=table.device)
    with iir_kernels.on_device(table.device):
        err = build.library().drums_accumulate(
            table.data_ptr(), table.shape[-1], counts.data_ptr(),
            slots.data_ptr(), starts.data_ptr(), shifts.data_ptr(),
            limits.data_ptr(), vels.data_ptr(), nchunks, M, CHUNK,
            y.data_ptr(), n_frames, iir_kernels.raw_stream(table.device))
    if err:
        raise RuntimeError(f"drum kernel launch failed: CUDA error {err}")
    return y


def accumulate_hits_plain(table_padded, counts, slots, starts, shifts,
                          limits, vels, n_frames: int) -> torch.Tensor:
    """K1's plain twin: the hits in layout order, each adding
    row[:limit] * (vel / 127) at its note-on frame. vel / 127 is a true
    division on every device, as in the kernel: torch divides a CUDA
    tensor by a number through its reciprocal, which rounds some
    velocities differently."""
    out = torch.zeros((2, n_frames), dtype=torch.float32,
                      device=table_padded.device)
    scale = vels / torch.full_like(vels, 127.0)
    host = [torch.as_tensor(a).cpu() for a in (counts, slots, starts, shifts,
                                               limits)]
    cnt, sl, st, sh, li = (a.tolist() for a in host)
    for c, count in enumerate(cnt):
        for i in range(count):
            on = c * CHUNK + st[c][i] + 64 * sh[c][i]
            ln = min(li[c][i], n_frames - on)
            if ln <= 0:
                continue
            win = out[:, on:on + ln]
            win.copy_(win + table_padded[sl[c][i], :, :ln] * scale[c, i])
    return out
