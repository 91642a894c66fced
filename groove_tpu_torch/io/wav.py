"""WAV read/write and the 16-bit quantizer in torch.

Write spec matches the reference exactly (orchestration/src/helpers.rs:74-97
and the commented writer in settings/src/patches.rs:806-812): stereo,
16-bit signed int, each float sample scaled by i16::MAX (32767) and cast —
Rust's `as i16` saturates and truncates toward zero, reproduced here.

Read: 16/24/32-bit PCM and float WAVs, normalized to float32 in [-1, 1)
by the type's full scale (hound-compatible: i16 / 32768).

The host reader and writers are copies of groove_tpu/io/wav.py's.
quantize_16bit evaluates the same spec in torch on the render's device:
an f32 sample widened to f64 times 32767 is exact (a 24 x 15-bit
product), so it is bitwise the host writer's, and bitwise the
reference's double-f32 device quantizer.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np
import torch


def quantize_16bit(x: torch.Tensor) -> torch.Tensor:
    """float samples -> int16 by trunc(f64(x) * 32767), saturated."""
    v = torch.trunc(x.to(torch.float32).to(torch.float64) * 32767.0)
    return torch.clamp(v, -32768.0, 32767.0).to(torch.int16)


def _chunk_to_i2(chunk) -> np.ndarray:
    """ONE definition of the output quantization: float chunks scale by
    32767, truncate toward zero and saturate (Rust `as i16` semantics);
    int16 passes through (already quantized on-device —
    quantize_16bit_device is bitwise this spec); mono stacks to stereo."""
    c = np.asarray(chunk)
    if c.dtype == np.int16:
        scaled = c.astype("<i2", copy=False)
    else:
        scaled = np.clip(np.trunc(c.astype(np.float64) * 32767.0),
                         -32768, 32767).astype("<i2")
    if scaled.ndim == 1:
        scaled = np.stack([scaled, scaled], axis=-1)
    return scaled


def write_wav_16bit_stereo(path, samples: np.ndarray, sample_rate: int) -> None:
    """samples: [n, 2] float (or device-quantized int16); spec in
    _chunk_to_i2."""
    write_wav_16bit_stereo_stream(path, [samples], sample_rate)


def write_wav_16bit_stereo_stream(path, chunks, sample_rate: int) -> int:
    """Incremental writer for segment-streamed renders: consumes an
    iterator of [n, 2] float chunks, writing each as it arrives (constant
    memory for unbounded songs; the wave module patches the RIFF sizes on
    close). Quantization spec in _chunk_to_i2. Returns total frames
    written."""
    total = 0
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        for chunk in chunks:
            scaled = _chunk_to_i2(chunk)
            w.writeframes(scaled.tobytes())
            total += len(scaled)
    return total


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns ([n, channels] float32 in [-1, 1), sample_rate).

    Hand-rolled RIFF parse so 24-bit and float formats work without
    external deps.
    """
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body  # kept whole for the EXTENSIBLE GUID below
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real format is a
        # GUID at byte 24 of the fmt body; the first two GUID bytes are the
        # classic format code (1 = PCM, 3 = IEEE float).
        if len(fmt_body) >= 26:
            audio_format = struct.unpack_from("<H", fmt_body, 24)[0]
        else:
            audio_format = 1
    if audio_format == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
            1 << 23
        )
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    elif audio_format == 3 and bits == 64:
        x = np.frombuffer(raw, "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}/{bits}")
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels), rate
