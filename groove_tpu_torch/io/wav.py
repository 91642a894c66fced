"""16-bit WAV quantization in torch (port of groove_tpu/io/wav.py's device
quantizer).

The spec (groove_tpu.io.wav._chunk_to_i2): scale by 32767 in float64,
truncate toward zero, saturate to int16. An f32 sample widened to f64
times 32767 is exact (a 24 x 15-bit product), so evaluating the spec in
f64 on the device is bitwise the host writer's, and bitwise the
reference's double-f32 device quantizer. Writing reuses the jax-free
groove_tpu.io.wav.write_wav_16bit_stereo."""

from __future__ import annotations

import torch

from groove_tpu.io.wav import write_wav_16bit_stereo  # noqa: F401


def quantize_16bit(x: torch.Tensor) -> torch.Tensor:
    """float samples -> int16 by trunc(f64(x) * 32767), saturated."""
    v = torch.trunc(x.to(torch.float32).to(torch.float64) * 32767.0)
    return torch.clamp(v, -32768.0, 32767.0).to(torch.int16)
