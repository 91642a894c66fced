"""Simple devices (port of groove_tpu/models/simple.py): so far the toy
effect. The module's instruments (oscillator, envelope, metronome, the
toy instrument and audio source) are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch


def toy_effect(x: torch.Tensor) -> torch.Tensor:
    """Negator: signal + its toy-effected copy must cancel
    (orchestration/src/util.rs tests :52-78)."""
    return -x
