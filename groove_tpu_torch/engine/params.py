"""Render inputs: host-collected numpy arrays -> device tensors.

A Renderer's inputs (sample tables, prepared drum hits, note columns,
automation curves, host-designed filter coefficients) are the data this
system renders from. inputs_from_numpy carries such a dict — this
package's own collection, or groove_tpu's Renderer.inputs converted to
numpy — onto a torch device unchanged: same keys, dtypes and bits."""

from __future__ import annotations

import numpy as np
import torch


def inputs_from_numpy(d: dict, device) -> dict:
    """{name: np.ndarray} -> {name: torch.Tensor on `device`}."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in d.items()}
