"""DCA pan law (port of groove_tpu/ops/dca.py):

    left  = 1 - 0.25 * (pan + 1)^2
    right = 1 - (0.5 * pan - 0.5)^2

pan in [-1, 1]; pan = 0 gives 0.75 / 0.75."""

from __future__ import annotations

import torch


def pan_gains(pan, device=None):
    # a number is filled on the device: a host-to-device copy would wait
    # for the device's queue
    pan = torch.as_tensor(pan, dtype=torch.float32, device=device) \
        if torch.is_tensor(pan) \
        else torch.full((), float(pan), dtype=torch.float32, device=device)
    left = 1.0 - 0.25 * (pan + 1.0) ** 2
    right = 1.0 - (0.5 * pan - 0.5) ** 2
    return left, right
