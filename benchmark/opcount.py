"""OpCount: a frozen copy of chip_smoke.py's counter of torch operations
dispatched on CUDA tensors (views included; the kernels' ctypes launches
are not torch operations)."""

from __future__ import annotations


class OpCount:
    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        counter = self
        kind = self.device_type

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if any(isinstance(t, torch.Tensor) and t.device.type == kind
                       for t in tree_leaves((args, kwargs, out))):
                    counter.n += 1
                return out

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
