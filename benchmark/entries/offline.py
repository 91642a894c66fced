"""Offline bounce: Renderer(compiled, device).render_quantized(), the
whole song into a host int16 [n, 2] array, as `cli --wav` runs it."""

from __future__ import annotations

import time

from benchmark.staged import staged_render

# (module, attribute, span) the traced window opens a span around
SPANS = (
    ("groove_tpu_torch.models.welsh", "render_notes_parts", "voices"),
    ("groove_tpu_torch.models.welsh", "apply_cascade", "cascade"),
    ("groove_tpu_torch.engine.render", "scatter_notes", "scatter"),
    ("groove_tpu_torch.engine.render", "quantize_16bit", "quantize"),
    ("groove_tpu_torch.engine.render.Renderer", "_render_instrument",
     "instrument"),
    ("groove_tpu_torch.engine.render.Renderer", "_apply_effect", "effect"),
)


class Entry:
    def __init__(self, compiled, device: str, traffic: dict):
        from groove_tpu_torch.engine.render import Renderer

        self.r = Renderer(compiled, device)
        self.frames = compiled.n_frames

    def call(self):
        """One bounce: the host int16 [n, 2] array."""
        return self.r.render_quantized()

    def chunks(self, out):
        """The call's output as a list of host arrays."""
        return [out]

    def staged(self) -> dict:
        """One bounce with its stages synchronised: {stage: seconds}, and
        a second one split into the device render and the fetch (the
        int16 quantizer and the copy to the host)."""
        import torch

        from groove_tpu_torch.io.wav import quantize_16bit

        _, stages = staged_render(self.r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = self.r.render_device()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        quantize_16bit(y).cpu().numpy()
        stages["fetch"] = time.perf_counter() - t1
        stages["render_device"] = t1 - t0
        return stages

    def segments(self) -> int:
        return 1
