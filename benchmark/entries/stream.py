"""Streamed bounce: StreamingRenderer(compiled, device, segment_frames)
.stream(batch_segments, quantize=True), unsliced, consumed to its last
frame (`cli --stream`'s defaults)."""

from __future__ import annotations

SPANS = (
    ("groove_tpu_torch.engine.stream.StreamingRenderer", "step", "step"),
    ("groove_tpu_torch.engine.stream", "quantize_16bit", "quantize"),
)


class Entry:
    def __init__(self, compiled, device: str, traffic: dict):
        from groove_tpu_torch.engine.stream import StreamingRenderer

        self.r = StreamingRenderer(compiled, device,
                                   segment_frames=traffic["segment_frames"])
        self.batch = traffic["batch_segments"]
        self.prefetch = traffic["prefetch_segments"]
        self.frames = compiled.n_frames

    def call(self):
        """One stream, consumed whole: its host int16 chunks in order."""
        return list(self.r.stream(prefetch_segments=self.prefetch,
                                  batch_segments=self.batch, quantize=True))

    def chunks(self, out):
        return out

    def staged(self) -> dict:
        return {}

    def segments(self) -> int:
        return self.r.n_segs
