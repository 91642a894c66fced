"""The program's own spans and counters of the traced window: what
groove_tpu_torch.utils.profiling's recorder kept (it records while a
torch.profiler session runs, so under --trace 1 exactly the profiled
calls). A program without that recorder gives nothing."""

import statistics


def requests(root: str) -> list:
    """The spans of each recorded request whose root span is `root`, in
    the order they opened (the root first)."""
    try:
        from groove_tpu_torch.utils import profiling
    except ImportError:
        return []
    if not hasattr(profiling, "RECORDER"):
        return []
    return [spans for spans in profiling.requests().values()
            if spans[0].parent is None and spans[0].name == root]


def ms(spans, name: str) -> float:
    """The host milliseconds of the spans named `name`."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6


def host_syncs(spans) -> int:
    from groove_tpu_torch.utils import profiling

    return profiling.host_syncs(spans)


def per_segment(value):
    """value(spans) over the request's segments (its "step" spans)."""
    def read(spans):
        n = sum(s.name == "step" for s in spans)
        return value(spans) / n if n else None
    return read


def median_over(root: str, value):
    """The median over the recorded `root` requests of value(spans), or
    None where there is none."""
    vals = [v for v in map(value, requests(root)) if v is not None]
    return statistics.median(vals) if vals else None
