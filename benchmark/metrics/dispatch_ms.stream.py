"""dispatch_ms.stream: the host milliseconds of a stream's "step" spans
(each segment's graph enqueued) over its segments, median over the
traced streams; from the program's recorder."""

from benchmark.metrics._program_spans import median_over, ms, per_segment

NEEDS = ()


def read(obs):
    return median_over("stream", per_segment(lambda s: ms(s, "step")))
