"""host_syncs.stream: the points in a stream where the host waits for the
card (the program's "host_syncs" counter) over its segments, median over
the traced streams."""

from benchmark.metrics._program_spans import host_syncs, median_over, \
    per_segment

NEEDS = ()


def read(obs):
    return median_over("stream", per_segment(host_syncs))
