"""host_syncs: the points in a bounce where the host waits for the card
(the program's "host_syncs" counter), median over the traced bounces."""

from benchmark.metrics._program_spans import host_syncs, median_over

NEEDS = ()


def read(obs):
    return median_over("render", host_syncs)
