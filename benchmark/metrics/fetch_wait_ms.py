"""fetch_wait_ms: the host milliseconds of a bounce's "fetch" span, the
wait for the card's queue and the pageable copy of the int16 song to the
host, median over the traced bounces; from the program's recorder."""

from benchmark.metrics._program_spans import median_over, ms

NEEDS = ()


def read(obs):
    return median_over("render", lambda spans: ms(spans, "fetch"))
