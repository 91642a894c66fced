"""dispatch_ms: the host milliseconds of a bounce's "graph" span, the
enqueue of the song graph (Renderer.render_quantized), median over the
traced bounces; from the program's recorder."""

from benchmark.metrics._program_spans import median_over, ms

NEEDS = ()


def read(obs):
    return median_over("render", lambda spans: ms(spans, "graph"))
