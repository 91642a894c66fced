"""xrt.stream: xrt, read in the streamed cells, which report xrt.stream
(their own end-to-end rate, under a bound of its own)."""

from benchmark.metrics.xrt import NEEDS, read  # noqa: F401
