"""device_idle_pct.stream: device_idle_pct, read in the streamed cells, which report xrt.stream
(their own end-to-end rate, under a bound of its own)."""

from benchmark.metrics.device_idle_pct import NEEDS, read  # noqa: F401
