"""kernels_roofline.stream: kernels_roofline, read in the streamed cells, which report xrt.stream
(their own end-to-end rate, under a bound of its own)."""

from benchmark.metrics.kernels_roofline import NEEDS, read  # noqa: F401
