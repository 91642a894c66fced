"""fetch_ms: the int16 quantizer and the copy to the host of one offline
render (render_device() synchronised apart), median of the staged calls."""

from benchmark.metrics._stages import median_ms

NEEDS = ("staged",)


def read(obs):
    return median_ms(obs, lambda k: k == "fetch")
