"""effects_ms: every effect's synchronised stage of one offline render
(Renderer._apply_effect, all kinds), median of the staged calls."""

from benchmark.metrics._stages import median_ms

NEEDS = ("staged",)


def read(obs):
    return median_ms(obs, lambda k: k.startswith("effect:"))
