"""render_p90_ms: the 90th percentile (inclusive quantiles) of every
call's wall milliseconds in the window."""

import statistics

NEEDS = ()


def read(obs):
    s = obs["call_s"]
    if len(s) < 2:
        return None
    return statistics.quantiles(s, n=10, method="inclusive")[-1] * 1e3
