"""device_idle_pct: 100 x (1 - busy / wall) over the traced calls, busy
being the union of the card's kernel and copy intervals."""

NEEDS = ("trace",)


def read(obs):
    t = obs.get("trace")
    if not t or not t["device_events"] or obs["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / obs["window_s"])
