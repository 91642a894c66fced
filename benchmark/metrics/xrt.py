"""xrt: seconds of audio delivered to the host as int16 frames over the
window's wall seconds (all the work over all the time)."""

NEEDS = ()


def read(obs):
    if not obs["window_s"] or not obs["frames"]:
        return None
    return obs["frames"] / obs["sample_rate"] / obs["window_s"]
