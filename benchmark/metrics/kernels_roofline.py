"""kernels_roofline: the share, in %, of the least time of the work the
traced calls asked of the program's kernel entry points (benchmark/work.py,
from the calls' arguments) in the device time of what those calls
launched (the trace's operations linked to each call's span)."""

NEEDS = ("trace",)


def read(obs):
    t = obs.get("trace")
    if not t or t["kernel_device_s"] <= 0:
        return None
    return 100.0 * t["kernel_least_s"] / t["kernel_device_s"]
