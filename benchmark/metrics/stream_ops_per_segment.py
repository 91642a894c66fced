"""stream_ops_per_segment: torch operations on CUDA tensors of one steady
call (the frozen OpCount) over its segments."""

NEEDS = ("ops",)


def read(obs):
    if "ops_per_call" not in obs or not obs["segments"]:
        return None
    return obs["ops_per_call"] / obs["segments"]
