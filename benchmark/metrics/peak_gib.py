"""peak_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats(), in GiB."""

NEEDS = ()


def read(obs):
    return obs["peak_bytes"] / 2**30 if obs["peak_bytes"] else None
