"""setup_s: seconds from the process's start to the end of the warm-up
call (the kit, the compile, the entry's construction, one call)."""

NEEDS = ()


def read(obs):
    return obs["setup_s"]
