"""compile_s: host seconds of groove_tpu_torch.compiler.song.compile_song
in set-up."""

NEEDS = ()


def read(obs):
    return obs["compile_s"]
