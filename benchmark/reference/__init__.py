"""The benchmark's plain reference: the song rendered on the host in
float64 NumPy from the project dict and the kit's WAV files alone
(render.py: the devices and effects; song.py: the timeline). It imports
nothing of groove_tpu_torch, jax or groove_tpu and takes nothing the
program made."""
