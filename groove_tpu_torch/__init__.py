"""groove_tpu_torch — the Groove render engine on PyTorch and CUDA.

A port of groove_tpu (JAX/Pallas, the reference package beside this one)
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).
This package imports torch and numpy, never jax, and nothing of
groove_tpu: the host modules it shares with the reference (core/,
project/, the compiler's events/automation/params, io.wav's reader and
writers) are copies, held to their originals by
tests/test_torch_hostcopy.py.

Layout (each module names its groove_tpu counterpart):
    core/      musical time and value types (copies)
    project/   JSON5, project schema, patches, asset paths (copies)
    compiler/  compile_song (its own: the reference's pulls in jax), and
               copies of events/automation/params
    models/    drumkit/sampler loaders and voice helpers
    ops/       DSP in torch; kernel wrappers with their plain twins
    csrc/      CUDA C++ sources of the kernels
    kernels/   the nvcc build and ctypes binding
    engine/    the whole-song Renderer, the segment StreamingRenderer and
               live playback (livesong, live)
    parallel/  rendering over several devices: independent components
               (multidevice), timeline shards (meshrender, timeshard),
               track shards and songs one a device (mesh)
    io/        WAV reader/writers and the int16 quantizer; MIDI input and
               output, the native audio service (copies)
    testing/   seeded synthetic assets and projects
    cli.py     python -m groove_tpu_torch.cli <project> --wav --perf
               (--stream, --loop, --live PORT, --play, --multidevice,
               --mesh)

Every entry point takes a device; parallel/'s take a device list, by
default every visible CUDA device, and never fall back to the CPU.
"""

__version__ = "0.1.0"


def require_cuda() -> None:
    """Raise unless a CUDA device is visible to torch."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("groove_tpu_torch: CUDA is not available")
