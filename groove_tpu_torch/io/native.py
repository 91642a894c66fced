"""ctypes bindings for the native runtime (native/groove_native.cpp).

Provides the live-playback service the reference implements with cpal
(src/panels/audio_panel.rs): a lock-free ring buffer the engine pushes
rendered frames into, and a paced consumer thread (real audio HW isn't
present in CI; the null sink keeps realtime pacing, a file sink captures
the stream). Falls back gracefully when the shared library isn't built —
the pure-Python WAV path in io/wav.py is always available.

(A copy of groove_tpu/io/native.py, statement for
statement; tests/test_torch_hostcopy.py holds it so. _LIB_PATH resolves to the repository's native/ from this
package's io/ as from groove_tpu's.)
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libgroove_native.so"
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        build = _LIB_PATH.parent / "build.sh"
        try:
            subprocess.run(["sh", str(build)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_size_t
    lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_size_t]
    lib.rb_read.restype = ctypes.c_size_t
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.c_size_t]
    lib.rb_readable.restype = ctypes.c_size_t
    lib.rb_readable.argtypes = [ctypes.c_void_p]
    lib.audio_service_start.restype = ctypes.c_void_p
    lib.audio_service_start.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_int]
    lib.audio_service_stop.argtypes = [ctypes.c_void_p]
    lib.audio_service_frames_consumed.restype = ctypes.c_uint64
    lib.audio_service_frames_consumed.argtypes = [ctypes.c_void_p]
    lib.audio_service_underruns.restype = ctypes.c_uint64
    lib.audio_service_underruns.argtypes = [ctypes.c_void_p]
    lib.audio_service_needs_frames.restype = ctypes.c_int64
    lib.audio_service_needs_frames.argtypes = [ctypes.c_void_p]
    lib.wav_write_16bit_stereo.restype = ctypes.c_int
    lib.wav_write_16bit_stereo.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class RingBuffer:
    """SPSC stereo-frame ring. The lock is NOT for producer/consumer data
    exchange (the C side handles that with acquire/release atomics) — it
    serializes the Python-visible handle against close(), so a render
    thread that loses a shutdown race calls into a no-op, not a freed
    pointer."""

    def __init__(self, capacity_frames: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("groove_native library not available")
        self._lib = lib
        self._lock = threading.Lock()
        self._rb = lib.rb_create(capacity_frames)

    def write(self, frames: np.ndarray) -> int:
        """frames: [n, 2] float32. Returns frames accepted."""
        frames = np.ascontiguousarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != 2:
            raise ValueError(
                f"RingBuffer.write expects [n, 2] stereo frames, "
                f"got shape {frames.shape}")
        ptr = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        with self._lock:
            if self._rb is None:
                return 0
            return self._lib.rb_write(self._rb, ptr, len(frames))

    def read(self, n_frames: int) -> np.ndarray:
        out = np.zeros((n_frames, 2), np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        with self._lock:
            if self._rb is not None:
                self._lib.rb_read(self._rb, ptr, n_frames)
        return out

    def readable(self) -> int:
        with self._lock:
            if self._rb is None:
                return 0
            return self._lib.rb_readable(self._rb)

    def close(self):
        with self._lock:
            if self._rb:
                self._lib.rb_destroy(self._rb)
                self._rb = None


class AudioService:
    """Paced consumer thread: the live-playback half of the engine.

    Push rendered blocks with `write`; `needs_frames` is the reference's
    NeedsAudio(count) pull signal (audio_panel.rs:117-142).
    """

    def __init__(self, sample_rate: int = 44100, buffer_frames: int = 64,
                 capacity_frames: int = 1 << 16,
                 sink_path: Optional[str] = None, lead_buffers: int = 4):
        self.rb = RingBuffer(capacity_frames)
        lib = self.rb._lib
        self._lib = lib
        self._lock = threading.Lock()  # handle-vs-stop guard (see RingBuffer)
        self._svc = lib.audio_service_start(
            self.rb._rb, sample_rate, buffer_frames,
            (sink_path or "").encode(), int(lead_buffers),
        )
        if not self._svc:
            self.rb.close()
            raise RuntimeError(
                f"audio_service_start failed (sink_path={sink_path!r} "
                "could not be opened)")

    def write(self, frames: np.ndarray) -> int:
        return self.rb.write(frames)

    def needs_frames(self) -> int:
        with self._lock:
            if not self._svc:
                return 0
            return self._lib.audio_service_needs_frames(self._svc)

    def frames_consumed(self) -> int:
        with self._lock:
            if not self._svc:
                return 0
            return self._lib.audio_service_frames_consumed(self._svc)

    def underruns(self) -> int:
        with self._lock:
            if not self._svc:
                return 0
            return self._lib.audio_service_underruns(self._svc)

    def stop(self):
        with self._lock:
            svc, self._svc = self._svc, None
        if svc:
            self._lib.audio_service_stop(svc)
        self.rb.close()


def wav_write_fast(path, samples: np.ndarray, sample_rate: int) -> bool:
    """Native WAV writer; returns False if the library isn't available."""
    lib = _load()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.float32)
    if samples.ndim == 1:
        samples = np.stack([samples, samples], axis=-1)
    ptr = samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.wav_write_16bit_stereo(str(path).encode(), ptr, len(samples),
                                    int(sample_rate))
    return rc == 0
