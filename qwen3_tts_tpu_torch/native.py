"""ctypes bindings for the native C++ audio runtime (native/audio_kernels.cpp).

A copy of ``qwen3_tts_tpu/native.py`` (held equal by
``tests/test_torch_copies.py``); both load the same library, built on
demand with the in-tree Makefile. Every entry point has a pure-numpy
fallback with identical semantics, so the package works without a C++
toolchain; ``available()`` reports whether the fast path is active. Host
code only: no device work runs here.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libaudio_kernels.so"
_lib = None
_load_attempted = False


def _load():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:  # noqa: BLE001 — fall back to numpy paths
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.resample_sinc.restype = ctypes.c_int64
        lib.resample_sinc.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.wav_write_pcm16.restype = ctypes.c_int
        lib.wav_write_pcm16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.pcg_uniforms.restype = None
        lib.pcg_uniforms.argtypes = [
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _as_float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample_sinc(
    samples: np.ndarray, src_rate: int, dst_rate: int, sinc_len: int = 128
) -> np.ndarray | None:
    """Native polyphase resample; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(samples, dtype=np.float32)
    n_out = int(round(len(x) * dst_rate / src_rate))
    out = np.empty(n_out, np.float32)
    written = lib.resample_sinc(
        _as_float_ptr(x), len(x), src_rate, dst_rate, sinc_len, _as_float_ptr(out)
    )
    return out[:written]


def wav_write_pcm16(path: str, samples: np.ndarray, sample_rate: int) -> bool:
    lib = _load()
    if lib is None:
        return False
    x = np.ascontiguousarray(samples, dtype=np.float32)
    rc = lib.wav_write_pcm16(
        str(path).encode(), _as_float_ptr(x), len(x), int(sample_rate)
    )
    return rc == 0


def pcg_uniforms(seed: int, n: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, np.float32)
    lib.pcg_uniforms(ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), n, _as_float_ptr(out))
    return out
