"""Audio buffers and WAV I/O (PCM16 out, int/float in, multi-channel -> mono).

A copy of ``qwen3_tts_tpu/audio/io.py`` on the stdlib ``wave`` module and
numpy alone (the JAX package's optional native writer is not ported; it
writes the same bytes).
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class AudioBuffer:
    """Mono float32 samples in [-1, 1] plus a sample rate."""

    samples: np.ndarray
    sample_rate: int

    def __post_init__(self):
        self.samples = np.asarray(self.samples, dtype=np.float32).reshape(-1)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def duration(self) -> float:
        return len(self.samples) / self.sample_rate

    def normalize(self) -> None:
        peak = float(np.abs(self.samples).max()) if len(self.samples) else 0.0
        if peak > 0.0 and peak != 1.0:
            self.samples = self.samples / peak

    def normalize_db(self, target_db: float) -> None:
        peak = float(np.abs(self.samples).max()) if len(self.samples) else 0.0
        if peak > 0.0:
            target = 10.0 ** (target_db / 20.0)
            self.samples = self.samples * (target / peak)

    def save(self, path: str | Path) -> None:
        save_wav(path, self.samples, self.sample_rate)

    @classmethod
    def load(cls, path: str | Path) -> "AudioBuffer":
        return load_wav(path)


def save_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono PCM16 WAV: clamp to [-1, 1], scale by 32767."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


def load_wav(path) -> AudioBuffer:
    """Read a WAV file (path or binary file-like object); int formats scaled
    by 2^(bits-1), channels averaged."""
    src = path if hasattr(path, "read") else str(path)
    with wave.open(src, "rb") as r:
        channels = r.getnchannels()
        width = r.getsampwidth()
        rate = r.getframerate()
        raw = r.readframes(r.getnframes())

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        # 8-bit WAV is unsigned
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as_int = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
        data = as_int.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")

    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return AudioBuffer(data, rate)
