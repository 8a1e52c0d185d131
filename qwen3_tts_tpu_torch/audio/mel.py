"""librosa-compatible mel spectrograms (numpy, host-side preprocessing).

A copy of ``qwen3_tts_tpu/audio/mel.py`` (numpy alone; held equal by
``tests/test_torch_copies.py``). Slaney mel scale + Slaney area
normalization; reflect-padded STFT with a Hann window. The speaker-encoder
variant uses a **magnitude** spectrum ``sqrt(re^2 + im^2 + 1e-9)`` and
``log(max(mel, 1e-5))`` compression.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 400
    hop_length: int = 160
    win_length: int | None = None
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None


def speaker_encoder_config() -> MelConfig:
    """n_fft=1024, hop=256, 128 mels: the ECAPA-TDNN front end."""
    return MelConfig(sample_rate=24000, n_fft=1024, hop_length=256, win_length=1024)


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney / O'Shaughnessy scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp, min_log_hz * np.exp(logstep * (m - min_log_mel)))


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """[n_mels, n_fft/2 + 1] triangular filterbank, Slaney-normalized."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    n_freqs = cfg.n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fft_freqs = np.arange(n_freqs) * cfg.sample_rate / cfg.n_fft

    fb = np.zeros((cfg.n_mels, n_freqs), dtype=np.float64)
    for i in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        rising = (fft_freqs >= lo) & (fft_freqs <= ctr) & (ctr > lo)
        falling = (fft_freqs > ctr) & (fft_freqs <= hi) & (hi > ctr)
        fb[i, rising] = (fft_freqs[rising] - lo) / (ctr - lo)
        fb[i, falling] = (hi - fft_freqs[falling]) / (hi - ctr)
        bw = hi - lo
        if bw > 0:
            fb[i] *= 2.0 / bw
    return fb.astype(np.float32)


def hann_window(length: int) -> np.ndarray:
    """Periodic Hann window: 0.5 * (1 - cos(2*pi*i / N))."""
    i = np.arange(length, dtype=np.float32)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / length))).astype(np.float32)


def _reflect_pad(samples: np.ndarray, pad: int) -> np.ndarray:
    """Reflect padding mirroring positions 1.. / len-2..."""
    n = len(samples)
    left_idx = [min(i, n - 1) for i in range(pad, 0, -1)]
    right_idx = [n - 2 - i if n >= 2 + i else 0 for i in range(pad)]
    return np.concatenate([samples[left_idx], samples, samples[right_idx]])


def stft(samples: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """STFT with (n_fft - hop)/2 reflect padding -> complex [n_frames, n_fft/2+1]."""
    samples = np.asarray(samples, dtype=np.float32)
    win_length = cfg.win_length or cfg.n_fft
    window = hann_window(win_length)
    pad = (cfg.n_fft - cfg.hop_length) // 2
    padded = _reflect_pad(samples, pad)

    n_frames = (len(padded) - cfg.n_fft) // cfg.hop_length + 1
    if n_frames <= 0:
        return np.zeros((0, cfg.n_fft // 2 + 1), dtype=np.complex64)
    idx = np.arange(cfg.n_fft)[None, :] + cfg.hop_length * np.arange(n_frames)[:, None]
    frames = padded[idx]
    if win_length < cfg.n_fft:
        w = np.zeros(cfg.n_fft, np.float32)
        w[:win_length] = window
    else:
        w = window
    return np.fft.rfft(frames * w, n=cfg.n_fft, axis=1).astype(np.complex64)


class MelSpectrogram:
    def __init__(self, cfg: MelConfig = MelConfig()):
        self.cfg = cfg
        self.fb = mel_filterbank(cfg)

    def compute(self, samples: np.ndarray) -> np.ndarray:
        """Power-spectrum mel: [n_frames, n_mels]."""
        spec = stft(samples, self.cfg)
        power = (spec.real**2 + spec.imag**2).astype(np.float32)
        return power @ self.fb.T

    def compute_log(self, samples: np.ndarray) -> np.ndarray:
        return np.log(np.maximum(self.compute(samples), 1e-10))

    def compute_for_speaker_encoder(self, samples: np.ndarray) -> np.ndarray:
        """Magnitude-spectrum mel with log(max(., 1e-5)): [n_mels, n_frames]."""
        spec = stft(samples, self.cfg)
        mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9).astype(np.float32)
        mel = mag @ self.fb.T
        return np.log(np.maximum(mel, 1e-5)).T.astype(np.float32)
